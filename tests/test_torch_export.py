"""The port's serving export (`spnet_tpu_torch/io/export.py`) on the CPU: a
port checkpoint -> `torch.export` artifact -> loaded without the model
code, with a symbolic batch: its output matches JAX's `model.apply` on the
same weights within `tests/test_export.py`'s tolerance (rtol 1e-5, atol
1e-6) and the port's eager model bitwise, at b=4 and b=7 through one
artifact, for Xception and MobileNetTiny; the program calls the kernels
K1 and K4 as the registered operators (checked with `opcheck`); the fixed
batch fall-back; and `python -m spnet_tpu_torch export`."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu_torch.config import ExperimentConfig, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.io import export
from spnet_tpu_torch.io.checkpoint import save_checkpoint
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops.activations import selective_sigmoid_fwd
from spnet_tpu_torch.ops.sepconv import sepconv_infer
from spnet_tpu_torch.train.steps import make_predict_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


def _perturb(tree, rng):
    """Non-trivial BN parameters and statistics (JAX's init has mean 0,
    var 1, scale 1, bias 0); kernels as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _checkpoint(path, mc, seed=0):
    """A port checkpoint of `mc` with JAX's init (BN perturbed), and the
    JAX model and variables it came from."""
    rng = np.random.default_rng(seed)
    jm = jbuild(JModelConfig(**dataclasses.asdict(mc)))
    v = jm.init(jax.random.key(seed), np.zeros((1, SIZE, SIZE, 1),
                                               np.float32), train=False)
    params = _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng)
    stats = _perturb(jax.tree_util.tree_map(np.asarray, v["batch_stats"]),
                     rng)
    model = build_model(mc, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    save_checkpoint(path, model.state_dict(), ExperimentConfig(model=mc))
    return jm, {"params": params, "batch_stats": stats}, model


@pytest.mark.parametrize("backbone", ["Xception", "MobileNetTiny"])
def test_export_round_trip_matches_jax(backbone, tmp_path):
    mc = ModelConfig(backbone=backbone, input_size=SIZE,
                     compute_dtype="float32")
    jm, variables, model = _checkpoint(str(tmp_path / "ck"), mc)
    art = export.export_predictor(str(tmp_path / "ck"), str(tmp_path / "a"),
                                  device="cpu")
    call, meta = export.load_predictor(art)
    assert meta["input"] == {"height": SIZE, "width": SIZE, "channels": 1,
                             "dtype": "uint8", "batch": "symbolic"}
    assert meta["config"]["model"]["backbone"] == backbone
    assert meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert "spnet_tpu_torch.ops" in meta["requires"]
    eager = make_predict_step(model)
    rng = np.random.default_rng(1)
    for b in (4, 7):
        x = rng.integers(0, 256, (b, SIZE, SIZE, 1), dtype=np.uint8)
        got = call(x)
        assert got.shape == (b, 576) and got.dtype == torch.float32
        assert torch.equal(got, eager(torch.from_numpy(x)))
        xf = (x.astype(np.float32) / 255.0 - 0.5) * 2.0
        want = np.asarray(jm.apply(variables, xf, train=False))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _ops(artifact_dir):
    """Calls of each operator in the artifact's program, by name."""
    prog = torch.export.load(os.path.join(artifact_dir, export.ARTIFACT))
    counts = {}
    for node in prog.graph.nodes:
        if node.op == "call_function":
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


def test_artifact_calls_the_registered_kernels(tmp_path):
    """Xception's 34 separable convs are 34 calls of the operator
    `spnet_tpu_torch::sepconv_infer` and the 'ss' head one call of
    `spnet_tpu_torch::selective_sigmoid_fwd` (the kernels K1 and K4 on a
    card; on the CPU their plain twins, so no launch is counted here);
    the 'ss' artifact is its eager model bitwise."""
    mc = ModelConfig(input_size=SIZE, compute_dtype="float32",
                     selective_sigmoid=True)
    model = build_model(mc, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    save_checkpoint(str(tmp_path / "ck"), model.state_dict(),
                    ExperimentConfig(model=mc))
    launches = (sepconv_infer.launches, selective_sigmoid_fwd.launches)
    art = export.export_predictor(str(tmp_path / "ck"), str(tmp_path / "a"),
                                  device="cpu")
    ops = _ops(art)
    assert ops["spnet_tpu_torch.sepconv_infer.default"] == 34
    assert ops["spnet_tpu_torch.selective_sigmoid_fwd.default"] == 1
    call, _ = export.load_predictor(art)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (5, SIZE, SIZE, 1), dtype=np.uint8))
    y = call(x)
    assert torch.equal(y, make_predict_step(model)(x))
    assert ((y[:, 6::8] > 0) & (y[:, 6::8] < 1)).all()
    assert (sepconv_infer.launches, selective_sigmoid_fwd.launches) == \
        launches


def test_registered_operators_pass_opcheck():
    """Schema, fake (shape and dtype without data), autograd registration
    and dynamic shapes of the two operators, on CPU tensors (their plain
    twins); each gives its wrapper's plain result."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 6, 8, generator=g)
    dw, pw = torch.randn(3, 3, 8, generator=g), torch.randn(8, 16,
                                                            generator=g)
    scale, bias = torch.rand(16, generator=g), torch.rand(16, generator=g)
    for relu, relu_in in ((True, False), (False, True)):
        args = (x, dw, pw, scale, bias, relu, relu_in)
        torch.library.opcheck(torch.ops.spnet_tpu_torch.sepconv_infer.default,
                              args)
        assert torch.equal(torch.ops.spnet_tpu_torch.sepconv_infer(*args),
                           sepconv_infer(*args))
    z = 4 * torch.randn(3, 24, generator=g)
    torch.library.opcheck(
        torch.ops.spnet_tpu_torch.selective_sigmoid_fwd.default, (z,))
    assert torch.equal(torch.ops.spnet_tpu_torch.selective_sigmoid_fwd(z),
                       selective_sigmoid_fwd(z))


def test_symbolic_batch_falls_back_to_a_fixed_batch(monkeypatch, capsys,
                                                    tmp_path):
    """When the symbolic export fails, JAX's fall-back: a fixed batch of
    64, printed and recorded in meta.json."""
    mc = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                     compute_dtype="float32")
    model = build_model(mc, device="cpu")
    save_checkpoint(str(tmp_path / "ck"), model.state_dict(),
                    ExperimentConfig(model=mc))
    real = torch.export.export

    def no_symbolic(mod, args, dynamic_shapes=None, **kw):
        if dynamic_shapes is not None:
            raise RuntimeError("no symbolic batch")
        return real(mod, args, **kw)

    monkeypatch.setattr(torch.export, "export", no_symbolic)
    art = export.export_predictor(str(tmp_path / "ck"), str(tmp_path / "a"),
                                  device="cpu")
    assert "symbolic batch unsupported here: no symbolic batch" in \
        capsys.readouterr().out
    call, meta = export.load_predictor(art)
    assert meta["input"]["batch"] == export.FALLBACK_BATCH
    x = torch.zeros((export.FALLBACK_BATCH, SIZE, SIZE, 1), dtype=torch.uint8)
    assert call(x).shape == (export.FALLBACK_BATCH, 576)


def test_cli_export(tmp_path):
    """`python -m spnet_tpu_torch export -w ck -o art --device cpu` writes
    the artifact and its meta.json; the artifact loads in a process that
    imports only torch and the port's operators."""
    mc = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                     compute_dtype="float32")
    model = build_model(mc, device="cpu")
    save_checkpoint(str(tmp_path / "ck"), model.state_dict(),
                    ExperimentConfig(model=mc))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "spnet_tpu_torch", "export", "-w", "ck",
         "-o", "art", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "exported serving artifact to art" in proc.stdout
    meta = json.load(open(tmp_path / "art" / "meta.json"))
    assert meta["input"]["batch"] == "symbolic"
    code = ("import sys, torch, numpy as np\n"
            "import spnet_tpu_torch.ops.sepconv, "
            "spnet_tpu_torch.ops.activations\n"
            "m = torch.export.load('art/predictor.pt2').module()\n"
            "y = m(torch.zeros((3, 64, 64, 1), dtype=torch.uint8))\n"
            "assert y.shape == (3, 576), y.shape\n"
            "bad = [k for k in sys.modules if k.startswith(('jax', "
            "'spnet_tpu_torch.models', 'spnet_tpu_torch.train'))]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
