"""Native-resolution ('big') mode of the port, `ModelConfig.input_size = 0`:
uncut 512x384 frames (the JAX package's `test_e2e.py::
test_big_mode_native_resolution`).  Against the JAX package at 384x512:
MobileNetTiny float32 in eval mode and a train-mode loss with its
gradient (the parity recipe of `test_torch_heads.py`), and Xception
float32 in eval mode at b=1 (odd-sized SAME pools at 93x125 and 47x63,
the non-square NHWC flatten of a 6x8x2048 map into the head).  Also the
ten K1 shapes the model gives at this size (those `chip_smoke.py` phase
18 checks on the card), the inference benchmark's native frames, and the
CLI's train -> evaluate -> predict with `--input_size 0`."""

import dataclasses
import glob
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.train.steps import kernel_l2 as j_kernel_l2
from spnet_tpu_torch.cli import evaluate as cli_evaluate
from spnet_tpu_torch.cli import predict as cli_predict
from spnet_tpu_torch.cli import train as cli_train
from spnet_tpu_torch.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.data.csvio import write_meta_file
from spnet_tpu_torch.io.checkpoint import load_checkpoint
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops import sepconv
from spnet_tpu_torch.tools import bench_infer
from spnet_tpu_torch.train.steps import forward_loss
from test_torch_heads import _labels

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 384, 512
#: Xception at 384x512 in float32 eval, the port against JAX: 1e-4 of the
#: output's scale, as at 331 (tests/test_torch_models.py)
EVAL_ATOL_OF_SCALE = 1e-4
#: MobileNetTiny's float32 train-mode gradient at 384x512 against JAX's
#: float64 one, per leaf as a share of its max: JAX's own float32 gradient
#: reaches 7.0e-2 (backbone.block9.bn.bias), the port's 1.3e-2
#: (backbone.block7.bn.bias), measured with these weights and frames
NATIVE_GRAD_SPREAD = 2.5e-2


def _cfg(backbone, config=ModelConfig, **kw):
    return config(backbone=backbone, input_size=0, compute_dtype="float32",
                  dropout_rate=0.0, **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fill(tree, rng, gain=1.0):
    """numpy values for a tree of shapes: kernels U(-l, l) with the Keras
    glorot limit of their flax fans (times `gain`), biases and running
    means N(0, 0.1), BN scales U(0.8, 1.2), running variances U(0.5,
    1.5) (tests/test_torch_backbones.py)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, gain)
            continue
        if k == "kernel":
            rf = math.prod(v.shape[:-2])
            lim = gain * math.sqrt(6.0 / (v.shape[-2] * rf
                                          + v.shape[-1] * rf))
            out[k] = rng.uniform(-lim, lim, v.shape)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, v.shape)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, v.shape)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape)
        else:
            raise KeyError(k)
        out[k] = out[k].astype(np.float32)
    return out


def _jax_variables(jm, rng, gain=1.0):
    """(params, batch_stats) of the JAX model at 384x512 from its shapes
    (`jax.eval_shape`, no init program), filled by `_fill`."""
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(0)},
                        jnp.zeros((1, H, W, 1)), train=False))
    return (_fill(shapes["params"], rng, gain),
            _fill(shapes["batch_stats"], rng))


def _eval_pair(backbone, n, seed, gain=1.0):
    """The JAX and the port's float32 eval outputs of `backbone` at
    384x512 on n seeded frames, from the same filled weights."""
    rng = np.random.default_rng(seed)
    jm = jbuild(_cfg(backbone, JModelConfig))
    params, stats = _jax_variables(jm, rng, gain)
    x = rng.normal(0, 1, (n, H, W, 1)).astype(np.float32)
    y_jax = np.asarray(jax.jit(
        lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x,
                                 train=False))(params, stats, x))
    model = build_model(_cfg(backbone), device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    with torch.inference_mode():
        y = model(torch.from_numpy(x)).numpy()
    return y, y_jax, model


@pytest.mark.parametrize("backbone,n,gain", [("MobileNetTiny", 2, 2.0),
                                             ("Xception", 1, 1.0)])
def test_native_eval_matches_jax(backbone, n, gain):
    """float32 eval at 384x512 from the same weights: within
    EVAL_ATOL_OF_SCALE of the output's scale.  Xception's head reads a
    6x8x2048 map (98304 x 576, 77.43 M parameters)."""
    y, y_jax, model = _eval_pair(backbone, n, seed=len(backbone), gain=gain)
    assert y.shape == y_jax.shape == (n, 576)
    scale = np.abs(y_jax).max()
    assert scale > 1e-2
    np.testing.assert_allclose(y, y_jax, rtol=0,
                               atol=EVAL_ATOL_OF_SCALE * scale)
    if backbone == "Xception":
        assert model.final_output.weight.shape == (576, 6 * 8 * 2048)
        assert round(sum(p.numel() for p in model.parameters()) / 1e6,
                     2) == 77.43


def test_native_train_gradient_matches_jax():
    """MobileNetTiny at 384x512, train mode, dropout 0, 2 frames: data loss
    + 1e-4 * 'reference' L2 and its gradient leaf by leaf, against JAX in
    float64 (the oracle of `test_torch_backbones_train.py`: MobileNetTiny's
    float32 train mode is ill-conditioned, and at this size JAX's own
    float32 gradient lies up to 7.0e-2 of a leaf's max from its float64
    one, the port's 1.3e-2).  The loss within rel 1e-5 (measured 1.1e-6),
    the head kernel's gradient within 1e-3 of its max (measured 5.9e-5),
    every leaf within NATIVE_GRAD_SPREAD of its max (or 1e-6 of the
    largest gradient), the median leaf within 1e-2 (measured 1.5e-3)."""
    rng = np.random.default_rng(7)
    jm = jbuild(_cfg("MobileNetTiny", JModelConfig))
    params, stats = _jax_variables(jm, rng, gain=2.0)
    x = rng.normal(0, 1, (2, H, W, 1)).astype(np.float32)
    y = _labels(rng, 2)
    with jax.enable_x64(True):
        jm64 = jbuild(dataclasses.replace(
            _cfg("MobileNetTiny", JModelConfig), compute_dtype="float64"))
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)

        def loss_fn(p):
            out, _ = jm64.apply({"params": p, "batch_stats": f64(stats)},
                                f64(x), train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.key(1)})
            data = j_components(f64(y), out, JLossWeights(), "same")["total"]
            return data + 1e-4 * j_kernel_l2(p, "reference"), data

        (j_loss, j_data), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(f64(params))
        j_grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                         j_grads)
    model = build_model(_cfg("MobileNetTiny"), device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    model.train()
    names, tparams = zip(*model.named_parameters())
    loss, data = forward_loss(model, torch.from_numpy(x), torch.from_numpy(y),
                              None, LossWeights(), "same", 1e-4, "reference")
    grads = torch.autograd.grad(loss, tparams)
    assert float(data.detach()) == pytest.approx(float(j_data), rel=1e-5)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    want = flax_tree_to_torch(j_grads, model)
    assert set(want) == set(names)
    floor = 1e-6 * max(np.abs(w.numpy()).max() for w in want.values())
    rel = {}
    for name, g in zip(names, grads):
        ref = want[name].numpy()
        rel[name] = (np.abs(g.numpy() - ref).max()
                     / max(np.abs(ref).max(), floor))
    assert rel["final_output.weight"] <= 1e-3
    worst = max(rel, key=rel.get)
    assert rel[worst] <= NATIVE_GRAD_SPREAD, (worst, rel[worst])
    assert np.median(list(rel.values())) <= 1e-2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_native_sepconv_shapes_are_the_smokes(monkeypatch):
    """The separable convs of Xception at 384x512 (b=1, eval): the ten
    (H, W, C, F, relu, relu_in, uses) of `chip_smoke.NATIVE_SHAPES`, 34 a
    batch, with the widths and heights the 331 path never has (125, 63;
    93, 47)."""
    calls = []
    orig = sepconv.sepconv_infer_torch

    def spy(x, dw, pw, scale, bias, relu=True, relu_in=False):
        calls.append((*x.shape[1:], pw.shape[1], relu, relu_in))
        return orig(x, dw, pw, scale, bias, relu, relu_in)

    monkeypatch.setattr(sepconv, "sepconv_infer_torch", spy)
    model = build_model(ModelConfig(input_size=0, compute_dtype="float32"),
                        device="cpu")
    with torch.inference_mode():
        model(torch.zeros(1, H, W, 1))
    want = [s[1:] for s in _chip_smoke().NATIVE_SHAPES]
    got = [(*c, calls.count(c)) for c in dict.fromkeys(calls)]
    assert got == want and len(calls) == 34
    assert {c[1] for c in calls} >= {125, 63} and \
        {c[0] for c in calls} >= {93, 47}


def test_bench_infer_native_frames():
    """`bench_infer.setup(input_size=0)` gives native 384x512 uint8 frames
    and a model built for them."""
    model, x, mc = bench_infer.setup(2, 3, device="cpu",
                                     backbone="MobileNetTiny", input_size=0)
    assert x.shape == (3, H, W, 1) and x.dtype == torch.uint8
    assert model.backbone.output_hw(H // 2, W // 2) == (6, 8)
    assert model.final_output.in_features == 6 * 8 * 128
    assert mc.input_size == 0


def _write_native_frames(d, n, seed, grid=GridSpec()):
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (H, W), dtype=np.uint8)).save(
            os.path.join(d, f"frame_{i:02d}.png"))
        k = int(rng.integers(1, 5))
        a = rng.uniform(12, 90, k)
        write_meta_file(os.path.join(d, f"frame_{i:02d}.csv"), np.stack(
            [rng.uniform(grid.cx_min, grid.cx_max, k),
             rng.uniform(grid.cy_min, grid.cy_max, k), a,
             a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
             rng.uniform(1, 11, k)], axis=1))


def test_cli_native_train_evaluate_predict(tmp_path, monkeypatch, capsys):
    """`train --input_size 0` (MobileNetTiny, float32, 4 native PNG frames,
    b=2, 1 epoch) writes a checkpoint whose config keeps input_size 0;
    `evaluate` and `predict` rebuild the model for 384x512 from it and
    serve the uncut frames."""
    _write_native_frames(str(tmp_path / "data" / "Train"), 4, 1)
    _write_native_frames(str(tmp_path / "data" / "Val"), 2, 2)
    monkeypatch.chdir(tmp_path)
    cli_train.main(["-d", "data", "-b", "2", "-e", "1", "-w", "ck",
                    "--name", "big", "--backbone", "MobileNetTiny",
                    "--input_size", "0", "--dtype", "float32",
                    "--device", "cpu", "--no-eval"])
    payload, cfg = load_checkpoint("ck")
    assert payload["step"] == 2 and cfg.model.input_size == 0
    assert len(glob.glob("logs/big_*/losses.dat")) == 1
    cli_evaluate.main(["-w", "ck", "-d", "data/Val", "-b", "2", "-l",
                       "eval", "--device", "cpu"])
    assert "mAP" in capsys.readouterr().out
    assert len((tmp_path / "eval" / "hawley_spnet.csv").read_text()
               .splitlines()) > 0
    cli_predict.main(["-w", "ck", "-d", "data/Val", "-b", "2", "-l", "pred",
                      "--device", "cpu"])
    assert "predicting on 2 frames" in capsys.readouterr().out
    assert len((tmp_path / "pred" / "hawley_spnet.csv").read_text()
               .splitlines()) > 0
