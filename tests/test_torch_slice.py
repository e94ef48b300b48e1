"""The port's serving slice as a whole: predict -> denormalize -> metrics
against the JAX package on the same seeded uint8 frames and converted
weights; the `python -m spnet_tpu_torch predict` CLI on PNG frames; and
the rule that the port imports neither jax nor the JAX package."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import ExperimentConfig as JExperimentConfig
from spnet_tpu.config import GridSpec as JGridSpec
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.eval import metrics as jmetrics
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.loop import predict_in_batches as j_predict_in_batches
from spnet_tpu.train.steps import make_predict_step as j_make_predict_step
from spnet_tpu_torch.cli.common import load_model_and_state, \
    resolve_device
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, denormalize, normalize
from spnet_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train.loop import predict_in_batches
from spnet_tpu_torch.train.steps import make_predict_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96  # full-width Xception on a small frame: 2x2x2048 into the head


def _labels(rng, n, grid):
    recs = []
    for _ in range(n):
        k = int(rng.integers(1, 6))
        a = rng.uniform(12, 90, k)
        raw = np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                        rng.uniform(grid.cy_min, grid.cy_max, k), a,
                        a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
                        rng.uniform(1, 11, k)], axis=1)
        recs.append(canonicalize_records(raw))
    return normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                     grid).astype(np.float32)


def _perturb_stats(tree, rng):
    return {k: (_perturb_stats(v, rng) if isinstance(v, dict) else
                (rng.normal(0, 0.1, v.shape) if k == "mean" else
                 rng.uniform(0.5, 1.5, v.shape)).astype(np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = JExperimentConfig(model=JModelConfig(input_size=SIZE,
                                                compute_dtype="float32"))
    cfg = ExperimentConfig.from_json(jcfg.to_json())  # the port's twin
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (10, SIZE, SIZE, 1), dtype=np.uint8)
    y = _labels(rng, 10, cfg.grid)
    jm = jbuild(jcfg.model)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), x.astype(np.float32))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = _perturb_stats(jax.tree_util.tree_map(np.asarray,
                                                  v["batch_stats"]), rng)
    y_jax, _ = j_predict_in_batches(j_make_predict_step(jm), params, stats,
                                    x, 4, verbose=False)
    model = build_model(cfg.model, num_outputs=cfg.grid.num_outputs,
                        device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return cfg, x, y, np.asarray(y_jax), model, (params, stats)


def test_predict_in_batches_matches_jax(slice_setup):
    """10 frames at b=4: two full batches and one padded; float32, the
    same 1e-4-of-scale tolerance as the model parity test."""
    cfg, x, _, y_jax, model, _ = slice_setup
    y, fps = predict_in_batches(make_predict_step(model), x, 4, "cpu",
                                verbose=False)
    assert y.shape == y_jax.shape == (10, 576) and fps > 0
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-4 * scale)
    dy = np.abs(denormalize(y, cfg.grid) - denormalize(y_jax, cfg.grid))
    assert np.all(dy <= 1e-4 * scale * cfg.grid.ranges + 1e-6)


def test_evaluate_network_matches_jax_metrics(slice_setup, tmp_path):
    """The port's evaluate (predict -> denormalize -> calc_map /
    calc_errors -> CSV) against the JAX metrics of the JAX predictions."""
    cfg, x, y, y_jax, model, _ = slice_setup
    ds = Dataset(x=x, y=y, file_list=[f"synthetic://0/{i}"
                                      for i in range(len(x))],
                 grid=cfg.grid)
    res = evaluate_network(cfg, model, ds, "cpu", log_dir=str(tmp_path),
                           num_draw=0, verbose=0)
    yp, yt = denormalize(y_jax, cfg.grid), denormalize(y, cfg.grid)
    st = jmetrics.calc_errors(yp, yt)
    jgrid = JGridSpec.from_json(cfg.grid.to_json())
    assert res["mAP"] == pytest.approx(jmetrics.calc_map(yp, yt, jgrid),
                                       abs=1e-6)
    for k in ("ring_truecounts", "ring_miscounts", "total_obj",
              "false_obj_pos", "false_obj_neg", "true_obj_pos",
              "true_obj_neg"):
        assert res[k] == getattr(st, k), k
    assert res["mean_pix_err"] == pytest.approx(st.mean_pix_err, abs=1e-3)
    assert (tmp_path / "hawley_spnet.csv").exists()
    res_h = evaluate_network(cfg, model, ds, "cpu", tta="h",
                             log_dir=str(tmp_path / "tta"), num_draw=0,
                             verbose=0)
    assert np.isfinite(res_h["mAP"]) and res_h["fps"] > 0
    assert res_h["total_obj"] == res["total_obj"]


def test_flax_checkpoint_converts_and_serves(slice_setup, tmp_path):
    """scripts/flax_ckpt_to_torch.py: an Orbax checkpoint of the JAX model
    becomes a port checkpoint that the CLI loader serves with the JAX
    model's predictions."""
    import importlib.util

    from spnet_tpu.cli.common import InferenceState
    from spnet_tpu.io.checkpoint import save_checkpoint as j_save

    cfg, x, _, y_jax, _, (params, stats) = slice_setup
    j_save(str(tmp_path / "jax"), InferenceState(params, stats, 12),
           JExperimentConfig.from_json(cfg.to_json()))
    spec = importlib.util.spec_from_file_location(
        "flax_ckpt_to_torch", os.path.join(ROOT, "scripts",
                                           "flax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(["-w", str(tmp_path / "jax"), "-o", str(tmp_path / "pt")])

    cfg2, model, step = load_model_and_state(str(tmp_path / "pt"), "cpu")
    assert cfg2 == cfg and step == 12
    y, _ = predict_in_batches(make_predict_step(model), x, 4, "cpu",
                              verbose=False)
    np.testing.assert_allclose(y, y_jax, rtol=0,
                               atol=1e-4 * np.abs(y_jax).max())


def test_checkpoint_round_trip(tmp_path):
    cfg = ExperimentConfig(grid=GridSpec(nx=4, ny=3),
                           model=ModelConfig(input_size=SIZE))
    state = {"a.weight": torch.arange(6.0).reshape(2, 3)}
    save_checkpoint(str(tmp_path), state, cfg, step=7)
    payload, cfg2 = load_checkpoint(str(tmp_path))
    assert cfg2 == cfg and payload["step"] == 7
    assert torch.equal(payload["state_dict"]["a.weight"], state["a.weight"])
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nothing"))


def test_cli_predict_writes_csv(tmp_path):
    from PIL import Image

    cfg = ExperimentConfig(model=ModelConfig(input_size=SIZE,
                                             compute_dtype="float32"))
    model = build_model(cfg.model, num_outputs=cfg.grid.num_outputs,
                        device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), model.state_dict(), cfg)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8)
                        ).save(frames / f"frame_{i}.png")
    logdir = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "spnet_tpu_torch", "predict",
         "-w", str(tmp_path / "ckpt"), "-d", str(frames), "-b", "2",
         "-l", str(logdir), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = (logdir / "hawley_spnet.csv").read_text().splitlines()
    # 3 frames at b=2: the reference keeps a multiple of the batch (2)
    assert {r.split(",")[2] for r in rows} == {"frame_0.png", "frame_1.png"}
    assert (logdir / "steelpan_pred_00000.png").exists()


def test_cuda_device_absent_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        resolve_device("cuda")


def test_port_never_imports_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import spnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(spnet_tpu_torch.__path__, "
        "'spnet_tpu_torch.'):\n"
        # the native decoder's ctypes library is a .so, not a module
        "    if importlib.util.find_spec(m.name).origin.endswith('.py'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "train = ['spnet_tpu_torch.' + m for m in ('train.loop', "
        "'train.steps', 'train.state', 'train.optim', 'train.schedule', "
        "'ops.losses', 'ops.augment', 'cli.train', 'io.checkpoint', "
        "'data.synth', 'ops.resize', 'ops.grid_encode', 'io.tb', "
        "'utils.profiling', 'cli.gen_fake_espi')]\n"
        "missing = [m for m in train if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('spnet_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('spnet_tpu_torch')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 57  # every module imported


def _imported_modules(path):
    """Every module an `import` / `from ... import` in the file names."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["spnet_tpu_torch", "chip_smoke.py"])
def test_port_never_names_the_jax_package(where):
    """No module of the port, and not `chip_smoke.py`, imports
    `spnet_tpu` (not even its numpy modules: the port keeps its own copy of
    config, grid, data and io), jax or flax.  No file is exempt."""
    top = os.path.join(ROOT, where)
    files = [top] if top.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs
        if f.endswith(".py")]
    assert len(files) >= (1 if top.endswith(".py") else 57)
    bad = sorted((os.path.relpath(f, ROOT), m) for f in files
                 for m in _imported_modules(f)
                 if m.split(".")[0] in ("spnet_tpu", "jax", "jaxlib", "flax"))
    assert not bad, bad
    assert not os.path.exists(os.path.join(ROOT, "spnet_tpu_torch",
                                           "shared.py"))
