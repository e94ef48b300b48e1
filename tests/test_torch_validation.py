"""The port's accuracy-validation tools (`spnet_tpu_torch/tools/`:
synth_cache, dataset_a, sanity_train, eval_breakdown, eval_tta,
movie_predict) against the JAX package's scripts of the same names, on
the CPU at a small size.  Each JAX script is imported by its path and
driven with its own argv; where it would train or load a checkpoint, the
JAX functions it calls are replaced by stand-ins that hand it the same
data the port sees."""

import collections
import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import spnet_tpu.cli.common as j_cli_common
import spnet_tpu.data.dataset as j_dataset
import spnet_tpu.grid as j_grid
import spnet_tpu.train.loop as j_loop
import spnet_tpu.train.steps as j_steps
from spnet_tpu.config import ExperimentConfig as JExperimentConfig
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu_torch.config import ExperimentConfig, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.io.checkpoint import save_checkpoint
from spnet_tpu_torch.models.spnet import build_model
import spnet_tpu_torch.train.loop as t_loop
from spnet_tpu_torch.tools import dataset_a, eval_breakdown, eval_tta, \
    movie_predict, runtime, sanity_train, synth_cache
from test_torch_backbones import fill
from test_torch_tta import _noisy_grids

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
#: the training history's losses, the port against JAX from the same
#: weights and frames (MobileNetTiny float32, augmentation and dropout
#: off), as tests/test_torch_bench.py holds the benchmark's epochs
HISTORY_RTOL = 1e-4
#: a model output's agreement, of its scale (tests/test_torch_tta.py)
OUTPUT_ATOL = 1e-4
#: mean pixel error and mAP of the same predictions
#: (tests/test_torch_tta.py::test_evaluate_network_tta_matches_jax)
PIX_ERR_ATOL, MAP_ATOL = 1e-3, 1e-6
COUNTS = ("ring_truecounts", "ring_miscounts", "total_obj", "false_obj_pos",
          "false_obj_neg", "true_obj_pos", "true_obj_neg")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _result(text, tag):
    lines = [l for l in text.splitlines() if l.startswith(tag + " ")]
    assert len(lines) == 1, text[-2000:]
    return json.loads(lines[0][len(tag) + 1:])


def _run(fn, *args, **kw):
    """(fn's return, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _tiny_cfg():
    return ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                       compute_dtype="float32")


@pytest.fixture(scope="module")
def tiny_weights():
    """JAX's MobileNetTiny-64 float32 (filled with seeded values, BN
    statistics included) and the port's model holding the same weights."""
    cfg = _tiny_cfg()
    jm = jbuild(JModelConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        np.zeros((1, SIZE, SIZE, 1), np.float32), train=False))
    rng = np.random.default_rng(12)
    params = fill(shapes["params"], rng)
    stats = fill(shapes["batch_stats"], rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return jm, params, stats, model


# ---------------------------------------------------------------- (a)

CONFIG_CASES = {
    "defaults": ([], {}),
    "sweep25_xception": (["25", "32", "1e-4", "40960", "bfloat16", "331",
                          "Xception"], {}),
    # the rest of JAX's 25-epoch backbone sweep (scripts/r4_queue*.sh)
    **{f"sweep25_{bb.lower()}": (["25", "32", "1e-4", "40960", "bfloat16",
                                  "331", bb], {})
       for bb in ("DarkNet19", "InceptionResNetV2", "MobileNet",
                  "NASNetMobile")},
    "native_remat_default": (["3", "8", "2e-4", "640", "float32", "0",
                              "MobileNetTiny"], {}),
    "native_remat_off": (["3", "8", "2e-4", "640", "float32", "0",
                          "MobileNetTiny"], {"SPNET_REMAT": "0"}),
    "no_augment_bf16_backbone": (["7", "4", "3e-5", "100", "float32", "96",
                                  "MobileNet"],
                                 {"SPNET_AUGMENT": "0",
                                  "SPNET_BACKBONE_DTYPE": "bfloat16",
                                  "SPNET_NVAL": "48"}),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_dataset_a_builds_the_jax_scripts_config(case, monkeypatch):
    """The same argv and environment give the same experiment.json as
    `scripts/dataset_a_run.py`, and the same two cached sets (frames,
    seed, batch), train first."""
    argv, env = CONFIG_CASES[case]
    for k in ("SPNET_REMAT", "SPNET_AUGMENT", "SPNET_BACKBONE_DTYPE",
              "SPNET_NVAL", "SPNET_MATMUL_PRECISION", "SPNET_CKPT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {"jax": [], "torch": []}

    def catcher(tag):
        def synth(n, cfg, seed, batch=None, **kw):
            seen[tag].append((n, seed, batch))
            return collections.namedtuple("Set", "x")(np.zeros((n, 1)))
        return synth

    def stop(tag):
        def train(cfg, *a, **kw):
            seen[tag + "_cfg"] = json.loads(cfg.to_json())
            raise _Stop
        return train

    script = _script("dataset_a_run")
    monkeypatch.setattr(script, "_cached_synth", catcher("jax"))
    monkeypatch.setattr(script, "train_network", stop("jax"))
    monkeypatch.setattr(sys, "argv", ["dataset_a_run.py", *argv])
    with pytest.raises(_Stop):
        _run(script.main)
    monkeypatch.setattr(dataset_a, "cached_synth", catcher("torch"))
    monkeypatch.setattr(dataset_a, "train_network", stop("torch"))
    with pytest.raises(_Stop):
        _run(dataset_a.main, [*argv, "--device", "cpu"])
    assert seen["torch_cfg"] == seen["jax_cfg"]
    assert seen["torch"] == seen["jax"] and len(seen["jax"]) == 2
    if case == "native_remat_default":
        assert seen["jax_cfg"]["model"]["remat"] is True
    if case == "native_remat_off":
        assert seen["jax_cfg"]["model"]["remat"] is False


@pytest.mark.parametrize("prec,tf32", [("highest", False), ("float32", False),
                                       ("high", True), ("", None)])
def test_matmul_precision_maps_to_tf32(prec, tf32, monkeypatch):
    """SPNET_MATMUL_PRECISION: 'highest' turns TF32 off for cuDNN and
    cuBLAS, 'high' on; unset leaves PyTorch's flags; the line says which
    ran.  An unknown value raises."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setenv("SPNET_MATMUL_PRECISION", prec)
    try:
        line = runtime.apply_matmul_precision()
        now = (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        assert now == (before if tf32 is None else (tf32, tf32))
        assert f"cuDNN TF32 {'on' if now[0] else 'off'}" in line
        monkeypatch.setenv("SPNET_MATMUL_PRECISION", "fastest")
        with pytest.raises(SystemExit, match="SPNET_MATMUL_PRECISION"):
            runtime.apply_matmul_precision()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------- (b)

def _exp_cfg(size=SIZE):
    return ExperimentConfig(model=ModelConfig(input_size=size))


def test_cache_hit_returns_the_stored_arrays_bitwise(tmp_path):
    cfg = _exp_cfg()
    made = synth_cache.cached_synth(6, cfg, seed=3, device="cpu",
                                    cache_dir=str(tmp_path))
    path = synth_cache.cache_path(6, 3, SIZE, "cpu",
                                  cache_dir=str(tmp_path))
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    hit, out = _run(synth_cache.cached_synth, 6, cfg, seed=3, device="cpu",
                    cache_dir=str(tmp_path))
    assert "cache hit" in out
    for ds in (made, hit):
        for k, v in (("x", ds.x), ("y", ds.y), ("rows", ds.rows),
                     ("mask", ds.row_mask)):
            assert v.dtype == stored[k].dtype
            np.testing.assert_array_equal(v, stored[k])
    assert hit.file_list == [f"synthetic://3/{i}" for i in range(6)]


def test_cache_slice_equals_the_smaller_set(tmp_path):
    """The first n frames of a larger cache of the same recipe are the
    n-frame set made directly (a frame is a function of seed and index)."""
    cfg = _exp_cfg()
    synth_cache.cached_synth(7, cfg, seed=5, device="cpu",
                             cache_dir=str(tmp_path))
    sliced, out = _run(synth_cache.cached_synth, 4, cfg, seed=5,
                       device="cpu", cache_dir=str(tmp_path))
    assert "cache slice: first 4" in out
    direct = synthetic_dataset(4, cfg.grid, seed=5, input_size=SIZE,
                               device="cpu")
    for k in ("x", "y", "rows", "row_mask"):
        np.testing.assert_array_equal(getattr(sliced, k),
                                      getattr(direct, k))
    assert sliced.file_list == direct.file_list
    # another recipe's or another seed's cache is never sliced
    assert not os.path.exists(synth_cache.cache_path(
        4, 5, SIZE, "cpu", cache_dir=str(tmp_path)))
    other, out = _run(synth_cache.cached_synth, 4, cfg, seed=6,
                      device="cpu", cache_dir=str(tmp_path))
    assert "cache" not in out


@pytest.mark.parametrize("kw", [dict(n=4992, seed=777777),
                                dict(n=40960, seed=0, batch=32),
                                dict(n=8, seed=1, blur=True),
                                dict(n=8, seed=1, resize_method="linear")])
def test_cache_key_never_equals_the_jax_scripts(kw, monkeypatch, tmp_path):
    """The JAX script's file for the same arguments is another file, and a
    JAX cache in the directory is neither hit nor sliced by the port; the
    key carries the device type."""
    monkeypatch.chdir(tmp_path)
    cfg = _exp_cfg(8)
    script = _script("dataset_a_run")
    kw = dict(kw)
    n = kw.pop("n")
    fake = lambda n, grid, **k: j_dataset.Dataset(  # noqa: E731
        x=np.zeros((n, 1, 1, 1), np.uint8), y=np.zeros((n, 1), np.float32),
        file_list=[""] * n, grid=grid, rows=np.zeros((n, 16, 6), np.float32),
        row_mask=np.zeros((n, 16), bool))
    monkeypatch.setattr(script, "synthetic_dataset", fake)
    script._cached_synth(n + 1, JExperimentConfig.from_json(cfg.to_json()),
                         **kw)
    jax_files = os.listdir("logs/synth_cache")
    assert len(jax_files) == 1
    paths = {d: synth_cache.cache_path(n, kw["seed"], 8, d, kw.get("blur"),
                                       kw.get("resize_method", "lanczos3"))
             for d in ("cpu", "cuda")}
    assert paths["cpu"] != paths["cuda"]
    jax_name = jax_files[0].replace(f"n{n + 1}_", f"n{n}_")
    assert all(os.path.basename(p) != jax_name for p in paths.values())
    seen = []
    monkeypatch.setattr(synth_cache, "synthetic_dataset",
                        lambda *a, **k: seen.append(a) or fake(
                            a[0], a[1]))
    _, out = _run(synth_cache.cached_synth, n, cfg, device="cpu", **kw)
    assert seen and "cache" not in out


# ---------------------------------------------------------------- (c)

def _edge_grids():
    """Denormalized truth and predictions (4 frames): every true object
    has 1-5 rings and a semi-minor axis of 40 px or more, so the buckets
    of 6-11 rings and of b < 40 hold no true positive; predicted rings are
    off by exactly 0.5 (correct) or 0.75 (wrong); one object is missed and
    one slot is a false positive."""
    rng = np.random.default_rng(3)
    yt = _noisy_grids(rng, 4).reshape(4, -1, 8)
    yt[..., 6] = 1.0
    live = [(f, s) for f in range(4) for s in (3, 10, 17, 40)]
    for i, (f, s) in enumerate(live):
        yt[f, s, 6] = 0.0
        yt[f, s, 3] = 40.0 + 7 * i
        yt[f, s, 7] = 1 + i % 5
    yp = yt.copy()
    for i, (f, s) in enumerate(live):
        yp[f, s, 7] = yt[f, s, 7] + (0.5 if i % 2 else -0.75)
    yp[0, 3, 6] = 1.0      # a miss
    yp[1, 55, 6] = 0.0     # a false positive
    return yt.reshape(4, -1), yp.reshape(4, -1)


@pytest.mark.parametrize("case", ["random", "edge"])
def test_breakdown_equals_the_jax_scripts_line(case, monkeypatch):
    if case == "random":
        rng = np.random.default_rng(11)
        yt = _noisy_grids(rng, 16)
        yt[:, 6::8] = np.rint(yt[:, 6::8])
        yp = yt + rng.normal(0, 0.4, yt.shape).astype(np.float32)
        yp[:, 6::8] = rng.uniform(0, 1, yp[:, 6::8].shape)
    else:
        yt, yp = _edge_grids()
    n = yt.shape[0]
    jcfg = JExperimentConfig()
    # the script denormalizes what it is handed: hand it the denormalized
    # arrays and an identity, so the 0.5 edges stay exact
    monkeypatch.setattr(j_cli_common, "load_model_and_state",
                        lambda ckpt: (jcfg, None, _state(None, None, 0)))
    monkeypatch.setattr(j_dataset, "synthetic_dataset",
                        lambda n_val, grid, **kw: j_dataset.Dataset(
                            x=np.zeros((n_val, 1, 1, 1), np.uint8), y=yt,
                            file_list=[""] * n_val, grid=grid))
    monkeypatch.setattr(j_steps, "make_predict_step", lambda model: None)
    monkeypatch.setattr(j_loop, "predict_in_batches",
                        lambda *a, **k: (yp, 1.0))
    monkeypatch.setattr(j_grid, "denormalize", lambda y, grid: y)
    monkeypatch.setattr(sys, "argv", ["eval_breakdown.py", "ck", str(n)])
    _, out = _run(_script("eval_breakdown").main)
    want = _result(out, "BREAKDOWN")
    got = json.loads(json.dumps(eval_breakdown.breakdown(yt, yp)))
    assert got == want
    if case == "edge":
        assert set(want["ring_acc_by_true_rings"]) <= {"1", "2", "3", "4",
                                                       "5"}
        assert not {"0-25", "25-40"} & set(want["ring_acc_by_b"])
        assert want["fn"] == 1 and want["fp"] == 1
        # 15 true positives (the miss was one of the 0.75 ones), the 8
        # off by exactly 0.5 counted right
        assert want["ring_acc_given_tp"] == round(100 * 8 / 15, 2)


# ---------------------------------------------------------------- (d)

def test_dataset_a_runs_end_to_end(monkeypatch, tmp_path):
    """`tools.dataset_a 2 16 1e-4 64 float32 64 MobileNetTiny` with
    SPNET_NVAL=32 on the CPU: augmentation on, the frames generated into
    the port's cache, a checkpoint, losses.dat, the evaluation's CSV and
    one result line with the JAX script's keys."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPNET_NVAL", "32")
    monkeypatch.setenv("SPNET_CKPT", "ck")
    for k in ("SPNET_LOGDIR", "SPNET_AUGMENT", "SPNET_REMAT"):
        monkeypatch.delenv(k, raising=False)
    res, out = _run(dataset_a.main, ["2", "16", "1e-4", "64", "float32",
                                     str(SIZE), "MobileNetTiny",
                                     "--device", "cpu"])
    line = _result(out, "DATASET_A_RESULT")
    assert set(line) == {"last", "last10_ring_acc", "wall_s", "final_eval"}
    assert line == json.loads(json.dumps(res, default=float))
    assert line["last"]["epoch"] == 1
    assert np.isfinite(line["last"]["train_loss"])
    for k in ("mAP", "ring_acc", "class_acc", "mean_pix_err", "fps"):
        assert np.isfinite(line["final_eval"][k]), k
    assert sorted(os.listdir("logs/synth_cache")) == [
        f"n32_s777777_i{SIZE}_torch_cpu.npz", f"n64_s0_i{SIZE}_torch_cpu.npz"]
    assert os.path.exists("ck/state.pt")
    assert os.path.exists("logs/dataset_a/losses.dat")
    assert os.path.exists("logs/dataset_a_eval/hawley_spnet.csv")
    assert "(calc_map: 32 frames in" in out


def test_dataset_a_history_matches_jax(monkeypatch, tmp_path):
    """Both scripts on the same 64 + 32 frames from the same initial
    weights (JAX's init, converted), 2 epochs of b=16 at lr_max 4e-5 (the
    recipe's default), MobileNetTiny float32 at 64^2, augmentation off
    (SPNET_AUGMENT=0) and dropout off: the last epoch's train and val
    losses within HISTORY_RTOL, the accuracies and the final evaluation's
    counts equal.  (At lr_max 1e-4 the epoch-2 train loss parted by
    3.6e-4, measured: Adam's first steps amplify float32 noise with the
    learning rate on MobileNetTiny's ill-conditioned float32 train mode,
    as tests/test_torch_parallel.py found.)"""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPNET_NVAL", "32")
    monkeypatch.setenv("SPNET_AUGMENT", "0")
    for k in ("SPNET_CKPT", "SPNET_LOGDIR", "SPNET_REMAT",
              "SPNET_MATMUL_PRECISION"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SPNET_SCAN_UNROLL", "1")
    argv = ["2", "16", "4e-5", "64", "float32", str(SIZE), "MobileNetTiny"]
    cfg = ExperimentConfig(model=_tiny_cfg())
    sets = {seed: synth_cache.cached_synth(n, cfg, seed=seed, device="cpu")
            for n, seed in ((64, 0), (32, 777777))}
    init = {}

    script = _script("dataset_a_run")
    monkeypatch.setattr(script, "_cached_synth", lambda n, c, seed, **k:
                        j_dataset.Dataset(x=sets[seed].x, y=sets[seed].y,
                                          file_list=sets[seed].file_list,
                                          grid=c.grid))
    j_train = script.train_network

    def j_train_no_dropout(c, *a, **k):
        return j_train(dataclasses.replace(c, model=dataclasses.replace(
            c.model, dropout_rate=0.0)), *a, **k)

    j_create = j_loop.create_train_state

    def j_create_kept(*a, **k):
        st = j_create(*a, **k)
        init["params"], init["stats"] = jax.tree_util.tree_map(
            np.asarray, (st.params, st.batch_stats))
        return st

    monkeypatch.setattr(script, "train_network", j_train_no_dropout)
    monkeypatch.setattr(j_loop, "create_train_state", j_create_kept)
    monkeypatch.setattr(sys, "argv", ["dataset_a_run.py", *argv])
    _, out = _run(script.main)
    want = _result(out, "DATASET_A_RESULT")

    t_train = dataset_a.train_network
    t_build = t_loop.build_model

    def t_train_no_dropout(c, *a, **k):
        return t_train(dataclasses.replace(c, model=dataclasses.replace(
            c.model, dropout_rate=0.0)), *a, **k)

    def t_build_from_jax(*a, **k):
        model = t_build(*a, **k)
        model.load_state_dict(flax_to_state_dict(init["params"],
                                                 init["stats"], model))
        return model

    monkeypatch.setattr(dataset_a, "train_network", t_train_no_dropout)
    monkeypatch.setattr(t_loop, "build_model", t_build_from_jax)
    _, out = _run(dataset_a.main, [*argv, "--device", "cpu"])
    got = _result(out, "DATASET_A_RESULT")

    assert set(got) == set(want)
    assert set(got["last"]) == set(want["last"])
    g, w = got["last"], want["last"]
    assert g["epoch"] == w["epoch"] == 1
    np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                               rtol=HISTORY_RTOL)
    for k in w["val_comps"]:
        np.testing.assert_allclose(g["val_comps"][k], w["val_comps"][k],
                                   rtol=HISTORY_RTOL, err_msg=k)
    assert g["ring_acc"] == w["ring_acc"]
    assert g["class_acc"] == w["class_acc"]
    assert g["mean_pix_err"] == pytest.approx(w["mean_pix_err"],
                                              abs=PIX_ERR_ATOL)
    assert got["last10_ring_acc"] == want["last10_ring_acc"]
    for k in COUNTS:
        assert got["final_eval"][k] == want["final_eval"][k], k
    assert got["final_eval"]["mAP"] == pytest.approx(
        want["final_eval"]["mAP"], abs=MAP_ATOL)


def test_sanity_train_runs_small(monkeypatch, tmp_path):
    """`tools.sanity_train 32 2 MobileNetTiny 2e-4 16` at 64^2 with
    SPNET_MAP=1: the JAX script's keys (first, last, wall_s, final_eval),
    first and last from epochs 1 and 2, b=32 (one step an epoch)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPNET_MAP", "1")
    monkeypatch.delenv("SPNET_CKPT", raising=False)
    res, out = _run(sanity_train.main, ["32", "2", "MobileNetTiny", "2e-4",
                                        "16", "--device", "cpu"],
                    input_size=SIZE)
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == {"first", "last", "wall_s", "final_eval"}
    assert (line["first"]["epoch"], line["last"]["epoch"]) == (0, 1)
    assert np.isfinite(line["final_eval"]["mAP"])
    assert os.path.exists("logs/sanity/losses.dat")


@pytest.mark.parametrize("tool,argv", [
    (dataset_a, []), (sanity_train, []), (eval_breakdown, ["ck"]),
    (eval_tta, ["ck"]), (movie_predict, [])])
def test_tools_need_a_card_unless_asked(tool, argv, monkeypatch):
    """Without --device or SPNET_DEVICE each tool asks for the card, and
    on a host without one it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.delenv("SPNET_DEVICE", raising=False)
    monkeypatch.setenv("SPNET_CKPT", "")
    if tool is movie_predict:
        monkeypatch.setattr(movie_predict, "find_checkpoint", lambda: "ck")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main(argv)
    monkeypatch.setenv("SPNET_DEVICE", "cpu")
    assert runtime.tool_device() == torch.device("cpu")
    assert runtime.tool_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------- (e)

def _val_npz(path, x, y):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = x.shape[0]
    np.savez(path, x=x, y=y, rows=np.zeros((n, 16, 6), np.float32),
             mask=np.zeros((n, 16), bool))


def _state(params, stats, step):
    return collections.namedtuple("State", "params batch_stats step")(
        params, stats, step)


def test_eval_tta_matches_the_jax_script(tiny_weights, monkeypatch,
                                         tmp_path):
    """Both scripts on the same 8 frames at 64^2 with the same weights:
    each flipped view's statistics, the plain and the TTA evaluation's
    counts equal, pixel errors within PIX_ERR_ATOL and mAP within
    MAP_ATOL."""
    jm, params, stats, model = tiny_weights
    cfg = ExperimentConfig(model=_tiny_cfg())
    jcfg = JExperimentConfig.from_json(cfg.to_json())
    rng = np.random.default_rng(21)
    x = rng.integers(0, 256, (8, SIZE, SIZE, 1), dtype=np.uint8)
    y = (_noisy_grids(rng, 8) - cfg.grid.means) / cfg.grid.ranges
    y = np.asarray(y, np.float32)
    y[:, 6::8] = np.rint(np.clip(y[:, 6::8], 0, 1))
    for d in ("jax", "pt"):
        (tmp_path / d).mkdir()
    _val_npz(str(tmp_path / "jax" / f"logs/synth_cache/n4992_s777777_i{SIZE}"
                 "_v2.npz"), x, y)
    _val_npz(os.path.join(str(tmp_path / "pt"), synth_cache.cache_path(
        4992, 777777, SIZE, "cpu")), x, y)
    monkeypatch.delenv("SPNET_TTA_PER_VIEW", raising=False)

    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(j_cli_common, "load_model_and_state",
                        lambda ckpt: (jcfg, jm, _state(params, stats, 5)))
    monkeypatch.setattr(sys, "argv", ["eval_tta.py", "ck"])
    _, out = _run(_script("eval_tta").main)
    want = _result(out, "EVAL_TTA_RESULT")

    monkeypatch.chdir(tmp_path / "pt")
    save_checkpoint("ck", model.state_dict(), cfg, step=5)
    _, out = _run(eval_tta.main, ["ck", "--device", "cpu"])
    got = _result(out, "EVAL_TTA_RESULT")
    assert "step=5" in out

    assert set(got) == set(want)
    assert [got[k] for k in ("ckpt", "source", "modes")] == \
        [want[k] for k in ("ckpt", "source", "modes")]
    assert set(got["per_view"]) == set(want["per_view"]) == {"h", "v", "hv"}
    for mode, w in want["per_view"].items():
        g = got["per_view"][mode]
        for k in ("ring_acc", "class_acc", "fp", "fn"):
            assert g[k] == w[k], (mode, k)
        assert g["mean_pix_err"] == pytest.approx(w["mean_pix_err"],
                                                  abs=PIX_ERR_ATOL)
    for run in ("plain", "tta"):
        for k in COUNTS:
            assert got[run][k] == want[run][k], (run, k)
        assert got[run]["mAP"] == pytest.approx(want[run]["mAP"],
                                                abs=MAP_ATOL)
        assert got[run]["mean_pix_err"] == pytest.approx(
            want[run]["mean_pix_err"], abs=PIX_ERR_ATOL)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_movie_predict_matches_the_jax_script(tiny_weights, monkeypatch,
                                              tmp_path):
    """Both scripts over the same 8 native 512x384 .bmp frames at b=8 with
    the same weights (64^2 input): the same files, the same CSV rows
    (names equal, numbers within OUTPUT_ATOL of their scale) and 8
    overlays each."""
    jm, params, stats, model = tiny_weights
    cfg = ExperimentConfig(model=_tiny_cfg())
    jcfg = JExperimentConfig.from_json(cfg.to_json())
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (8, 384, 512), dtype=np.uint8)
    for d in ("jax", "pt"):
        fd = tmp_path / d / "logs" / "movie_frames"
        fd.mkdir(parents=True)
        for i, f in enumerate(frames):
            Image.fromarray(f, mode="L").save(fd / f"frame_{i:06d}.bmp")
    (tmp_path / "jax" / "logs" / "dataset_a_ckpt" / "state").mkdir(
        parents=True)

    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(j_cli_common, "load_model_and_state",
                        lambda ckpt: (jcfg, jm, _state(params, stats, 5)))
    monkeypatch.setattr(sys, "argv", ["movie_predict.py", "8", "8"])
    _, out = _run(_script("movie_predict").main)
    want = _result(out, "MOVIE_RESULT")

    monkeypatch.chdir(tmp_path / "pt")
    monkeypatch.setenv("SPNET_CKPT", "ck")
    save_checkpoint("ck", model.state_dict(), cfg, step=5)
    _, out = _run(movie_predict.main, ["8", "8", "--device", "cpu"])
    got = _result(out, "MOVIE_RESULT")

    for k in ("frames", "bmp", "overlays"):
        assert got[k] == want[k], k
    assert got["overlays"] == 8 and got["ckpt"] == "ck"
    rows_j = _csv_rows(tmp_path / "jax" / want["csv"])
    rows_t = _csv_rows(tmp_path / "pt" / got["csv"])
    assert len(rows_t) == len(rows_j) > 0
    num_j = [[float(v) for v in r if _is_num(v)] for r in rows_j]
    num_t = [[float(v) for v in r if _is_num(v)] for r in rows_t]
    assert [[v for v in r if not _is_num(v)] for r in rows_t] == \
        [[v for v in r if not _is_num(v)] for r in rows_j]
    scale = max(abs(v) for r in num_j for v in r)
    for a, b in zip(num_t, num_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=OUTPUT_ATOL * scale)


def _is_num(v):
    try:
        float(v)
        return True
    except ValueError:
        return False
