"""The port's reference-generator tools (`spnet_tpu_torch/tools/`:
refgen_dataset, refgen_run, and the `refgen` source of eval_breakdown and
eval_tta) against the JAX package's scripts of the same names, on the CPU
at a small size.  Each JAX script is imported by its path and driven with
its own argv, in a working directory under tmp_path (the scripts read and
write relative `logs/` paths).  The frames are drawn with this host's cv2,
so the port's pixels are held bitwise to the script's; the pool bitwise to
the serial drawing."""

import collections
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import spnet_tpu.cli.common as j_cli_common
import spnet_tpu.train.loop as j_loop
from spnet_tpu.config import ExperimentConfig as JExperimentConfig
from spnet_tpu.config import GridSpec as JGridSpec
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.io.checkpoint import save_checkpoint
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.tools import eval_breakdown, eval_tta, refgen_dataset, \
    refgen_run
from test_torch_backbones import fill

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
SHARD = 16
JAX_DIR = "logs/refgen_cache"  # the JAX scripts' shard directory
#: mean pixel error and mAP of the same predictions from two packages
#: (tests/test_torch_validation.py)
PIX_ERR_ATOL, MAP_ATOL = 1e-3, 1e-6
#: a mean ring error rounded to 4 decimals, of predictions within 1e-4 of
#: their scale (the model parity tolerance)
RING_ERR_ATOL = 2e-4
COUNTS = ("ring_truecounts", "ring_miscounts", "total_obj", "false_obj_pos",
          "false_obj_neg", "true_obj_pos", "true_obj_neg")
RESULT_KEYS = {"last", "last10_ring_acc", "wall_s", "final_eval"}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw):
    """(fn's return, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _result(text, tag):
    lines = [l for l in text.splitlines() if l.startswith(tag + " ")]
    assert len(lines) == 1, text[-2000:]
    return json.loads(lines[0][len(tag) + 1:])


def _overflow_line(text):
    lines = [l for l in text.splitlines() if "grid-slot overflow" in l]
    assert len(lines) == 1, text[-2000:]
    return lines[0]


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _copy_shards(src, dst):
    os.makedirs(dst, exist_ok=True)
    for f in sorted(os.listdir(src)):
        shutil.copy(os.path.join(src, f), os.path.join(dst, f))


@pytest.fixture(scope="module")
def port_shards(tmp_path_factory):
    """48 frames at 64^2 in 3 shards of 16, drawn by the port."""
    d = str(tmp_path_factory.mktemp("port_shards"))
    saved = refgen_dataset.SHARD
    refgen_dataset.SHARD = SHARD
    try:
        _run(refgen_dataset.write_shards, 48, SIZE, 0, None, cache_dir=d)
    finally:
        refgen_dataset.SHARD = saved
    return d


# ---------------------------------------------------------------- frames

@pytest.mark.parametrize("seed,idx", [(0, 0), (0, 1), (3, 17), (1, 45951)])
def test_render_frame_is_the_scripts(seed, idx):
    """One native frame and its label rows, bitwise the script's."""
    script = _script("refgen_dataset")
    img, rows = refgen_dataset.render_frame(seed, idx)
    want_img, want_rows = script.render_frame(seed, idx)
    assert img.dtype == np.uint8 and img.shape == (384, 512)
    np.testing.assert_array_equal(img, want_img)
    assert rows == want_rows and 1 <= len(rows) <= 7


@pytest.mark.parametrize("size", [SIZE, 0])
def test_gen_shard_is_the_scripts(size):
    """x, rows and mask of a shard, bitwise the script's, at 64^2 (PIL
    LANCZOS) and at size 0 (native 512x384, no resize)."""
    script = _script("refgen_dataset")
    got = refgen_dataset.gen_shard(0, 5, 6, size)
    want = script.gen_shard(0, 5, 6, size)
    assert got[0].shape == ((6, SIZE, SIZE, 1) if size else
                            (6, 384, 512, 1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pool_is_bitwise_serial():
    """A shard over a pool of 2 spawned workers, bitwise the serial one."""
    serial = refgen_dataset.gen_shard(2, 40, 12, SIZE)
    with refgen_dataset.make_pool(2) as pool:
        pooled = refgen_dataset.gen_shard(2, 40, 12, SIZE, pool)
    for a, b in zip(serial, pooled):
        np.testing.assert_array_equal(a, b)


def test_main_writes_the_scripts_shards_and_resumes(monkeypatch, tmp_path):
    """`main 40 64 0` with SHARD 16: three shards bitwise the script's
    (the port's also record the versions), the progress lines and
    REFGEN_DONE; a rerun skips all three and draws nothing; a partial set
    is completed."""
    monkeypatch.chdir(tmp_path)
    script = _script("refgen_dataset")
    monkeypatch.setattr(script, "SHARD", SHARD)
    monkeypatch.setattr(refgen_dataset, "SHARD", SHARD)
    monkeypatch.setattr(sys, "argv", ["refgen_dataset.py", "40", "64", "0"])
    _, want = _run(script.main)
    out, text = _run(refgen_dataset.main, ["40", "64", "0"])
    assert out["frames"] == 40 and out["workers"] == os.cpu_count()
    assert "REFGEN_DONE" in text and "REFGEN_DONE" in want
    names = sorted(os.listdir(JAX_DIR))
    assert names == sorted(os.listdir(refgen_dataset.CACHE_DIR)) == [
        f"refgen_s0_i64_{s:04d}.npz" for s in range(3)]
    for n in names:
        j = _arrays(os.path.join(JAX_DIR, n))
        t = _arrays(os.path.join(refgen_dataset.CACHE_DIR, n))
        assert set(t) == set(j) | {"versions"}
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
        assert list(t["versions"]) == list(refgen_dataset.versions())
    progress = [l.split(" (")[0] for l in text.splitlines()
                if l.startswith("shard ")]
    assert progress == [l.split(" (")[0] for l in want.splitlines()
                        if l.startswith("shard ")]
    assert progress == [f"shard {s}/3 done" for s in range(3)]
    again, text = _run(refgen_dataset.main, ["40", "64", "0"])
    assert again["frames"] == 0 and text.count("exists, skip") == 3
    os.remove(refgen_dataset.shard_path(0, SIZE, 1))
    again, text = _run(refgen_dataset.main, ["40", "64", "0"])
    assert again["frames"] == SHARD and text.count("exists, skip") == 2
    t = _arrays(refgen_dataset.shard_path(0, SIZE, 1))
    np.testing.assert_array_equal(
        t["x"], _arrays(os.path.join(JAX_DIR, names[1]))["x"])


@pytest.mark.parametrize("versions", ["altered", "unrecorded"])
def test_shard_of_other_versions_is_refused(versions, port_shards,
                                            tmp_path):
    """A rerun over a shard drawn with another cv2 (or one that records no
    versions, as the JAX script's) refuses it, naming both sets."""
    d = str(tmp_path / "cache")
    _copy_shards(port_shards, d)
    path = refgen_dataset.shard_path(0, SIZE, 0, d)
    z = _arrays(path)
    if versions == "altered":
        z["versions"] = np.array(["cv2=0.0.0", *z["versions"][1:]])
    else:
        del z["versions"]
    np.savez(path, **z)
    with pytest.raises(SystemExit) as e:
        _run(refgen_dataset.write_shards, 48, SIZE, 0, None, cache_dir=d)
    msg = str(e.value)
    assert f"cv2={refgen_dataset.cv2.__version__}" in msg
    assert ("cv2=0.0.0" if versions == "altered" else "unrecorded") in msg


# ---------------------------------------------------------------- loading

def _crowded(path):
    """The first frame's first three rows moved into one grid cell: that
    frame overflows the cell's two slots."""
    z = _arrays(path)
    z["rows"][0, :3] = [[100, 100, 30, 20, 10, 2], [101, 100, 25, 15, 20, 3],
                        [100, 101, 40, 30, 30, 4]]
    z["mask"][0, :3] = True
    np.savez(path, **z)


@pytest.mark.parametrize("maker", ["port", "jax", "crowded"])
def test_load_refgen_is_the_scripts(maker, port_shards, monkeypatch,
                                    tmp_path):
    """The same shards in both packages' directories (drawn by the port,
    by the JAX script, or the port's with one crowded frame): 24 + 8
    frames read from the first two of three shards, x, rows and mask
    bitwise, y within 1e-6, the same file names and overflow line."""
    monkeypatch.chdir(tmp_path)
    script = _script("refgen_run")
    if maker == "jax":
        gen = _script("refgen_dataset")
        monkeypatch.setattr(gen, "SHARD", SHARD)
        monkeypatch.setattr(sys, "argv", ["refgen_dataset.py", "48", "64"])
        _run(gen.main)
    else:
        _copy_shards(port_shards, JAX_DIR)
        if maker == "crowded":
            _crowded(os.path.join(JAX_DIR, "refgen_s0_i64_0000.npz"))
    _copy_shards(JAX_DIR, refgen_run.CACHE_DIR)
    (want_tr, want_va), want = _run(script.load_refgen, 24, 8, JGridSpec(),
                                    size=SIZE)
    (tr, va), got = _run(refgen_run.load_refgen, 24, 8, GridSpec(),
                         size=SIZE)
    assert _overflow_line(got) == _overflow_line(want)
    assert _overflow_line(got).strip().startswith(
        "grid-slot overflow frames: 1/32" if maker == "crowded" else
        "grid-slot overflow frames: 0/32")
    for g, w in ((tr, want_tr), (va, want_va)):
        for k in ("x", "rows", "row_mask"):
            assert getattr(g, k).dtype == getattr(w, k).dtype
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
        np.testing.assert_allclose(g.y, w.y, rtol=0, atol=1e-6)
        assert g.file_list == w.file_list
    assert tr.x.shape == (24, SIZE, SIZE, 1) and va.file_list[0] == \
        "refgen://val/0"


@pytest.mark.parametrize("case", ["no_shards", "too_few"])
def test_load_refgen_errors(case, port_shards, monkeypatch, tmp_path):
    """No shard: FileNotFoundError naming the port's directory and its
    generator; fewer frames than asked: the script's ValueError.  A
    leftover `.tmp.npz` is never read."""
    monkeypatch.chdir(tmp_path)
    if case == "no_shards":
        os.makedirs(refgen_run.CACHE_DIR)
        open(os.path.join(refgen_run.CACHE_DIR,
                          "refgen_s0_i64_0000.npz.tmp.npz"), "w").close()
        with pytest.raises(FileNotFoundError,
                           match="refgen_cache_torch.*tools.refgen_dataset"):
            refgen_run.load_refgen(24, 8, GridSpec(), size=SIZE)
    else:
        _copy_shards(port_shards, refgen_run.CACHE_DIR)
        with pytest.raises(ValueError, match="only 48 refgen frames.*"
                                             "need 60"):
            refgen_run.load_refgen(50, 10, GridSpec(), size=SIZE)


# ---------------------------------------------------------------- the run

CONFIG_CASES = {
    "defaults": ([], {}),
    "sweep25_bf16": (["25", "32", "1e-4", "bfloat16", "331"], {}),
    "native_remat_default": (["3", "8", "2e-4", "float32", "0"], {}),
    "native_remat_off_mixed": (["3", "8", "2e-4", "float32", "0"],
                               {"SPNET_REMAT": "0",
                                "SPNET_BACKBONE_DTYPE": "bfloat16"}),
    "remat_on_96": (["2", "4", "3e-5", "float32", "96"],
                    {"SPNET_REMAT": "1"}),
}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_refgen_run_builds_the_scripts_config(case, monkeypatch):
    """The same argv and environment give the same experiment.json as
    `scripts/refgen_run.py`, and the same load (frames, size)."""
    argv, env = CONFIG_CASES[case]
    for k in ("SPNET_REMAT", "SPNET_BACKBONE_DTYPE", "SPNET_CKPT",
              "SPNET_LOGDIR", "SPNET_MATMUL_PRECISION"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}

    def catcher(tag):
        def load(n_train, n_val, grid, size=331, seed=0):
            seen[tag] = (n_train, n_val, size, seed)
            x = np.zeros((1, 1, 1, 1), np.uint8)
            return (collections.namedtuple("Set", "x")(x),) * 2
        return load

    def stop(tag):
        def train(cfg, *a, **kw):
            seen[tag + "_cfg"] = json.loads(cfg.to_json())
            seen[tag + "_kw"] = {k: kw[k] for k in ("render_overlays",
                                                    "device_data")}
            raise _Stop
        return train

    script = _script("refgen_run")
    monkeypatch.setattr(script, "load_refgen", catcher("jax"))
    monkeypatch.setattr(j_loop, "train_network", stop("jax"))
    monkeypatch.setattr(sys, "argv", ["refgen_run.py", *argv])
    with pytest.raises(_Stop):
        _run(script.main)
    monkeypatch.setattr(refgen_run, "load_refgen", catcher("torch"))
    monkeypatch.setattr(refgen_run, "train_network", stop("torch"))
    with pytest.raises(_Stop):
        _run(refgen_run.main, [*argv, "--device", "cpu"])
    assert seen["torch_cfg"] == seen["jax_cfg"]
    assert seen["torch"] == seen["jax"]
    assert seen["torch_kw"] == seen["jax_kw"] == {"render_overlays": False,
                                                  "device_data": True}
    assert seen["jax"][:2] == (refgen_run.N_TRAIN, refgen_run.N_VAL)
    remat = seen["jax_cfg"]["model"]["remat"]
    assert remat is (case in ("native_remat_default", "remat_on_96"))


def test_refgen_run_end_to_end_against_the_script(port_shards, monkeypatch,
                                                  tmp_path):
    """`refgen_run 1 16 1e-4 float32 64` on 32 + 16 refgen frames, the
    port on the CPU and the JAX script (its hard-coded 40,960 + 4,992 cut
    to the same 32 + 16): the REFGEN_RESULT keys, the history entry's and
    the final evaluation's keys equal; the same overflow line and true
    objects; the checkpoint written under SPNET_CKPT."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPNET_SCAN_UNROLL", "1")
    monkeypatch.setenv("SPNET_CKPT", "ck")
    for k in ("SPNET_REMAT", "SPNET_BACKBONE_DTYPE", "SPNET_LOGDIR",
              "SPNET_MATMUL_PRECISION"):
        monkeypatch.delenv(k, raising=False)
    _copy_shards(port_shards, JAX_DIR)
    _copy_shards(port_shards, refgen_run.CACHE_DIR)
    argv = ["1", "16", "1e-4", "float32", str(SIZE)]

    script = _script("refgen_run")
    load = script.load_refgen
    monkeypatch.setattr(script, "load_refgen",
                        lambda n_train, n_val, grid, size: load(
                            32, 16, grid, size=size))
    monkeypatch.setattr(sys, "argv", ["refgen_run.py", *argv])
    monkeypatch.setenv("SPNET_CKPT", "ck_jax")
    _, text = _run(script.main)
    want, want_over = _result(text, "REFGEN_RESULT"), _overflow_line(text)

    monkeypatch.setenv("SPNET_CKPT", "ck")
    monkeypatch.setattr(refgen_run, "N_TRAIN", 32)
    monkeypatch.setattr(refgen_run, "N_VAL", 16)
    out, text = _run(refgen_run.main, [*argv, "--device", "cpu"])
    got = _result(text, "REFGEN_RESULT")
    assert set(got) == set(want) == RESULT_KEYS
    assert set(got["last"]) == set(want["last"])
    assert set(got["final_eval"]) >= set(want["final_eval"])
    assert got["last"]["epoch"] == want["last"]["epoch"] == 0
    assert got["final_eval"]["total_obj"] == want["final_eval"]["total_obj"]
    assert _overflow_line(text) == want_over
    assert all(np.isfinite(got["final_eval"][k])
               for k in ("ring_acc", "mAP", "mean_pix_err"))
    assert [l for l in text.splitlines() if l.startswith("[stage]")]
    assert os.path.exists("ck/experiment.json")
    assert os.path.exists("logs/refgen_run/losses.dat")
    assert got == json.loads(json.dumps(out, default=float))


def test_refgen_run_needs_a_card_unless_asked(monkeypatch):
    """Without --device or SPNET_DEVICE the run asks for the card, and on
    a host without one it raises before reading any shard."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.delenv("SPNET_DEVICE", raising=False)
    monkeypatch.setattr(refgen_run, "load_refgen", None)  # never reached
    with pytest.raises(SystemExit, match="CUDA is not available"):
        refgen_run.main([])


# ---------------------------------------------------------------- eval tools

@pytest.fixture(scope="module")
def tiny_ckpt():
    """JAX's MobileNetTiny-64 float32 (seeded values, BN statistics
    included) and the port's model holding the same weights."""
    cfg = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                      compute_dtype="float32")
    jm = jbuild(JModelConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        np.zeros((1, SIZE, SIZE, 1), np.float32), train=False))
    rng = np.random.default_rng(15)
    params = fill(shapes["params"], rng)
    stats = fill(shapes["batch_stats"], rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    exp = ExperimentConfig(model=cfg)
    return exp, JExperimentConfig.from_json(exp.to_json()), jm, params, \
        stats, model


def _state(params, stats, step):
    return collections.namedtuple("State", "params batch_stats step")(
        params, stats, step)


def _eval_dirs(tmp_path, monkeypatch, tiny, shards):
    """jax/ and pt/ working directories holding the same shards, the JAX
    loader patched to the port's split and the port's checkpoint in pt/."""
    exp, jexp, jm, params, stats, model = tiny
    for d in ("jax", "pt"):
        _copy_shards(shards, str(tmp_path / d / JAX_DIR))
        _copy_shards(shards, str(tmp_path / d / refgen_run.CACHE_DIR))
    j_run = importlib.import_module("scripts.refgen_run")
    load = j_run.load_refgen
    monkeypatch.setattr(j_run, "load_refgen",
                        lambda n_train, n_val, grid, size: load(
                            refgen_run.N_TRAIN, refgen_run.N_VAL, grid,
                            size=size))
    monkeypatch.setattr(j_cli_common, "load_model_and_state",
                        lambda ckpt: (jexp, jm, _state(params, stats, 5)))
    save_checkpoint(str(tmp_path / "pt" / "ck"), model.state_dict(), exp,
                    step=5)


def test_eval_breakdown_refgen_is_the_scripts(tiny_ckpt, monkeypatch,
                                              tmp_path):
    """`eval_breakdown <ckpt> refgen` on the same weights and the refgen
    val split: the script's BREAKDOWN line (its reshape needs 4,992 val
    frames: the split is the 16 drawn frames repeated into one shard),
    the mean ring error within RING_ERR_ATOL."""
    monkeypatch.syspath_prepend(ROOT)
    base = refgen_dataset.gen_shard(0, 0, 16, SIZE)
    reps = 4992 // 16
    d = str(tmp_path / "shards")
    os.makedirs(d)
    np.savez(os.path.join(d, "refgen_s0_i64_0000.npz"),
             x=np.tile(base[0], (reps, 1, 1, 1)),
             rows=np.tile(base[1], (reps, 1, 1)),
             mask=np.tile(base[2], (reps, 1)),
             versions=refgen_dataset.versions())
    monkeypatch.setattr(refgen_run, "N_TRAIN", 0)
    monkeypatch.setattr(refgen_run, "N_VAL", 4992)
    _eval_dirs(tmp_path, monkeypatch, tiny_ckpt, d)

    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["eval_breakdown.py", "ck", "refgen"])
    _, text = _run(_script("eval_breakdown").main)
    want = _result(text, "BREAKDOWN")
    monkeypatch.chdir(tmp_path / "pt")
    got, text = _run(eval_breakdown.main, ["ck", "refgen", "--device",
                                           "cpu"])
    got = json.loads(json.dumps(got, default=float))
    assert _result(text, "BREAKDOWN") == got
    assert got["n_true"] == want["n_true"] > 0
    assert got["mean_ring_err_tp"] == pytest.approx(
        want["mean_ring_err_tp"], abs=RING_ERR_ATOL)
    del got["mean_ring_err_tp"], want["mean_ring_err_tp"]
    assert got == want


def test_eval_tta_refgen_is_the_scripts(tiny_ckpt, port_shards, monkeypatch,
                                        tmp_path):
    """`eval_tta <ckpt> refgen h,v,hv` on the same weights and the 16
    refgen val frames after 32 train frames: each flipped view's
    statistics and both evaluations' counts equal, pixel errors within
    PIX_ERR_ATOL and mAP within MAP_ATOL."""
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.delenv("SPNET_TTA_PER_VIEW", raising=False)
    monkeypatch.setattr(refgen_run, "N_TRAIN", 32)
    monkeypatch.setattr(refgen_run, "N_VAL", 16)
    _eval_dirs(tmp_path, monkeypatch, tiny_ckpt, port_shards)

    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["eval_tta.py", "ck", "refgen"])
    _, text = _run(_script("eval_tta").main)
    want = _result(text, "EVAL_TTA_RESULT")
    monkeypatch.chdir(tmp_path / "pt")
    _, text = _run(eval_tta.main, ["ck", "refgen", "--device", "cpu"])
    got = _result(text, "EVAL_TTA_RESULT")
    assert "val set: (16, 64, 64, 1) from refgen" in text
    assert [got[k] for k in ("source", "modes")] == \
        [want[k] for k in ("source", "modes")] == ["refgen", "h,v,hv"]
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


def test_eval_tta_refuses_an_unknown_source():
    with pytest.raises(SystemExit, match="'synth' or 'refgen'"):
        eval_tta.main(["ck", "movies", "--device", "cpu"])
