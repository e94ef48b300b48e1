"""The port's benchmarks (`spnet_tpu_torch/tools/bench.py`, the `bench`
command, `tools/bench_infer.py`) and `eval/metrics.py::precision`, on the
CPU: the training benchmark run small, its two epochs against the JAX
package's epoch program over the same index matrices, the inference
benchmark's two modes against `predict_in_batches`, both entry points
refusing to run without a card, and `precision` against JAX's."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.config import GridSpec as JGridSpec
from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.eval import metrics as jmetrics
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.config import ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.eval import metrics as tmetrics
from spnet_tpu_torch.models.layers import BatchNorm
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.tools import bench, bench_infer, bench_native
from spnet_tpu_torch.train.loop import predict_in_batches
from spnet_tpu_torch.train.steps import make_predict_step
from test_torch_heads import _labels
from test_torch_metrics import _predictions

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
KEYS = ("metric", "value", "unit", "vs_baseline")
#: the two packages' per-step losses of the benchmark's two epochs,
#: MobileNetTiny float32 at 64^2, whose train mode is ill-conditioned in
#: float32 (tests/test_torch_heads.py), as in
#: test_torch_mobilenet.py::test_mobilenet_tiny_train_steps_match_jax
#: (measured: 6.6e-6 and 7.7e-6 relative; one batch's loss differs from
#: another's by 1-7 %)
EPOCH_LOSS_RTOL = 1e-4


def test_bench_runs_small_on_the_cpu():
    """The training benchmark end to end at a toy size (synthetic frames,
    MobileNetTiny at 64^2, 2 x 2 steps of b=2): the JAX benchmark's four
    keys, a finite positive rate, the card named in the unit (the CPU
    here)."""
    out = bench.main(batch_size=2, steps_per_epoch=2, n_data=4,
                     device="cpu", backbone="MobileNetTiny",
                     input_size=SIZE)
    assert tuple(out) == KEYS
    assert out["metric"] == "train_images_per_sec_per_chip"
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / 126.6, 3)
    assert out["unit"].startswith("img/s per cpu (MobileNetTiny 64x64 b2")


def test_bench_honours_the_batch_size_variable(monkeypatch):
    """SPNET_BENCH_BS changes the batch and keeps the images timed."""
    seen = {}

    def fake_epochs(model, mc, x_all, y_all, b, steps, augment):
        seen.update(b=b, steps=steps, n=x_all.shape[0], augment=augment,
                    dtype=mc.compute_dtype)
        losses = torch.zeros(steps)
        return losses, losses, 1.0

    monkeypatch.setattr(bench, "train_epochs", fake_epochs)
    monkeypatch.setenv("SPNET_BENCH_BS", "3")
    monkeypatch.setenv("SPNET_BENCH_AUGMENT", "0")
    monkeypatch.setenv("SPNET_BENCH_DTYPE", "float32")
    out = bench.main(batch_size=2, steps_per_epoch=3, n_data=7,
                     device="cpu", backbone="MobileNetTiny",
                     input_size=SIZE)
    assert seen == dict(b=3, steps=2, n=6, augment=False, dtype="float32")
    assert out["value"] == 6.0 and "augmentation off" in out["unit"]


def test_bench_epochs_match_jax(monkeypatch):
    """The benchmark's two epochs (`bench.train_epochs`: a fresh train state
    under onecycle(4e-5, 100000), index matrices of seeds 1 and 2) against
    JAX's `make_train_step(indexed='epoch')` program over the same
    matrices, from the same weights (JAX's init, converted): MobileNetTiny
    float32 at 64^2, dropout 0, augmentation off, 8 frames, b=4, 3 steps
    an epoch.  Every step's loss within EPOCH_LOSS_RTOL."""
    cfg = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                      compute_dtype="float32", dropout_rate=0.0)
    n, b, steps = 8, 4, 3
    rng = np.random.default_rng(5)
    x_all = rng.integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)
    y_all = _labels(rng, n)
    monkeypatch.setenv("SPNET_SCAN_UNROLL", "1")
    jm = jbuild(JModelConfig(**dataclasses.asdict(cfg)))
    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((b, SIZE, SIZE, 1)),
                             j_schedule(bench.LR_MAX, bench.SCHEDULE_STEPS),
                             adam_variant="optax")
    init = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     j_state.params),
                              jax.tree_util.tree_map(np.asarray,
                                                     j_state.batch_stats),
                              build_model(cfg, device="cpu"))
    j_step = j_make_train_step(jm, JLossWeights(), "same", l2_reg=1e-4,
                               augment=False, indexed="epoch",
                               pregather=False)
    want = []
    for seed in (bench.WARMUP_SEED, bench.TIMED_SEED):
        idx = bench.index_matrix(seed, steps, n, b)
        assert idx.shape == (steps, b) and idx.dtype == np.int64
        j_state, losses = j_step(j_state, jnp.asarray(x_all),
                                 jnp.asarray(y_all),
                                 jnp.asarray(idx.astype(np.int32)),
                                 jax.random.key(seed))
        want.append(np.asarray(losses))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(init)
    warm, timed, seconds = bench.train_epochs(
        model, cfg, torch.from_numpy(x_all), torch.from_numpy(y_all), b,
        steps, augment=False)
    assert seconds > 0
    np.testing.assert_allclose(warm.numpy(), want[0], rtol=EPOCH_LOSS_RTOL)
    np.testing.assert_allclose(timed.numpy(), want[1], rtol=EPOCH_LOSS_RTOL)
    # the two epochs train on different minibatches
    assert not np.allclose(want[0], want[1], rtol=1e-3)


def test_bench_infer_modes_are_bitwise_predict_in_batches():
    """The inference benchmark's pipelined batches and its sweep (eager on
    the CPU; a CUDA graph on the card) give `predict_in_batches`'s outputs
    bit for bit on the whole batches, 10 frames at b=4 (the sweep takes the
    2 whole batches; `predict_in_batches` pads the last); seeded BN running
    statistics, so that the outputs are not all near 0; the JSON dict
    carries both rates."""
    model, x, mc = bench_infer.setup(4, 10, device="cpu",
                                     backbone="MobileNetTiny",
                                     input_size=SIZE)
    assert x.shape == (10, SIZE, SIZE, 1) and x.dtype == torch.uint8
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.01, 0.05, generator=gen)
    predict = make_predict_step(model)
    y1, fps1 = bench_infer.pipelined(predict, x, 4)
    y2, fps2 = bench_infer.captured_sweep(predict, x, 4)
    ref, _ = predict_in_batches(predict, x, 4, "cpu", verbose=False)
    assert y1.shape == (10, 576) and y2.shape == (8, 576)
    assert y1.abs().max() > 0.1
    assert torch.equal(y1[:8], torch.from_numpy(ref[:8]))
    assert torch.equal(y2, y1[:8])
    out = bench_infer.result(4, fps1, fps2, x.device, mc)
    assert tuple(out) == KEYS and out["metric"] == "inference_fps_per_chip"
    assert out["value"] == round(max(fps1, fps2), 1)
    assert f"pipelined {round(fps1, 1)}, captured sweep {round(fps2, 1)}" \
        in out["unit"]


def test_bench_native_runs_small_on_the_cpu(capsys):
    """`tools/bench_native.py` at a toy size (MobileNetTiny, native
    384x512 frames, 2 turns of a 1-step b=2 bench and bench_infer at b=2
    over 5 frames): one JSON line a turn and benchmark, each a benchmark's
    four keys at 512x384, then the median, min and max of every rate."""
    summary = bench_native.run(2, device="cpu", backbone="MobileNetTiny",
                               batch_size=2, steps_per_epoch=1, n_data=4,
                               n_frames=5, infer_batches=(2,))
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert len(lines) == 5 and lines[-1] == {"turns": 2, "native": summary}
    for r in lines[:-1]:
        assert set(KEYS) <= set(r) and "512x384" in r["unit"]
    assert [r["metric"] for r in lines[:2]] == [
        "train_images_per_sec_per_chip", "inference_fps_per_chip"]
    assert set(summary) == {"train", "pipelined_b2", "sweep_b2"}
    rates = summary["train"]
    assert 0 < rates["min"] <= rates["median"] <= rates["max"]
    assert rates["min"] == min(lines[0]["value"], lines[2]["value"])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the benchmarks would run")
@pytest.mark.parametrize("cmd", [["-m", "spnet_tpu_torch", "bench"],
                                 ["-m", "spnet_tpu_torch.tools.bench_infer",
                                  "16"]])
def test_benchmarks_need_a_card(cmd):
    """Both entry points default to the card and refuse to run without
    one: no CPU rate is ever printed under their metric names."""
    res = subprocess.run([sys.executable, *cmd], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr + res.stdout
    assert "per_chip" not in res.stdout


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_precision_matches_jax(thresh):
    """`precision` (slot IoUs, then one threshold) equals JAX's: precision,
    tp, fp and fn, with the grid given and with the default one."""
    yp, yt, grid = _predictions(6)
    jgrid = JGridSpec(**dataclasses.asdict(grid))
    got = tmetrics.precision(yp, yt, thresh, grid)
    assert got == jmetrics.precision(yp, yt, thresh, jgrid)
    assert tmetrics.precision(yp, yt, thresh) == \
        jmetrics.precision(yp, yt, thresh)
    prec, tp, fp, fn = got
    assert tp > 0 and fn > 0 and fp == 0 and 0 < prec < 1
