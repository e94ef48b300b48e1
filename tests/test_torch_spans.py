"""The port's spans (`spnet_tpu_torch/utils/profiling.py::span`) on the
CPU: under `torch.profiler` the predict path's phases, the separable conv
layers and the epoch form's phases export as `cpu_op` events where the
work happens; without a profiler a span is one shared no-op; and the
training loop reports the epoch form's captures."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.grid import normalize
from spnet_tpu_torch.models.layers import SeparableConvBN
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train import loop
from spnet_tpu_torch.train import steps as program_steps
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.utils.profiling import span

torch.set_num_threads(2)
SIZE = 32
TINY = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                   compute_dtype="float32")
PHASES = ("spnet.predict.warmup", "spnet.predict.copy_in",
          "spnet.predict.forward", "spnet.predict.copy_out")


def _traced(work, tmp_path):
    """work()'s result and the `cpu_op` and `user_annotation` events of
    its chrome trace, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = work()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, sorted((e for e in events if e.get("cat") in (
        "cpu_op", "user_annotation") and "dur" in e), key=lambda e: e["ts"])


def _named(events, name, cat="cpu_op"):
    return [e for e in events if e["name"] == name and e["cat"] == cat]


def _inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] \
        + outer["dur"]


@pytest.fixture(scope="module")
def predictor():
    """A small model's predict step (MobileNetTiny: its separable convs
    run the plain path) and 40 uint8 frames."""
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).integers(0, 256, (40, SIZE, SIZE, 1),
                                          np.uint8)
    n_sep = sum(isinstance(m, SeparableConvBN) for m in model.modules())
    return program_steps.make_predict_step(model), x, n_sep


def _predict(step, x, marker=False):
    def fn(xb):  # the test's own range around each forward
        with torch.profiler.record_function("test.predict_fn"):
            return step(xb)
    return lambda: loop.predict_in_batches(fn if marker else step, x, 16,
                                           "cpu", verbose=False)[0]


def test_predict_phases_export_in_order(predictor, tmp_path):
    """40 frames at b=16: one warm-up, three copy-ins and forwards in
    turns, one copy-out, as `cpu_op` events that do not overlap."""
    step, x, _ = predictor
    _, events = _traced(_predict(step, x), tmp_path)
    phases = [e for e in events if e["name"] in PHASES]
    assert all(e["cat"] == "cpu_op" for e in phases)
    assert [e["name"].rsplit(".", 1)[1] for e in phases] == (
        ["warmup"] + ["copy_in", "forward"] * 3 + ["copy_out"])
    for a, b in zip(phases, phases[1:]):
        assert a["ts"] + a["dur"] <= b["ts"], (a["name"], b["name"])


def test_forward_ops_inside_forward_spans(predictor, tmp_path):
    """Each call of the predict step after the warm-up, and every aten op
    it runs, lies inside one `spnet.predict.forward` span; the warm-up's
    call inside the warm-up span."""
    step, x, _ = predictor
    _, events = _traced(_predict(step, x, marker=True), tmp_path)
    calls = _named(events, "test.predict_fn", "user_annotation")
    forwards = _named(events, "spnet.predict.forward")
    (warmup,) = _named(events, "spnet.predict.warmup")
    assert len(calls) == 4 and len(forwards) == 3
    assert _inside(calls[0], warmup)
    for call, fwd in zip(calls[1:], forwards):
        assert _inside(call, fwd)
        ops = [e for e in events if e["name"].startswith("aten::")
               and _inside(e, call)]
        assert any(e["name"] == "aten::convolution" for e in ops)
        assert all(_inside(e, fwd) for e in ops)


def test_sepconv_spans_nest_in_forward_or_warmup(predictor, tmp_path):
    """One `spnet.sepconv` span a separable conv layer a batch (the
    warm-up's and three), each inside a forward or the warm-up."""
    step, x, n_sep = predictor
    _, events = _traced(_predict(step, x), tmp_path)
    outer = [e for e in events if e["name"] in (
        "spnet.predict.forward", "spnet.predict.warmup")]
    seps = _named(events, "spnet.sepconv")
    assert n_sep > 0 and len(seps) == 4 * n_sep
    for s in seps:
        assert sum(_inside(s, o) for o in outer) == 1


def test_fused_sepconv_runs_inside_its_span(tmp_path):
    """Xception's fused variant in eval mode (the plain version of the
    kernel on the CPU) opens its span too, around the layer's ops."""
    layer = SeparableConvBN(8, 16, act="relu").eval()
    assert layer.fused
    x = torch.randn(2, 6, 6, 8)
    with torch.no_grad():
        _, events = _traced(lambda: layer(x), tmp_path)
    (sep,) = _named(events, "spnet.sepconv")
    ops = [e for e in events if e["name"].startswith("aten::")]
    assert ops and all(_inside(e, sep) for e in ops)


def test_outputs_equal_with_and_without_the_profiler(predictor, tmp_path):
    step, x, _ = predictor
    plain = _predict(step, x)()
    traced, _ = _traced(_predict(step, x), tmp_path)
    assert plain.dtype == np.float32 and plain.shape[0] == 40
    assert np.array_equal(plain, traced)


def test_span_without_a_profiler_is_one_shared_noop(tmp_path):
    """Without a profiler every span is the same object, and one entered
    then records nothing even if a profiler starts inside it; under a
    profiler each span is its own range."""
    assert span("a") is span("b")
    with span("spnet.test.off"):
        _, events = _traced(lambda: torch.ones(3) + 1, tmp_path)
    assert not _named(events, "spnet.test.off")
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("a") is not span("a")


def _epoch_setup():
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, onecycle_schedule(1e-3, 100))
    step = program_steps.make_train_step(model, augment=True,
                                         indexed="epoch")
    grid = GridSpec()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (8, SIZE, SIZE, 1), np.uint8))
    y = torch.from_numpy(normalize(np.tile(grid.defaults.reshape(-1),
                                           (8, 1)), grid).astype(np.float32))
    return state, step, x, y


def test_epoch_phases_on_the_cpu(tmp_path):
    """On the CPU each call of the epoch form exports one
    `spnet.epoch.prepare` and then one `spnet.epoch.run`, which holds its
    steps' separable convs; the CPU captures nothing."""
    state, step, x, y = _epoch_setup()
    train_epoch = program_steps.make_train_epoch(step)
    idx = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    gen = torch.Generator().manual_seed(0)

    def two_calls():
        for _ in range(2):
            train_epoch(state, x, y, idx, gen)

    _, events = _traced(two_calls, tmp_path)
    prep = _named(events, "spnet.epoch.prepare")
    run = _named(events, "spnet.epoch.run")
    assert len(prep) == len(run) == 2
    assert not _named(events, "spnet.epoch.capture")
    for p, r in zip(prep, run):
        assert p["ts"] + p["dur"] <= r["ts"]
    assert all(any(_inside(s, r) for r in run)
               for s in _named(events, "spnet.sepconv"))
    assert train_epoch.capture_seconds == []


def test_train_network_reports_each_epochs_captures(monkeypatch, capsys):
    """The epoch line carries the captures of each epoch and their
    seconds (a recapture in the second epoch, stood in for on the CPU,
    where the epoch form captures nothing)."""
    def make_train_epoch(step, geo=False):
        real = program_steps.make_train_epoch(step, geo)
        calls = []

        def train_epoch(*args):
            calls.append(1)
            if len(calls) == 2:
                real.capture_seconds.append(0.25)
            return real(*args)
        train_epoch.capture_seconds = real.capture_seconds
        return train_epoch

    monkeypatch.setattr(loop, "make_train_epoch", make_train_epoch)
    grid = GridSpec()
    rng = np.random.default_rng(0)

    def dataset(n):
        y = normalize(np.tile(grid.defaults.reshape(-1), (n, 1)), grid)
        return Dataset(x=rng.integers(0, 256, (n, SIZE, SIZE, 1), np.uint8),
                       y=y.astype(np.float32), grid=grid,
                       file_list=[f"synthetic://{i}" for i in range(n)])

    cfg = ExperimentConfig(model=TINY, train=TrainConfig(
        batch_size=4, epochs=2, save_every=1))
    _, history = loop.train_network(cfg, dataset(8), dataset(4), "cpu",
                                    render_overlays=False, device_data=True)
    assert len(history) == 2
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("epoch ")]
    assert len(lines) == 2
    assert lines[0].endswith("captures 0 (0.00s)")
    assert lines[1].endswith("captures 1 (0.25s)")
