"""The readers of the program's spans (`perfbench/spans.py`) on a recorded
run of the predict cell from a program that opens them, and on a made-up
tail: each reader returns a share, the idle shares split the device's
idle time, the predict path's spans hold the tail's device operations,
and without spans nothing is read.

The recording lives in `fixtures_spans/`, beside `fixtures/`: the predict
cell's record in `fixtures/` predates the spans."""

import json
import math

import pytest

from conftest import ROOT
from perfbench import core, spans
from perfbench.trace import Tail

CELL = "xception331-predict-b16"
FIXTURE = (ROOT / "perfbench" / "tests" / "fixtures_spans"
           / f"{CELL}__trace.json.gz")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in SPEC["per_layer"] if m["name"] in (
    "idle_launch_pct.predict", "idle_sync_pct.predict",
    "sepconv_span_roofline.predict")]


def _values(record, names):
    got = core.read_metrics([m for m in SPEC["per_layer"]
                             if m["name"] in names], record)
    return {k: v["value"] for k, v in got.items()}


@pytest.fixture
def record():
    return core.load_record(FIXTURE)


@pytest.mark.parametrize("name", [m["name"] for m in SPAN_METRICS])
def test_span_readers_on_a_recorded_run(record, name):
    """Each reader reports a positive, finite share of at most 100 % in
    the cell it lists."""
    (metric,) = [m for m in SPAN_METRICS if m["name"] == name]
    assert CELL in metric["workloads"]
    v = _values(record, (name,))[name]
    assert math.isfinite(v) and 0 < v <= 100.0, (name, v)


def test_idle_shares_split_the_device_idle(record):
    """The two idle shares and the idle outside the predict path's spans
    add up to `device_idle_pct.predict`."""
    got = _values(record, ("idle_launch_pct.predict",
                           "idle_sync_pct.predict",
                           "device_idle_pct.predict"))
    tail = record["tails"]["plain"]
    outside = sum(b - a for a, b in tail.idle_gaps()) - spans.idle_us(
        tail, spans.PREDICT)
    parts = got["idle_launch_pct.predict"] + got["idle_sync_pct.predict"]
    assert parts <= got["device_idle_pct.predict"]
    assert parts + 100.0 * outside / tail.window_us == pytest.approx(
        got["device_idle_pct.predict"], rel=1e-9)


def test_predict_spans_hold_the_device_work(record):
    """At least 99 % of the tail's device operations were launched inside
    a `spnet.predict.*` span."""
    tail = record["tails"]["plain"]
    inside = spans.launched_in(tail, spans.PREDICT)
    assert tail.device and len(inside) >= 0.99 * len(tail.device)


def test_nothing_read_without_spans(record):
    """With the program's spans stripped from the tails, as a program
    without them traces, the three readers return nothing."""
    assert len(_values(record, [m["name"] for m in SPAN_METRICS])) == 3
    for t in record["tails"].values():
        t.host_ops = [o for o in t.host_ops
                      if not o[0].startswith(spans.PREFIX)]
    assert _values(record, [m["name"] for m in SPAN_METRICS]) == {}


def test_idle_gap_split_by_overlap():
    """A gap that two phases share is split by overlap, not given whole to
    the phase open at its middle; device operations go to the span open
    on their launching thread when launched, the warm-up's left out."""
    tail = Tail(
        window=[0.0, 100.0],
        device=[["k", 10.0, 20.0, 1], ["k", 60.0, 10.0, 2],
                ["k", 80.0, 5.0, 3]],
        launches={1: [5.0, 7], 2: [45.0, 7], 3: [50.0, 8]},
        ranges=[],
        host_ops=[["spnet.predict.warmup", 0.0, 8.0, 7],
                  ["spnet.sepconv", 4.0, 2.0, 7],
                  ["spnet.predict.copy_in", 30.0, 10.0, 7],
                  ["spnet.predict.forward", 40.0, 30.0, 7],
                  ["spnet.sepconv", 44.0, 4.0, 7],
                  ["spnet.sepconv", 49.0, 4.0, 9],
                  ["aten::conv2d", 44.0, 3.0, 7]])
    # gaps: [0, 10), [30, 60), [70, 80), [85, 100)
    assert spans.idle_us(tail, spans.PREDICT_LAUNCH) == 20.0  # 40-60
    assert spans.idle_us(tail, spans.PREDICT_SYNC) == 8.0 + 10.0
    assert spans.idle_us(tail, spans.PREDICT) == 38.0
    assert spans.launched_in(tail, spans.SEPCONV) == [tail.device[0],
                                                      tail.device[1]]
    assert spans.launched_in(tail, spans.SEPCONV, outside=(
        "spnet.predict.warmup",)) == [tail.device[1]]
