"""Every metric's reader on records recorded on the card (a traced run of
each cell, `run.py --record-out`): each returns a number where its cell
reports it, shares stay within 100 %, and on a record without a device
trace the device readers return nothing."""

import json
import math

import pytest

from conftest import ROOT
from perfbench import core

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FIXTURES = sorted((ROOT / "perfbench" / "tests" / "fixtures")
                  .glob("*.json.gz"))
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _cell(path):
    return path.name.split("__")[0]


def test_a_fixture_for_every_cell():
    assert {_cell(f) for f in FIXTURES} == {w["name"]
                                           for w in SPEC["workloads"]}


@pytest.mark.parametrize("fixture", FIXTURES, ids=_cell)
def test_readers_on_recorded_runs(fixture):
    record = core.load_record(fixture)
    cell = _cell(fixture)
    for entries in (SPEC["end_to_end"], SPEC["per_layer"]):
        wanted = core.metrics_of(entries, cell)
        got = core.read_metrics(wanted, record)
        assert set(got) == {m["name"] for m in wanted}
        for m in wanted:
            v = got[m["name"]]["value"]
            assert math.isfinite(v) and v > 0, (m["name"], v)
            if m["unit"] == "%":
                assert v <= 100.0, (m["name"], v)


def test_device_readers_without_a_trace():
    record = core.load_record(FIXTURES[0])
    for t in record["tails"].values():
        t.device = []
    names = [m["name"] for m in SPEC["per_layer"]
             if m["source"] == "device_trace"]
    got = core.read_metrics([m for m in SPEC["per_layer"]
                             if m["name"] in names], record)
    assert got == {}
