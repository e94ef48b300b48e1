"""The Inception-ResNet-v2 cell `irv2-331-train-b32` on the CPU at a small
size (input 160, the smallest the backbone takes: its last maps 1x1; b=4,
full widths): in float32 its run follows the reference to rounding; with
half of each minibatch left out it is not correct; the fp8 control's and
the half-batch fault's readings each break one of the cell's limits.  And
the two readers that came with it, `kernels_per_step.train` and
`conv_roofline.train`, on synthetic tails and on the cell's recorded
one."""

import importlib.util
import math

import pytest
import torch

from conftest import ROOT, small
from perfbench import core
from perfbench.trace import Tail
from test_perfbench_reference import F32_ROUNDING
from test_perfbench_run import _half_batch

CELL = "irv2-331-train-b32"
FIXTURE = ROOT / "perfbench" / "tests" / "fixtures" / f"{CELL}__trace.json.gz"


def _small(**model):
    return small(CELL, input_size=160, **model)


def test_cell_follows_reference_f32():
    res, checks, _ = core.run_cell(CELL, 2 ** 31 + 77, 0.5, False,
                                   torch.device("cpu"), 0.0,
                                   _small(compute_dtype="float32"))
    assert res["correct"], res["checks"]
    for name, value, _ in checks:
        assert value < F32_ROUNDING[name], (name, value)


def test_half_batch_is_not_correct(monkeypatch):
    _half_batch(monkeypatch)
    res, _, _ = core.run_cell(CELL, 2 ** 31 + 41, 0.5, False,
                              torch.device("cpu"), 0.0,
                              _small(compute_dtype="float32"))
    assert not res["correct"]


def test_control_and_fault_readings_break_a_limit():
    """In the configuration's bf16: the reference in fp8 (the control) and
    the reference on half of each batch (the fault), each against the
    float32 reference, read above one of the cell's limits."""
    limits = core.load_cell(CELL)["limits"]
    res, _, _ = core.run_cell(CELL, 2 ** 31 + 43, 0.5, False,
                              torch.device("cpu"), 0.0, _small(),
                              calibrate=True)
    for side in ("control_fp8", "fault_half_batch"):
        got = res["readings"][side]
        assert any(got[k] > lim for k, lim in limits.items()), (side, got)


def _reader(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
GEMM = "nvjet_tst_128x64_64x8_2x4_h_bz_NTT"
BN = "void (anonymous namespace)::batchnorm_stats_kernel<__nv_bfloat16, 8>()"
PEAKS = {"flops": 989e12, "bytes_per_s": 3.35e12, "card": "H100"}


def _record(names_us, units=2, kind="train_resident", batch=32,
            flops=6e9):
    device = [[n, 10.0 * i, us, i] for i, (n, us) in enumerate(names_us)]
    return {"kind": kind, "batch": batch, "peaks": PEAKS,
            "counts": {"forward_flops": flops},
            "tails": {"plain": Tail([0.0, 1e5], device, {}, [], [], units)}}


def test_kernels_a_step_leave_out_copies_and_sets():
    read = _reader("kernels_per_step.train")
    rec = _record([(CONV, 5.0), ("Memcpy DtoD (Device -> Device)", 1.0),
                   (BN, 2.0), ("Memset (Device)", 1.0), (GEMM, 3.0),
                   ("memcpy32_post", 1.0)], units=2)
    assert read(rec) == 4 / 2
    assert read(_record([("Memset (Device)", 1.0)])) is None
    assert read(_record([(CONV, 5.0)], kind="predict_clips")) is None
    assert read({"kind": "train_resident", "tails": {}}) is None


def test_conv_roofline_is_least_time_over_conv_and_gemm_time():
    read = _reader("conv_roofline.train")
    rec = _record([(CONV, 700.0), (BN, 500.0), (GEMM, 300.0)], units=2)
    least_us = 3 * 6e9 * 32 / 989e12 * 1e6
    assert read(rec) == pytest.approx(100 * least_us / 500.0, rel=1e-12)
    assert read(_record([(BN, 500.0)])) is None
    no_peaks = _record([(CONV, 700.0)])
    no_peaks["peaks"] = None
    assert read(no_peaks) is None


def test_readers_on_the_recorded_tail():
    """A short traced run of the cell on the card (8-step chunks): every
    kernel of the replays counted, and the convs' share under 100 %."""
    record = core.load_record(FIXTURE)
    tail = record["tails"]["plain"]
    kernels = _reader("kernels_per_step.train")(record)
    assert kernels == sum(not n.startswith(("Memcpy", "Memset"))
                          for n, *_ in tail.device) / tail.units
    assert kernels > 1242  # BatchNorm's six launches a layer alone
    share = _reader("conv_roofline.train")(record)
    assert math.isfinite(share) and 0 < share <= 100
