"""The reader of `batchnorm_ms.train` on synthetic tails: the device ms a
step of the train-mode BatchNorm kernels, found by their name prefix and
by no frozen kernel class, and nothing where none ran."""

import importlib.util

from conftest import ROOT
from perfbench.trace import Tail, kernel_class

BN = ("void (anonymous namespace)::batchnorm_stats_kernel<__nv_bfloat16, "
      "8>(__nv_bfloat16 const*, float*, long long, int)",
      "void (anonymous namespace)::batchnorm_finalize_kernel(float const*, "
      "int, int, float, float const*, float, float*, float*, float*, "
      "float*, float, float, float)",
      "void (anonymous namespace)::batchnorm_grad_dx_kernel<float, 1>("
      "float const*, float const*, float const*, float const*, float const*"
      ", float const*, float*, long long, int, int)")
ATEN = ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
        "at::native::MeanOps<float, float, float, float>, unsigned int, "
        "float, 4> >(at::native::ReduceOp<float, at::native::MeanOps<float,"
        " float, float, float>, unsigned int, float, 4>)")


def _reader():
    path = ROOT / "perfbench" / "metrics" / "batchnorm_ms.train.py"
    spec = importlib.util.spec_from_file_location("bn_ms_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _record(names_us, units=4, kind="train_resident"):
    device = [[n, 10.0 * i, us, i] for i, (n, us) in enumerate(names_us)]
    tail = Tail([0.0, 1e4], device, {}, [], [], units)
    return {"kind": kind, "tails": {"plain": tail}}


def test_reads_the_kernels_ms_a_step():
    read = _reader()
    rec = _record([(BN[0], 100.0), (BN[1], 3.0), (ATEN, 500.0),
                   (BN[2], 97.0), (BN[0], 100.0)], units=4)
    assert read(rec) == (100.0 + 3.0 + 97.0 + 100.0) / 4 / 1e3


def test_nothing_where_no_kernel_ran():
    read = _reader()
    assert read(_record([(ATEN, 500.0)])) is None
    assert read(_record([(BN[0], 100.0)], kind="predict_clips")) is None
    assert read(_record([])) is None
    assert read({"kind": "train_resident", "tails": {}}) is None


def test_no_frozen_class_takes_the_kernels():
    """So `elementwise_reduce_ms.train` no longer counts BatchNorm's work
    once the kernels run, and `batchnorm_ms.train` counts it alone."""
    assert {kernel_class(n) for n in BN} == {"other"}
    assert kernel_class(ATEN) == "reduction"

