"""The port's measurement tools on the card.  No jax here, so run this file
on the card without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_tools_cuda.py -q

Elsewhere every case skips."""

import pytest
import torch

from spnet_tpu_torch.tools import bench_infer
from spnet_tpu_torch.train.steps import make_predict_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_sweeps_leave_no_memory_behind(cuda):
    """Every capture of `bench_infer.captured_sweep` runs on one side
    stream, so a sweep after the first allocates nothing that outlives it.
    A new stream a capture kept cuBLAS's 33 MiB of workspaces for that
    stream alive each time (the +0.0645 GiB a `bench_native` turn, two
    sweeps a turn)."""
    model, x, _ = bench_infer.setup(16, 64, device="cuda",
                                    backbone="MobileNetTiny", input_size=64)
    predict = make_predict_step(model)
    y0, _ = bench_infer.captured_sweep(predict, x, 16)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    for b in (16, 8, 16):
        y, _ = bench_infer.captured_sweep(predict, x, b)
        del y
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == before
    assert bench_infer.capture_stream(x.device) is \
        bench_infer.capture_stream(cuda)
    del y0
