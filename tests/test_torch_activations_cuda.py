"""The selective-sigmoid kernel K4 (forward and backward) against its plain
PyTorch twins, on the card.  No jax here; run this file on the card
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_activations_cuda.py -q

Elsewhere every case skips."""

import pytest
import torch

from spnet_tpu_torch.ops.activations import (
    SelectiveSigmoid,
    selective_sigmoid_bwd,
    selective_sigmoid_fwd,
    selective_sigmoid_grad_torch,
    selective_sigmoid_torch,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _on(device, v, offset):
    """v copied to the device; `offset` makes a view whose data pointer is
    not 16-byte aligned."""
    buf = torch.empty(v.numel() + offset, device=device)
    return buf[offset:].view(v.shape).copy_(v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [
    ((128, 576), 0),     # the training batch
    ((16, 576), 0),      # the serving batch
    ((3, 8 * 37), 0),    # ragged last block
    ((5, 8 * 250), 1),   # ragged and misaligned
])
def test_kernels_match_twins(cuda, shape, offset):
    """Forward and backward within 1e-6 of the twins' scale: both compute
    1 / (1 + expf(-x)) and g * (y * (1 - y)) in float32 on the card."""
    g = torch.Generator().manual_seed(shape[0] * 1000 + shape[1])
    x = _on(cuda, 4 * torch.randn(shape, generator=g), offset)
    up = _on(cuda, torch.randn(shape, generator=g), offset)
    f0, b0 = selective_sigmoid_fwd.launches, selective_sigmoid_bwd.launches
    y = selective_sigmoid_fwd(x)
    dx = selective_sigmoid_bwd(y, up)
    torch.cuda.synchronize()
    assert (selective_sigmoid_fwd.launches, selective_sigmoid_bwd.launches) \
        == (f0 + 1, b0 + 1)
    ref = selective_sigmoid_torch(x)
    ref_dx = selective_sigmoid_grad_torch(ref, up)
    assert (y - ref).abs().max() <= 1e-6 * ref.abs().max()
    assert (dx - ref_dx).abs().max() <= 1e-6 * ref_dx.abs().max()
    lin = torch.arange(shape[1], device=cuda) % 8 != 6
    assert torch.equal(y[:, lin], x[:, lin])
    assert torch.equal(dx[:, lin], up[:, lin])


@pytest.mark.cuda
def test_autograd_function_launches_both_kernels(cuda):
    x = torch.randn(16, 576, device=cuda).requires_grad_(True)
    f0, b0 = selective_sigmoid_fwd.launches, selective_sigmoid_bwd.launches
    SelectiveSigmoid.apply(x).square().sum().backward()
    torch.cuda.synchronize()
    assert (selective_sigmoid_fwd.launches, selective_sigmoid_bwd.launches) \
        == (f0 + 1, b0 + 1)
    assert torch.isfinite(x.grad).all()
