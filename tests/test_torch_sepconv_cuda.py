"""The fused separable-conv CUDA kernel against its plain PyTorch version,
on the card.  No jax here: the kernel's test must not depend on it, so run
this file on the card without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_sepconv_cuda.py -q

Elsewhere every case skips."""

import pytest
import torch

from spnet_tpu_torch.ops.sepconv import sepconv_infer, sepconv_infer_torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(shape, dtype, device, offset=0):
    b, h, w, c, f = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, h, w, c, generator=g).to(device, dtype)
    if offset:  # a contiguous view whose data pointer is not 16-byte aligned
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=device)
        x = buf[offset:].view(b, h, w, c).copy_(x)
    dw = torch.randn(3, 3, c, generator=g).mul(0.3).to(device)
    pw = (torch.randn(c, f, generator=g) / c ** 0.5).to(device, dtype)
    scale = (torch.rand(f, generator=g) + 0.5).to(device)
    bias = torch.randn(f, generator=g).mul(0.1).to(device)
    return x, dw, pw, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,offset", [
    ((16, 10, 10, 728, 728), 0),  # Xception middle flow
    ((2, 7, 5, 24, 40), 0),       # ragged, 16-byte accesses
    ((3, 9, 9, 33, 70), 0),       # ragged, one element per access
    ((2, 7, 5, 24, 40), 1),       # misaligned view
])
def test_kernel_matches_plain(cuda, shape, offset, dtype, rtol):
    """float32: only the summation order differs; bfloat16: the two
    versions also round at different points."""
    args = _args(shape, dtype, cuda, offset)
    before = sepconv_infer.launches
    out = sepconv_infer(*args, relu=True)
    torch.cuda.synchronize()
    assert sepconv_infer.launches == before + 1
    ref = sepconv_infer_torch(*args, relu=True)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= rtol
