"""The fused separable-conv CUDA kernel against its plain PyTorch version,
on the card.  No jax here: the kernel's test must not depend on it, so run
this file on the card without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_sepconv_cuda.py -q

Elsewhere every case skips."""

import pytest
import torch

from spnet_tpu_torch.ops.sepconv import sepconv_infer, sepconv_infer_torch

# (H, W, C, F) of Xception-331's separable convs
XCEPTION = [(80, 80, 64, 128), (80, 80, 128, 128), (40, 40, 128, 256),
            (40, 40, 256, 256), (20, 20, 256, 728), (20, 20, 728, 728),
            (10, 10, 728, 728), (10, 10, 728, 1024), (5, 5, 1024, 1536),
            (5, 5, 1536, 2048)]
BF16_RTOL, F32_RTOL = 2e-2, 1e-4


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


def _rel_err(args, relu, relu_in):
    before = sepconv_infer.launches
    out = sepconv_infer(*args, relu=relu, relu_in=relu_in)
    torch.cuda.synchronize()
    assert sepconv_infer.launches == before + 1
    ref = sepconv_infer_torch(*args, relu=relu, relu_in=relu_in)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("b", [16, 256])
@pytest.mark.parametrize("hwcf", XCEPTION)
def test_bf16_kernel_at_xception_shapes(cuda, hwcf, b, relu_in):
    """The wgmma path at every shape of the predict (b=16) and val-sweep
    (b=256) batches: the two versions round at different points."""
    args = _args((b, *hwcf), torch.bfloat16, cuda)
    assert _rel_err(args, relu_in, relu_in) <= BF16_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, F32_RTOL),
                                        (torch.bfloat16, BF16_RTOL)])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("shape,offset", [
    ((16, 10, 10, 728, 728), 0),  # Xception middle flow
    ((2, 7, 5, 24, 40), 0),       # ragged C and F, multiples of 8
    ((5, 11, 13, 200, 72), 0),    # ragged, a run crossing rows and images
    ((3, 9, 9, 33, 70), 0),       # ragged, one element per access
    ((2, 7, 5, 24, 40), 1),       # misaligned view
])
def test_kernel_matches_plain(cuda, shape, offset, dtype, rtol, relu_in):
    """float32: only the summation order differs; bfloat16: the two
    versions also round at different points."""
    args = _args(shape, dtype, cuda, offset)
    assert _rel_err(args, True, relu_in) <= rtol


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, dw, pw, scale, bias = _args((2, 7, 5, 24, 40), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sepconv_infer(x.transpose(1, 2), dw, pw, scale, bias)
    with pytest.raises(ValueError, match="pw must be"):
        sepconv_infer(x, dw, pw.float(), scale, bias)
    with pytest.raises(ValueError, match="is on"):
        sepconv_infer(x, dw, pw, scale.cpu(), bias)
    with pytest.raises(TypeError):
        sepconv_infer(x.half(), dw, pw.half(), scale, bias)


@pytest.mark.cuda
def test_kernel_after_the_descriptor_ring_wraps(cuda):
    """The launcher caches TMA descriptors in a ring of 256 and looks up
    three a launch (weight, x, taps).  300 launches with one weight and a
    fresh x each (kept alive: distinct addresses) walk the ring past the
    weight's entry: the launch whose x descriptor takes that slot must
    still read the weight through its own descriptor."""
    dw, pw, scale, bias = _args((2, 8, 8, 64, 64), torch.bfloat16, cuda)[1:]
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn(2, 8, 8, 64, generator=g).to(cuda, torch.bfloat16)
          for _ in range(300)]
    for x in xs:
        out = sepconv_infer(x, dw, pw, scale, bias)
        ref = sepconv_infer_torch(x, dw, pw, scale, bias)
        rel = ((out.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert rel <= BF16_RTOL
    torch.cuda.synchronize()
