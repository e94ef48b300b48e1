"""Port of the fused separable conv (`spnet_tpu_torch/ops/sepconv.py`)
against the JAX package: the plain PyTorch version vs `sepconv_infer_jnp`
and the Pallas kernel in interpret mode (with and without the input ReLU),
`fold_bn`, the kernel's tile plan, the eval Xception with the input ReLU
fused against its plain composition, and the wrapper's device dispatch and
input checks.  The CUDA kernel itself is tested on the card by
`test_torch_sepconv_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.ops.sepconv_pallas import (
    fold_bn as fold_bn_jnp,
    sepconv_infer_jnp,
    sepconv_infer_pallas,
)
from spnet_tpu_torch.config import ModelConfig
from spnet_tpu_torch.models.layers import BatchNorm, SeparableConvBN
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops import _build
from spnet_tpu_torch.ops.sepconv import (
    fold_bn,
    sepconv_infer,
    sepconv_infer_torch,
    sepconv_plan,
)
from spnet_tpu_torch.tools import k1_variants

torch.set_num_threads(2)

# float32 on the CPU: the port and JAX differ only in summation order
TOL = 1e-5


def _inputs(seed, b, h, w, c, f):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    dw = rng.normal(0, 0.2, (3, 3, c)).astype(np.float32)
    pw = rng.normal(0, 0.1, (c, f)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, f).astype(np.float32)
    beta = rng.normal(0, 0.3, f).astype(np.float32)
    mean = rng.normal(0, 0.2, f).astype(np.float32)
    var = rng.uniform(0.5, 2.0, f).astype(np.float32)
    return x, dw, pw, (gamma, beta, mean, var)


SHAPES = {
    "aligned": (4, 8, 8, 128, 128),
    "unaligned": (3, 5, 7, 24, 40),
}


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_jnp_and_pallas(shape, relu):
    x, dw, pw, bn = _inputs(3, *SHAPES[shape])
    scale_j, bias_j = fold_bn_jnp(*map(jnp.asarray, bn))
    args_j = (jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw), scale_j,
              bias_j)
    ref_jnp = np.asarray(sepconv_infer_jnp(*args_j, relu=relu))
    ref_pallas = np.asarray(sepconv_infer_pallas(*args_j, relu=relu))

    scale, bias = fold_bn(*map(torch.from_numpy, bn))
    out = sepconv_infer_torch(torch.from_numpy(x), torch.from_numpy(dw),
                              torch.from_numpy(pw), scale, bias, relu=relu)
    assert out.shape == ref_jnp.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_jnp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), ref_pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_relu_in_matches_pallas_of_relu_input(shape, relu):
    """`relu_in=True` is the Pallas kernel (interpret mode) applied to
    `jnp.maximum(x, 0)`, and differs from the kernel of x itself."""
    x, dw, pw, bn = _inputs(4, *SHAPES[shape])
    scale_j, bias_j = fold_bn_jnp(*map(jnp.asarray, bn))
    ref = np.asarray(sepconv_infer_pallas(
        jnp.maximum(jnp.asarray(x), 0), jnp.asarray(dw), jnp.asarray(pw),
        scale_j, bias_j, relu=relu))
    scale, bias = fold_bn(*map(torch.from_numpy, bn))
    args = (torch.from_numpy(x), torch.from_numpy(dw), torch.from_numpy(pw),
            scale, bias)
    out = sepconv_infer_torch(*args, relu=relu, relu_in=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    assert torch.equal(sepconv_infer(*args, relu=relu, relu_in=True), out)
    plain = sepconv_infer_torch(*args, relu=relu)
    assert (out - plain).abs().max() > 1e-2


# (H, W, C, F) of Xception-331's separable convs
XCEPTION = [(80, 80, 64, 128), (80, 80, 128, 128), (40, 40, 128, 256),
            (40, 40, 256, 256), (20, 20, 256, 728), (20, 20, 728, 728),
            (10, 10, 728, 728), (10, 10, 728, 1024), (5, 5, 1024, 1536),
            (5, 5, 1536, 2048)]


@pytest.mark.parametrize("b", [16, 256])
def test_sepconv_plan_at_xception_shapes(b):
    """TN never exceeds F rounded up to 8 (so F = 128 gets no half-empty
    tile) and is as wide as F allows up to 256; TM is a number of 64-row
    wgmma tiles; the tiles fill 132 SMs wherever 64-row tiles could."""
    for h, w, c, f in XCEPTION:
        tm, tn, tiles = sepconv_plan(b, h, w, c, f)
        m = b * h * w
        assert tm in (64, 128) and tn in (64, 128, 256), (h, c, f)
        assert tn <= -(-f // 8) * 8 and tn == min(256, -(-f // 64) * 64)
        n_tiles = -(-f // tn)
        assert tiles == -(-m // tm) * n_tiles
        if -(-m // 64) * n_tiles >= 132:
            assert tiles >= 132, (b, h, c, f, tiles)
        if -(-m // 128) * n_tiles >= 132:
            assert tm == 128  # the larger tile whenever it fills the card
    # b=16 10x10 728->728: 1600 pixels, 75 tiles of 64 x 256 (128 rows
    # would leave 39 of 132 SMs busy)
    assert sepconv_plan(16, 10, 10, 728, 728) == (64, 256, 75)
    assert sepconv_plan(16, 80, 80, 64, 128) == (128, 128, 800)
    assert sepconv_plan(256, 10, 10, 728, 728, sms=1000) == (64, 256, 1200)


def test_eval_xception_relu_in_matches_plain_composition():
    """The eval-mode SPNet Xception (f32, 96²) with the input ReLU fused
    into 31 of its 34 separable convs equals the same weights through the
    plain composition (`F.relu` -> depthwise -> matmul -> BN), to float32
    summation order."""
    gen = torch.Generator().manual_seed(2)
    model = build_model(ModelConfig(input_size=96, compute_dtype="float32"),
                        device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    seps = [m for m in model.modules() if isinstance(m, SeparableConvBN)]
    assert len(seps) == 34 and sum(m.relu_in for m in seps) == 31
    assert all(m.fused for m in seps)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 96, 96, 1)).astype(np.float32))
    with torch.inference_mode():
        fused = model(x)
        for m in seps:
            m.fused = False
        plain = model(x)
    scale = plain.abs().max()
    assert scale > 0.1
    assert (fused - plain).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("name", list(k1_variants.VARIANTS))
def test_k1_variants_cut_the_current_kernel(name):
    """The timing tool's cuts each match `csrc/sepconv.cu` exactly once, so
    a change to the kernel cannot leave the tool timing the wrong thing."""
    src = (_build.CSRC / "sepconv.cu").read_text()
    out = k1_variants.variant_source(src, k1_variants.VARIANTS[name])
    assert (out == src) == (name == "full")
    with pytest.raises(ValueError, match="not found once"):
        k1_variants.variant_source(src.replace("wgmma_k16<TN>(d,", "x("),
                                   [k1_variants.PRODUCT])


def test_fold_bn_matches_jnp():
    _, _, _, bn = _inputs(7, 1, 1, 1, 1, 64)
    s_j, b_j = fold_bn_jnp(*map(jnp.asarray, bn))
    s, b = fold_bn(*map(torch.from_numpy, bn))
    # one division and one sqrt per channel: float32 rounding only
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=1e-6,
                               atol=1e-7)


def _torch_args(seed=5, shape=(2, 5, 5, 16, 24), dtype=torch.float32):
    x, dw, pw, bn = _inputs(seed, *shape)
    scale, bias = fold_bn(*map(torch.from_numpy, bn))
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dw),
            torch.from_numpy(pw).to(dtype), scale, bias)


def test_wrapper_on_cpu_takes_plain_path_without_launching():
    sepconv_infer.launches = 0
    args = _torch_args()
    out = sepconv_infer(*args, relu=True)
    assert torch.equal(out, sepconv_infer_torch(*args, relu=True))
    assert sepconv_infer.launches == 0


def test_wrapper_bf16_on_cpu():
    """bfloat16 through the plain path: dw in bf16 like the JAX twin,
    f32 accumulation; compared with the float32 result at bf16's
    resolution (a few roundings of ~4e-3 relative each)."""
    args16 = _torch_args(dtype=torch.bfloat16)
    out = sepconv_infer(*args16, relu=False)
    assert out.dtype == torch.bfloat16
    ref = sepconv_infer_torch(*_torch_args(), relu=False)
    err = (out.float() - ref).abs().max() / ref.abs().max()
    assert err < 2e-2


@pytest.mark.parametrize("bad", [
    "x_dtype", "x_rank", "dw_shape", "dw_dtype", "pw_rows", "pw_dtype",
    "scale_shape", "bias_dtype", "noncontiguous",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dw, pw, scale, bias = _torch_args()
    if bad == "x_dtype":
        x, pw = x.half(), pw.half()
    elif bad == "x_rank":
        x = x[0]
    elif bad == "dw_shape":
        dw = dw[:2]
    elif bad == "dw_dtype":
        dw = dw.double()
    elif bad == "pw_rows":
        pw = pw[:-1]
    elif bad == "pw_dtype":
        pw = pw.to(torch.bfloat16)
    elif bad == "scale_shape":
        scale = scale[:-1]
    elif bad == "bias_dtype":
        bias = bias.double()
    elif bad == "noncontiguous":
        x = x.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        sepconv_infer(x, dw, pw, scale, bias)
