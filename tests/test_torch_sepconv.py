"""Port of the fused separable conv (`spnet_tpu_torch/ops/sepconv.py`)
against the JAX package: the plain PyTorch version vs `sepconv_infer_jnp`
and the Pallas kernel in interpret mode, `fold_bn`, and the wrapper's
device dispatch and input checks.  The CUDA kernel itself is tested on
the card by `test_torch_sepconv_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.ops.sepconv_pallas import (
    fold_bn as fold_bn_jnp,
    sepconv_infer_jnp,
    sepconv_infer_pallas,
)
from spnet_tpu_torch.ops.sepconv import (
    fold_bn,
    sepconv_infer,
    sepconv_infer_torch,
)

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
