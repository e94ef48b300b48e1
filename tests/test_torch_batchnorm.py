"""The train-mode BatchNorm kernels' arithmetic on the CPU
(`spnet_tpu_torch/ops/batchnorm.py`; the kernels run only on the card,
`tests/test_torch_batchnorm_cuda.py`).

`batchnorm_grad_torch`, the kernels' backward formula in plain PyTorch, is
held in float64 against autograd of flax's composition (the arithmetic of
`BatchNorm.plain`, then the activation): with and without a scale, each
activation, with the running statistics updated or left alone, and with a
channel whose fast variance E[x^2] - E[x]^2 comes out negative and is
clamped at 0 (where clamp_min passes no gradient).  In float64 the two
differ only by the order of the sums.  And the layer's routing: on the CPU
`BatchNorm.forward(x, act)` is the plain composition and then the
activation, in both modes."""

import pytest
import torch

from spnet_tpu_torch.models.layers import ACTIVATIONS, BatchNorm, ConvBN, \
    conv2d_nhwc
from spnet_tpu_torch.ops.batchnorm import ACTS, batchnorm_grad_torch, \
    batchnorm_train

EPS, MOMENTUM = 1e-3, 0.99
F64_RTOL = 1e-10  # float64: the sums' order alone


def _raw_variance(x):
    dims = tuple(range(x.dim() - 1))
    return torch.square(x).mean(dims) - torch.square(x.mean(dims))


def _inputs(scale: bool):
    """x (4, 5, 6, 8) float64, upstream gradient, scale (or None), bias.
    The channels spread around offsets, but channel 3 holds values near
    1e4 whose fast variance is negative: its true variance (~1e-8) lies
    below the rounding of E[x^2] (~1e8, an ulp 1.5e-8); the first seed
    that gives a negative one is taken."""
    g = torch.Generator().manual_seed(7)
    shape = (4, 5, 6, 8)
    x = (torch.randn(shape, generator=g, dtype=torch.float64)
         * torch.linspace(0.5, 3.0, 8, dtype=torch.float64)
         + torch.linspace(-2.0, 2.0, 8, dtype=torch.float64))
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    weight = (1.0 + 0.2 * torch.randn(8, generator=g, dtype=torch.float64)
              if scale else None)
    bias = 0.3 * torch.randn(8, generator=g, dtype=torch.float64)
    bias[3] = 0.0  # so that the activations pass part of channel 3
    for seed in range(100):
        x[..., 3] = 1e4 + 1e-4 * torch.randn(
            shape[:-1], generator=torch.Generator().manual_seed(seed),
            dtype=torch.float64)
        if _raw_variance(x)[3] < 0:
            return x, dy, weight, bias
    raise AssertionError("no seed gave a negative fast variance")


def _flax_composition(x, weight, bias, act, running=None):
    """flax's train-mode BatchNorm in x's dtype, as `BatchNorm.plain`
    writes it, then the activation; updates `running` (mean, var) as the
    layer does when it is given.  Returns (output, mean, rstd, raw
    variance)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    mean_sq = torch.square(x).mean(dims)
    raw = mean_sq - torch.square(mean)
    var = torch.clamp_min(raw, 0.0)
    if running is not None:
        with torch.no_grad():
            running[0].copy_(MOMENTUM * running[0] + (1 - MOMENTUM) * mean)
            running[1].copy_(MOMENTUM * running[1] + (1 - MOMENTUM) * var)
    rstd = torch.rsqrt(var + EPS)
    mul = rstd if weight is None else rstd * weight
    return ACTIVATIONS[act]((x - mean) * mul + bias), mean, rstd, raw


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("scale", [True, False])
def test_backward_formula_matches_autograd(scale, update_stats, act):
    x, dy, weight, bias = _inputs(scale)
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)
              if t is not None]
    xa, wa, ba = leaves if scale else (leaves[0], None, leaves[1])
    running = (torch.zeros(8, dtype=torch.float64),
               torch.ones(8, dtype=torch.float64))
    y, mean, rstd, raw = _flax_composition(
        xa, wa, ba, act, running if update_stats else None)
    y.backward(dy)
    assert raw[3] < 0 and (raw[:3] > 0).all() and (raw[4:] > 0).all()
    keep = (raw >= 0).to(torch.float64)
    dx, dw, db = batchnorm_grad_torch(x, dy, mean.detach(), rstd.detach(),
                                      keep, weight, bias, act)
    torch.testing.assert_close(dx, xa.grad, rtol=F64_RTOL, atol=0.0)
    torch.testing.assert_close(db, ba.grad, rtol=F64_RTOL, atol=0.0)
    if scale:
        torch.testing.assert_close(dw, wa.grad, rtol=F64_RTOL, atol=0.0)
    else:
        assert dw is None
    if update_stats:
        torch.testing.assert_close(
            running[0], (1 - MOMENTUM) * mean.detach(), rtol=1e-15, atol=0)
        torch.testing.assert_close(
            running[1], MOMENTUM + (1 - MOMENTUM) * raw.detach().clamp_min(0),
            rtol=1e-15, atol=0)
    else:
        assert (running[0] == 0).all() and (running[1] == 1).all()
    # the clamped channel's keep = 0 matters: with keep = 1 its gradient
    # would take the variance's path that clamp_min cuts
    dx1, _, _ = batchnorm_grad_torch(x, dy, mean.detach(), rstd.detach(),
                                     torch.ones_like(keep), weight, bias,
                                     act)
    err = (dx1[..., 3] - xa.grad[..., 3]).abs().max()
    assert err > 1e3 * F64_RTOL * xa.grad[..., 3].abs().max()


@pytest.mark.parametrize("act", sorted(ACTS))
def test_backward_formula_bf16_matches_autograd(act):
    """In bfloat16 the formula against autograd of the layer's own plain
    composition (`BatchNorm.plain` on the CPU, float32 arithmetic, bf16
    input and output, the activation in bf16), given the layer's
    statistics: dx within one bf16 rounding of its scale (the two round
    the float32 result of other orders of operations to bf16), dweight and
    dbias to float32 sums in other orders."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(2, 9, 7, 24, generator=g) * 2 + 0.5).bfloat16()
    dy = torch.randn(2, 9, 7, 24, generator=g).bfloat16()
    bn = BatchNorm(24).train()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.2 * torch.randn(24, generator=g))
        bn.bias.copy_(0.3 * torch.randn(24, generator=g))
    xa = x.clone().requires_grad_(True)
    y = bn(xa, act)
    y.backward(dy)
    xf = x.float()
    mean = xf.mean((0, 1, 2))
    raw = torch.square(xf).mean((0, 1, 2)) - torch.square(mean)
    rstd = torch.rsqrt(raw.clamp_min(0) + bn.eps)
    dx, dw, db = batchnorm_grad_torch(x, dy, mean, rstd,
                                      (raw >= 0).float(), bn.weight.detach(),
                                      bn.bias.detach(), act)
    assert dx.dtype == torch.bfloat16
    scale = xa.grad.float().abs().max()
    assert (dx.float() - xa.grad.float()).abs().max() <= 2 ** -7 * scale
    sums = dy.float().abs().sum((0, 1, 2))
    assert ((db - bn.bias.grad).abs() <= 1e-5 * sums).all()
    assert ((dw - bn.weight.grad).abs() <= 1e-5 * sums * 4 * rstd).all()


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("training", [True, False])
def test_cpu_forward_is_the_plain_composition(training, act):
    """On the CPU the layer is `plain` and then the activation, bitwise,
    in both modes; ConvBN hands its activation to its BatchNorm; the
    kernels' wrapper refuses a CPU tensor."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 6, 16, generator=g).bfloat16()
    a, b = BatchNorm(16).train(training), BatchNorm(16).train(training)
    ya = a(x, act)
    yb = ACTIVATIONS[act](b.plain(x))
    assert torch.equal(ya, yb)
    assert torch.equal(a.running_mean, b.running_mean)
    assert torch.equal(a.running_var, b.running_var)
    cb = ConvBN(3, 16, 3, act=act).train(training)
    cb.conv.reset_parameters(g)
    xc = torch.randn(2, 6, 6, 3, generator=g).bfloat16()
    want = ACTIVATIONS[act](BatchNorm(16).train(training).plain(
        conv2d_nhwc(xc, cb.conv.weight)))
    assert torch.equal(cb(xc), want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        batchnorm_train(x, a, act)


def test_unknown_activation_is_refused():
    with pytest.raises(ValueError, match="act must be one of"):
        BatchNorm(8)(torch.zeros(2, 8), "gelu")
    with pytest.raises(ValueError, match="act must be one of"):
        ConvBN(3, 8, act="gelu")(torch.zeros(1, 4, 4, 3))
