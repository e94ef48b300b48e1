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
activation, in both modes.  And `onchip_plan`, which path a direction
takes on the card, at the train cells' BatchNorm calls with an H100's
values (`layer_plan` on meta tensors of their shapes)."""

import functools

import pytest
import torch

from spnet_tpu_torch.config import GridSpec, ModelConfig
from spnet_tpu_torch.models.layers import ACTIVATIONS, BatchNorm, ConvBN, \
    Dropout, conv2d_nhwc
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops.batchnorm import ACTS, H100, MAX_CLUSTER, OnChip, \
    _vector_width, batchnorm_grad_torch, batchnorm_train, layer_plan

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


@functools.lru_cache(maxsize=None)
def _census(backbone: str, batch: int) -> tuple:
    """(rows, C) of each train-mode BatchNorm call of SPNet-`backbone` at
    331 and `batch`, bf16, in order: forward pre-hooks on a forward at
    batch 1 on the meta device (its dropouts in eval mode), rows scaled by
    the batch."""
    model = build_model(ModelConfig(backbone=backbone),
                        num_outputs=GridSpec().num_outputs,
                        device="meta").train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()
    calls = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(lambda m, a: calls.append(
                (batch * a[0].numel() // a[0].shape[-1], a[0].shape[-1])))
    with torch.no_grad():
        model(torch.zeros(1, 331, 331, 1, device="meta"))
    return tuple(calls)


def _meta(rows: int, c: int, esize: int = 2):
    dtype = {2: torch.bfloat16, 4: torch.float32}[esize]
    return torch.empty(rows, c, dtype=dtype, device="meta")


def _vw(c: int) -> int:
    return _vector_width(c, _meta(1, c))


def _plan(rows: int, c: int, esize: int = 2, world: int = 1):
    return layer_plan(_meta(rows, c, esize), world=world, card=H100)


#: backbone, the train cell's batch, BatchNorm calls a forward, and the
#: large ones that keep the three-launch path (rows)
CELLS = [("Xception", 16, 43, [435600, 435600, 435600, 107584, 102400,
                               102400, 102400, 25600, 25600]),
         ("InceptionResNetV2", 32, 207, [871200, 871200, 871200, 215168,
                                         204800, 204800, 43808])]


@pytest.mark.parametrize("backbone,batch,calls,large", CELLS)
def test_onchip_plan_takes_all_but_the_large_calls(backbone, batch, calls,
                                                   large):
    """At the train cells' shapes on an H100 every call takes the on-chip
    path but the large ones: Xception's 3-channel stem, its 107,584- and
    102,400-row layers and its two 25,600 x 256; IRv2's six of over
    200,000 rows and its 43,808 x 192 (no K fits their slab within the
    grid's 0.9 blocks an SM)."""
    census = _census(backbone, batch)
    assert len(census) == calls
    old = sorted((rows for rows, c in census if _plan(rows, c) is None),
                 reverse=True)
    assert old == large
    assert calls - len(large) == {"Xception": 34,
                                  "InceptionResNetV2": 200}[backbone]


@pytest.mark.parametrize("backbone,batch", [c[:2] for c in CELLS])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_onchip_plan_never_in_a_group(backbone, batch, world):
    """Inside a group the all-reduce sits between the passes: W > 1 keeps
    the three-launch path at every shape, however small a rank's rows."""
    for rows, c in _census(backbone, batch):
        assert _plan(rows // world, c, world=world) is None


@pytest.mark.parametrize("backbone,batch", [c[:2] for c in CELLS])
def test_onchip_plan_layout(backbone, batch):
    """Each on-chip plan of the census: clusters of at most MAX_CLUSTER
    blocks, a power of two of threads across the group's channels and a
    row of a group at least a 32-byte sector wide where the groups fill a
    third of the card, the groups and rows a block that cover the layer,
    the backward's slab within what the card leaves a block for it,
    and at most 0.9 blocks an SM: one wave."""
    slab, sms = H100
    for rows, c in _census(backbone, batch):
        p = _plan(rows, c)
        if p is None:
            continue
        vw = _vw(c)
        assert 1 <= p.cluster <= MAX_CLUSTER
        assert p.tw in (1, 2, 4, 8, 16, 32)
        wider = -(-(c // vw) // (2 * p.tw))  # the groups a step wider
        assert p.tw * vw * 2 >= 32 or 3 * wider * MAX_CLUSTER < sms
        assert p.groups == -(-(c // vw) // p.tw)
        assert p.rows_per_block == -(-rows // p.cluster)
        assert 2 * p.rows_per_block * p.tw * vw * 2 <= slab
        assert 10 * p.groups * p.cluster <= 9 * sms


@pytest.mark.parametrize("rows,c,plan", [
    (10368, 32, OnChip(8, 1, 4, 1296)),    # IRv2's block35 branches
    (288, 1536, OnChip(4, 8, 24, 72)),     # IRv2's conv_7b
    (2048, 192, OnChip(8, 2, 12, 256)),    # IRv2's block17 branches
    (1600, 728, OnChip(4, 4, 23, 400)),    # Xception's middle flow
    (10368, 256, OnChip(6, 2, 16, 1728)),  # IRv2's 18x18 x 256
    (25600, 128, OnChip(8, 2, 8, 3200)),   # K raised to fit the slab
    (105, 11, OnChip(8, 2, 6, 14)),        # ragged: one channel a thread
])
def test_onchip_plan_as_documented(rows, c, plan):
    assert _plan(rows, c) == plan


@pytest.mark.parametrize("esize", [2, 4])
def test_onchip_plan_limit(esize):
    """The most rows on chip at 64 channels: K = MAX_CLUSTER blocks, one
    thread of 8 channels across (eight groups fill under a third of the
    card), x and dy of each block's rows in what is left of a block's
    shared memory; a row more takes the three-launch path, and so does
    float32 at half the bfloat16 rows."""
    slab, _ = H100
    per = slab // (2 * 8 * esize)
    limit = MAX_CLUSTER * per
    assert limit == {2: 52_736, 4: 26_368}[esize]
    assert _plan(limit, 64, esize) == OnChip(MAX_CLUSTER, 1, 8, per)
    assert _plan(limit + 1, 64, esize) is None
