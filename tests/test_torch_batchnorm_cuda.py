"""The train-mode BatchNorm kernels (`csrc/batchnorm.cu` through
`ops/batchnorm.py::batchnorm_train`) against their plain twin on the card:
`BatchNorm.plain` and the activation, through autograd.  No jax here; run
this file on the card without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_batchnorm_cuda.py -q

Elsewhere every case skips.

Each case checks, in the working type:
  * the statistics against the plain composition's float32 ones: the
    mean 1e-5 of the channel's mean magnitude (float32 sums of up to
    435,600 rows in other orders), rstd and the running variance rel 1e-4
    (the fast variance E[x^2] - E[x]^2 cancels up to ~60x here);
  * the output bitwise against the twin's arithmetic from the kernels'
    own statistics (the same float32 ops, each rounded alike, one rounding
    to the type, the activation on it), and against the plain composition
    within one rounding to the type or 1e-4 of the value, and 1e-4 of the
    output's scale (statistics that differ in their last float32 bits);
  * the running mean against the plain composition's: rel 1e-5;
  * dx, dscale, dbias against `batchnorm_grad_torch` from the kernels'
    statistics (dx within one rounding to the type: the sums s1, s2 differ
    in order; dscale and dbias 1e-5 of the sums of the terms' magnitudes),
    and against autograd of the plain composition (dx within two
    roundings to the type and 1e-4 of its scale: autograd rounds the
    activation's gradient and the statistics' chain in other places;
    dbias 1e-4 of its value and 1e-5 of the largest sum of its terms'
    magnitudes); where the two sides' statistics flip an element's
    activation mask, dx and its channel's dbias besides by that element's
    term, allowed only where the plain pre-activation lies within the
    output's tolerance of the kink, and at most 1e-5 of the elements;
  * the plan's launches a forward and backward (`ops/batchnorm.py::
    layer_plan`): two where the layer fits on chip (one launch a
    direction, both counted in `batchnorm_train.onchip`), six else.
"""

import copy
import math

import pytest
import torch

from spnet_tpu_torch.models.layers import ACTIVATIONS, BatchNorm
from spnet_tpu_torch.ops.batchnorm import H100, MAX_CLUSTER, _act_grad, \
    _card, batchnorm_grad_torch, batchnorm_train, layer_plan

ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
#: where each activation's derivative jumps
KINKS = {"": (), "relu": (0.0,), "relu6": (0.0, 6.0), "leaky": (0.0,)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(c: int, scale: bool, seed: int, device, momentum=0.99):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, momentum=momentum, scale=scale)
    with torch.no_grad():
        if scale:
            bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.3 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(1 + 0.1 * torch.rand(c, generator=g))
    return bn.to(device).train()


def _inputs(shape, dtype, seed: int, device, offset: int = 0):
    """x with per-channel offsets and spreads, and dy; `offset` elements
    into a buffer makes a view whose pointer is not 16-byte aligned."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    spread = torch.linspace(0.2, 3.0, c, device=device)
    shift = torch.linspace(-1.5, 2.5, c, device=device)
    x = torch.randn(shape, generator=g, device=device) * spread + shift
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=device)
    x = buf[offset:].view(shape).copy_(x)
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    return x, dy


def _kernel_run(bn, x, dy, act):
    before = batchnorm_train.launches, batchnorm_train.onchip
    xa = x.detach().requires_grad_(True)  # x's own pointer, aligned or not
    y = bn(xa, act)
    _, stats, _, _ = y.grad_fn.saved_tensors
    y.backward(dy)
    return dict(y=y.detach(), dx=xa.grad, stats=stats.view(3, -1).clone(),
                dw=None if bn.weight is None else bn.weight.grad.clone(),
                db=bn.bias.grad.clone(),
                launches=batchnorm_train.launches - before[0],
                onchip=batchnorm_train.onchip - before[1])


def _onchip(x, dy) -> bool:
    """Whether the plan puts the backward of a layer over x and dy on
    chip, as the wrapper takes it."""
    return layer_plan(x, dy, 1) is not None


def _plain_run(bn, x, dy, act):
    xa = x.detach().clone().requires_grad_(True)
    z = bn.plain(xa)
    y = ACTIVATIONS[act](z)
    y.backward(dy)
    return dict(z=z.detach(), y=y.detach(), dx=xa.grad,
                dw=None if bn.weight is None else bn.weight.grad.clone(),
                db=bn.bias.grad.clone())


def _twin_y(x, stats, bn, act):
    mean, rstd = stats[0], stats[1]
    mul = rstd if bn.weight is None else rstd * bn.weight.detach()
    return ACTIVATIONS[act](((x.float() - mean) * mul
                             + bn.bias.detach()).to(x.dtype))


def _check_case(shape, dtype, act, scale, cuda, offset=0, momentum=0.99,
                update_stats=True):
    c = shape[-1]
    x, dy = _inputs(shape, dtype, sum(shape) + len(act), cuda, offset)
    bn = _layer(c, scale, c, cuda, momentum)
    bn.update_stats = update_stats
    ref = copy.deepcopy(bn)
    running0 = (bn.running_mean.clone(), bn.running_var.clone())
    k = _kernel_run(bn, x, dy, act)
    p = _plain_run(ref, x, dy, act)
    ulp = ULP[dtype]

    xf = x.float()
    rows = x.numel() // c
    mean = xf.reshape(rows, c).mean(0)
    var = (torch.square(xf).reshape(rows, c).mean(0)
           - torch.square(mean)).clamp_min(0)
    mag = xf.abs().reshape(rows, c).mean(0)
    assert ((k["stats"][0] - mean).abs() <= 1e-5 * mag).all()
    torch.testing.assert_close(k["stats"][1], torch.rsqrt(var + bn.eps),
                               rtol=1e-4, atol=0)
    assert torch.equal(k["y"], _twin_y(x, k["stats"], bn, act))
    scale_y = p["y"].float().abs().max()

    def y_tol(v):
        return max(ulp, 1e-4) * v.abs() + 1e-4 * scale_y

    assert ((k["y"].float() - p["y"].float()).abs()
            <= y_tol(p["y"].float())).all()
    if update_stats:
        torch.testing.assert_close(bn.running_mean, ref.running_mean,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bn.running_var, ref.running_var,
                                   rtol=1e-4, atol=1e-6)
    else:
        assert torch.equal(bn.running_mean, running0[0])
        assert torch.equal(bn.running_var, running0[1])

    w = None if bn.weight is None else bn.weight.detach()
    st = k["stats"]
    tdx, tdw, tdb = batchnorm_grad_torch(x, dy, st[0], st[1], st[2], w,
                                         bn.bias.detach(), act)
    scale_dx = tdx.float().abs().max()
    assert ((k["dx"].float() - tdx.float()).abs()
            <= ulp * tdx.float().abs() + 1e-5 * scale_dx).all()
    terms = dy.float().abs().reshape(rows, c).sum(0)
    assert ((k["db"] - tdb).abs() <= 1e-5 * terms).all()
    if scale:
        spread = (xf.reshape(rows, c) - st[0]).abs().max(0).values
        assert ((k["dw"] - tdw).abs() <= 1e-5 * terms * spread
                * st[1]).all()
    # where statistics apart in their last bits put an output on the other
    # side of the activation's kink, the two masks differ and so, by that
    # element's own term (a dy, or 0.9 a dy for leaky), do dx and dbias:
    # only where the plain pre-activation lies within the output's
    # tolerance of a kink, at most 1e-5 of the elements
    ones = torch.ones_like(k["y"])
    flips = _act_grad(ones, k["y"], act) != _act_grad(ones, p["y"], act)
    zp = p["z"].float()
    near = torch.zeros_like(flips)
    for kink in KINKS[act]:
        near |= (zp - kink).abs() <= y_tol(zp)
    n_flips = int(flips.sum())
    assert not (flips & ~near).any(), "a mask flip away from the kink"
    assert n_flips <= math.ceil(1e-5 * flips.numel()), f"{n_flips} flips"
    mul = st[1] if w is None else st[1] * w
    jump = flips * (mul * dy.float()).abs()
    assert ((k["dx"].float() - p["dx"].float()).abs()
            <= 2 * ulp * p["dx"].float().abs() + 1e-4 * scale_dx
            + jump).all(), f"{n_flips} mask flips"
    hit = flips.reshape(rows, c).any(0)
    torch.testing.assert_close(k["db"][~hit], p["db"][~hit], rtol=1e-4,
                               atol=1e-5 * float(terms.max()))
    flipped = (flips * dy.float().abs()).reshape(rows, c).sum(0)
    assert ((k["db"] - p["db"]).abs() <= 1e-4 * p["db"].abs()
            + 1e-5 * terms.max() + flipped)[hit].all()
    onchip = _onchip(x, dy)
    assert (k["launches"], k["onchip"]) == ((2, 2) if onchip else (6, 0))
    return onchip


# (shape, activation as the model has it there)
MODEL_SHAPES = [
    ((16, 165, 165, 3), "leaky"),   # the stem: 3 channels, scalar path
    ((16, 80, 80, 128), ""),        # Xception's largest train BatchNorm
    ((16, 82, 82, 32), "relu"),     # conv1 (ConvBN, ReLU)
    ((16, 10, 10, 728), ""),        # the middle flow
    ((16, 5, 5, 2048), "relu"),     # the exit flow's last
    ((16, 163, 163, 128), ""),      # larger than the L2
    ((16, 21, 21, 728), ""),
    ((16, 11, 11, 2048), "relu"),
    ((16, 83, 83, 8), "relu6"),     # MobileNetTiny's 8-channel layers
    ((16, 41, 41, 44), "relu"),     # NASNet's 44 channels: 4 a thread
    ((3, 7, 5, 11), ""),            # ragged: 11 channels, 105 rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,act", MODEL_SHAPES)
def test_kernels_match_twin_bf16(cuda, shape, act):
    _check_case(shape, torch.bfloat16, act, True, cuda)


#: Inception-ResNet-v2's gamma-less layers (Keras `scale=False`) at the
#: 25-epoch sweep's b=32 and 331 input, each with the ReLU it has there
IRV2_SHAPES = [
    (32, 82, 82, 32),      # stem1
    (32, 18, 18, 32),      # a block35 branch
    (32, 8, 8, 192),       # a block17 branch
    (32, 3, 3, 384),       # mixed_7a
    (32, 3, 3, 1536),      # conv_7b
    (32, 37, 37, 192),     # three launches: no K fits the grid's bound
    (32, 39, 39, 80),      # on chip, near the limit
    (32, 80, 80, 64),      # three launches: over the limit
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", IRV2_SHAPES)
def test_gammaless_kernels_at_irv2_shapes_bf16(cuda, shape):
    _check_case(shape, torch.bfloat16, "relu", False, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["", "relu", "relu6", "leaky"])
@pytest.mark.parametrize("scale", [True, False])
def test_each_activation_and_scale(cuda, act, scale):
    _check_case((16, 20, 20, 256), torch.bfloat16, act, scale, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,act", [((16, 40, 40, 256), "relu"),
                                       ((4, 33, 33, 3), "leaky")])
def test_kernels_match_twin_float32(cuda, shape, act):
    """float32 activations (`backbone_dtype` splits, float32 runs)."""
    _check_case(shape, torch.float32, act, True, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(8, 20, 20), (16, 82, 82)])
def test_misaligned_view_and_frozen_stats(cuda, hw):
    """A view one element into its buffer takes the narrower loads; the
    recompute of a checkpointed backbone leaves the running statistics;
    NASNet's momentum: on chip (3,200 rows) and on the three-launch path
    (107,584 rows; the misaligned view's path is the plan's for one
    channel a thread)."""
    onchip = hw[1] == 20
    _check_case((*hw, 128), torch.bfloat16, "relu", True, cuda, offset=1)
    assert _check_case((*hw, 128), torch.bfloat16, "", True, cuda,
                       update_stats=False) == onchip
    assert _check_case((*hw, 88), torch.bfloat16, "relu", False, cuda,
                       momentum=0.9997) == onchip


def _bf16_plan(rows: int, c: int, device):
    """The plan of a bf16 (rows, c) layer, its pointers aligned, on this
    card."""
    x = torch.empty(rows, c, dtype=torch.bfloat16, device="meta")
    return layer_plan(x, world=1, card=_card(device.index or 0))


def _onchip_limit(c: int, device) -> int:
    """The most rows of a bf16 (rows, c) layer that the plan puts on
    chip on this card."""
    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _bf16_plan(mid, c, device) is None:
            hi = mid
        else:
            lo = mid
    return lo


@pytest.mark.cuda
def test_an_h100_reports_the_plans_card(cuda):
    """The values the CPU tests of the plan take (`ops/batchnorm.py::H100`)
    are what an H100 reports: its SMs, and the shared memory a block of
    the on-chip kernels may give its slab beside their static arrays."""
    if "H100" not in torch.cuda.get_device_name(cuda):
        pytest.skip("the plan's CPU tests take an H100's values")
    assert _card(cuda.index or 0) == H100


@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 1])
def test_at_the_onchip_limit(cuda, past):
    """bf16 just under the most rows the plan puts on chip (K =
    MAX_CLUSTER, the slab filling the shared memory), and one row over
    (the three-launch path)."""
    limit = _onchip_limit(64, cuda)
    assert _bf16_plan(limit, 64, cuda).cluster == MAX_CLUSTER
    assert _check_case((limit + past, 64), torch.bfloat16, "relu", False,
                       cuda) == (not past)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 20, 20, 256), (16, 40, 40, 256)])
def test_graph_replays_the_eager_bits(cuda, shape):
    """A forward and backward captured in a CUDA graph and replayed gives
    the eager call's output and gradients bitwise (no atomics: the sums'
    order is fixed by the shape), on chip (6,400 rows) and on the
    three-launch path (25,600 rows)."""
    x, dy = _inputs(shape, torch.bfloat16, 1, cuda)
    assert _onchip(x, dy) == (shape[1] == 20)
    bn = _layer(shape[-1], True, 1, cuda)
    bn.update_stats = False
    eager = _kernel_run(bn, x, dy, "relu")
    xa = x.detach().clone().requires_grad_(True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            bn.weight.grad = bn.bias.grad = xa.grad = None
            bn(xa, "relu").backward(dy)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    bn.weight.grad = bn.bias.grad = xa.grad = None
    with torch.cuda.graph(graph):
        y = bn(xa, "relu")
        y.backward(dy)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager["y"])
        assert torch.equal(xa.grad, eager["dx"])
        assert torch.equal(bn.weight.grad, eager["dw"])
        assert torch.equal(bn.bias.grad, eager["db"])


@pytest.mark.cuda
def test_eval_mode_and_cpu_take_no_kernel(cuda):
    bn = _layer(64, True, 2, cuda).eval()
    x, _ = _inputs((4, 9, 9, 64), torch.bfloat16, 2, cuda)
    before = batchnorm_train.launches
    y = bn(x, "relu")
    assert batchnorm_train.launches == before
    assert torch.equal(y, torch.relu(bn.plain(x)))
