"""Train-mode (batch-statistics) BatchNorm with the activation after it,
on the card.

`models/layers.py::BatchNorm` takes `batchnorm_train` in train mode on a
CUDA tensor; its plain composition (flax's arithmetic as float32 torch
ops, `BatchNorm.plain`, then the activation) is the twin of these kernels
and the only path on the CPU and in eval mode.  Four parts:

  * `batchnorm_train(x, bn, act)`: the kernels of `csrc/batchnorm.cu`
    through `BatchNormTrain`, an autograd function.  Forward: the stats
    pass, the finalize (batch statistics and the running-statistic update
    unless `bn.update_stats` is off), the normalize pass with the
    activation.  Backward: the sums pass, the finalize (dscale, dbias and
    the dx coefficients), the dx pass.  Inside a process group of W > 1
    ranks the moments [E x, E x^2] are all-reduced between the stats and
    the finalize, and the two sums between the backward's finalize and dx
    pass, as the plain composition's autograd-aware all-reduce does.  A
    direction whose rows fit on chip (`onchip_plan`) runs as one launch
    instead, a cluster of blocks per channel group that keeps its slab in
    shared memory between the reduction and the elementwise pass.  It
    saves x and the (3, C) float32 statistics (mean, rstd, and 0 where the
    fast variance was clamped): no float32 copy of the activation.  On a
    CUDA tensor it launches or raises; `.launches` counts the kernels
    launched (three a direction, four with a group, one on chip) and
    `.onchip` the directions that took the one-launch path.
  * `onchip_plan`: which path a direction takes, from its shape, the
    world size and the card; `layer_plan` applies it to a layer's
    tensors, for the wrapper and for whatever counts its launches.
  * `batchnorm_grad_torch`: the backward's formula in plain PyTorch, the
    kernels' arithmetic step for step (tests hold it against autograd of
    the plain composition in float64, and the kernels against it).
  * `ACTS`: the activations the normalize pass applies, by name, with the
    kernels' code of each (`csrc/batchnorm.cu`'s ACT_* mirror it);
    `models/layers.py::ACTIVATIONS` takes its names from here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from spnet_tpu_torch.ops._build import load_library, on_device
from spnet_tpu_torch.parallel import mesh

#: activation name -> the kernels' code; "leaky" is LeakyReLU(0.1)
ACTS = {"": 0, "relu": 1, "relu6": 2, "leaky": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _act_grad(d, z, act: str):
    """d through the derivative of `act` at z, in d's dtype, as torch's
    backward of relu, relu6 (hardtanh) and leaky_relu(0.1) computes it."""
    if act == "relu":
        return torch.where(z > 0, d, torch.zeros_like(d))
    if act == "relu6":
        return torch.where((z > 0) & (z < 6), d, torch.zeros_like(d))
    if act == "leaky":
        return torch.where(z > 0, d, d * 0.1)
    return d


def batchnorm_grad_torch(x, dy, mean, rstd, keep, weight, bias,
                         act: str = "", n: int | None = None):
    """The backward of `batchnorm_train` as its kernels compute it: x and
    dy (..., C), the forward's per-channel mean, rstd and keep (1, or 0
    where E[x^2] - E[x]^2 < 0 was clamped), weight (None without a scale)
    and bias.  Returns (dx in x's dtype, dweight or None, dbias).

    z = x's-dtype((x - mean) * mul + bias) with mul = rstd * weight is
    recomputed for the activation's mask, g is dy through it, and with
    s1 = sum g, s2 = sum g (x - mean) over the rows: dbias = s1,
    dweight = s2 * rstd, dx = a g - (c (x - mean) + b) with a = mul,
    b = a s1 / n, c = keep a rstd^2 s2 / n.  n is the rows' count (a
    group's count, with s1, s2 its sums, on the card).  Sums in float32
    for float32 and bfloat16 inputs, float64 for float64."""
    acc = torch.promote_types(x.dtype, torch.float32)
    c = x.shape[-1]
    xf = x.reshape(-1, c).to(acc)
    d = dy.reshape(-1, c)
    mul = rstd if weight is None else rstd * weight
    if act:
        d = _act_grad(d, ((xf - mean) * mul + bias).to(x.dtype), act)
    g = d.to(acc)
    xm = xf - mean
    s1, s2 = g.sum(0), (g * xm).sum(0)
    n = xf.shape[0] if n is None else n
    b = mul * s1 / n
    cc = keep * mul * rstd * rstd * s2 / n
    dx = (mul * g - (cc * xm + b)).to(x.dtype).reshape(x.shape)
    return dx, None if weight is None else s2 * rstd, s1


#: threads a block of every kernel (`csrc/batchnorm.cu`'s THREADS)
THREADS = 256
#: the most blocks a cluster of the on-chip kernels: the portable size
MAX_CLUSTER = 8
#: the narrowest row of a group that still fills a 32-byte sector
SECTOR_BYTES = 32
#: (bytes a block of the on-chip kernels may give its backward slab, SMs)
#: as an H100 80GB reports them (`_card`): the card whose sweep set
#: `onchip_plan`
H100 = (210_944, 132)


class OnChip(NamedTuple):
    """The one-launch layout of a direction: `groups` clusters, one a
    group of `tw` * vw channels, each of `cluster` blocks over
    `rows_per_block` rows (the last block's may be fewer)."""
    cluster: int
    tw: int
    groups: int
    rows_per_block: int


@functools.lru_cache(maxsize=None)
def onchip_plan(rows: int, c: int, vw: int, esize: int, world: int,
                slab_bytes: int, sms: int) -> OnChip | None:
    """The on-chip layout of a (rows, C) layer at vector width vw and
    element size esize, or None for the three-launch path, on a card that
    leaves a block `slab_bytes` of shared memory for the backward's slab
    and has `sms` SMs.  Set from a sweep of every (tw, K) at the train
    cells' shapes on an H100 (PERF.md):

    * None inside a process group (world > 1: the all-reduce sits between
      the reduction and the elementwise pass).
    * tw, the group's threads across channels: the widest power of two up
      to 32 (a warp reading 32 * vw contiguous channels of a row) at which
      the groups at K = MAX_CLUSTER still fill the card's `sms` SMs; but
      not below one 32-byte sector of a row unless the groups would then
      fill under a third of the card (a narrower row reads each sector
      half: 2048 x 128 took 9.0 µs at two threads, 10.0 at one).
    * K: about three quarters of the card in blocks (sms * 3 / 4 //
      groups, at most MAX_CLUSTER, at least 1), raised until the
      backward's slab (x and dy of rows / K rows of the group) fits
      `slab_bytes`; the grid stays within 0.9 blocks an SM, so that even
      at one block an SM every cluster is resident at once (an H100 then
      holds clusters of 4 or 8 on 120 of its 132 SMs; a grid of more ran
      in two waves: 32x37x37x192 took 120 µs on chip, 80 on the
      three-launch path).  Where no K fits, one thread fewer across a
      group, down to one; then None."""
    if world != 1:
        return None
    v = c // vw

    def groups(tw: int) -> int:
        return -(-v // tw)

    tw = min(32, 1 << (v - 1).bit_length())
    while tw > 1 and groups(tw) * MAX_CLUSTER < sms and (
            tw // 2 * vw * esize >= SECTOR_BYTES
            or 3 * groups(tw) * MAX_CLUSTER < sms):
        tw //= 2
    while True:
        g = groups(tw)
        first = max(1, min(MAX_CLUSTER, 3 * sms // 4 // g, rows))
        for k in range(first, MAX_CLUSTER + 1):
            if 10 * g * k > 9 * sms:
                break
            per = -(-rows // k)
            if 2 * per * tw * vw * esize <= slab_bytes:
                return OnChip(k, tw, g, per)
        if tw == 1:
            return None
        tw //= 2


@functools.lru_cache(maxsize=None)
def _card(device_index: int) -> tuple[int, int]:
    """(bytes a block of the on-chip kernels may give its backward slab,
    SMs) of the card, as `onchip_plan` takes them."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    fn = load_library().spnet_batchnorm_onchip_smem
    slab = on_device(device_index, lambda stream: fn(device_index))
    if slab <= 0:
        raise RuntimeError(f"cannot read the shared memory of cuda:"
                           f"{device_index}")
    return slab, sms


def layer_plan(x, dy=None, world: int | None = None,
               card: tuple[int, int] | None = None) -> OnChip | None:
    """The path of a direction of `batchnorm_train` over x (..., C), and
    dy for the backward: `onchip_plan` at the vector width that C and
    their pointers allow (`_vector_width`; a meta tensor's pointer counts
    as aligned), in a group of `world` ranks (default: the mesh's), on
    the card that holds x, or on `card` (slab bytes, SMs) where given."""
    c = x.shape[-1]
    world = mesh.world_size() if world is None else world
    card = _card(x.device.index) if card is None else card
    vw = _vector_width(c, x) if dy is None else _vector_width(c, x, dy)
    return onchip_plan(x.numel() // c, c, vw, x.element_size(), world,
                       *card)


@functools.lru_cache(maxsize=None)
def _splits(rows: int, c: int, vw: int, device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return load_library().spnet_batchnorm_splits(rows, c, vw, sms)


def _vector_width(c: int, *tensors) -> int:
    """The widest of 8, 4, 2, 1 channels a thread that divides C and the
    alignment of every tensor's data pointer."""
    esize = tensors[0].element_size()
    for vw in (8, 4, 2):
        if c % vw == 0 and all(t.data_ptr() % (vw * esize) == 0
                               for t in tensors):
            return vw
    return 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, device_index: int, *args):
    fn = getattr(load_library(), f"spnet_batchnorm_{name}")
    err = on_device(device_index, lambda stream: fn(*args, stream))
    if err != 0:
        raise RuntimeError(f"batchnorm {name} kernel launch failed: CUDA "
                           f"error {err}")
    batchnorm_train.launches += 1


def _check(x, bn, act: str):
    if x.device.type != "cuda":
        raise ValueError(f"batchnorm_train runs on a CUDA tensor, got "
                         f"{x.device}: the plain composition "
                         f"(BatchNorm.plain) is the CPU's path")
    if x.dtype not in _DTYPES:
        raise TypeError(f"batchnorm_train takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    c = bn.bias.shape[0]
    if x.dim() < 2 or x.shape[-1] != c or x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)}: need (..., {c}) with rows")
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if t is not None and (t.device != x.device or t.dtype !=
                              torch.float32 or not t.is_contiguous()):
            raise ValueError(f"bn.{name} must be contiguous float32 on "
                             f"{x.device}")


def batchnorm_train(x, bn, act: str = ""):
    """`act`(BatchNorm `bn` in train mode)(x) through the kernels, with
    autograd: x (..., C) float32 or bfloat16 on the card, bn a
    `models/layers.py::BatchNorm` (its eps, momentum, update_stats, scale,
    bias and running statistics), act one of `ACTS`."""
    _check(x, bn, act)
    return BatchNormTrain.apply(x, bn.weight, bn.bias, bn, act)


batchnorm_train.launches = 0
batchnorm_train.onchip = 0


class BatchNormTrain(torch.autograd.Function):
    """Forward and backward of `batchnorm_train` (see the module's
    docstring); weight and bias are the autograd inputs beside x, `bn`
    gives the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, act):
        x = x.contiguous()
        c = x.shape[-1]
        rows = x.numel() // c
        dev = x.device.index
        dtype = _DTYPES[x.dtype]
        vw = _vector_width(c, x)
        n_ranks = mesh.world_size()
        f32 = dict(dtype=torch.float32, device=x.device)
        stats = torch.empty(3 * c, **f32)
        running = (bn.running_mean, bn.running_var) if bn.update_stats \
            else (None, None)
        m = bn.momentum
        y = torch.empty_like(x)
        plan = layer_plan(x, world=n_ranks)
        if plan is not None:
            _launch("onchip_fwd", dev, x.data_ptr(), _ptr(weight),
                    bias.data_ptr(), y.data_ptr(), stats.data_ptr(),
                    *map(_ptr, running), rows, c, dtype, vw, plan.tw,
                    plan.cluster, 1.0 / rows, m, 1 - m, bn.eps, ACTS[act])
            batchnorm_train.onchip += 1
        else:
            splits = _splits(rows, c, vw, dev)
            part = torch.empty(splits * 2 * c, **f32)
            _launch("stats", dev, x.data_ptr(), part.data_ptr(), rows, c,
                    dtype, vw, splits)
            finish = (stats.data_ptr(), *map(_ptr, running), m, 1 - m,
                      bn.eps)
            if n_ranks > 1:
                moments = torch.empty(2 * c, **f32)
                _launch("finalize", dev, part.data_ptr(), splits, c,
                        1.0 / rows, None, 1.0, moments.data_ptr(), None,
                        None, None, m, 1 - m, bn.eps)
                dist.all_reduce(moments)
                _launch("finalize", dev, None, 0, c, 1.0,
                        moments.data_ptr(), float(n_ranks), None, *finish)
            else:
                _launch("finalize", dev, part.data_ptr(), splits, c,
                        1.0 / rows, None, 1.0, None, *finish)
            _launch("apply", dev, x.data_ptr(), stats.data_ptr(),
                    _ptr(weight), bias.data_ptr(), y.data_ptr(), rows, c,
                    dtype, vw, splits, ACTS[act])
        if bn.update_stats:
            for t in running:
                torch.autograd.graph.increment_version(t)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.act, ctx.n_ranks = ACTS[act], n_ranks
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats, weight, bias = ctx.saved_tensors
        dy = dy.contiguous()
        c = x.shape[-1]
        rows = x.numel() // c
        dev = x.device.index
        dtype = _DTYPES[x.dtype]
        dx = torch.empty_like(x)
        vw = _vector_width(c, x, dy)
        f32 = dict(dtype=torch.float32, device=x.device)
        dbias = torch.empty(c, **f32)
        dweight = None if weight is None else torch.empty(c, **f32)
        plan = layer_plan(x, dy, ctx.n_ranks)
        if plan is not None:
            _launch("onchip_bwd", dev, x.data_ptr(), dy.data_ptr(),
                    stats.data_ptr(), _ptr(weight), bias.data_ptr(),
                    dx.data_ptr(), _ptr(dweight), dbias.data_ptr(), rows, c,
                    dtype, vw, plan.tw, plan.cluster, 1.0 / rows, ctx.act)
            batchnorm_train.onchip += 1
            return dx, dweight, dbias, None, None
        splits = _splits(rows, c, vw, dev)
        part = torch.empty(splits * 2 * c, **f32)
        coef = torch.empty(3 * c, **f32)
        _launch("grad_sums", dev, x.data_ptr(), dy.data_ptr(),
                stats.data_ptr(), _ptr(weight), bias.data_ptr(),
                part.data_ptr(), rows, c, dtype, vw, splits, ctx.act)
        sums = None
        if ctx.n_ranks > 1:
            sums = torch.empty(2 * c, **f32)
            _launch("grad_finalize", dev, part.data_ptr(), splits, c, None,
                    sums.data_ptr(), _ptr(dweight), dbias.data_ptr(),
                    stats.data_ptr(), _ptr(weight), 1.0, None)
            dist.all_reduce(sums)
            part = None
        _launch("grad_finalize", dev, _ptr(part), splits, c, _ptr(sums),
                None, _ptr(dweight), dbias.data_ptr(), stats.data_ptr(),
                _ptr(weight), 1.0 / (rows * ctx.n_ranks), coef.data_ptr())
        _launch("grad_dx", dev, x.data_ptr(), dy.data_ptr(),
                stats.data_ptr(), _ptr(weight), bias.data_ptr(),
                coef.data_ptr(), dx.data_ptr(), rows, c, dtype, vw, splits,
                ctx.act)
        return dx, dweight, dbias, None, None
