"""The SPNet multi-task detection loss.

Counterpart of `spnet_tpu/ops/losses.py`.  On normalized (B, M) target and
prediction vectors, M = S * 8, per predictor slot:

  pobj      = 1 - y_true[noobj]                    (existence gate, 0/1)
  center    = w.center * pobj * (d_cx^2 + d_cy^2)
  size      = w.size   * pobj * (d_a^2 + d_b^2)
  angle     = w.angle  * pobj * (d_cos2t^2 + d_sin2t^2) * (a_t - b_t)^2
  rings     = w.rings  * pobj * d_rings^2
  noobj     = w.noobj  * d_noobj^2                       (loss_type 'same')
            = w.noobj  * BCE-with-logits(z=y_pred, t=noobj_true)  (hybrid)
  loss      = mean_B( sum_slots(all terms) / M )

and its gradient with respect to y_pred, per slot and variable:

  dloss/dy_pred = pobj * coef[var] * 2 (p - t) / (B M),  coef = the
                  variable's weight (the angle pair times (a_t - b_t)^2);
  noobj lane    = w.noobj * 2 (p - t) / (B M), or w.noobj (sigmoid(p) - t)
                  / (B M) under 'hybrid'.

Plain versions: `loss_components` / `spnet_loss` (the twin) and
`spnet_loss_grad_torch` (the closed-form gradient), the oracles of the
kernels.  The kernels (`csrc/loss.cu`, K2 and K3 in one pass):
  * `spnet_loss_fused`: an autograd function.  Its forward is one launch
    that gives the loss and, when y_pred needs a gradient, the gradient
    too, which it keeps; its backward is one launch that scales the kept
    gradient by the upstream g (`spnet_loss_grad_scale`).  With
    `selective_sigmoid=True` y_pred is the 'ss' head's pre-activation z:
    the same launch applies the selective sigmoid (K4) to it first and
    gives the gradient with respect to z, so the 'ss' training step runs
    no K4 launch of its own.
  * `spnet_loss_fwd(y_true, y_pred)`: the loss alone, one launch.
  * `spnet_loss_bwd(y_true, y_pred, g)`: g * dloss/dy_pred, one launch.
On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.  Launches are counted in
`spnet_loss_fwd.launches` (the loss, with or without the gradient) and
`spnet_loss_bwd.launches` (the standalone gradient and the backward's
scale), and the forward's launches with the selective sigmoid also in
`spnet_loss_fwd.ss_launches`; CPU calls are not counted.

The loss reduces across blocks in the launch itself, through a small
workspace (partials and a counter the kernel leaves at 0) kept per
(device, stream) and made at that stream's first loss call, so a call
can be captured into a CUDA graph once one eager call has run on the
capturing stream.  Two launches on one stream never overlap; a graph that
holds the loss must not be replayed on one stream while the stream it was
captured on runs the loss.
"""

from __future__ import annotations

import functools

import torch

from spnet_tpu_torch.config import (
    IND_A, IND_ANGLE1, IND_ANGLE2, IND_B, IND_CX, IND_CY, IND_NOOBJ,
    IND_RINGS, VARS_PER_PRED, LossWeights,
)
from spnet_tpu_torch.ops._build import load_library, on_device
from spnet_tpu_torch.ops.activations import selective_sigmoid_grad_torch, \
    selective_sigmoid_torch

LOSS_TYPES = ("same", "hybrid")


def loss_components(y_true, y_pred, weights: LossWeights = LossWeights(),
                    loss_type: str = "same") -> dict:
    """Per-component scalar losses: 'center', 'size', 'angle', 'noobj',
    'rings' and their sum 'total' (0-d tensors)."""
    b, m = y_pred.shape
    t = y_true.reshape(b, -1, VARS_PER_PRED)
    p = y_pred.reshape(b, -1, VARS_PER_PRED)
    sq = torch.square(t - p)
    pobj = 1.0 - t[..., IND_NOOBJ]

    center = weights.center * torch.sum(
        pobj * (sq[..., IND_CX] + sq[..., IND_CY]), dim=-1)
    size = weights.size * torch.sum(
        pobj * (sq[..., IND_A] + sq[..., IND_B]), dim=-1)
    abdiff2 = torch.square(t[..., IND_A] - t[..., IND_B])
    angle = weights.angle * torch.sum(
        pobj * (sq[..., IND_ANGLE1] + sq[..., IND_ANGLE2]) * abdiff2, dim=-1)
    rings = weights.rings * torch.sum(pobj * sq[..., IND_RINGS], dim=-1)
    if loss_type == "same":
        noobj = weights.noobj * torch.sum(sq[..., IND_NOOBJ], dim=-1)
    else:
        # numerically stable BCE-with-logits on the raw noobj outputs
        z = p[..., IND_NOOBJ]
        tt = t[..., IND_NOOBJ]
        noobj = weights.noobj * torch.sum(
            torch.clamp_min(z, 0.0) - z * tt
            + torch.log1p(torch.exp(-torch.abs(z))), dim=-1)
    comps = {
        "center": torch.mean(center) / m,
        "size": torch.mean(size) / m,
        "angle": torch.mean(angle) / m,
        "noobj": torch.mean(noobj) / m,
        "rings": torch.mean(rings) / m,
    }
    comps["total"] = (comps["center"] + comps["size"] + comps["angle"]
                      + comps["noobj"] + comps["rings"])
    return comps


def spnet_loss(y_true, y_pred, weights: LossWeights = LossWeights(),
               loss_type: str = "same"):
    """Scalar total loss (the twin of the fused kernels)."""
    return loss_components(y_true, y_pred, weights, loss_type)["total"]


def spnet_loss_grad_torch(y_true, y_pred, weights: LossWeights = LossWeights(),
                          loss_type: str = "same"):
    """dloss/dy_pred in closed form (the plain version of the kernels'
    gradient; the module docstring has the formula).  (B, M) float32."""
    b, m = y_pred.shape
    t = y_true.reshape(b, -1, VARS_PER_PRED)
    p = y_pred.reshape(b, -1, VARS_PER_PRED)
    pobj = 1.0 - t[..., IND_NOOBJ]
    ones = torch.ones_like(pobj)
    angle = weights.angle * torch.square(t[..., IND_A] - t[..., IND_B])
    coef = [None] * VARS_PER_PRED
    coef[IND_CX] = coef[IND_CY] = weights.center * ones
    coef[IND_A] = coef[IND_B] = weights.size * ones
    coef[IND_ANGLE1] = coef[IND_ANGLE2] = angle
    coef[IND_NOOBJ] = 0.0 * ones
    coef[IND_RINGS] = weights.rings * ones
    inv_norm = 1.0 / (b * m)
    grad = pobj[..., None] * torch.stack(coef, dim=-1) * (2.0 * (p - t)) \
        * inv_norm
    z, tt = p[..., IND_NOOBJ], t[..., IND_NOOBJ]
    noobj = (torch.sigmoid(z) - tt if loss_type == "hybrid"
             else 2.0 * (z - tt))
    grad[..., IND_NOOBJ] = weights.noobj * noobj * inv_norm
    return grad.reshape(b, m)


def _check(y_true, y_pred, loss_type: str):
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be one of {LOSS_TYPES}, got "
                         f"{loss_type!r}")
    for name, v in (("y_true", y_true), ("y_pred", y_pred)):
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y_pred.dim() != 2 or y_true.shape != y_pred.shape:
        raise ValueError(f"y_true {tuple(y_true.shape)} and y_pred "
                         f"{tuple(y_pred.shape)} must be the same (B, M)")
    b, m = y_pred.shape
    if b == 0 or m == 0 or m % VARS_PER_PRED:
        raise ValueError(f"(B, M) = {(b, m)}: need B >= 1 and M a positive "
                         f"multiple of {VARS_PER_PRED}")
    if y_true.device != y_pred.device:
        raise ValueError(f"y_true is on {y_true.device}, y_pred on "
                         f"{y_pred.device}")
    if y_pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no loss kernel for device {y_pred.device}")


# Slots per block in csrc/loss.cu (its THREADS): a launch over n slots
# runs loss_blocks(n) blocks, one partial sum each.
LOSS_THREADS = 256


def loss_blocks(n_slots: int) -> int:
    return -(-n_slots // LOSS_THREADS)


@functools.lru_cache(maxsize=None)
def _weight_args(weights: LossWeights, loss_type: str) -> tuple:
    return (weights.center, weights.size, weights.angle, weights.noobj,
            weights.rings, int(loss_type == "hybrid"))


_workspaces: dict = {}  # (device index, stream) -> (partials, counter)
_outgrown: list = []    # kept alive: a captured graph may still use them


def _workspace(index: int, stream: int, blocks: int):
    """The loss's partials and counter for this device and stream, made
    (the counter zeroed) outside any stream capture at the stream's first
    call, and again, at the next power of two, when a call needs more
    partials than they hold."""
    ws = _workspaces.get((index, stream))
    if ws is not None and ws[0].numel() >= blocks:
        return ws
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "spnet loss: the first loss call on a CUDA stream (or the first "
            f"with {blocks} partial sums) is being captured; run it once "
            "eagerly on the capturing stream first, so that its workspace "
            "is made outside the capture")
    if ws is not None:
        _outgrown.append(ws)
    size = max(1024, 1 << (blocks - 1).bit_length())
    ws = (torch.empty(size, dtype=torch.float32, device=f"cuda:{index}"),
          torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}"))
    _workspaces[(index, stream)] = ws
    return ws


def _launch(y_true, y_pred, g, dyp, out, weights: LossWeights,
            loss_type: str, ss: bool = False):
    """One launch of the loss kernel: the loss into `out` and/or the
    gradient (times *g, when g is given) into `dyp`; None for what is not
    wanted.  ss: y_pred is the 'ss' head's pre-activation (the selective
    sigmoid in the same pass)."""
    lib = load_library()
    b, m = y_pred.shape
    n_slots = b * m // VARS_PER_PRED
    index = y_pred.device.index

    def launch(stream):
        workspace = (None, 0, None)
        if out is not None:
            partials, counter = _workspace(index, stream, loss_blocks(n_slots))
            workspace = (partials.data_ptr(), partials.numel(),
                         counter.data_ptr())
        return lib.spnet_loss(
            y_true.data_ptr(), y_pred.data_ptr(),
            None if g is None else g.data_ptr(),
            None if dyp is None else dyp.data_ptr(),
            None if out is None else out.data_ptr(), *workspace, n_slots,
            1.0 / (b * m), *_weight_args(weights, loss_type), int(ss),
            stream)

    err = on_device(index, launch)
    if err != 0:
        raise RuntimeError(f"loss kernel launch failed: CUDA error {err}")


def spnet_loss_fwd(y_true, y_pred, weights: LossWeights = LossWeights(),
                   loss_type: str = "same"):
    """The scalar loss: one launch of the loss kernel (K2) on a CUDA
    tensor, `spnet_loss` on a CPU one.  Returns a 0-d float32 tensor on
    y_pred's device."""
    _check(y_true, y_pred, loss_type)
    if y_pred.device.type == "cpu":
        return spnet_loss(y_true, y_pred, weights, loss_type)
    out = torch.empty((), dtype=torch.float32, device=y_pred.device)
    _launch(y_true, y_pred, None, None, out, weights, loss_type)
    spnet_loss_fwd.launches += 1
    return out


def spnet_loss_bwd(y_true, y_pred, g, weights: LossWeights = LossWeights(),
                   loss_type: str = "same"):
    """d(loss)/d(y_pred) times the upstream gradient g (one float32 on the
    same device): one launch of the loss kernel with the gradient on and
    the loss off (K3) on a CUDA tensor, `spnet_loss_grad_torch` times g on
    a CPU one.  Returns (B, M) float32."""
    _check(y_true, y_pred, loss_type)
    if g.dtype != torch.float32 or g.numel() != 1 or \
            g.device != y_pred.device:
        raise ValueError(f"g must be one float32 on {y_pred.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if y_pred.device.type == "cpu":
        return spnet_loss_grad_torch(y_true, y_pred, weights, loss_type) \
            * g.reshape(())
    dyp = torch.empty_like(y_pred)
    _launch(y_true, y_pred, g, dyp, None, weights, loss_type)
    spnet_loss_bwd.launches += 1
    return dyp


def spnet_loss_grad_scale(grad, g):
    """g * grad for the gradient `grad` (B, M) float32 that
    `spnet_loss_fused`'s forward kept and its upstream gradient g (one
    float32 on the same device): one launch on a CUDA tensor, counted in
    `spnet_loss_bwd.launches`; a product on a CPU one.  A new tensor: a
    second backward of the same graph gives the same gradient."""
    if grad.device.type == "cpu":
        return grad * g
    lib = load_library()
    out = torch.empty_like(grad)
    n_slots = grad.numel() // VARS_PER_PRED
    err = on_device(grad.device.index, lambda stream: (
        lib.spnet_loss_grad_scale(g.data_ptr(), grad.data_ptr(),
                                  out.data_ptr(), n_slots, stream)))
    if err != 0:
        raise RuntimeError(f"loss gradient scale kernel launch failed: CUDA "
                           f"error {err}")
    spnet_loss_bwd.launches += 1
    return out


spnet_loss_fwd.launches = 0
spnet_loss_fwd.ss_launches = 0  # of those, launches of the 'ss' variant
spnet_loss_bwd.launches = 0


def _fused_twin(y_true, y_pred, weights: LossWeights, loss_type: str,
                with_grad: bool, ss: bool):
    """The plain version of the fused forward: the loss and, when asked,
    its closed-form gradient; with `ss`, of the selective sigmoid of
    y_pred, the gradient taken on through the sigmoid's backward."""
    p = selective_sigmoid_torch(y_pred) if ss else y_pred
    loss = spnet_loss(y_true, p, weights, loss_type)
    if not with_grad:
        return loss, None
    grad = spnet_loss_grad_torch(y_true, p, weights, loss_type)
    return loss, selective_sigmoid_grad_torch(p, grad) if ss else grad


class _FusedLoss(torch.autograd.Function):
    """The loss, with the gradient computed in the same pass when y_pred
    needs one (`with_grad`) and kept for the backward, which scales it by
    g (the JAX package's `jax.custom_vjp` around `spnet_loss_pallas`).
    With `ss`, y_pred is the 'ss' head's pre-activation and the gradient
    is with respect to it.  y_true gets no gradient."""

    @staticmethod
    def forward(ctx, y_true, y_pred, weights, loss_type, with_grad, ss):
        if y_pred.device.type == "cpu":
            loss, grad = _fused_twin(y_true, y_pred, weights, loss_type,
                                     with_grad, ss)
        else:
            loss = torch.empty((), dtype=torch.float32, device=y_pred.device)
            grad = torch.empty_like(y_pred) if with_grad else None
            _launch(y_true, y_pred, None, grad, loss, weights, loss_type, ss)
            spnet_loss_fwd.launches += 1
            if ss:
                spnet_loss_fwd.ss_launches += 1
        if grad is not None:
            ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        if not ctx.saved_tensors:  # y_pred needed no gradient
            return None, None, None, None, None, None
        (grad,) = ctx.saved_tensors
        return None, spnet_loss_grad_scale(grad, g), None, None, None, None


def spnet_loss_fused(y_true, y_pred, weights: LossWeights = LossWeights(),
                     loss_type: str = "same",
                     selective_sigmoid: bool = False):
    """Scalar total loss through the fused kernels, differentiable in
    y_pred.  Under `torch.no_grad` / `inference_mode`, or when y_pred needs
    no gradient, no gradient is computed.  selective_sigmoid=True: y_pred
    is the 'ss' head's output before its selective sigmoid, which the
    kernel applies (the loss of `selective_sigmoid_fwd(y_pred)`, the
    gradient with respect to y_pred)."""
    _check(y_true, y_pred, loss_type)
    with_grad = y_pred.requires_grad and torch.is_grad_enabled()
    return _FusedLoss.apply(y_true, y_pred, weights, loss_type, with_grad,
                            selective_sigmoid)
