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

Two implementations:
  * `loss_components` / `spnet_loss`: the plain PyTorch twin (and the
    oracle of the kernels).
  * `spnet_loss_fused`: an autograd function whose forward is the wrapper
    `spnet_loss_fwd` (kernel K2, `csrc/loss.cu`) and whose backward is the
    wrapper `spnet_loss_bwd` (kernel K3).  On a CUDA tensor each wrapper
    launches its kernel or raises; on a CPU tensor it runs the twin (the
    forward, or the twin's autograd gradient).  Each wrapper counts its
    kernel launches in `.launches`; CPU calls are not counted.
"""

from __future__ import annotations

import torch

from spnet_tpu_torch.config import (
    IND_A, IND_ANGLE1, IND_ANGLE2, IND_B, IND_CX, IND_CY, IND_NOOBJ,
    IND_RINGS, VARS_PER_PRED, LossWeights,
)

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


def _kernel_args(y_pred, weights: LossWeights, loss_type: str):
    b, m = y_pred.shape
    return (b * m // VARS_PER_PRED, 1.0 / (b * m), weights.center,
            weights.size, weights.angle, weights.noobj, weights.rings,
            int(loss_type == "hybrid"))


def spnet_loss_fwd(y_true, y_pred, weights: LossWeights = LossWeights(),
                   loss_type: str = "same"):
    """The scalar loss: kernel K2 on a CUDA tensor, `spnet_loss` on a CPU
    one.  Returns a 0-d float32 tensor on y_pred's device."""
    _check(y_true, y_pred, loss_type)
    if y_pred.device.type == "cpu":
        return spnet_loss(y_true, y_pred, weights, loss_type)
    from spnet_tpu_torch.ops._build import load_library

    lib = load_library()
    args = _kernel_args(y_pred, weights, loss_type)
    n_partials = lib.spnet_loss_fwd_partials(args[0])
    partials = torch.empty(n_partials, dtype=torch.float32,
                           device=y_pred.device)
    out = torch.empty((), dtype=torch.float32, device=y_pred.device)
    with torch.cuda.device(y_pred.device):
        stream = torch.cuda.current_stream(y_pred.device).cuda_stream
        err = lib.spnet_loss_fwd(y_true.data_ptr(), y_pred.data_ptr(),
                                 partials.data_ptr(), n_partials,
                                 out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"loss forward kernel launch failed: CUDA error "
                           f"{err}")
    spnet_loss_fwd.launches += 1
    return out


def spnet_loss_bwd(y_true, y_pred, g, weights: LossWeights = LossWeights(),
                   loss_type: str = "same"):
    """d(loss)/d(y_pred) times the upstream gradient g (a 0-d float32
    tensor on the same device): kernel K3 on a CUDA tensor, the twin's
    autograd gradient on a CPU one.  Returns (B, M) float32."""
    _check(y_true, y_pred, loss_type)
    if g.dtype != torch.float32 or g.numel() != 1 or \
            g.device != y_pred.device:
        raise ValueError(f"g must be one float32 on {y_pred.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if y_pred.device.type == "cpu":
        with torch.enable_grad():
            yp = y_pred.detach().requires_grad_(True)
            loss = spnet_loss(y_true.detach(), yp, weights, loss_type)
            (grad,) = torch.autograd.grad(loss, yp)
        return grad * g.reshape(())
    from spnet_tpu_torch.ops._build import load_library

    lib = load_library()
    g = g.reshape(()).contiguous()
    dyp = torch.empty_like(y_pred)
    with torch.cuda.device(y_pred.device):
        stream = torch.cuda.current_stream(y_pred.device).cuda_stream
        err = lib.spnet_loss_bwd(y_true.data_ptr(), y_pred.data_ptr(),
                                 g.data_ptr(), dyp.data_ptr(),
                                 *_kernel_args(y_pred, weights, loss_type),
                                 stream)
    if err != 0:
        raise RuntimeError(f"loss backward kernel launch failed: CUDA error "
                           f"{err}")
    spnet_loss_bwd.launches += 1
    return dyp


spnet_loss_fwd.launches = 0
spnet_loss_bwd.launches = 0


class _FusedLoss(torch.autograd.Function):
    """Forward K2, backward K3 (the JAX package's `jax.custom_vjp` around
    `spnet_loss_pallas`).  y_true gets no gradient."""

    @staticmethod
    def forward(ctx, y_true, y_pred, weights, loss_type):
        ctx.save_for_backward(y_true, y_pred)
        ctx.weights, ctx.loss_type = weights, loss_type
        return spnet_loss_fwd(y_true, y_pred, weights, loss_type)

    @staticmethod
    def backward(ctx, g):
        y_true, y_pred = ctx.saved_tensors
        dyp = spnet_loss_bwd(y_true, y_pred, g.float(), ctx.weights,
                             ctx.loss_type)
        return None, dyp, None, None


def spnet_loss_fused(y_true, y_pred, weights: LossWeights = LossWeights(),
                     loss_type: str = "same"):
    """Scalar total loss through the fused kernels, differentiable in
    y_pred."""
    return _FusedLoss.apply(y_true, y_pred, weights, loss_type)
