"""Selective (strided) sigmoid: sigmoid on the noobj variable of every
8-wide predictor slot, identity on the other seven.

Counterpart of `spnet_tpu/ops/activations.py` (reference model_type 'ss').
On a (B, M) float32 head output, M = S * 8:

  y[..., s*8 + 6] = sigmoid(x[..., s*8 + 6]),  y = x elsewhere
  dx              = g * (y * (1 - y)) on lane 6,  g elsewhere

Three parts:
  * `selective_sigmoid_torch` / `selective_sigmoid_grad_torch`: the plain
    twins (and the oracles of the kernels).
  * `selective_sigmoid_fwd` / `selective_sigmoid_bwd`: the wrappers of
    kernel K4's forward and backward (`csrc/activations.cu`).  On a CUDA
    tensor each launches its kernel or raises; on a CPU tensor each runs its
    twin.  Each counts its kernel launches in `.launches`; CPU calls are not
    counted.
  * `SelectiveSigmoid`: the autograd function over the two wrappers, which
    the model's 'ss' head applies.  Its backward skips the checks: it gets
    the tensors its forward checked.
On the 'ss' training step the loss kernel applies the selective sigmoid
in its own pass (`ops/losses.py::spnet_loss_fused`, selective_sigmoid=True)
and the model leaves it out, so these kernels serve predict, evaluate and
the paths that do not take the fused loss.
"""

from __future__ import annotations

import torch

from spnet_tpu_torch.config import IND_NOOBJ, VARS_PER_PRED
from spnet_tpu_torch.ops._build import load_library, on_device


def _noobj_lanes(x):
    return torch.arange(x.shape[-1], device=x.device) % VARS_PER_PRED \
        == IND_NOOBJ


def selective_sigmoid_torch(x):
    """Plain twin of `selective_sigmoid_jnp`; x (..., M), M % 8 == 0."""
    return torch.where(_noobj_lanes(x), torch.sigmoid(x), x)


def selective_sigmoid_grad_torch(y, g):
    """Plain twin of the backward: y is the forward's output, g the
    upstream gradient."""
    return torch.where(_noobj_lanes(y), g * (y * (1.0 - y)), g)


def _check(*named):
    """Each (name, tensor) is (B, M) float32, contiguous, M % 8 == 0, all
    of one shape on one CPU or CUDA device."""
    first_name, first = named[0]
    for name, v in named:
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.shape != first.shape:
            raise ValueError(f"{name} {tuple(v.shape)} and {first_name} "
                             f"{tuple(first.shape)} must be the same (B, M)")
        if v.device != first.device:
            raise ValueError(f"{name} is on {v.device}, {first_name} on "
                             f"{first.device}")
    if first.dim() != 2:
        raise ValueError(f"{first_name} must be (B, M), got "
                         f"{tuple(first.shape)}")
    b, m = first.shape
    if b == 0 or m == 0 or m % VARS_PER_PRED:
        raise ValueError(f"(B, M) = {(b, m)}: need B >= 1 and M a positive "
                         f"multiple of {VARS_PER_PRED}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no selective-sigmoid kernel for device "
                         f"{first.device}")


def _launch(fn_name: str, out, *inputs):
    fn = getattr(load_library(), fn_name)
    n_slots = out.numel() // VARS_PER_PRED
    ptrs = [v.data_ptr() for v in inputs]
    err = on_device(out.device.index, lambda stream: fn(
        *ptrs, out.data_ptr(), n_slots, stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def selective_sigmoid_fwd(x):
    """The selective sigmoid of x (B, M) float32: kernel K4 on a CUDA
    tensor, the twin on a CPU one."""
    _check(("x", x))
    if x.device.type == "cpu":
        return selective_sigmoid_torch(x)
    y = _launch("spnet_selective_sigmoid_fwd", torch.empty_like(x), x)
    selective_sigmoid_fwd.launches += 1
    return y


def selective_sigmoid_bwd(y, g):
    """Its gradient from the forward's output y and the upstream gradient
    g (both (B, M) float32): K4's backward kernel on a CUDA tensor, the
    twin on a CPU one."""
    _check(("y", y), ("g", g))
    return _bwd(y, g)


def _bwd(y, g):
    """selective_sigmoid_bwd without the checks."""
    if y.device.type == "cpu":
        return selective_sigmoid_grad_torch(y, g)
    dx = _launch("spnet_selective_sigmoid_bwd", torch.empty_like(g), y, g)
    selective_sigmoid_bwd.launches += 1
    return dx


selective_sigmoid_fwd.launches = 0
selective_sigmoid_bwd.launches = 0


class SelectiveSigmoid(torch.autograd.Function):
    """Forward `selective_sigmoid_fwd`, backward `selective_sigmoid_bwd`
    from the saved output (unchecked: the forward checked y, and g has
    its shape, dtype and device)."""

    @staticmethod
    def forward(ctx, x):
        y = selective_sigmoid_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _bwd(y, g.contiguous())
