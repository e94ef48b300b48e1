"""Adam, in the two update semantics of the JAX package.

Counterpart of `spnet_tpu/train/optim.py` and of the `optax.adam` that
`spnet_tpu/train/state.py::make_optimizer` builds by default:

  optax.adam (the default):
      lr   = schedule(count)                         count 0-based
      p   -= lr * m_hat / (sqrt(v_hat) + eps)        v_hat bias-corrected

  Keras (`keras_adam`, opt-in):
      lr_t = schedule(count) * sqrt(1 - b2^t) / (1 - b1^t),  t = count + 1
      p   -= lr_t * m / (sqrt(v) + eps)              v uncorrected

Both keep `count` in the optimizer state, as optax and `keras_adam` do,
so a fresh state (`unfreeze`) restarts the schedule the update applies at
schedule(0) while the train state's step carries on.  The updates are
plain functions over lists of float32 tensors, applied in place under
`no_grad`: on CUDA tensors by one kernel over every leaf
(`ops/adam.py::adam_apply`), on the CPU by PyTorch's multi-tensor
(`_foreach`) passes, `foreach_update`, which are also the kernel's plain
twin (the kernel gives their bits).  A parameter whose moments are None is
frozen: its update is zero, as under optax's `multi_transform` +
`set_to_zero`.

The arithmetic reads no host number that changes from step to step, so a
CUDA graph of the step replays it (`train/steps.py::make_train_epoch`):
the count has a float32 mirror `t` on the parameters' device, which the
update advances, and the bias corrections 1 - b^t are taken from it in
float32, as optax takes them; the learning rate enters as a 0-d float32
tensor (`*_adam_apply`).  `*_adam_update` evaluates schedule(count) on
the host and applies that: one formulation for the eager and the graphed
step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from spnet_tpu_torch.ops.adam import adam_apply

B1, B2, EPS = 0.9, 0.999, 1e-7  # eps: Keras's K.epsilon(), as in JAX


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied since init
    mu: list  # first moments, None for a frozen parameter
    nu: list  # second moments, None for a frozen parameter
    t: torch.Tensor  # count as a 0-d float32 on the parameters' device


def adam_init(params, trainable=None) -> AdamState:
    """Zero moments for every trainable parameter (all when trainable is
    None), None for the others; count 0."""
    if trainable is None:
        trainable = [True] * len(params)
    mu = [torch.zeros_like(p) if t else None
          for p, t in zip(params, trainable)]
    nu = [torch.zeros_like(p) if t else None
          for p, t in zip(params, trainable)]
    return AdamState(0, mu, nu, torch.zeros((), dtype=torch.float32,
                                            device=params[0].device))


def lr_tensor(lr: float, state: AdamState) -> torch.Tensor:
    """The learning rate as the 0-d float32 tensor the updates take, on
    the device of the state's count."""
    return torch.full((), lr, dtype=torch.float32, device=state.t.device)


def _live(params, grads, state):
    keep = [i for i, m in enumerate(state.mu) if m is not None]
    return ([params[i] for i in keep], [grads[i] for i in keep],
            [state.mu[i] for i in keep], [state.nu[i] for i in keep])


def _moments(grads, mus, nus, b1, b2):
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)


def _advance(state: AdamState, b1: float, b2: float):
    """t += 1 in place; returns the bias corrections (1 - b1^t, 1 - b2^t),
    float32 on the device."""
    state.t.add_(1.0)
    return 1.0 - torch.pow(b1, state.t), 1.0 - torch.pow(b2, state.t)


def foreach_update(ps, gs, mus, nus, lr, bc1, bc2, b1: float, b2: float,
                   eps: float, optax: bool) -> None:
    """The update of the live leaves in `_foreach` passes, in place: the
    CPU's path and the plain twin of `ops/adam.py::adam_apply`, with its
    arguments.  optax: lr is the learning rate, the moments bias-corrected
    by bc1, bc2; Keras: lr is lr_t, bc1 and bc2 are not read."""
    _moments(gs, mus, nus, b1, b2)
    if optax:
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
    else:
        denom = torch._foreach_sqrt(nus)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mus, denom)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(ps, upd)


def _update(ps, gs, mus, nus, *args) -> None:
    """The kernel for CUDA tensors, the `_foreach` passes otherwise."""
    if not ps:
        return
    if ps[0].device.type == "cuda":
        adam_apply(ps, gs, mus, nus, *args)
    else:
        foreach_update(ps, gs, mus, nus, *args)


@torch.no_grad()
def optax_adam_apply(params, grads, state: AdamState, lr: torch.Tensor,
                     b1: float = B1, b2: float = B2,
                     eps: float = EPS) -> AdamState:
    """optax.adam's update with learning rate `lr` (0-d float32 on the
    device), in place on `params`."""
    ps, gs, mus, nus = _live(params, grads, state)
    bc1, bc2 = _advance(state, b1, b2)
    _update(ps, gs, mus, nus, lr, bc1, bc2, b1, b2, eps, True)
    return dataclasses.replace(state, count=state.count + 1)


@torch.no_grad()
def keras_adam_apply(params, grads, state: AdamState, lr: torch.Tensor,
                     b1: float = B1, b2: float = B2,
                     eps: float = EPS) -> AdamState:
    """tf.keras Adam (`spnet_tpu.train.optim.keras_adam`) with learning
    rate `lr`, in place: lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t) in
    float32 on the device."""
    ps, gs, mus, nus = _live(params, grads, state)
    bc1, bc2 = _advance(state, b1, b2)
    lr_t = lr * torch.sqrt(bc2) / bc1
    _update(ps, gs, mus, nus, lr_t, bc1, bc2, b1, b2, eps, False)
    return dataclasses.replace(state, count=state.count + 1)


def optax_adam_update(params, grads, state: AdamState,
                      schedule: Callable[[int], float],
                      b1: float = B1, b2: float = B2,
                      eps: float = EPS) -> AdamState:
    """optax.adam(schedule, eps=eps) applied in place to `params`."""
    return optax_adam_apply(params, grads, state,
                            lr_tensor(schedule(state.count), state),
                            b1, b2, eps)


def keras_adam_update(params, grads, state: AdamState,
                      schedule: Callable[[int], float],
                      b1: float = B1, b2: float = B2,
                      eps: float = EPS) -> AdamState:
    """tf.keras Adam under `schedule` in place."""
    return keras_adam_apply(params, grads, state,
                            lr_tensor(schedule(state.count), state),
                            b1, b2, eps)


ADAM_APPLIES = {"optax": optax_adam_apply, "keras": keras_adam_apply}
