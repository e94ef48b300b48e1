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
`no_grad` with PyTorch's multi-tensor (`_foreach`) ops.  A parameter whose
moments are None is frozen: its update is zero, as under optax's
`multi_transform` + `set_to_zero`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

B1, B2, EPS = 0.9, 0.999, 1e-7  # eps: Keras's K.epsilon(), as in JAX


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied since init
    mu: list  # first moments, None for a frozen parameter
    nu: list  # second moments, None for a frozen parameter


def adam_init(params, trainable=None) -> AdamState:
    """Zero moments for every trainable parameter (all when trainable is
    None), None for the others; count 0."""
    if trainable is None:
        trainable = [True] * len(params)
    mu = [torch.zeros_like(p) if t else None
          for p, t in zip(params, trainable)]
    nu = [torch.zeros_like(p) if t else None
          for p, t in zip(params, trainable)]
    return AdamState(0, mu, nu)


def _live(params, grads, state):
    keep = [i for i, m in enumerate(state.mu) if m is not None]
    return ([params[i] for i in keep], [grads[i] for i in keep],
            [state.mu[i] for i in keep], [state.nu[i] for i in keep])


def _moments(grads, mus, nus, b1, b2):
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)


@torch.no_grad()
def optax_adam_update(params, grads, state: AdamState,
                      schedule: Callable[[int], float],
                      b1: float = B1, b2: float = B2,
                      eps: float = EPS) -> AdamState:
    """optax.adam(schedule, eps=eps) applied in place to `params`."""
    ps, gs, mus, nus = _live(params, grads, state)
    lr = schedule(state.count)
    count = state.count + 1
    if ps:
        _moments(gs, mus, nus, b1, b2)
        denom = torch._foreach_div(nus, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mus, 1.0 - b1 ** count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(ps, upd, alpha=-lr)
    return AdamState(count, state.mu, state.nu)


@torch.no_grad()
def keras_adam_update(params, grads, state: AdamState,
                      schedule: Callable[[int], float],
                      b1: float = B1, b2: float = B2,
                      eps: float = EPS) -> AdamState:
    """tf.keras Adam (`spnet_tpu.train.optim.keras_adam`) in place."""
    ps, gs, mus, nus = _live(params, grads, state)
    lr = schedule(state.count)
    count = state.count + 1
    lr_t = lr * math.sqrt(1.0 - b2 ** count) / (1.0 - b1 ** count)
    if ps:
        _moments(gs, mus, nus, b1, b2)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mus, denom)
        torch._foreach_add_(ps, upd, alpha=-lr_t)
    return AdamState(count, state.mu, state.nu)


ADAM_UPDATES = {"optax": optax_adam_update, "keras": keras_adam_update}
