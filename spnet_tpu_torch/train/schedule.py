"""1-cycle learning-rate schedule, per step (batch).

Counterpart of `spnet_tpu/train/schedule.py` (which imports jax.numpy):
linear warmup over the first 30% of iterations from lr_max/div_factor to
lr_max, then cosine annealing down to lr_start/final_div, then held
there.  The schedule is a function of the step counter that the host
evaluates (a Python float), so the optimizer passes the learning rate to
the device as a scalar argument and never waits for the card.
"""

from __future__ import annotations

import math

import numpy as np


def onecycle_schedule(lr_max: float, total_steps: int,
                      pct_start: float = 0.3, div_factor: float = 25.0,
                      final_div: float = 1e4):
    """Returns sched(step: int) -> learning rate (float).

    Matches the reference LUT (`onecycle_lut`) at integer steps: the ramp
    has np.linspace semantics (value i of n spans [start, stop]
    inclusive)."""
    lr_start = lr_max / div_factor
    lr_end = lr_start / final_div
    a1 = int(total_steps * pct_start)
    a2 = total_steps - a1

    def sched(step) -> float:
        step = float(step)
        if step >= total_steps:  # extra epochs hold lr_end
            return lr_end
        if step < a1:
            return lr_start + (lr_max - lr_start) * step / max(a1 - 1, 1)
        t = (step - a1) / max(a2 - 1, 1)
        return (lr_max - lr_end) * (1.0 + math.cos(math.pi * t)) / 2.0 \
            + lr_end

    return sched


def onecycle_lut(lr_max: float, n_data_points: int, epochs: int,
                 batch_size: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div: float = 1e4
                 ) -> np.ndarray:
    """Numpy LUT with the reference's exact construction (test oracle and
    plotting)."""
    lr_start = lr_max / div_factor
    lr_end = lr_start / final_div
    n_iter = n_data_points * epochs // batch_size
    a1 = int(n_iter * pct_start)
    a2 = n_iter - a1
    first = np.linspace(lr_start, lr_max, a1)
    second = (lr_max - lr_end) * (1 + np.cos(np.linspace(0, np.pi, a2))) / 2 \
        + lr_end
    return np.concatenate([first, second])
