"""Profiling / tracing hooks.

Counterpart of `spnet_tpu/utils/profiling.py`:

  * `trace(logdir)` — context manager around `torch.profiler.profile`
    (CPU activity, and CUDA activity where torch sees a card) that writes
    a TensorBoard-loadable trace (`tensorboard_trace_handler`: one
    `*.pt.trace.json` per run, also readable by chrome://tracing and
    Perfetto) into `logdir`.
  * `annotate(name)` — a named `torch.profiler.record_function` range, so
    train phases (the geometric augmentation, the label encode) are
    visible in the trace timeline and in `key_averages()`.
  * `Throughput` — rolling images/sec meter for the hot loop.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str = "logs/profile"):
    """Capture a host + device trace of everything inside the block;
    yields the profiler, whose `key_averages()` the caller may read."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Named region that shows up on the profiler timeline."""
    return torch.profiler.record_function(name)


class Throughput:
    """Rolling throughput meter: call update(n_items) per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def update(self, n_items: int) -> None:
        now = time.time()
        self._events.append((now, n_items))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        items = sum(n for _, n in self._events[1:])
        return items / dt if dt > 0 else 0.0
