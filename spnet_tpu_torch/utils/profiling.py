"""Profiling / tracing hooks.

Counterpart of `spnet_tpu/utils/profiling.py`:

  * `trace(logdir)` — context manager around `torch.profiler.profile`
    (CPU activity, and CUDA activity where torch sees a card) that writes
    a TensorBoard-loadable trace (`tensorboard_trace_handler`: one
    `*.pt.trace.json` per run, also readable by chrome://tracing and
    Perfetto) into `logdir`.
  * `span(name)` — a named host range of the program's own phases.  While
    a torch profiler records (`train --profile`, `trace`, a benchmark's
    traced run) it is a function-scope record function, which the trace
    exports as a `cpu_op` event on the clock of the kernels and their
    launches; otherwise it is one shared no-op context, so an untraced
    run pays a flag check a span.  The program's spans are named
    `spnet.<layer>.<phase>`.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


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


#: the span of an untraced run, shared: it records nothing
_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named `name` in the profiler's trace while a profiler
    records; else the shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF
