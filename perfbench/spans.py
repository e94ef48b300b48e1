"""The program's own spans in a traced tail, joined with the device.

The port names the host phases of its layers `spnet.<layer>.<phase>`
(`spnet_tpu_torch/utils/profiling.py::span`).  While the profiler records
each span is a function-scope record function, which the trace exports as
a `cpu_op` event, so `Tail.host_ops` holds the spans beside the aten ops,
on the clock of the device operations and of the host's launches.  Here
they are joined with the tail's idle gaps (by overlap: a gap that spans
two phases is split between them) and with the device operations (by the
correlation id of the launch, made on the span's thread while it was
open).  A program without spans gives a tail without them, and the
readers built on this module return nothing there.

Times are microseconds, as in `trace.Tail`.
"""

from __future__ import annotations

import bisect

PREFIX = "spnet."
#: the predict path's phases (`train/loop.py::predict_in_batches`), which
#: do not overlap: the host enqueues the forward's kernels, or copies for
#: the device and waits on it
PREDICT_LAUNCH = ("spnet.predict.forward",)
PREDICT_SYNC = ("spnet.predict.copy_in", "spnet.predict.warmup",
                "spnet.predict.copy_out")
PREDICT = PREDICT_LAUNCH + PREDICT_SYNC
SEPCONV = "spnet.sepconv"


def spans(tail, names) -> list:
    """(start, end, tid) of each span called one of `names`."""
    names = (names,) if isinstance(names, str) else tuple(names)
    return [(ts, ts + dur, tid) for name, ts, dur, tid in tail.host_ops
            if name in names]


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted, disjoint
    [start, end] pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_us(tail, names) -> float:
    """Time of the tail in which no device operation ran while the host
    was inside a span called one of `names`."""
    return overlap_us(merged(tail.idle_gaps()),
                      merged((a, b) for a, b, _ in spans(tail, names)))


def launched_in(tail, names, outside=()) -> list:
    """The device operations ([name, ts, dur, correlation]) launched while
    a span called one of `names` was open on the launching thread, and no
    span called one of `outside`."""
    def by_tid(which):
        out: dict = {}
        for a, b, tid in spans(tail, which):
            out.setdefault(tid, []).append((a, b))
        for tid, iv in out.items():
            iv = merged(iv)
            out[tid] = ([a for a, _ in iv], [b for _, b in iv])
        return out

    def holds(table, ts, tid):
        if tid not in table:
            return False
        starts, ends = table[tid]
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= ends[i]

    inside, out = by_tid(names), by_tid(outside)
    ops = []
    for op in tail.device:
        launch = tail.launches.get(op[3])
        if launch and holds(inside, launch[0], launch[1]) \
                and not holds(out, launch[0], launch[1]):
            ops.append(op)
    return ops
