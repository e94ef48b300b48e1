"""The device trace of a run's traced tail, reduced to what the readers
need.

`traced(work)` runs `work()` under `torch.profiler` (CPU and CUDA
activities) inside a `perfbench.tail` range that ends with a device
synchronize, writes the chrome trace into a fresh directory under the
run's TMPDIR, reads it back and deletes it.  `Tail` keeps, of the events
inside that range: the device operations (kernels, copies, sets) with
their names, times and correlation ids, the host's launch calls, the
benchmark's own ranges, and the host's top-level aten ops.  On a host
without a card a tail has no device operation, and every reader of
device time returns nothing.

Kernel classes are the port's `tools/profile_step.py::CLASSES` as they
stood when this benchmark was written, frozen here: the first pattern
that finds a kernel's name takes it.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import shutil
import tempfile

import torch

TAIL = "perfbench.tail"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

CLASSES = (
    ("ours", r"wgmma_kernel|simple_kernel|loss_kernel|grad_scale_kernel"
             r"|sel_sigmoid_(fwd|bwd)_kernel"),
    ("cudnn_conv", r"fprop|dgrad|wgrad|conv|cudnn|nhwcToNchw|nchwToNhwc"),
    ("gemm", r"gemm|gemv|cublas|cutlass|nvjet|splitKreduce|aten::(mm|addmm|bmm|"
             r"matmul|linear)\b"),
    ("multi_tensor_apply", r"multi_tensor_apply|aten::_foreach"),
    ("copy_cast", r"copy_kernel|[Mm]emcpy|Memset|aten::(copy_|_to_copy|to|"
                  r"clone|contiguous|fill_|zero_)\b"),
    ("index_gather", r"index|gather|scatter|aten::(take|embedding)"),
    ("reduction", r"reduce|Reduce|aten::(sum|mean|var|std|norm|amax|amin|"
                  r"max|min|prod|cumsum|argmax|argmin|var_mean)\b"),
    ("elementwise", r"elementwise|aten::(mul|add|sub|div|neg|sqrt|rsqrt|pow|"
                    r"exp|log|sigmoid|tanh|relu|threshold|leaky_relu|"
                    r"hardtanh|clamp|where|maximum|minimum|lerp|addcmul|"
                    r"addcdiv|square|abs|sign|lt|gt|le|ge|eq|ne|floor|round|"
                    r"masked_fill|uniform|bernoulli|normal|reciprocal|rand\w*"
                    r"|logical_\w+|bitwise_\w+)_?\b"),
    ("other", r""),
)
_CLASS_RE = tuple((c, re.compile(p)) for c, p in CLASSES)


def kernel_class(name: str) -> str:
    return next(c for c, p in _CLASS_RE if p.search(name))


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(intervals):
        if hi is not None and a <= hi:
            hi = max(hi, b)
            continue
        if hi is not None:
            total += hi - lo
        lo, hi = a, b
    return total if hi is None else total + hi - lo


class Tail:
    """The events of one traced tail (times in microseconds).

    device: [name, ts, dur, correlation] of each device operation;
    launches: {correlation: [ts, tid]} of the host's runtime calls;
    ranges: [name, ts, dur, tid] of the benchmark's own host ranges;
    host_ops: [name, ts, dur, tid] of the host's aten ops;
    units: how many steps (train) or frames (predict) the tail ran."""

    def __init__(self, window: list, device: list, launches: dict,
                 ranges: list, host_ops: list, units: int = 0,
                 extra: dict | None = None):
        self.window, self.device, self.launches = window, device, launches
        self.ranges, self.host_ops, self.units = ranges, host_ops, units
        self.extra = extra or {}

    # ---- serialisation (the tests' recorded fixture) -------------------
    def to_json(self) -> dict:
        return dict(window=self.window, device=self.device,
                    launches={str(k): v for k, v in self.launches.items()},
                    ranges=self.ranges, host_ops=self.host_ops,
                    units=self.units, extra=self.extra)

    @classmethod
    def from_json(cls, d: dict) -> "Tail":
        return cls(d["window"], d["device"],
                   {int(k): v for k, v in d["launches"].items()},
                   d["ranges"], d["host_ops"], d["units"], d.get("extra"))

    @classmethod
    def from_chrome(cls, events: list, units: int) -> "Tail":
        (win,) = [e for e in events if e.get("name") == TAIL
                  and e.get("cat") == "user_annotation"]
        w0, w1 = win["ts"], win["ts"] + win["dur"]

        def inside(e):
            return "dur" in e and e["ts"] < w1 and e["ts"] + e["dur"] > w0

        device = [[e["name"], e["ts"], e["dur"],
                   e.get("args", {}).get("correlation")]
                  for e in events if e.get("cat") in DEVICE_CATS
                  and inside(e)]
        launches = {e["args"]["correlation"]: [e["ts"], e.get("tid")]
                    for e in events if e.get("cat") == "cuda_runtime"
                    and "correlation" in e.get("args", {})}
        ranges = [[e["name"], e["ts"], e["dur"], e.get("tid")]
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("perfbench.")
                  and e["name"] != TAIL and inside(e)]
        host_ops = [[e["name"], e["ts"], e["dur"], e.get("tid")]
                    for e in events if e.get("cat") == "cpu_op"
                    and inside(e)]
        return cls([w0, w1], device, launches, ranges, host_ops, units)

    # ---- what the readers use ------------------------------------------
    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        w0, w1 = self.window
        return union_us((max(ts, w0), min(ts + dur, w1))
                        for _, ts, dur, _ in self.device)

    def by_name(self) -> dict:
        out: dict = {}
        for name, _, dur, _ in self.device:
            out[name] = out.get(name, 0.0) + dur
        return out

    def class_us(self, *classes: str) -> float:
        return sum(us for n, us in self.by_name().items()
                   if kernel_class(n) in classes)

    def device_us_in_ranges(self, name: str) -> float:
        """Device time of the kernels launched inside the benchmark ranges
        called `name` (a launch's correlation id joins the host call to
        its kernel)."""
        spans: dict = {}
        for n, ts, dur, tid in self.ranges:
            if n == name:
                spans.setdefault(tid, []).append((ts, ts + dur))
        merged = {}
        for tid, iv in spans.items():  # sorted, overlaps joined
            out = []
            for a, b in sorted(iv):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            merged[tid] = ([a for a, _ in out], [b for _, b in out])
        total = 0.0
        for _, _, dur, corr in self.device:
            ts_tid = self.launches.get(corr)
            if not ts_tid or ts_tid[1] not in merged:
                continue
            starts, ends = merged[ts_tid[1]]
            i = bisect.bisect_right(starts, ts_tid[0]) - 1
            if i >= 0 and ts_tid[0] <= ends[i]:
                total += dur
        return total

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        operation."""
        w0, w1 = self.window
        gaps, at = [], w0
        for _, ts, dur, _ in sorted(self.device, key=lambda d: d[1]):
            if ts > at:
                gaps.append((at, ts))
            at = max(at, ts + dur)
        if at < w1:
            gaps.append((at, w1))
        return gaps

    def host_label(self, t: float) -> str:
        """What the host was doing at time t: the innermost benchmark range
        open then, and the outermost aten op running then."""
        rng = [r for r in self.ranges if r[1] <= t <= r[1] + r[2]]
        ops = [o for o in self.host_ops if o[1] <= t <= o[1] + o[2]]
        label = (min(rng, key=lambda r: r[2])[0] if rng else "outside")
        if ops:
            label += "/" + max(ops, key=lambda o: o[2])[0]
        return label

    def breakdown(self, top: int = 10, short_us: float = 20.0) -> dict:
        """The device operations that took most time, in seconds; and the
        idle time: first all gaps shorter than `short_us` summed, then the
        longest gaps, each named by what the host was doing at its
        middle."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = self.idle_gaps()
        short = [b - a for a, b in gaps if b - a < short_us]
        longest = sorted((g for g in gaps if g[1] - g[0] >= short_us),
                         key=lambda g: g[0] - g[1])[: top - 1]
        idle = [[f"{len(short)} gaps under {short_us:g} us", sum(short)
                 / 1e6]] + [[self.host_label((a + b) / 2)[:160],
                             (b - a) / 1e6] for a, b in longest]
        return {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
                "idle_gaps": idle}


def traced(work, units: int, device) -> Tail:
    """Run work() under the profiler, inside the tail range, and reduce
    the trace; `units` is what work() ran (steps or frames)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    out_dir = tempfile.mkdtemp(prefix="perfbench_trace_")
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(TAIL):
                work()
                if on_card:
                    torch.cuda.synchronize(device)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return Tail.from_chrome(events, units)


def span(name: str):
    """A benchmark range of the host, visible in the trace."""
    return torch.profiler.record_function(f"perfbench.{name}")
