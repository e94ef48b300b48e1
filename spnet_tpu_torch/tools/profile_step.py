"""Where the train step's device time goes, kernel by kernel.

    python -m spnet_tpu_torch.tools.profile_step [batch] [--form epoch|eager]
        [--steps N] [--backbone NAME] [--device cuda|cpu]

Counterpart of the JAX package's `scripts/profile_step.py` (batch 128 and
5 traced steps by default, as there): SPNet-331 with the backbone
`--backbone` (Xception by default; `--backbone InceptionResNetV2 32` is
the 25-epoch sweep's step) and the ModelConfig defaults (bf16 compute,
f32 parameters), a uint8 batch from `np.random.default_rng(0)`, the
default labels `normalize(tile(grid.defaults))`, `onecycle_schedule(4e-5,
1000)` and `make_train_step(..., "same", l2_reg=1e-4, augment=True,
indexed="epoch")`.  The `batch` frames are the resident set; `idx_mat`
holds N permutations of them.

  * `--form epoch` (default): `make_train_epoch`, the step `train_network`
    runs on one rank (on the card one CUDA graph of the step, replayed
    once a row);
  * `--form eager`: the step called once a row.

One run of N steps warms up (the capture, cuDNN's autotune, the
allocator), one is timed on the host clock to a synchronize (the step's
wall ms), and one is traced (`utils/profiling.py::trace`, CPU + CUDA
activities) inside a `profile_step.window` range that ends with a
synchronize.  From the trace's device events (kernels, copies, sets):

  * the busy share of the window (the union of their intervals);
  * the top kernels by device time, with calls and share;
  * the device time by kernel class (`CLASSES`, read from the names);
  * eager only: the top aten ops by self device time (PERF.md's older
    tables are by op), and the device time of the kernels launched inside
    BatchNorm forwards (each `BatchNorm` module's forward runs inside a
    `BN_RANGE` span, `utils/profiling.py::span`, that this tool's hooks
    open and close; the model is unchanged), and of those launched inside
    the residual blocks' own `RESIDUAL_RANGE` spans (InceptionResNetV2's
    `_Residual.forward`; 0 for a backbone without them).  Inside a graph
    replay no such range exists, so the epoch form reports classes only:
    BatchNorm is spread over the reduction and elementwise classes.

Both forms also report the residual joins a traced step ran on the host
(`_Residual.joins`): 40 in an eager InceptionResNetV2 step, none in a
graph's replays.

The epoch form checks that the trace sees inside the replays: the loss
kernel must show one call a step, or the tool raises.  On the CPU (the
tests) the "kernels" are the aten ops, by self CPU time, and every line
names the device it ran on.  Prints one `PROFILE_STEP_RESULT {json}` line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from spnet_tpu_torch.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu_torch.grid import normalize
from spnet_tpu_torch.models.inception_resnet_v2 import _Residual
from spnet_tpu_torch.models.layers import BatchNorm
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.tools.runtime import card, tool_device
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import make_train_epoch, make_train_step
from spnet_tpu_torch.utils.profiling import span, trace

FORMS = ("epoch", "eager")
WINDOW = "profile_step.window"
BN_RANGE = "spnet.profile_step.batchnorm"
RESIDUAL_RANGE = "spnet.residual"
LOGDIR = "logs/profile_step_torch"
TOP_KERNELS = 25
TOP_OPS = 15

#: kernel classes, tried in this order; the first whose pattern finds the
#: kernel's name (a CUDA kernel, or an aten op on the CPU) takes it
CLASSES = (
    ("ours", r"wgmma_kernel|simple_kernel|loss_kernel|grad_scale_kernel"
             r"|sel_sigmoid_(fwd|bwd)_kernel|batchnorm_\w+_kernel"),
    ("cudnn_conv", r"fprop|dgrad|wgrad|conv|cudnn|nhwcToNchw|nchwToNhwc"),
    ("gemm", r"gemm|gemv|cublas|cutlass|nvjet|splitKreduce|aten::(mm|addmm|bmm|"
             r"matmul|linear)\b"),
    ("multi_tensor_apply", r"multi_tensor_apply|aten::_foreach"),
    # a graph's device-to-device copies run as memcpy32_post / memcpy128
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
CLASS_NAMES = tuple(c for c, _ in CLASSES)
_CLASS_RE = tuple((c, re.compile(p)) for c, p in CLASSES)


def kernel_class(name: str) -> str:
    """The class of a kernel (or, on the CPU, an aten op) by its name."""
    return next(c for c, p in _CLASS_RE if p.search(name))


def _setup(batch: int, steps: int, device: torch.device, backbone: str,
           input_size: int):
    """The model, train state, step, resident set and index matrix of the
    JAX script's run."""
    grid = GridSpec()
    mc = ModelConfig(backbone=backbone, input_size=input_size)
    model = build_model(mc, num_outputs=grid.num_outputs, device=device,
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (batch, input_size, input_size, 1), np.uint8)
    y = normalize(np.tile(grid.defaults.reshape(-1), (batch, 1)),
                  grid).astype(np.float32)
    idx = np.stack([np.random.default_rng(1 + i).permutation(batch)
                    for i in range(steps)])
    state = create_train_state(model, onecycle_schedule(4e-5, 1000))
    step = make_train_step(model, LossWeights(), "same", l2_reg=1e-4,
                           augment=True, indexed="epoch")
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return mc, model, state, step, put(x), put(y), put(idx)


def _bn_ranges(model: torch.nn.Module) -> list:
    """Hooks that open a `BN_RANGE` span before each BatchNorm forward and
    close it after; returns their handles."""
    open_ranges = []

    def enter(_m, _inp):
        rf = span(BN_RANGE)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(_m, _inp, _out):
        open_ranges.pop().__exit__(None, None, None)

    return [h for m in model.modules() if isinstance(m, BatchNorm)
            for h in (m.register_forward_pre_hook(enter),
                      m.register_forward_hook(leave))]


def _union_us(intervals) -> float:
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


def _self_time_us(avg) -> tuple[float, float]:
    """(self device us, self CPU us) of a key_averages row."""
    return float(avg.self_device_time_total), float(avg.self_cpu_time_total)


def summarize(trace_path: str, prof, on_card: bool, steps: int,
              eager: bool) -> dict:
    """The tables from one traced window (see the module docstring)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    (win,) = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    if on_card:
        dev = [e for e in events if e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
        kernels = {}
        for e in dev:
            k = kernels.setdefault(e["name"], [0.0, 0])
            k[0] += e["dur"]
            k[1] += 1
        busy = _union_us((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                         for e in dev if e["ts"] < w1 and e["ts"]
                         + e["dur"] > w0)
    else:  # the CPU's kernels: the aten ops, by self time; busy: the
        # host ops, not the spans around them
        kernels = {a.key: [_self_time_us(a)[1], a.count]
                   for a in prof.key_averages()
                   if a.key.startswith("aten::")}
        busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") == "cpu_op" and "dur" in e
                         and not e["name"].startswith("spnet."))
    total = sum(v[0] for v in kernels.values())
    classes = {c: 0.0 for c in CLASS_NAMES}
    for name, (us, _) in kernels.items():
        classes[kernel_class(name)] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    out = dict(
        window_ms=win["dur"] / 1e3,
        busy_share=busy / win["dur"],
        device_us_per_step=total / steps,
        top_kernels=[dict(name=n[:200], calls=c, us_per_step=us / steps,
                          share=us / total if total else 0.0,
                          cls=kernel_class(n))
                     for n, (us, c) in top],
        classes_us={c: v / steps for c, v in classes.items()},
        class_shares={c: (v / total if total else 0.0)
                      for c, v in classes.items()},
        loss_kernel_calls=sum(c for n, (_, c) in kernels.items()
                              if "loss_kernel" in n),
        aten_ops=None, bn_forward_us_per_step=None,
        residual_forward_us_per_step=None)
    if eager:
        rows = []
        for a in prof.key_averages():
            if a.key.startswith("aten::"):
                us = _self_time_us(a)[0 if on_card else 1]
                if us > 0:
                    rows.append((us, a.key, a.count))
        rows.sort(reverse=True)
        out["aten_ops"] = [dict(op=k, calls=c, us_per_step=us / steps,
                                share=us / total if total else 0.0)
                           for us, k, c in rows[:TOP_OPS]]
        for key, name in (("bn_forward_us_per_step", BN_RANGE),
                          ("residual_forward_us_per_step", RESIDUAL_RANGE)):
            out[key] = _range_us(events, on_card, name) / steps
    return out


def _range_us(events, on_card: bool, name: str) -> float:
    """Device time of the kernels launched inside the spans `name` (a
    launch's correlation id joins the host call to its kernel); on the
    CPU, the spans' own time."""
    ranges = [e for e in events if e.get("cat") == "cpu_op"
              and e.get("name") == name]
    if not on_card:
        return float(sum(e["dur"] for e in ranges))
    kern = {}
    for e in events:
        if e.get("cat") == "kernel":
            c = e.get("args", {}).get("correlation")
            kern[c] = kern.get(c, 0.0) + e["dur"]
    by_tid = {}
    for e in ranges:
        by_tid.setdefault(e.get("tid"), []).append((e["ts"], e["ts"]
                                                    + e["dur"]))
    total = 0.0
    for e in events:
        if not e.get("cat", "").startswith("cuda_") \
                or "correlation" not in e.get("args", {}):
            continue
        c = e["args"]["correlation"]
        if c in kern and any(a <= e["ts"] <= b
                             for a, b in by_tid.get(e.get("tid"), ())):
            total += kern[c]
    return total


def _print(res: dict) -> None:
    dev = res["card"] or res["device"]
    print(f"[profile_step] {res['form']} form, {res['backbone']}-"
          f"{res['input_size']} b={res['batch']}, {res['steps']} steps on "
          f"{dev}: {res['step_ms']:.3f} ms a step (host clock, untraced); "
          f"traced window {res['window_ms']:.3f} ms, busy share "
          f"{res['busy_share']:.4f}, {res['device_us_per_step']:.1f} us of "
          f"kernels a step; loss_kernel calls {res['loss_kernel_calls']}")
    print(f"[profile_step] top {len(res['top_kernels'])} kernels by time:")
    for k in res["top_kernels"]:
        print(f"  {k['share'] * 100:6.2f} %  {k['us_per_step']:10.1f}"
              f" us/step  {k['calls']:6d} calls  [{k['cls']}]  "
              f"{k['name'][:120]}")
    print("[profile_step] time by kernel class (us a step, share):")
    for c in CLASS_NAMES:
        print(f"  {c:20s} {res['classes_us'][c]:10.1f}  "
              f"{res['class_shares'][c] * 100:6.2f} %")
    if res["aten_ops"] is not None:
        print("[profile_step] top aten ops by self time:")
        for o in res["aten_ops"]:
            print(f"  {o['share'] * 100:6.2f} %  {o['us_per_step']:10.1f}"
                  f" us/step  {o['calls']:6d} calls  {o['op']}")
        print(f"[profile_step] BatchNorm forwards: "
              f"{res['bn_forward_us_per_step']:.1f} us a step (the "
              "backward's BN kernels are not attributed); residual block "
              f"forwards: {res['residual_forward_us_per_step']:.1f} us a "
              "step (their BatchNorms included)")
    else:
        print("[profile_step] the epoch form is read by class only (on "
              "the card its step is a CUDA graph, and no range reaches "
              "inside a replay): BatchNorm is spread over the reduction "
              "and elementwise classes")
    print(f"[profile_step] residual joins on the host: "
          f"{res['residual_joins_per_step']:g} a traced step")


def run(batch: int = 128, form: str = "epoch", steps: int = 5, *,
        device: str | torch.device = "cuda", backbone: str = "Xception",
        input_size: int = 331, logdir: str = LOGDIR) -> dict:
    """Warm up, time and trace `steps` steps of the chosen form; returns
    the result dict (printed by `main`)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    device = torch.device(device)
    on_card = device.type == "cuda"
    smi = card(device)
    mc, model, state, step, x, y, idx = _setup(batch, steps, device,
                                               backbone, input_size)
    gen = torch.Generator(device=device).manual_seed(0)
    if form == "epoch":
        train_epoch = make_train_epoch(step)

        def steps_run():
            return train_epoch(state, x, y, idx, gen)[1]
        hooks = []
    else:
        def steps_run():
            return torch.stack([step(state, x, y, row, gen)[1]["loss"]
                                for row in idx])
        hooks = _bn_ranges(model)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    try:
        losses = steps_run()  # warm-up: capture, autotune, allocator
        sync()
        t0 = time.perf_counter()
        losses = steps_run()
        sync()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        out_dir = os.path.join(logdir, f"{form}_b{batch}_{device.type}")
        shutil.rmtree(out_dir, ignore_errors=True)
        joins = _Residual.joins
        with trace(out_dir) as prof:
            with torch.profiler.record_function(WINDOW):
                losses = steps_run()
                sync()
        joins = _Residual.joins - joins
    finally:
        for h in hooks:
            h.remove()
    if not torch.isfinite(losses).all():
        raise FloatingPointError(f"non-finite train losses {losses}")
    (path,) = [os.path.join(out_dir, f) for f in os.listdir(out_dir)
               if f.endswith(".json")]
    res = dict(form=form, batch=batch, steps=steps, backbone=mc.backbone,
               input_size=mc.input_size, compute_dtype=mc.compute_dtype,
               device=str(device), card=smi, step_ms=step_ms, trace=path,
               residual_joins_per_step=joins / steps,
               **summarize(path, prof, on_card, steps, form == "eager"))
    if form == "epoch" and on_card and res["loss_kernel_calls"] != steps:
        raise RuntimeError(
            f"the trace of {steps} graph replays shows "
            f"{res['loss_kernel_calls']} loss_kernel calls: the profiler "
            "does not see inside CUDA-graph replays here, so the epoch "
            "form's table would not be the step's; profile --form eager")
    return res


def main(argv=None, **kwargs) -> dict:
    """Parse argv, run, print the tables and the result line.  Keyword
    arguments (input_size, logdir) let a CPU test run it small."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", type=int, nargs="?", default=128)
    p.add_argument("--form", choices=FORMS, default="epoch")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--backbone", default="Xception",
                   help="the model's backbone (ModelConfig.backbone)")
    p.add_argument("--device", default=None,
                   help="torch device; default SPNET_DEVICE, else 'cuda'")
    args = p.parse_args(argv)
    res = run(args.batch, args.form, args.steps,
              device=tool_device(args.device), backbone=args.backbone,
              **kwargs)
    _print(res)
    print("PROFILE_STEP_RESULT " + json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
