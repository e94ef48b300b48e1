"""The harness: one run of one cell, driven by data.

A run finds everything by name, starting from `BENCHMARK.json` at the
root of the checkout:

  * the cell (`workloads[]`), its configuration file (`configs[].file`),
    its traffic mix `perfbench/traffic/<traffic>.json` and its limits
    `perfbench/limits/<cell>.json`;
  * the traffic's `kind`, the module `perfbench/kinds/<kind>.py` that
    sets the program up, runs the measured window, traces a tail and
    compares with the reference;
  * each metric the cell reports (`end_to_end` without a trace,
    `per_layer` with one; all cells, or those in the metric's
    `workloads`), read by `perfbench/metrics/<metric>.py`, whose
    `read(record)` returns a number or None (nothing to read: the metric
    is left out of the line).

A kind's `run(ctx)` returns a record (the readers' input) and a check,
which is called once the window has closed and the peak is read; it frees
the program's state and returns the compared numbers.  Adding a cell, a
configuration, a traffic mix or a metric adds files and entries, and
edits none.
"""

from __future__ import annotations

import dataclasses
import gc
import gzip
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spnet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench: Path | None = None) -> dict:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports."""
    spec = load_json(bench or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (one of "
                         f"{', '.join(cells)})")
    cell = cells[name]
    (cfg_entry,) = [c for c in spec["configs"] if c["name"] == cell["config"]]
    return dict(
        cell=cell,
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=metrics_of(spec["end_to_end"], name),
        per_layer=metrics_of(spec["per_layer"], name))


def peaks(device_name: str, dtype: str) -> dict | None:
    """The card's published dense peak for `dtype` and its bandwidth, from
    `perfbench/peaks.json`; None for a card it does not list."""
    for card in load_json(HERE / "peaks.json")["cards"]:
        if card["match"] in device_name:
            return dict(flops=card["flops"][dtype],
                        bytes_per_s=card["bytes_per_s"], card=card["match"])
    return None


@dataclasses.dataclass
class Ctx:
    """What a kind's run is given."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    calibrate: bool = False


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    """Give the freed program state back before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def program_model(ctx: Ctx, calib_frames):
    """The program's model for the configuration, on the run's device,
    holding the benchmark's weights: made from the seed on the device
    (`inputs.make_weights`), BatchNorm statistics from `calib_frames`.
    Returns (model in eval mode, the weights on the host for the
    reference)."""
    from perfbench import inputs
    from perfbench.counts.model import ref_config
    from perfbench.reference import spnet as ref
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.models.spnet import build_model

    m = ctx.config["model"]
    model = build_model(
        ModelConfig(backbone=m["backbone"], input_size=m["input_size"],
                    compute_dtype=m["compute_dtype"],
                    param_dtype=m["param_dtype"], loss_type=m["loss_type"],
                    dropout_rate=m["dropout_rate"], l2_reg=m["l2_reg"]),
        num_outputs=m["num_outputs"], device="meta").to_empty(
            device=ctx.device)
    rc = ref_config(ctx.config)
    weights = inputs.make_weights(ref.param_shapes(rc), ctx.seed, ctx.device)
    inputs.calibrate_bn(weights, rc, calib_frames)
    model.load_state_dict(weights)  # strict: the names and shapes agree
    host = {k: v.cpu() for k, v in weights.items()}
    del weights
    return model.eval(), host


# ---- the comparisons ---------------------------------------------------

def rel_gap(p: float, r: float) -> float:
    """|p - r| / |r|; inf where p is not finite."""
    if not math.isfinite(p):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gaps(prog: list, ref_: list, scale: list | None = None) -> list:
    """Each leaf's gap, |p - r| / max(s, the median leaf's s), where s is
    `scale` (the reference's norms; `ref_` where not given); inf for a
    number that is not finite."""
    scale = ref_ if scale is None else scale
    med = statistics.median(scale)
    return [abs(p - r) / max(s, med, 1e-30) if math.isfinite(p)
            else math.inf for p, r, s in zip(prog, ref_, scale)]


def rel_gap_total(prog: list, ref_: list) -> float:
    """‖p - r‖ / ‖r‖ over all the tensors together; inf where p is not
    finite."""
    d = math.sqrt(sum(float((p - r).double().pow(2).sum())
                      for p, r in zip(prog, ref_)))
    n = math.sqrt(sum(float(r.double().pow(2).sum()) for r in ref_))
    return d / max(n, 1e-30) if math.isfinite(d) else math.inf


def frame_gaps(y, r) -> tuple[float, float]:
    """Each frame's (row's) distance from the reference, ‖y - r‖ over the
    larger of ‖r‖ and the median frame's ‖r‖: of the worst frame and of
    the median one; inf where y is not finite or has another shape."""
    y, r = torch.as_tensor(y).double(), torch.as_tensor(r).double()
    if y.shape != r.shape or not bool(torch.isfinite(y).all()):
        return math.inf, math.inf
    rn = r.norm(dim=1)
    den = rn.clamp_min(max(float(rn.median()), 1e-30))
    gap = (y - r).norm(dim=1) / den
    return float(gap.max()), float(gap.median())


def norms(tensors) -> list:
    return [float(n) for n in torch.stack(
        [t.float().norm() for t in tensors]).cpu()]


# ---- one run -----------------------------------------------------------

def card_power_limit() -> str | None:
    """The card's power limit as nvidia-smi reads it (None without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def read_metrics(entries: list, record: dict) -> dict:
    out = {}
    for m in entries:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, overrides: dict | None = None,
             calibrate: bool = False) -> tuple[dict, list, dict]:
    """Run the cell; returns (the result line's object, the compared
    numbers as (name, value, limit), the readers' record).  `overrides` replaces entries of
    the configuration's model and of the traffic (the tests' small
    sizes)."""
    spec = load_cell(name)
    overrides = overrides or {}
    spec["config"]["model"].update(overrides.get("model", {}))
    spec["traffic"].update(overrides.get("traffic", {}))
    ctx = Ctx(name, spec["config"], spec["traffic"], seed, seconds, trace,
              device, t0, calibrate)
    kind = importlib.import_module(
        f"perfbench.kinds.{spec['traffic']['kind']}")
    record, check = kind.run(ctx)
    numbers, readings = check()
    free(device)
    if calibrate:
        readings["program"] = numbers
    checks = [(k, numbers[k], lim) for k, lim in spec["limits"].items()]
    correct = (record["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks))
    on_card = device.type == "cuda"
    record["peaks"] = (peaks(torch.cuda.get_device_name(device),
                             spec["config"]["model"]["compute_dtype"])
                       if on_card else None)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": record["peak_bytes"]}
    if on_card:
        dev["power_limit"] = card_power_limit()
    res = {"correct": bool(correct), "attempted": record["attempted"],
           "failed": record["failed"]}
    if trace:
        tail = record["tails"]["plain"]
        dev["busy_s"] = tail.busy_us() / 1e6
        dev["window_s"] = tail.window_us / 1e6
        res["metrics"] = read_metrics(spec["per_layer"], record)
        res["device"] = dev
        res["breakdown"] = tail.breakdown()
    else:
        res["metrics"] = read_metrics(spec["end_to_end"], record)
        res["device"] = dev
    if readings:
        res["readings"] = readings
    res["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return res, checks, record


def save_record(record: dict, path: str) -> None:
    """Write the readers' record, tails included, as gzipped JSON (the
    tests' recorded fixtures)."""
    out = {k: v for k, v in record.items() if k != "tails"}
    out["tails"] = {k: t.to_json() for k, t in record["tails"].items()}
    with gzip.open(path, "wt") as f:
        json.dump(out, f)


def load_record(path) -> dict:
    from perfbench.trace import Tail

    with gzip.open(path, "rt") as f:
        record = json.load(f)
    record["tails"] = {k: Tail.from_json(t)
                       for k, t in record["tails"].items()}
    return record


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record-out", default=None,
                   help="also write the readers' record here (.json.gz)")
    args = p.parse_args(argv)
    chips = load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res, checks, record = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), device, t0)
    if args.record_out:
        save_record(record, args.record_out)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
