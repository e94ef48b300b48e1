"""Native-resolution runs of the port's two benchmarks, in turns.

    python -m spnet_tpu_torch.tools.bench_native [--turns 5] [--device cuda]

`bench` and `bench_infer` time Xception at 331x331, as the JAX package's
benchmarks do.  This tool times the same work at `input_size=0`, the
frames' own 384x512: each turn runs `bench.main(input_size=0)` (b=128, a
warm-up and a timed epoch of 160 steps on 2048 `synthetic_dataset`
frames), then `bench_infer`'s two modes at b=64 and b=16 over 4096 seeded
frames, each from a fresh model.  It prints one JSON line a turn and
benchmark (the train line with the run's peak `max_memory_allocated` in
GiB), then one line with the median, min and max of each rate over the
turns.  The two modes' outputs must be bitwise equal.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from spnet_tpu_torch.cli.common import resolve_device
from spnet_tpu_torch.tools import bench, bench_infer
from spnet_tpu_torch.train.steps import make_predict_step

INFER_BATCHES = (64, 16)


def run(turns: int = 5, *, device: str = "cuda", backbone: str = "Xception",
        batch_size: int = 128, steps_per_epoch: int = 160,
        n_data: int = 2048, n_frames: int = 4096,
        infer_batches=INFER_BATCHES) -> dict:
    """{name: {median, min, max}} over `turns` turns; names `train`
    (images/s), `pipelined_b<b>` and `sweep_b<b>` (frames/s) and, on a
    card, `peak_gib`.  The keyword arguments let a CPU test run it small."""
    dev = resolve_device(device)
    rates = {"train": []} | ({"peak_gib": []} if dev.type == "cuda" else {})
    for b in infer_batches:
        rates[f"pipelined_b{b}"], rates[f"sweep_b{b}"] = [], []
    for turn in range(turns):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out = bench.main(batch_size, steps_per_epoch, n_data, device=device,
                         backbone=backbone, input_size=0)
        if dev.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            rates["peak_gib"].append(out["peak_gib"])
        print(json.dumps(dict(turn=turn, **out)), flush=True)
        rates["train"].append(out["value"])
        model, x, mc = bench_infer.setup(n_frames=n_frames, device=device,
                                         backbone=backbone, input_size=0)
        predict = make_predict_step(model)
        for b in infer_batches:
            y1, fps1 = bench_infer.pipelined(predict, x, b)
            y2, fps2 = bench_infer.captured_sweep(predict, x, b)
            if not torch.equal(y1[: y2.shape[0]], y2):
                raise SystemExit(f"bench_native: b={b}: the captured "
                                 "sweep's outputs differ from the "
                                 "pipelined batches'")
            r = bench_infer.result(b, fps1, fps2, x.device, mc)
            print(json.dumps(dict(turn=turn, **r)), flush=True)
            rates[f"pipelined_b{b}"].append(fps1)
            rates[f"sweep_b{b}"].append(fps2)
        del model, predict, x, y1, y2
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {k: {"median": statistics.median(v), "min": min(v),
                   "max": max(v)} for k, v in rates.items()}
    print(json.dumps({"turns": turns, "native": summary}), flush=True)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--turns", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    args = p.parse_args(argv)
    return run(args.turns, device=args.device)


if __name__ == "__main__":
    main()
