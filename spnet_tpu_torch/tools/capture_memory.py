"""Card memory left behind by `bench_infer.captured_sweep`, sweep by sweep.

    python -m spnet_tpu_torch.tools.capture_memory [--sweeps 3]

Runs the captured sweep of `tools/bench_infer.py` at b=64 and b=16 (its
two batches) `sweeps` times each, two ways: on the tool's one capture
stream, then on a fresh `torch.cuda.Stream` for every capture.  Prints
`memory_allocated` before and after each sweep and, for every block that
outlives a sweep, its size and the allocating frames that name cuBLAS,
cuDNN or a graph (from a `torch.cuda.memory` snapshot diff).  cuBLAS
keeps a workspace for each stream that runs a matmul, for the life of the
process, so the second way leaves one behind for every new stream.
"""

from __future__ import annotations

import argparse

import torch

from spnet_tpu_torch.cli.common import resolve_device
from spnet_tpu_torch.tools import bench_infer
from spnet_tpu_torch.train.steps import make_predict_step

KEYWORDS = ("blas", "cudnn", "graph", "workspace", "handle")


def _live_blocks() -> dict:
    blocks = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                blocks[b["address"]] = b
    return blocks


def sweeps(predict, x, n: int, fresh_streams: bool) -> list[int]:
    """Bytes each of n x 2 sweeps left allocated; prints each sweep."""
    way = "a new stream a capture" if fresh_streams else "one stream"
    kept = bench_infer.capture_stream
    if fresh_streams:
        bench_infer.capture_stream = lambda device: torch.cuda.Stream(device)
    grown = []
    try:
        for turn in range(n):
            for b in (64, 16):
                torch.cuda.synchronize()
                before, live = torch.cuda.memory_allocated(), _live_blocks()
                bench_infer.captured_sweep(predict, x, b)
                torch.cuda.synchronize()
                after = torch.cuda.memory_allocated()
                grown.append(after - before)
                print(f"[{way}] sweep {turn} b={b}: memory_allocated "
                      f"{before} -> {after} (+{(after - before) / 2**20:.2f}"
                      " MiB)", flush=True)
                for addr, blk in _live_blocks().items():
                    if addr in live:
                        continue
                    names = [f.get("name", "") for f in blk.get("frames", [])]
                    hits = [m for m in names
                            if any(k in m.lower() for k in KEYWORDS)][:3]
                    print(f"[{way}]   {blk['size'] / 2**20:.2f} MiB live "
                          f"after it, allocated in {hits}", flush=True)
    finally:
        bench_infer.capture_stream = kept
    return grown


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sweeps", type=int, default=3)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    model, x, _ = bench_infer.setup(64, 1024, device=str(device))
    predict = make_predict_step(model)
    bench_infer.pipelined(predict, x, 64)
    torch.cuda.memory._record_memory_history(max_entries=200_000)
    try:
        out = {"one_stream": sweeps(predict, x, args.sweeps, False),
               "fresh_streams": sweeps(predict, x, args.sweeps, True)}
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    print({k: [round(v / 2**20, 2) for v in vs] for k, vs in out.items()})
    return out


if __name__ == "__main__":
    main()
