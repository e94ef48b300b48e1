"""Inference benchmark of the port on one card: batched predict frames/s.

    python -m spnet_tpu_torch.tools.bench_infer [batch_size] [n_frames] \\
        [--device cuda]

Counterpart of the JAX package's `scripts/bench_infer.py` (defaults b=64,
4096 frames): SPNet Xception-331 bf16 (seeded Keras init) through
`make_predict_step`, over seeded uint8 frames held on the card, two ways:

  1. pipelined batches: every batch is launched, then every output is
     copied to the host; timed to the last copy;
  2. one captured sweep: the `n_frames // batch_size` batches captured
     once into a CUDA graph (in place of JAX's `lax.scan` program), one
     warm replay, then one timed replay and one bulk copy to the host.

The separable convs of each batch run the K1 kernel (34 launches a
batch).  On the CPU (`--device cpu`, the tests) the sweep runs the same
batches eagerly, with no graph.  Prints one JSON line: metric, value (the
faster mode), unit (both rates and the card) and vs_baseline (the
reference's ~725 FPS on an RTX 2080 Ti, BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from spnet_tpu_torch.cli.common import resolve_device
from spnet_tpu_torch.config import ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH, GridSpec, \
    ModelConfig
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.tools.bench import device_name
from spnet_tpu_torch.train.steps import capture_stream, make_predict_step

BASELINE_FPS = 725.0  # RTX 2080 Ti, BASELINE.md
#: replays of the captured sweep: one warm, one timed
SWEEP_REPLAYS = 2


def setup(batch_size: int = 64, n_frames: int = 4096, *,
          device: str = "cuda", backbone: str = "Xception",
          input_size: int = 331):
    """(model, frames, ModelConfig): a seeded model in eval mode and
    n_frames seeded uint8 frames (n, H, W, 1) on `device`."""
    device = resolve_device(device)
    mc = ModelConfig(backbone=backbone, input_size=input_size)
    model = build_model(mc, num_outputs=GridSpec().num_outputs,
                        device=device)
    hw = ((input_size, input_size) if input_size
          else (ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (n_frames, *hw, 1),
                                      np.uint8)).to(device)
    return model, x, mc


def pipelined(predict, x, batch_size: int):
    """Mode 1: (outputs (n, M) float32 on the host, frames/s), after one
    warm-up batch."""
    predict(x[:batch_size]).cpu()
    t0 = time.perf_counter()
    outs = [predict(x[s : s + batch_size])
            for s in range(0, x.shape[0], batch_size)]
    y = torch.cat([o.cpu() for o in outs]).float()
    return y, x.shape[0] / (time.perf_counter() - t0)


def captured_sweep(predict, x, batch_size: int):
    """Mode 2: (outputs (steps * batch_size, M) float32 on the host,
    frames/s) of the first `steps = n // batch_size` batches as one CUDA
    graph: one eager warm-up batch on the capturing stream, the capture,
    SWEEP_REPLAYS replays of which the last is timed to its bulk copy.  On
    the CPU the same batches run eagerly, once to warm up and once timed."""
    steps = x.shape[0] // batch_size
    xs = x[: steps * batch_size].view(steps, batch_size, *x.shape[1:])

    def sweep():
        return torch.stack([predict(xs[i]) for i in range(steps)])

    if x.device.type != "cuda":
        sweep()
        t0 = time.perf_counter()
        y = sweep().cpu()
        return y.reshape(-1, y.shape[-1]).float(), \
            steps * batch_size / (time.perf_counter() - t0)
    stream = capture_stream(x.device)
    stream.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(stream):
        predict(xs[0])
    torch.cuda.current_stream(x.device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        ys = sweep()
    for _ in range(SWEEP_REPLAYS - 1):
        graph.replay()
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    graph.replay()
    y = ys.cpu()
    fps = steps * batch_size / (time.perf_counter() - t0)
    del graph
    return y.reshape(-1, y.shape[-1]).float(), fps


def result(batch_size: int, fps_pipelined: float, fps_sweep: float,
           device: torch.device, model_cfg) -> dict:
    """The benchmark's JSON dict."""
    fps = max(fps_pipelined, fps_sweep)
    size = model_cfg.input_size
    return {
        "metric": "inference_fps_per_chip",
        "value": round(fps, 1),
        "unit": f"frames/s per {device_name(device)} "
                f"({model_cfg.backbone} "
                f"{f'{size}x{size}' if size else '512x384'} "
                f"{model_cfg.compute_dtype} b{batch_size}; pipelined "
                f"{round(fps_pipelined, 1)}, captured sweep "
                f"{round(fps_sweep, 1)})",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch_size", type=int, nargs="?", default=64)
    p.add_argument("n_frames", type=int, nargs="?", default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    args = p.parse_args(argv)
    model, x, mc = setup(args.batch_size, args.n_frames, device=args.device)
    predict = make_predict_step(model)
    y1, fps1 = pipelined(predict, x, args.batch_size)
    y2, fps2 = captured_sweep(predict, x, args.batch_size)
    if not torch.equal(y1[: y2.shape[0]], y2):
        raise SystemExit("bench_infer: the captured sweep's outputs differ "
                         "from the pipelined batches'")
    out = result(args.batch_size, fps1, fps2, x.device, mc)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
