"""The reference's movie workflow end to end: predict over a directory of
.bmp frames at a large batch, with overlays, the CSV and the frame rate.

    python -m spnet_tpu_torch.tools.movie_predict [n] [batch] [--device cuda]

Counterpart of the JAX package's `scripts/movie_predict.py` (defaults
n=512, b=512).  The reference extracts .bmp frames from a steelpan movie
with ffmpeg and runs `predict_spnet.py` over them; no movie ships with
this repository, so the frames are `n` synthetic ESPI renders of seed 31
at the native 512x384 (`synthetic_dataset(input_size=0)`), written as
mode-L .bmp files into logs/movie_frames (kept when it already holds n).
`predict_network` then decodes them, predicts at `batch` and writes the
CSV and 8 overlays into logs/movie_pred/.  The checkpoint is the first
of SPNET_CKPT and logs/dataset_a_ckpt (`tools/dataset_a.py`'s run) that
holds one.  Prints one line `MOVIE_RESULT {json}`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

from spnet_tpu_torch.cli.common import load_model_and_state
from spnet_tpu_torch.config import GridSpec
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.eval.predict import predict_network
from spnet_tpu_torch.io.checkpoint import STATE_FILENAME
from spnet_tpu_torch.tools.runtime import add_device_arg, memory, \
    tool_device

FRAMES_DIR, LOG_DIR = "logs/movie_frames", "logs/movie_pred/"
CKPT_DIRS = ("logs/dataset_a_ckpt",)
FRAME_SEED = 31


def render_bmp_frames(outdir: str, n: int, device, seed: int = FRAME_SEED
                      ) -> float:
    """Render n synthetic frames at the native 512x384 on `device` and
    save them as mode-L .bmp; seconds taken (0 when outdir holds n)."""
    from PIL import Image

    os.makedirs(outdir, exist_ok=True)
    if len(glob.glob(os.path.join(outdir, "*.bmp"))) >= n:
        return 0.0
    t0 = time.time()
    ds = synthetic_dataset(n, GridSpec(), seed=seed, input_size=0,
                           uint8=True, device=device)
    for i in range(n):
        Image.fromarray(ds.x[i, :, :, 0], mode="L").save(
            os.path.join(outdir, f"frame_{i:06d}.bmp"))
    return time.time() - t0


def find_checkpoint() -> str:
    for ckpt in (os.environ.get("SPNET_CKPT", ""), *CKPT_DIRS):
        if ckpt and os.path.exists(os.path.join(ckpt, STATE_FILENAME)):
            return ckpt
    raise SystemExit("movie_predict: no trained checkpoint found (set "
                     f"SPNET_CKPT, or train one into {CKPT_DIRS[0]})")


def main(argv=None) -> dict:
    t0 = time.time()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=512)
    p.add_argument("batch", type=int, nargs="?", default=512)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)
    ckpt = find_checkpoint()

    t_render = render_bmp_frames(FRAMES_DIR, args.n, device)
    print(f"frames ready in {t_render:.1f}s", flush=True)
    cfg, model, _ = load_model_and_state(ckpt, device)
    print(f"checkpoint {ckpt}: {cfg.model.backbone} "
          f"input_size={cfg.model.input_size}", flush=True)
    t1 = time.time()
    preds, files = predict_network(cfg, model, FRAMES_DIR, device,
                                   log_dir=LOG_DIR, batch_size=args.batch,
                                   num_draw=8, verbose=1)
    wall = time.time() - t1
    memory("after movie_predict", device)

    csvs = sorted(glob.glob(os.path.join(LOG_DIR, "*.csv")))
    overlays = sorted(glob.glob(os.path.join(LOG_DIR, "*.png")))
    if not preds.shape[0] == len(files) == args.n:
        raise SystemExit(f"movie_predict: {preds.shape[0]} predictions of "
                         f"{len(files)} files, {args.n} frames asked for")
    if not (csvs and overlays):
        raise SystemExit(f"movie_predict: {len(csvs)} CSV and "
                         f"{len(overlays)} overlays written")
    out = {
        "ckpt": ckpt,
        "frames": args.n,
        "bmp": True,
        "fps_incl_load": round(args.n / wall, 1),
        "csv": csvs[0],
        "overlays": len(overlays),
        "wall_s": round(time.time() - t0, 1),
    }
    print("MOVIE_RESULT " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
