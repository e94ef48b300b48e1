"""`python -m spnet_tpu_torch augment` — offline dataset inflation.

Counterpart of `spnet_tpu/cli/augment_preproc.py` (reference
`augment_preproc.py`): for every image + CSV pair, `n_augs` randomized
variants — flip in {none, v, h, vh}, rotation U(-20, 20) degrees,
translation 0 (one time in ten) or round(U(-40, 40)) pixels per axis —
written beside the original with the reference's provenance suffixes
(`_v/_h/_vh`, `_r<angle>`, `_t<dx>,<dy>`).  The draws are JAX's: one
`np.random.default_rng(seed)` for the whole directory, four draws per
variant in the same order, so the file names are the JAX tool's.

A file's variants are warped on `--device` (default `cuda`) with the
port's `flip_image_and_labels` -> `rotate_image_and_labels` ->
`translate_image_and_labels` (bilinear, zero fill; the ellipse rows
remapped alike), then copied to the host in one transfer; the PNG and CSV
files are written there.  As in JAX, a file keeps its first MAX_ROWS
ellipses, and the warped pixels are clipped to [0, 255] and truncated to
uint8.

With `--geo_augment` at train time, offline inflation is not needed; the
tool exists for the data contract (datasets other tools read).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from spnet_tpu_torch.cli.common import add_device_arg, resolve_device
from spnet_tpu_torch.data.csvio import paired_file_lists, read_raw_meta, \
    write_meta_file
from spnet_tpu_torch.ops.augment import flip_image_and_labels, \
    rotate_image_and_labels, translate_image_and_labels

MAX_ROWS = 16  # fixed-slot padding for label rows; rows past it are dropped
#: flip_sel -> (`flip_image_and_labels` mode, file-name suffix)
FLIPS = ((-2, ""), (0, "_v"), (1, "_h"), (-1, "_vh"))


def draw_variant(rng: np.random.Generator) -> tuple[int, float, float, float]:
    """(flip_sel, rotation degrees, tx, ty) of one variant, drawn as JAX's
    tool draws them."""
    flip_sel = int(rng.integers(0, 4))
    rot = float(rng.uniform(-20, 20))
    if rng.integers(0, 10) == 0:
        tx = ty = 0.0
    else:
        tx = float(np.round(rng.uniform(-40, 40)))
        ty = float(np.round(rng.uniform(-40, 40)))
    return flip_sel, rot, tx, ty


def variant_suffix(flip_sel: int, rot: float, tx: float, ty: float) -> str:
    suffix = FLIPS[flip_sel][1] + f"_r{rot:>.2f}"
    if tx or ty:
        suffix += f"_t{int(tx)},{int(ty)}"
    return suffix


def warp_variant(img, rows, mask, flip_sel: int, rot: float, tx: float,
                 ty: float):
    """One variant of img (H, W, 1) float32 and its padded rows (MAX_ROWS,
    6): flip, then rotate, then translate, as JAX's `_augment_one`."""
    img, rows = flip_image_and_labels(img, rows, mask, FLIPS[flip_sel][0])
    img, rows = rotate_image_and_labels(img, rows, mask, rot)
    return translate_image_and_labels(img, rows, mask, tx, ty)


def augment_one_file(img_path: str, meta_path: str, n_augs: int,
                     rng: np.random.Generator,
                     device: str | torch.device = "cuda") -> float:
    """Write the n_augs variants of one pair; returns the seconds from the
    upload of the frame to the host copy of its warped variants."""
    from PIL import Image

    img = np.asarray(Image.open(img_path), np.float32)
    if img.ndim == 2:
        img = img[..., None]
    raw = read_raw_meta(meta_path)
    n = raw.shape[0]
    rows = np.zeros((MAX_ROWS, 6), np.float32)
    rows[:n] = raw[:MAX_ROWS]
    mask = np.zeros((MAX_ROWS,), bool)
    mask[:n] = True

    draws = [draw_variant(rng) for _ in range(n_augs)]
    t0 = time.perf_counter()
    img_d = torch.from_numpy(img).to(device)
    rows_d = torch.from_numpy(rows).to(device)
    mask_d = torch.from_numpy(mask).to(device)
    outs = [warp_variant(img_d, rows_d, mask_d, *v) for v in draws]
    imgs = torch.stack([o[0] for o in outs]).cpu().numpy()
    out_rows = torch.stack([o[1] for o in outs]).cpu().numpy()
    warp_s = time.perf_counter() - t0

    prefix = os.path.splitext(img_path)[0]
    for v, out_img, out_r in zip(draws, imgs, out_rows):
        out_prefix = prefix + variant_suffix(*v)
        arr = np.clip(out_img, 0, 255).astype(np.uint8)  # truncates
        Image.fromarray(arr.squeeze(-1), "L").save(out_prefix + ".png")
        write_meta_file(out_prefix + ".csv", out_r[mask].tolist())
    return warp_s


def augment_data(path: str = "Train", n_augs: int = 39, seed: int = 0,
                 device: str | torch.device = "cuda") -> dict:
    """Inflate every pair in `path` by n_augs variants.  Returns files,
    variants, seconds (the whole call) and warp_seconds (uploads, warps and
    host copies)."""
    device = resolve_device(str(device))
    imgs, metas = paired_file_lists(
        path if path.endswith(os.sep) else path + os.sep)
    print(f"augment_data: inflating {len(imgs)} files in {path} "
          f"by {n_augs + 1}x on {device}")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    warp_s = 0.0
    for i, (im, mt) in enumerate(zip(imgs, metas)):
        if i % 10 == 0:
            print(f"     progress: {i}/{len(imgs)}", end="\r")
        warp_s += augment_one_file(im, mt, n_augs, rng, device)
    seconds = time.perf_counter() - t0
    print(f"\naugment_data: {len(imgs)} files, {len(imgs) * n_augs} "
          f"variants in {seconds:.2f} s "
          f"({len(imgs) / max(seconds, 1e-9):.2f} files/s); warp "
          f"{warp_s:.2f} s ({100 * warp_s / max(seconds, 1e-9):.1f} %)")
    return dict(files=len(imgs), variants=len(imgs) * n_augs,
                seconds=seconds, warp_seconds=warp_s)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="augments data in path",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-d", "--datapath", default="Train/")
    p.add_argument("-n", "--naugs", type=int, default=42)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)
    return augment_data(path=args.datapath, n_augs=args.naugs,
                        seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
