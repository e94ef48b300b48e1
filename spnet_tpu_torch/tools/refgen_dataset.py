"""Frames drawn by the reference generator's own cv2 pipeline, as npz
shards in the trainer's resident uint8 format.

    python -m spnet_tpu_torch.tools.refgen_dataset [total_frames] \\
        [input_size] [seed]

Counterpart of the JAX package's `scripts/refgen_dataset.py`, with its
argv and defaults (45,952 frames, 331, seed 0) and its arithmetic: a
host copy of the reference's drawing (`gen_fake_espi.py:145-277` of the
reference repository) in numpy, cv2 and PIL.  Per frame: a grey 128
background, cosine polylines (black, 15-40 px thick), 1-7 non-overlapping
ring ellipses (cv2.ellipse, LINE_AA, shift=10, the angle negated), the
reference's blur skipped (its `blur_inplace` discards the cv2 result),
N(40, 40) noise added with cv2's saturating add, a 0/1 pixel-dropout
mask, and a PIL LANCZOS resize of the native 512x384 frame to
input_size x input_size (input_size 0 keeps 512x384).  The rejection
sampler keeps the reference's quirks: the redo branch draws other axes
and angle ranges and refreshes the ring count only through the
line-width clamp.

Each frame is a pure function of (seed, index): `random.Random`,
`np.random.RandomState` and `cv2.setRNGSeed` are seeded per frame as
the JAX script seeds them, so the scenes are the JAX script's, and its
pixels too under the same cv2.  The frames of a shard are rendered over
a `multiprocessing` pool of `os.cpu_count()` workers (spawned: they
import no torch), bitwise the serial ones.

Shards of SHARD frames go to `logs/refgen_cache_torch/` (never the JAX
script's `logs/refgen_cache/`), each written through a `.tmp.npz` and
`os.replace`; a complete shard is skipped, so a run resumes.  A shard
records the cv2, numpy and PIL versions that drew it, and a rerun
refuses a shard of other versions: the pixels follow cv2's drawing, so
a shard from another installation is other data.  Host work only: no
tensor, no device.  Prints the worker count, the script's progress
lines, the frames per second, then `REFGEN_DONE`.
"""

from __future__ import annotations

import multiprocessing
import os
import random
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import cv2
import numpy as np
import PIL
from PIL import Image

from spnet_tpu_torch.data.dataset import pad_raw_rows

W, H = 512, 384  # reference imWidth / imHeight (gen_fake_espi.py:31-32)
MIN_LINE_WIDTH = 4  # px per ring pair (gen_fake_espi.py:46)
SHARD = 2048
BLACK, GREY = 0, 128
CACHE_DIR = "logs/refgen_cache_torch"
CHUNK = 8  # frames a pool task


def draw_waves(img, rnd: random.Random, rs: np.random.RandomState):
    """Background cosine stripes (`gen_fake_espi.py:60-80`)."""
    xs = np.arange(0, W)
    amp = rnd.randint(10, 200)
    x_wavelength = rnd.randint(100, W // 2)
    thickness = rnd.randint(15, 40)
    slope = 3 * (rs.rand() - 0.5)
    y_spacing = rnd.randint(
        thickness + thickness * int(np.abs(1.5 * slope)), H // 3)
    numlines = 60 + H // y_spacing
    cos_term = amp * np.cos(xs / x_wavelength)
    for j in range(numlines):
        y_start = j * y_spacing - W * abs(slope)  # img.shape[1] == W
        ys = (y_start + slope * xs + cos_term).astype(np.int64)
        pts = np.stack([xs, ys], axis=1).astype(np.int32)
        cv2.polylines(img, [pts], False, BLACK, thickness=thickness)


def ellipse_box(center, axes, angle_deg):
    """Axis-aligned bbox of a rotated ellipse (`gen_fake_espi.py:82-98`)."""
    rad = np.radians(angle_deg)
    a, b = axes
    dx = np.sqrt(a**2 * np.cos(rad) ** 2 + b**2 * np.sin(rad) ** 2)
    dy = np.sqrt(a**2 * np.sin(rad) ** 2 + b**2 * np.cos(rad) ** 2)
    return [center[0] - dx, center[1] - dy, center[0] + dx, center[1] + dy]


def boxes_overlap(a, b):
    return not (a[2] < b[0] or a[0] > b[2] or a[3] < b[1] or a[1] > b[3])


def draw_ring_ellipse(img, center, axes, angle, color, thickness):
    """The reference's sub-pixel AA ellipse (`utils.py:35-54`): shift=10
    fixed-point center / axes, LINE_AA, the angle NEGATED (the web
    interface is 'upside down')."""
    shift = 10
    center = (int(round(center[0] * 2**shift)),
              int(round(center[1] * 2**shift)))
    axes = (int(round(axes[0] * 2**shift)),
            int(round(axes[1] * 2**shift)))
    cv2.ellipse(img, center, axes, -angle, 0, 360, color, thickness,
                cv2.LINE_AA, shift)


def draw_rings(img, center, axes, angle, num_rings,
               rs: np.random.RandomState):
    """Concentric alternating rings (`gen_fake_espi.py:101-114`)."""
    num_wb = 2 * num_rings if num_rings > 0 else 1
    thickness = int(round(min(axes) / num_wb))
    rand_start = rs.choice([0, 1])
    for j in range(num_wb):
        color = BLACK if (rand_start + j) % 2 == 0 else GREY + 10
        sub_axes = [ax * (j + 1) * 1.0 / (num_wb + 1) for ax in axes]
        draw_ring_ellipse(img, center, sub_axes, angle, color, thickness)


def draw_antinodes(img, num_antinodes, rnd, rs):
    """Rejection-sampled non-overlapping antinodes
    (`gen_fake_espi.py:145-206`), with its quirks: the redo branch draws
    from another axes range and refreshes num_rings only through the
    line-width clamp; the angle ranges differ (1..179 on the first try,
    1..180 on a redo)."""
    boxes, rows = [], []
    for _ in range(num_antinodes):
        axes = (rnd.randint(15, int(W / 3.5)), rnd.randint(15, int(H / 3.5)))
        axes = sorted(axes, reverse=True)
        max_rings = min(axes[1] // 8, 11)
        num_rings = rnd.randint(1, max_rings)
        if axes[1] / num_rings < MIN_LINE_WIDTH:
            num_rings = axes[1] // MIN_LINE_WIDTH
        center = (rnd.randint(axes[0], W - axes[0]),
                  rnd.randint(axes[1], H - axes[1]))
        angle = rnd.randint(1, 179)
        box = ellipse_box(center, axes, angle)

        trycount, maxtries = 0, 2000
        while ((any(boxes_overlap(box, b) for b in boxes)
                or box[0] < 0 or box[2] > W or box[1] < 0 or box[3] > H)
               and trycount < maxtries):
            trycount += 1
            axes = sorted((rnd.randint(25, W // 3), rnd.randint(25, H // 3)),
                          reverse=True)
            if axes[1] / num_rings < MIN_LINE_WIDTH:
                num_rings = axes[1] // MIN_LINE_WIDTH
            center = (rnd.randint(axes[0], W - axes[0]),
                      rnd.randint(axes[1], H - axes[1]))
            angle = rnd.randint(1, 180)
            box = ellipse_box(center, axes, angle)

        if trycount < maxtries:
            draw_rings(img, center, axes, angle, num_rings, rs)
            rows.append([center[0], center[1], axes[0], axes[1],
                         angle, num_rings])
            boxes.append(box)
    return rows


def render_frame(seed: int, idx: int):
    """One reference-pipeline frame -> (uint8 (H, W), raw label rows)."""
    rnd = random.Random((seed << 32) ^ (idx * 2654435761 & 0xFFFFFFFF))
    rs = np.random.RandomState((seed * 1000003 + idx) % (2**31 - 1))
    cv2.setRNGSeed((seed * 7 + idx * 13) % (2**31 - 1))

    img = GREY * np.ones((H, W, 1), np.uint8)
    draw_waves(img, rnd, rs)
    num_antinodes = rnd.randint(1, 7)  # gen_fake_espi.py:251-252
    rows = draw_antinodes(img, num_antinodes, rnd, rs)
    # blur_inplace: a no-op (result discarded, augmentation.py:66-70)
    noise = np.zeros((H, W, 1), np.uint8)
    cv2.randn(noise, 40, 40)  # gen_fake_espi.py:263
    img = cv2.add(img, noise)  # saturating; cv2 squeezes to (H, W)
    mask = rs.randint(0, 2, size=img.shape).astype(np.uint8)
    img = img * mask  # gen_fake_espi.py:267-268 (0/1 pixel dropout)
    return img.reshape(H, W), rows


def resize_frame(img: np.ndarray, size: int | None) -> np.ndarray:
    """The reference's load path: PIL ANTIALIAS (== LANCZOS) square resize
    (`utils.py:337`).  size 0 / None keeps the native 512x384."""
    if not size:
        return img
    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.LANCZOS))


def _frame(job):
    """(resized frame, rows) of job = (seed, idx, size): a pool's task."""
    seed, idx, size = job
    img, rows = render_frame(seed, idx)
    return resize_frame(img, size), rows


def make_pool(workers: int | None = None) -> ProcessPoolExecutor:
    """A pool of `workers` (os.cpu_count()) spawned processes for
    `gen_shard`; the caller shuts it down.  A worker that dies breaks the
    pool, and the next map raises (`BrokenProcessPool`)."""
    return ProcessPoolExecutor(workers or os.cpu_count(),
                               mp_context=multiprocessing.get_context(
                                   "spawn"))


def gen_shard(seed, start, count, size, pool=None):
    """Frames start .. start + count - 1 of `seed` at `size` -> (x (count,
    h, w, 1) uint8, rows (count, ROW_SLOTS, 6), mask (count, ROW_SLOTS)),
    rendered here or, given `pool` (`make_pool`), over its workers in
    frame order."""
    jobs = [(seed, start + i, size) for i in range(count)]
    if pool is None:
        frames = map(_frame, jobs)
    else:
        frames = pool.map(_frame, jobs, chunksize=CHUNK)
    xs = np.zeros((count, size or H, size or W, 1), np.uint8)
    raws = []
    for i, (img, rows) in enumerate(frames):
        xs[i, :, :, 0] = img
        raws.append(np.array(rows, np.float32).reshape(-1, 6))
    rows_arr, mask_arr = pad_raw_rows(raws)
    return xs, rows_arr, mask_arr


def versions() -> np.ndarray:
    """The installation that draws: cv2, numpy and PIL versions."""
    return np.array([f"cv2={cv2.__version__}", f"numpy={np.__version__}",
                     f"PIL={PIL.__version__}"])


def shard_path(seed: int, size: int, s: int,
               cache_dir: str = CACHE_DIR) -> str:
    return os.path.join(cache_dir, f"refgen_s{seed}_i{size}_{s:04d}.npz")


def check_versions(path: str) -> None:
    """Raise SystemExit unless the shard at `path` was drawn by this
    installation's cv2, numpy and PIL."""
    with np.load(path, allow_pickle=False) as z:
        got = list(z["versions"]) if "versions" in z.files else None
    want = list(versions())
    if got != want:
        raise SystemExit(
            f"refgen_dataset: {path} was drawn with "
            f"{got if got is not None else 'unrecorded versions'}, this "
            f"installation has {want}: its pixels are other data; move "
            "the shard away or draw the set into another directory")


def write_shards(total: int, size: int, seed: int, pool,
                 cache_dir: str = CACHE_DIR) -> int:
    """Draw the missing shards of `total` frames into `cache_dir`, with
    the JAX script's progress lines; returns the frames drawn."""
    os.makedirs(cache_dir, exist_ok=True)
    t0 = time.time()
    drawn = 0
    n_shards = (total + SHARD - 1) // SHARD
    for s in range(n_shards):
        start = s * SHARD
        count = min(SHARD, total - start)
        path = shard_path(seed, size, s, cache_dir)
        if os.path.exists(path):
            check_versions(path)
            print(f"shard {s}/{n_shards}: exists, skip", flush=True)
            continue
        xs, rows, mask = gen_shard(seed, start, count, size, pool)
        tmp = path + ".tmp.npz"
        np.savez(tmp, x=xs, rows=rows, mask=mask, versions=versions())
        os.replace(tmp, path)
        drawn += count
        done = start + count
        rate = done / (time.time() - t0 + 1e-9)
        print(f"shard {s}/{n_shards} done ({done}/{total} frames, "
              f"{rate:.1f} fr/s, eta {(total-done)/max(rate,1e-9):.0f}s)",
              flush=True)
    return drawn


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    total = int(argv[0]) if len(argv) > 0 else 45952
    size = int(argv[1]) if len(argv) > 1 else 331
    seed = int(argv[2]) if len(argv) > 2 else 0
    workers = os.cpu_count()
    print(f"refgen: {total} frames at input_size {size}, seed {seed}, into "
          f"{CACHE_DIR}; {workers} workers (os.cpu_count()); "
          f"{', '.join(versions())}", flush=True)
    t0 = time.time()
    with make_pool(workers) as pool:
        drawn = write_shards(total, size, seed, pool)
    seconds = time.time() - t0
    out = {"frames": drawn, "seconds": round(seconds, 1),
           "frames_per_s": round(drawn / seconds, 2) if drawn else None,
           "workers": workers}
    print(f"refgen: drew {drawn} frames in {seconds:.1f} s "
          f"({out['frames_per_s']} frames/s over {workers} workers)",
          flush=True)
    print("REFGEN_DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
