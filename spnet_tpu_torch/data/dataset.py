"""Dataset assembly: images X + grid-encoded targets Y.

Capability twin of the reference's `build_dataset`/`build_X`/`build_Y`
(`spnet/utils.py:289-482`), with the hidden means/ranges
module state replaced by the explicit `GridSpec` and the multiprocessing
shared-memory image loader replaced by (a) a PIL host loader with an
optional .npy cache and (b) the native C++ loader in
`spnet_tpu_torch/native` when built (see loader.py).  The port's copy of
`spnet_tpu/data/dataset.py`; its `synthetic_dataset` renders with the
port's generator (`data/synth.py`) and resizes (`ops/resize.py`) on a
torch device.

Data contract preserved: directories of paired `*.png` + `*.csv`; images
resized to input_size x input_size, grayscale, Inception scaling
(img/255 - 0.5) * 2  (`utils.py:340-342`); Y is the normalized flat
(B, nx*ny*preds*8) grid; dataset truncated to a multiple of batch_size
(`utils.py:471-472`).
"""

from __future__ import annotations

import dataclasses
import os
import random as py_random

import numpy as np

from spnet_tpu_torch.config import GridSpec
from spnet_tpu_torch.data.csvio import paired_file_lists, parse_meta_file
from spnet_tpu_torch.grid import batch_ellipses_to_grid, normalize


@dataclasses.dataclass
class Dataset:
    x: np.ndarray  # (N, H, W, 1) uint8 raw pixels OR float32 inception-scaled
    y: np.ndarray  # (N, num_outputs) float32, normalized
    file_list: list[str]
    grid: GridSpec
    #: Optional padded RAW ellipse rows (N, S, 6) [cx,cy,a,b,angle,rings]
    #: in native image coordinates + slot validity (N, S) — carried so
    #: train-time GEOMETRIC augmentation can re-encode labels on device.
    rows: np.ndarray | None = None
    row_mask: np.ndarray | None = None


#: Padded raw-row slots per image for the geo-augment path.  12 covers
#: the generator's MAX_ANTINODES (7) and every reference dataset; images
#: with more rows keep the first ROW_SLOTS after the (cx, cy) sort.
ROW_SLOTS = 12


def pad_raw_rows(raw_list: list[np.ndarray], slots: int = ROW_SLOTS
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length raw row arrays into fixed (B, slots, 6) +
    validity mask (B, slots)."""
    b = len(raw_list)
    rows = np.zeros((b, slots, 6), np.float32)
    mask = np.zeros((b, slots), bool)
    for i, r in enumerate(raw_list):
        r = np.asarray(r, np.float32).reshape(-1, 6)
        n = min(r.shape[0], slots)
        rows[i, :n] = r[:n]
        mask[i, :n] = True
    return rows, mask


def nearest_multiple(a: int, b: int) -> int:
    """Largest multiple of b that is <= a (reference `utils.py:256`)."""
    return (a // b) * b


def load_image(path: str, size: int | None, grayscale: bool = True,
               method: str = "lanczos3") -> np.ndarray:
    """Decode + resize one image -> float32 (H, W, 1) in [-1, 1].

    method 'lanczos3' (default) matches the reference's PIL ANTIALIAS
    resize (`utils.py:337`); 'box' = area averaging."""
    from PIL import Image

    img = Image.open(path)
    if size and img.size != (size, size):  # size 0/None = native resolution
        img = img.resize((size, size),
                         Image.LANCZOS if method == "lanczos3"
                         else Image.BOX)
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]  # keep one channel of RGB sources
    arr = (arr / 255.0 - 0.5) * 2.0
    return arr[..., None]


def quantize_u8(x: np.ndarray) -> np.ndarray:
    """Inception-scaled float32 [-1, 1] -> uint8 pixel values.

    Inverse of the in-step `_prep_x` normalization (train/steps.py);
    quantization error is < 1/255 of the dynamic range — the same
    contract as the JAX package's synthetic path (its
    `synthetic_dataset` clips+casts its rendered frames to uint8)."""
    return np.clip(np.rint((x * 0.5 + 0.5) * 255.0), 0, 255).astype(
        np.uint8)


def build_x(
    img_files: list[str], size: int | None = 331, verbose: bool = True,
    method: str = "lanczos3", uint8: bool = False,
) -> np.ndarray:
    """Load a list of images into (N, size, size, 1).

    float32 inception-scaled by default; `uint8=True` stores raw pixel
    bytes instead (4x less host RAM and device memory; the train and
    predict steps normalize uint8 on the device, `train/steps.py`).  Uses
    the native C++ decode pipeline when available, else PIL.  The uint8
    native path converts in bounded chunks so peak host memory stays
    ~chunk-sized, not dataset-sized."""
    n = len(img_files)
    if n == 0:
        raise ValueError("no images to load")
    try:
        from spnet_tpu_torch.data.loader import native_build_x

        if uint8:
            chunk = 4096
            out = None
            for lo in range(0, n, chunk):
                part = native_build_x(img_files[lo:lo + chunk], size,
                                      method)
                if part is None:
                    out = None
                    break
                if out is None:
                    out = np.zeros((n,) + part.shape[1:], np.uint8)
                out[lo:lo + part.shape[0]] = quantize_u8(part)
                if verbose and n > 2000:
                    print(f"      loading image {lo + part.shape[0]}/{n}",
                          end="\r")
            if out is not None:
                if verbose and n > 2000:
                    print()
                return out
        else:
            out = native_build_x(img_files, size, method)
            if out is not None:
                return out
    except Exception:
        pass
    first = load_image(img_files[0], size, method=method)
    x = np.zeros((n,) + first.shape, np.uint8 if uint8 else np.float32)
    x[0] = quantize_u8(first) if uint8 else first
    for i in range(1, n):
        if verbose and i % 2000 == 0:
            print(f"      loading image {i}/{n}", end="\r")
        arr = load_image(img_files[i], size, method=method)
        x[i] = quantize_u8(arr) if uint8 else arr
    if verbose and n > 2000:
        print()
    return x


def build_y(
    meta_files: list[str], grid: GridSpec,
    img_files: list[str] | None = None, on_overflow: str = "raise",
) -> np.ndarray:
    """Parse all metadata, encode to the grid, normalize.

    on_overflow='drop' tolerates cells with more ellipses than predictor
    slots (can happen on heavily augmented data); default matches the
    reference's hard assert."""
    recs = []
    for i, mf in enumerate(meta_files):
        try:
            recs.append(parse_meta_file(mf))
        except Exception as e:  # surface the offending file
            raise ValueError(f"failed parsing {mf}: {e}") from e
    try:
        flat = batch_ellipses_to_grid(recs, grid, on_overflow)
    except Exception as e:
        raise ValueError(f"grid encoding failed in {meta_files[0]}..: {e}"
                         ) from e
    return normalize(flat, grid).astype(np.float32)


def build_dataset(
    path: str,
    grid: GridSpec | None = None,
    load_frac: float = 1.0,
    batch_size: int | None = None,
    shuffle: bool = True,
    input_size: int = 331,
    seed: int | None = None,
    cache: bool = False,
    on_overflow: str = "raise",
    shard_index: int = 0,
    num_shards: int = 1,
    uint8: bool = True,
) -> Dataset:
    """Load a Train/Val/Test directory into a Dataset.

    uint8 (default): store frames as raw pixel bytes, normalized on
    device in-step (`train/steps.py`) — 4x less host RAM, HBM
    and host->device traffic than float32.  Pass uint8=False for the float32
    inception-scaled layout (sub-1/255 quantization differences).

    shard_index/num_shards: multi-host input sharding — every process
    computes the SAME deterministic global shuffle (seeded), then takes
    the strided slice `files[shard_index::num_shards]`, so the union of
    all hosts is an exact partition of the dataset (grain-style sharded
    file lists; each host feeds its local devices of the global mesh).
    """
    grid = grid or GridSpec()
    img_files, meta_files = paired_file_lists(
        path if path.endswith(os.sep) else path + os.sep
    )
    if shuffle:
        pairs = list(zip(img_files, meta_files))
        rng = py_random.Random(seed)
        rng.shuffle(pairs)
        img_files, meta_files = map(list, zip(*pairs))
    if num_shards > 1:
        img_files = img_files[shard_index::num_shards]
        meta_files = meta_files[shard_index::num_shards]

    total = int(len(img_files) * load_frac)
    if batch_size:
        total = nearest_multiple(total, batch_size)
    if total == 0:
        raise ValueError(
            f"{path}: 0 usable examples (found {len(img_files)} files, "
            f"load_frac={load_frac}, batch_size={batch_size})"
        )
    img_files, meta_files = img_files[:total], meta_files[:total]

    suffix = "_u8" if uint8 else ""
    cache_path = os.path.join(path, f".x_cache_{input_size}{suffix}.npz")
    y = build_y(meta_files, grid, img_files, on_overflow=on_overflow)
    if cache and not shuffle and os.path.exists(cache_path):
        x = np.load(cache_path)["x"]
        if x.shape[0] != total:
            x = build_x(img_files, input_size, uint8=uint8)
    else:
        x = build_x(img_files, input_size, uint8=uint8)
        if cache and not shuffle:
            np.savez(cache_path, x=x)
    from spnet_tpu_torch.data.csvio import read_raw_meta

    rows, row_mask = pad_raw_rows([read_raw_meta(m) for m in meta_files])
    return Dataset(x=x, y=y, file_list=img_files, grid=grid,
                   rows=rows, row_mask=row_mask)


def batches(n: int, batch_size: int, shuffle: bool = True,
            seed: int = 0):
    """Yield index arrays covering [0, n) in batches (drop remainder)."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for s in range(0, n - batch_size + 1, batch_size):
        yield idx[s : s + batch_size]


def synthetic_dataset(
    num_frames: int,
    grid: GridSpec | None = None,
    seed: int = 0,
    input_size: int = 331,
    batch_size: int | None = None,
    uint8: bool = True,
    blur: bool | None = None,
    resize_method: str = "lanczos3",
    device="cuda",
) -> Dataset:
    """In-memory synthetic dataset: generator -> arrays, no PNG round
    trip (the twin of the JAX package's `synthetic_dataset`).  Frames
    render and resize on `device` (a torch device) in batches of 256;
    only the final resized frames come back to the host, by default as
    uint8: clipped to [0, 255] and cast, which truncates (not
    `quantize_u8`'s rounding), as the JAX package does.  Labels, raw rows
    and their mask come from the host codec and are bitwise the JAX
    package's; the pixels agree up to the noise (see `data/synth.py`)."""
    import torch

    from spnet_tpu_torch.data.synth import render_frames, sample_scene, \
        scenes_to_arrays
    from spnet_tpu_torch.grid import canonicalize_records
    from spnet_tpu_torch.ops.resize import resize

    device = torch.device(device)
    grid = grid or GridSpec()
    input_size = input_size or None  # 0 -> native resolution
    if batch_size:
        num_frames = nearest_multiple(num_frames, batch_size)

    xs, ys, files, raws = [], [], [], []
    gen_batch = 256
    for b0 in range(0, num_frames, gen_batch):
        nb = min(gen_batch, num_frames - b0)
        scenes = [sample_scene(seed, b0 + i, blur=blur)
                  for i in range(nb)]
        imgs = render_frames(scenes_to_arrays(scenes), device=device)
        if input_size:  # 0/None = the 'big' native-resolution convention
            # lanczos3 matches the reference's PIL ANTIALIAS downsampling
            # (`utils.py:337`); a triangle filter smears the thin (2-4 px)
            # ring bands the ring-count regression depends on
            imgs = resize(imgs, (input_size, input_size), resize_method,
                          antialias=True)
        xs.append(torch.clamp(imgs, 0, 255).to(torch.uint8)
                  .cpu().numpy()[..., None])
        raw_rows = [np.array(s.caption_rows()).reshape(-1, 6)
                    for s in scenes]
        raws.extend(raw_rows)
        recs = [canonicalize_records(r) for r in raw_rows]
        ys.append(normalize(batch_ellipses_to_grid(recs, grid), grid))
        base = len(files)
        files.extend(
            f"synthetic://{seed}/{base + i}" for i in range(len(scenes))
        )
    x = np.concatenate(xs)
    if not uint8:
        x = ((x.astype(np.float32) / 255.0) - 0.5) * 2.0
    rows, row_mask = pad_raw_rows(raws)
    return Dataset(
        x=x,
        y=np.concatenate(ys).astype(np.float32),
        file_list=files,
        grid=grid,
        rows=rows,
        row_mask=row_mask,
    )
