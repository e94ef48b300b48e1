"""A disk cache of synthetic datasets for the validation tools.

Counterpart of `_cached_synth` in the JAX package's
`scripts/dataset_a_run.py`: the arrays of `synthetic_dataset` (x, y, the
raw rows and their mask) kept as one `.npz` a recipe, so that the runs
and evaluations of one recipe generate their frames once.

The port's frames are not the JAX package's (their noise comes from torch
generators), and the card's noise stream is not the CPU's, so the file
name carries `torch` and the device type: a directory that holds the JAX
scripts' caches never feeds their frames to the port, nor a CPU cache to
the card.  A frame is a function of (seed, index) on one device, so the
first n frames of a larger cache of the same recipe are the n-frame set,
and a hit on one is sliced instead of generated.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from spnet_tpu_torch.data.dataset import Dataset, synthetic_dataset

CACHE_DIR = "logs/synth_cache"


def cache_path(n: int, seed: int, input_size: int, device, blur=None,
               resize_method: str = "lanczos3",
               cache_dir: str = CACHE_DIR) -> str:
    """The cache file of n frames of `seed` at `input_size` rendered on
    `device`'s type; every rendering knob is in the name."""
    recipe = f"_b{blur}_{resize_method}" if (
        blur is not None or resize_method != "lanczos3") else ""
    return os.path.join(cache_dir, f"n{n}_s{seed}_i{input_size}{recipe}"
                        f"_torch_{torch.device(device).type}.npz")


def _dataset(z, n: int, seed: int, grid) -> Dataset:
    return Dataset(x=z["x"][:n], y=z["y"][:n],
                   file_list=[f"synthetic://{seed}/{i}" for i in range(n)],
                   grid=grid, rows=z["rows"][:n], row_mask=z["mask"][:n])


def cached_synth(n: int, cfg, seed: int, batch: int | None = None,
                 blur=None, resize_method: str = "lanczos3",
                 device="cuda", cache_dir: str = CACHE_DIR) -> Dataset:
    """`synthetic_dataset(n, cfg.grid, seed, cfg.model.input_size, batch,
    blur=blur, resize_method=resize_method, device=device)` through the
    disk cache: a hit returns the stored arrays; else the first n frames
    of a larger cache of the same recipe and device type; else the set is
    generated and stored (a write that fails is reported, not fatal)."""
    size = cfg.model.input_size
    path = cache_path(n, seed, size, device, blur, resize_method, cache_dir)
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            ds = _dataset(z, z["x"].shape[0], seed, cfg.grid)
        print(f"  (cache hit: {path})")
        return ds
    tail = os.path.basename(path).split("_s", 1)[1]
    for cand in sorted(glob.glob(os.path.join(cache_dir, f"n*_s{tail}"))):
        m = re.match(r"n(\d+)_s", os.path.basename(cand))
        if m and int(m.group(1)) > n:
            with np.load(cand, allow_pickle=False) as z:
                ds = _dataset(z, n, seed, cfg.grid)
            print(f"  (cache slice: first {n} of {cand})")
            return ds
    ds = synthetic_dataset(n, cfg.grid, seed=seed, input_size=size,
                           batch_size=batch, blur=blur,
                           resize_method=resize_method, device=device)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, x=ds.x, y=ds.y, rows=ds.rows, mask=ds.row_mask)
        os.replace(tmp, path)
    except OSError as e:
        print(f"  (cache not written: {e!r})")
    return ds
