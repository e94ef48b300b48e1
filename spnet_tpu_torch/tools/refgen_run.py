"""The Dataset-A recipe trained on the reference generator's frames.

    python -m spnet_tpu_torch.tools.refgen_run [epochs] [batch] [lr_max] \\
        [dtype] [input_size] [--device cuda]

Counterpart of the JAX package's `scripts/refgen_run.py`, with its argv
and defaults (100 epochs, b=16, lr_max 4e-5, float32, 331) and its
environment: SPNET_BACKBONE_DTYPE, SPNET_REMAT (remat is on at
input_size=0 unless SPNET_REMAT=0; SPNET_REMAT=1 turns it on anywhere),
SPNET_CKPT (checkpoint directory; a run resumes from it), SPNET_LOGDIR
(default logs/refgen_run) and SPNET_MATMUL_PRECISION (`tools/runtime.py`:
'highest' turns TF32 off).  The recipe: Xception, augmentation on, blur
off, a checkpoint every 10 epochs, seed 0, the training set resident on
the device (the graphed epoch form on one rank).

The frames are the first N_TRAIN + N_VAL of the shards that
`tools/refgen_dataset.py` draws into `logs/refgen_cache_torch/` (train
first, then val), read by `load_refgen`.  Ends with `evaluate_network` on
the val set and prints one line `REFGEN_RESULT {json}` with the JAX
script's keys: last (the last epoch's history entry), last10_ring_acc,
wall_s (load and training) and final_eval; before it the seconds of each
stage (load, train, eval) and the card's memory after each.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.grid import GridOverflowError, batch_ellipses_to_grid, \
    canonicalize_records, ellipses_to_grid, normalize
from spnet_tpu_torch.tools.refgen_dataset import CACHE_DIR
from spnet_tpu_torch.tools.runtime import add_device_arg, \
    apply_matmul_precision, card, memory, tool_device
from spnet_tpu_torch.train.loop import train_network

#: the recipe's split (module constants, as the JAX script's locals; the
#: CPU tests and the smoke shrink them, and the eval tools read them)
N_TRAIN = 40960
N_VAL = 4992


def load_refgen(n_train: int, n_val: int, grid: GridSpec, size: int = 331,
                seed: int = 0):
    """(train, val) Datasets of the first n_train + n_val refgen frames of
    `seed` at `size`, read from the shards in sorted order: the frames, the
    normalized grid labels (a cell's third object dropped, as the JAX
    script drops it; the count of frames that overflow a cell is printed),
    and the raw rows with their mask."""
    # a .tmp.npz is a shard cut off mid-write (the JAX script's glob
    # would read it in its shard's place)
    paths = sorted(p for p in glob.glob(
        os.path.join(CACHE_DIR, f"refgen_s{seed}_i{size}_*.npz"))
        if not p.endswith(".tmp.npz"))
    if not paths:
        raise FileNotFoundError(
            f"no refgen shards in {CACHE_DIR}; run python -m "
            "spnet_tpu_torch.tools.refgen_dataset first")
    xs, rows_l, mask_l = [], [], []
    total = 0
    for p in paths:
        with np.load(p, allow_pickle=False) as z:
            xs.append(z["x"])
            rows_l.append(z["rows"])
            mask_l.append(z["mask"])
        total += xs[-1].shape[0]
        if total >= n_train + n_val:
            break
    x = np.concatenate(xs)[: n_train + n_val]
    rows = np.concatenate(rows_l)[: n_train + n_val]
    mask = np.concatenate(mask_l)[: n_train + n_val]
    if x.shape[0] < n_train + n_val:
        raise ValueError(f"only {x.shape[0]} refgen frames in {CACHE_DIR}, "
                         f"need {n_train + n_val}")

    recs = [canonicalize_records(r[m]) for r, m in zip(rows, mask)]
    n_over = 0
    for rec in recs:
        try:
            ellipses_to_grid(rec, grid, "raise")
        except GridOverflowError:
            n_over += 1
    print(f"  grid-slot overflow frames: {n_over}/{len(recs)} "
          f"({100.0 * n_over / len(recs):.2f}%)", flush=True)
    flat = batch_ellipses_to_grid(recs, grid, on_overflow="drop")
    y = normalize(flat, grid).astype(np.float32)

    def mk(sl, tag):
        return Dataset(
            x=x[sl], y=y[sl],
            file_list=[f"refgen://{tag}/{i}" for i in range(len(x[sl]))],
            grid=grid, rows=rows[sl], row_mask=mask[sl])

    return mk(slice(0, n_train), "train"), \
        mk(slice(n_train, n_train + n_val), "val")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("epochs", type=int, nargs="?", default=100)
    p.add_argument("batch", type=int, nargs="?", default=16)
    p.add_argument("lr_max", type=float, nargs="?", default=4e-5)
    p.add_argument("dtype", nargs="?", default="float32")
    p.add_argument("input_size", type=int, nargs="?", default=331)
    add_device_arg(p)
    return p.parse_args(argv)


def experiment_config(args: argparse.Namespace) -> ExperimentConfig:
    """The recipe's config, as the JAX script builds it from the same argv
    and environment."""
    remat = os.environ.get("SPNET_REMAT")
    return ExperimentConfig(
        grid=GridSpec(),
        model=ModelConfig(backbone="Xception", input_size=args.input_size,
                          compute_dtype=args.dtype,
                          backbone_dtype=os.environ.get(
                              "SPNET_BACKBONE_DTYPE", ""),
                          remat=(remat == "1" or (args.input_size == 0
                                                  and remat != "0"))),
        train=TrainConfig(batch_size=args.batch, epochs=args.epochs,
                          lr_max=args.lr_max, augment=True, blur_prob=0.0,
                          save_every=10, seed=0),
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = tool_device(args.device)
    card(device)
    print(apply_matmul_precision())
    cfg = experiment_config(args)
    t0 = time.time()
    train_ds, val_ds = load_refgen(N_TRAIN, N_VAL, cfg.grid,
                                   size=args.input_size)
    load_s = time.time() - t0
    print(f"refgen data ready in {load_s:.1f}s  "
          f"train {train_ds.x.shape} val {val_ds.x.shape}", flush=True)

    ckpt = os.environ.get("SPNET_CKPT", "") or None
    logdir = os.environ.get("SPNET_LOGDIR", "") or "logs/refgen_run"
    t1 = time.time()
    state, history = train_network(
        cfg, train_ds, val_ds, device, log_dir=logdir, ckpt_dir=ckpt,
        render_overlays=False, device_data=True, verbose=1)
    train_s = time.time() - t1
    print(f"[stage] load: {load_s:.1f} s; train: {train_s:.1f} s",
          flush=True)
    memory("after training", device)
    tail = history[-10:]
    out = {
        "last": history[-1] if history else None,
        "last10_ring_acc": (sum(h["ring_acc"] for h in tail) / len(tail)
                            if tail else None),
        "wall_s": round(time.time() - t0, 1),
    }
    t2 = time.time()
    res = evaluate_network(cfg, state.model, val_ds, device,
                           log_dir=logdir.rstrip("/") + "_eval/",
                           num_draw=0, verbose=1)
    print(f"[stage] eval: {time.time() - t2:.1f} s", flush=True)
    memory("after evaluate_network", device)
    out["final_eval"] = res
    print("REFGEN_RESULT " + json.dumps(out, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
