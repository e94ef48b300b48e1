"""The Dataset-A recipe's validation run: train on synthetic frames, then
score the val set.

    python -m spnet_tpu_torch.tools.dataset_a [epochs] [batch] [lr_max] \\
        [n_train] [compute_dtype] [input_size] [backbone] [--device cuda]

Counterpart of the JAX package's `scripts/dataset_a_run.py`, with its
argv and defaults (100 epochs, b=16, lr_max 4e-5, 40,960 frames,
bfloat16, 331, Xception) and its environment: SPNET_NVAL (val frames,
4992), SPNET_BACKBONE_DTYPE, SPNET_REMAT (remat is on at input_size=0
unless SPNET_REMAT=0; SPNET_REMAT=1 turns it on anywhere), SPNET_AUGMENT=0
(augmentation off), SPNET_CKPT (checkpoint directory; a run resumes from
it), SPNET_LOGDIR (default logs/dataset_a) and SPNET_MATMUL_PRECISION
(`tools/runtime.py`: 'highest' turns TF32 off).  The recipe: blur off,
a checkpoint every 10 epochs, seed 0 for the model and the train frames,
seed 777777 for the val frames, both from the disk cache
(`tools/synth_cache.py`), the training set resident on the device.

Ends with `evaluate_network` on the val set (mAP included) and prints one
line `DATASET_A_RESULT {json}` with the JAX script's keys: last (the last
epoch's history entry), last10_ring_acc, wall_s (data and training) and
final_eval.  On the card it also prints the memory after training and
after the evaluation, and the host time of `calc_map`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.tools.runtime import add_device_arg, \
    apply_matmul_precision, memory, tool_device
from spnet_tpu_torch.tools.synth_cache import cached_synth
from spnet_tpu_torch.train.loop import train_network

TRAIN_SEED, VAL_SEED = 0, 777777


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("epochs", type=int, nargs="?", default=100)
    p.add_argument("batch", type=int, nargs="?", default=16)
    p.add_argument("lr_max", type=float, nargs="?", default=4e-5)
    p.add_argument("n_train", type=int, nargs="?", default=40960)
    p.add_argument("compute_dtype", nargs="?", default="bfloat16")
    p.add_argument("input_size", type=int, nargs="?", default=331)
    p.add_argument("backbone", nargs="?", default="Xception")
    add_device_arg(p)
    return p.parse_args(argv)


def experiment_config(args: argparse.Namespace) -> ExperimentConfig:
    """The recipe's config, as the JAX script builds it from the same argv
    and environment."""
    remat = os.environ.get("SPNET_REMAT")
    return ExperimentConfig(
        grid=GridSpec(),
        model=ModelConfig(backbone=args.backbone,
                          input_size=args.input_size,
                          compute_dtype=args.compute_dtype,
                          backbone_dtype=os.environ.get(
                              "SPNET_BACKBONE_DTYPE", ""),
                          remat=(remat == "1" or (args.input_size == 0
                                                  and remat != "0"))),
        train=TrainConfig(batch_size=args.batch, epochs=args.epochs,
                          lr_max=args.lr_max,
                          augment=os.environ.get("SPNET_AUGMENT", "1")
                          != "0",
                          blur_prob=0.0, save_every=10, seed=TRAIN_SEED),
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = tool_device(args.device)
    print(apply_matmul_precision())
    cfg = experiment_config(args)
    n_val = int(os.environ.get("SPNET_NVAL", "4992"))
    t0 = time.time()
    print(f"generating {args.n_train} train + {n_val} val synthetic "
          f"frames on {device}...")
    train_ds = cached_synth(args.n_train, cfg, seed=TRAIN_SEED,
                            batch=args.batch, device=device)
    val_ds = cached_synth(n_val, cfg, seed=VAL_SEED, device=device)
    print(f"  data ready in {time.time() - t0:.1f}s  "
          f"train {train_ds.x.shape}  val {val_ds.x.shape}", flush=True)

    ckpt = os.environ.get("SPNET_CKPT", "") or None
    logdir = os.environ.get("SPNET_LOGDIR", "") or "logs/dataset_a"
    state, history = train_network(
        cfg, train_ds, val_ds, device, log_dir=logdir, ckpt_dir=ckpt,
        render_overlays=False, device_data=True, verbose=1)
    memory("after training", device)
    tail = history[-10:]
    out = {
        "last": history[-1] if history else None,
        "last10_ring_acc": (sum(h["ring_acc"] for h in tail) / len(tail)
                            if tail else None),
        "wall_s": round(time.time() - t0, 1),
    }
    res = evaluate_network(cfg, state.model, val_ds, device,
                           log_dir=logdir.rstrip("/") + "_eval/",
                           num_draw=0, verbose=1)
    memory("after evaluate_network", device)
    out["final_eval"] = res
    print("DATASET_A_RESULT " + json.dumps(out, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
