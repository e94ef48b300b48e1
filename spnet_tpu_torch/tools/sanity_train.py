"""A short learning-dynamics run: train on in-memory synthetic frames and
check that the accuracy metrics climb.

    python -m spnet_tpu_torch.tools.sanity_train [n_frames] [epochs] \\
        [backbone] [lr_max] [n_val] [--device cuda]

Counterpart of the JAX package's `scripts/sanity_train.py`, with its argv
and defaults (2048 frames, 15 epochs, Xception, lr_max 2e-4, 256 val
frames): 331x331, b=32, augmentation on with the TrainConfig's blur
probability, train frames of seed 0 and val frames of seed 777777, logs
in logs/sanity, checkpoints in SPNET_CKPT when set.  SPNET_MAP=1 adds
`evaluate_network` on the val set.  Prints one JSON line: first and last
(history entries), wall_s[, final_eval].
"""

from __future__ import annotations

import argparse
import json
import os
import time

from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.tools.runtime import add_device_arg, memory, \
    tool_device
from spnet_tpu_torch.train.loop import train_network


def main(argv=None, *, input_size: int = 331) -> dict:
    """The run's dict.  `input_size` is the JAX script's fixed 331; the
    keyword lets a CPU test run it small."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_frames", type=int, nargs="?", default=2048)
    p.add_argument("epochs", type=int, nargs="?", default=15)
    p.add_argument("backbone", nargs="?", default="Xception")
    p.add_argument("lr_max", type=float, nargs="?", default=2e-4)
    p.add_argument("n_val", type=int, nargs="?", default=256)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)

    cfg = ExperimentConfig(
        grid=GridSpec(),
        model=ModelConfig(backbone=args.backbone, input_size=input_size),
        train=TrainConfig(batch_size=32, epochs=args.epochs,
                          lr_max=args.lr_max, augment=True,
                          save_every=1000, seed=0),
    )
    t0 = time.time()
    print(f"generating {args.n_frames} synthetic frames on {device}...")
    train_ds = synthetic_dataset(args.n_frames, cfg.grid, seed=0,
                                 input_size=cfg.model.input_size,
                                 batch_size=cfg.train.batch_size,
                                 device=device)
    val_ds = synthetic_dataset(args.n_val, cfg.grid, seed=777777,
                               input_size=cfg.model.input_size,
                               device=device)
    print(f"  data ready in {time.time() - t0:.1f}s  "
          f"train {train_ds.x.shape}  val {val_ds.x.shape}")

    ckpt = os.environ.get("SPNET_CKPT", "") or None
    state, history = train_network(
        cfg, train_ds, val_ds, device, log_dir="logs/sanity",
        ckpt_dir=ckpt, render_overlays=False, verbose=1)
    memory("after training", device)
    out = {
        "first": history[0], "last": history[-1],
        "wall_s": round(time.time() - t0, 1),
    }
    if os.environ.get("SPNET_MAP", "0") == "1":
        out["final_eval"] = evaluate_network(
            cfg, state.model, val_ds, device, log_dir="logs/sanity_eval/",
            num_draw=0, verbose=1)
        memory("after evaluate_network", device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
