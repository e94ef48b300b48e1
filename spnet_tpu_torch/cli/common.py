"""Shared CLI plumbing: the device flag, the model flags, config assembly
and checkpoint loading.

`parse_grid`, `add_model_args`, `config_from_args` and
`timestamped_log_dir` are those of `spnet_tpu/cli/common.py`, which
imports jax and so cannot be reused."""

from __future__ import annotations

import argparse
import time

import torch

from spnet_tpu_torch.io.checkpoint import load_checkpoint
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.shared import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig


def parse_grid(s: str) -> tuple[int, int, int]:
    """'6x6x2' -> (6, 6, 2) (reference `train_spnet.py:118`)."""
    parts = [int(v) for v in s.split("x")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError("grid must look like 6x6x2")
    return tuple(parts)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's model flags; `build_model` raises for the choices not
    ported yet (InceptionResNetV2, NASNetMobile, DarkNet19, remat).  The
    selective-sigmoid and compound heads have no flag here either: a
    checkpoint's `experiment.json` or a `ModelConfig` selects them."""
    p.add_argument("--backbone", default="Xception",
                   choices=["Xception", "MobileNet", "MobileNetTiny",
                            "InceptionResNetV2", "NASNetMobile",
                            "DarkNet19"],
                   help="CNN backbone (Xception, MobileNet and "
                        "MobileNetTiny are ported)")
    p.add_argument("--loss_type", default="same",
                   choices=["same", "hybrid"],
                   help="'same' = MSE existence, 'hybrid' = BCE logits")
    p.add_argument("--input_size", type=int, default=331,
                   help="square input resolution; 0 = no resize, native "
                        "512x384 frames")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"], help="compute dtype")
    p.add_argument("--backbone_dtype", default="",
                   choices=["", "bfloat16", "float32"],
                   help="the backbone's compute dtype (empty = --dtype)")
    p.add_argument("--pretrained", default="",
                   help="Keras pretrained backbone weights (not ported "
                        "yet: any value raises)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone activations (not ported "
                        "yet: raises)")


def config_from_args(args, grid_tuple=(6, 6, 2)) -> ExperimentConfig:
    nx, ny, preds = grid_tuple
    return ExperimentConfig(
        grid=GridSpec(nx=nx, ny=ny, preds_per_cell=preds),
        model=ModelConfig(
            backbone=getattr(args, "backbone", "Xception"),
            input_size=getattr(args, "input_size", 331),
            loss_type=getattr(args, "loss_type", "same"),
            compute_dtype=getattr(args, "dtype", "bfloat16"),
            backbone_dtype=getattr(args, "backbone_dtype", ""),
            pretrained=getattr(args, "pretrained", ""),
            remat=getattr(args, "remat", False),
        ),
        train=TrainConfig(
            batch_size=getattr(args, "batch_size", 16),
            epochs=getattr(args, "epochs", 100),
            lr_max=getattr(args, "lrmax", 4e-5),
            freeze_fac=getattr(args, "freeze_fac", 0.0),
            frozen_epochs=getattr(args, "frozen_epochs", 0),
            fraction=getattr(args, "fraction", 1.0),
            seed=getattr(args, "random_seed", 1),
            augment=not getattr(args, "noaugment", False),
            blur_prob=getattr(args, "blur_prob", 0.0),
        ),
    )


def timestamped_log_dir(name: str = "") -> str:
    now = time.strftime("%c").replace("  ", "_").replace(" ", "_")
    base = "./logs/"
    return base + (name + "_" + now if name else now)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda', 'cuda:1', 'cpu')")


def resolve_device(name: str) -> torch.device:
    """The device asked for; CUDA asked for and absent is an error, never
    a silent switch to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available on this "
                         "host (pass --device cpu to run on the CPU)")
    return device


def load_model_and_state(ckpt_dir: str, device: str | torch.device):
    """Rebuild the model from a port checkpoint directory (the config
    travels with the weights).  Returns (config, model in eval mode on
    `device`, step)."""
    payload, cfg = load_checkpoint(ckpt_dir)
    model = build_model(cfg.model, num_outputs=cfg.grid.num_outputs)
    model.load_state_dict(payload["state_dict"])
    return cfg, model.to(device).eval(), payload["step"]
