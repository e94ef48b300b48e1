"""Shared CLI plumbing: the device flag and checkpoint loading."""

from __future__ import annotations

import argparse

import torch

from spnet_tpu_torch.io.checkpoint import load_checkpoint
from spnet_tpu_torch.models.spnet import build_model


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
