"""What the accuracy-validation tools share: the device they run on, the
matmul precision they ask for, and the memory readings they print.

Every tool runs on the card unless `--device cpu` or `SPNET_DEVICE=cpu`
asks for the CPU; a card asked for and absent raises, never a silent
switch to the CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess

import torch

from spnet_tpu_torch.cli.common import resolve_device


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device ('cuda', 'cuda:1', 'cpu'); default "
                        "SPNET_DEVICE, else 'cuda'")


def tool_device(name: str | None = None) -> torch.device:
    """`name` (the tool's --device), else SPNET_DEVICE, else the card."""
    return resolve_device(name or os.environ.get("SPNET_DEVICE", "")
                          or "cuda")


def apply_matmul_precision() -> str:
    """SPNET_MATMUL_PRECISION, the JAX scripts' setting, for cuDNN and
    cuBLAS float32 work: 'highest' / 'float32' turn TF32 off, 'high' /
    'tensorfloat32' turn it on, unset or 'default' leave PyTorch's
    defaults (cuDNN convolutions in TF32, matmuls in float32).  Returns
    the line that says which setting ran."""
    prec = os.environ.get("SPNET_MATMUL_PRECISION", "")
    if prec in ("highest", "float32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif prec in ("high", "tensorfloat32"):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    elif prec not in ("", "default"):
        raise SystemExit(f"SPNET_MATMUL_PRECISION={prec!r}: expected "
                         "highest, float32, high, tensorfloat32 or default")
    return (f"  (SPNET_MATMUL_PRECISION={prec or 'unset'}: cuDNN TF32 "
            f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}, matmul "
            f"TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'})")


def memory(tag: str, device: torch.device) -> dict | None:
    """Print and return the card's `memory_allocated` and
    `max_memory_allocated` in GiB at `tag`; None on the CPU."""
    if device.type != "cuda":
        return None
    out = {"allocated_gib": torch.cuda.memory_allocated(device) / 2**30,
           "max_allocated_gib":
               torch.cuda.max_memory_allocated(device) / 2**30}
    print(f"[memory] {tag}: memory_allocated {out['allocated_gib']:.4f} "
          f"GiB, max_memory_allocated {out['max_allocated_gib']:.4f} GiB",
          flush=True)
    return out


def card(device: torch.device) -> str | None:
    """Print and return the card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (a
    card below its maximum power runs slower under load); None on the
    CPU."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = ""
    line = line or f"{torch.cuda.get_device_name(device)}, power limit " \
        "not read"
    print(f"[card] {line}", flush=True)
    return line
