"""Serving export: a port checkpoint -> one `torch.export` artifact.

Counterpart of `spnet_tpu/io/export.py` (a StableHLO artifact in JAX).
`export_predictor` wraps the eval-mode model in a module that takes uint8
NHWC frames and fuses the Inception normalization (`train/steps.py::
_prep_x`), exports it with `torch.export.export` (weights baked in,
symbolic batch), and writes

  predictor.pt2   `torch.export.save` of the program: uint8 (B, H, W, 1)
                  frames in, the normalized flat grid (B, num_outputs)
                  float32 out
  meta.json       the ExperimentConfig JSON and the input contract, so a
                  server can size inputs and denormalize outputs
                  (`spnet_tpu_torch.grid.denormalize` with the GridSpec)

Unlike JAX's artifact, which needs only jax, this one calls the port's
kernels as the registered operators `spnet_tpu_torch::sepconv_infer` (K1)
and `spnet_tpu_torch::selective_sigmoid_fwd` (K4, the 'ss' head): where it
is loaded, `spnet_tpu_torch.ops` must be importable (and on a card, its
CUDA library buildable).  `load_predictor` imports them.  The artifact
runs on the device it was exported on; the kernels count their launches
as in eager calls.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

ARTIFACT = "predictor.pt2"
META = "meta.json"
#: The fixed batch JAX falls back to when a symbolic one fails
FALLBACK_BATCH = 64


class Predictor(nn.Module):
    """uint8 NHWC frames -> normalized flat grid, the model in eval mode."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        from spnet_tpu_torch.train.steps import _prep_x

        return self.model(_prep_x(x))


def export_predictor(ckpt_dir: str, out_dir: str,
                     batch_size: int | None = None,
                     device: str | torch.device = "cuda") -> str:
    """Export the checkpoint's inference function on `device`; returns
    out_dir.  batch_size None -> symbolic batch ("b", at least 1); an int
    pins it (and FALLBACK_BATCH is used if the symbolic export fails,
    which is printed)."""
    from spnet_tpu_torch.cli.common import load_model_and_state

    device = torch.device(device)
    cfg, model, _ = load_model_and_state(ckpt_dir, device)
    size = cfg.model.input_size or None
    h = size or cfg.grid.img_height
    w = size or cfg.grid.img_width
    pred = Predictor(model).eval()

    def frames(b):
        return (torch.zeros((b, h, w, 1), dtype=torch.uint8, device=device),)

    prog, sym_batch = None, False
    with torch.no_grad():
        if batch_size is None:
            try:
                prog = torch.export.export(
                    pred, frames(2),
                    dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
                sym_batch = True
            except Exception as e:  # noqa: BLE001 (JAX's fall-back)
                print(f"    (symbolic batch unsupported here: {e}; "
                      f"exporting fixed batch {FALLBACK_BATCH})")
                batch_size = FALLBACK_BATCH
        if prog is None:
            prog = torch.export.export(pred, frames(batch_size))

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(prog, os.path.join(out_dir, ARTIFACT))
    meta = {
        "config": json.loads(cfg.to_json()),
        "input": {"height": h, "width": w, "channels": 1, "dtype": "uint8",
                  "batch": "symbolic" if sym_batch else batch_size},
        "output": "normalized flat grid (B, num_outputs) float32; "
                  "denormalize with spnet_tpu_torch.grid.denormalize"
                  "(GridSpec)",
        "device": str(device),
        "torch_version": torch.__version__,
        "requires": "torch and spnet_tpu_torch.ops (the kernels K1 and K4 "
                    "as registered operators), imported before "
                    "torch.export.load",
    }
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_predictor(artifact_dir: str):
    """Load an exported artifact; returns (call, meta) where call(uint8
    NHWC array or tensor) -> normalized predictions (a float32 tensor on
    the artifact's device).  Needs torch and `spnet_tpu_torch.ops`, not
    the model code or the checkpoint."""
    # registers the operators the program calls
    import spnet_tpu_torch.ops.activations  # noqa: F401
    import spnet_tpu_torch.ops.sepconv  # noqa: F401

    with open(os.path.join(artifact_dir, META)) as f:
        meta = json.load(f)
    module = torch.export.load(os.path.join(artifact_dir, ARTIFACT)).module()
    device = torch.device(meta["device"])

    def call(x):
        with torch.inference_mode():
            return module(torch.as_tensor(x).to(device))

    return call, meta
