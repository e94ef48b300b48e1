"""The Keras pretrained import from a real weights FILE, feeding a
fine-tuning run.

    python -m spnet_tpu_torch.tools.keras_h5_finetune [--device cuda|cpu]

Counterpart of the JAX package's `scripts/keras_h5_finetune.py` (the
reference loads ImageNet weights through `keras.applications`; no such
file can be fetched here, so the file is a seeded-random one of the same
format and layer set):

  1. `keras.applications.MobileNet(include_top=False)` with seeded random
     weights, saved as `logs/keras_w_torch/mobilenet_seeded.weights.h5`;
  2. the FILE loaded through `io/keras_import.py::load_keras_backbone`
     into the port's MobileNet backbone (float32, eval mode), its output
     held to Keras's on the same frames: max|d| / std of Keras's output
     below 1e-3, the script's bound;
  3. `train_network` with `ModelConfig(pretrained=<file>)`, MobileNet at
     331, b=32, 2048 + 512 synthetic frames, 5 epochs (the script's
     recipe), on `--device` (default SPNET_DEVICE, else cuda).

Needs keras (and h5py), which the card's host does not have.  Keyword
arguments of `main` (n_train, n_val, input_size, batch, epochs, device)
let a CPU test run it small.  Prints `KERAS_H5_RESULT {json}`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.io.keras_import import apply_backbone_weights, \
    load_keras_backbone
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.tools.runtime import tool_device
from spnet_tpu_torch.train.loop import train_network

WEIGHTS = "logs/keras_w_torch/mobilenet_seeded.weights.h5"
#: max|d| / std of Keras's output that the file's import must stay below
FORWARD_BOUND = 1e-3
#: Keras's input for the parity check (the port's SPNet sees it after its
#: stem halves 2x this size)
PARITY_HW = 96


def main(argv=None, *, n_train: int = 2048, n_val: int = 512,
         input_size: int = 331, batch: int = 32, epochs: int = 5,
         device: str | None = None) -> dict:
    """The run's dict; the keyword arguments default to the script's."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device; default SPNET_DEVICE, else 'cuda'")
    args = p.parse_args(argv)
    device = tool_device(device or args.device)
    t0 = time.time()
    os.makedirs(os.path.dirname(WEIGHTS), exist_ok=True)

    # ---- 1. a seeded Keras MobileNet saved as a weights file ---------
    try:
        import keras
    except ImportError as e:
        raise ImportError("keras_h5_finetune writes and reads a Keras "
                          "weights file and needs keras (and h5py), which "
                          "are not installed here") from e
    keras.utils.set_random_seed(7)
    kmodel = keras.applications.MobileNet(
        include_top=False, weights=None, input_shape=(None, None, 3))
    kmodel.save_weights(WEIGHTS)
    size_mb = os.path.getsize(WEIGHTS) / 1e6
    print(f"saved {WEIGHTS} ({size_mb:.1f} MB)", flush=True)

    # ---- 2. the FILE through the port's import, forward parity -------
    model = build_model(ModelConfig(backbone="MobileNet",
                                    input_size=2 * PARITY_HW,
                                    compute_dtype="float32"), device=device)
    apply_backbone_weights(model, *load_keras_backbone(WEIGHTS,
                                                       "MobileNet"))
    x = np.random.default_rng(0).normal(
        size=(2, PARITY_HW, PARITY_HW, 3)).astype(np.float32)
    k_out = np.asarray(kmodel(x, training=False))
    with torch.no_grad():
        t_out = model.backbone.eval()(torch.from_numpy(x).to(device)) \
            .cpu().numpy()
    rel = float(np.max(np.abs(t_out - k_out)) / (np.std(k_out) + 1e-9))
    print(f"file-import forward parity: max|d|/std = {rel:.2e}", flush=True)
    if not rel < FORWARD_BOUND:
        raise AssertionError(f"the imported file's forward parts from "
                             f"Keras's by {rel} of its std (bound "
                             f"{FORWARD_BOUND})")
    del model

    # ---- 3. fine-tune from the file through train_network ------------
    grid = GridSpec()
    cfg = ExperimentConfig(
        grid=grid,
        model=ModelConfig(backbone="MobileNet", input_size=input_size,
                          pretrained=WEIGHTS),
        train=TrainConfig(batch_size=batch, epochs=epochs, lr_max=1e-4,
                          augment=True, blur_prob=0.0, seed=0,
                          save_every=10**9))
    train_ds = synthetic_dataset(n_train, grid, seed=5,
                                 input_size=input_size, batch_size=batch,
                                 device=device)
    val_ds = synthetic_dataset(n_val, grid, seed=666, input_size=input_size,
                               device=device)
    _, history = train_network(cfg, train_ds, val_ds, device,
                               log_dir="logs/keras_h5_ft_torch",
                               ckpt_dir=None, render_overlays=False,
                               device_data=True, verbose=1)
    out = {
        "weights_file": WEIGHTS,
        "file_mb": round(size_mb, 1),
        "forward_rel_err": rel,
        "device": str(device),
        "losses": [h["train_loss"] for h in history],
        "loss_decreased": history[-1]["train_loss"]
        < history[0]["train_loss"],
        "wall_s": round(time.time() - t0, 1),
    }
    print("KERAS_H5_RESULT " + json.dumps(out, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
