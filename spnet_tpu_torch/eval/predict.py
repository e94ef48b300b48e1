"""Label-free batch inference over a directory of frames.

Counterpart of `spnet_tpu/eval/predict.py` (reference
`predict_spnet.py:40-97`): glob *.png / *.bmp, batched timed predict,
denormalize with the checkpoint's own GridSpec, render prediction overlays
and the Zooniverse CSV (`hawley_spnet.csv`).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from spnet_tpu_torch.config import IND_NOOBJ, VARS_PER_PRED, ExperimentConfig
from spnet_tpu_torch.data.dataset import build_x, nearest_multiple
from spnet_tpu_torch.grid import denormalize
from spnet_tpu_torch.io.render import show_pred_ellipses
from spnet_tpu_torch.train.loop import predict_in_batches
from spnet_tpu_torch.train.steps import make_predict_step


def predict_network(
    cfg: ExperimentConfig,
    model,
    datapath: str,
    device: str | torch.device,
    log_dir: str = "logs/Predicting/",
    fraction: float = 1.0,
    batch_size: int | None = None,
    num_draw: int | None = None,
    verbose: int = 1,
) -> tuple[np.ndarray, list[str]]:
    """Returns (denormalized predictions, file list)."""
    os.makedirs(log_dir, exist_ok=True)
    batch_size = cfg.model.clamp_infer_batch(
        batch_size or cfg.train.batch_size)
    files = sorted(glob.glob(os.path.join(datapath, "*.png")))
    if not files:
        files = sorted(glob.glob(os.path.join(datapath, "*.bmp")))
    total = int(len(files) * fraction)
    total = nearest_multiple(total, batch_size) or total
    files = files[:total]
    if not files:
        raise ValueError(f"no images found in {datapath}")
    if verbose:
        print(f"predicting on {len(files)} frames from {datapath}")

    x = build_x(files, size=cfg.model.input_size or None)
    y_pred, fps = predict_in_batches(
        make_predict_step(model), x, batch_size, device, verbose=verbose)
    if cfg.model.loss_type != "same":  # 'hybrid': noobj is a logit
        y_pred[:, IND_NOOBJ::VARS_PER_PRED] = 1.0 / (
            1.0 + np.exp(-y_pred[:, IND_NOOBJ::VARS_PER_PRED])
        )
    yp = denormalize(y_pred, cfg.grid)
    show_pred_ellipses(
        None, yp, files,
        num_draw=(num_draw if num_draw is not None else yp.shape[0]),
        log_dir=log_dir,
        out_csv=os.path.join(log_dir, "hawley_spnet.csv"),
        show_true=False,
    )
    return yp, files
