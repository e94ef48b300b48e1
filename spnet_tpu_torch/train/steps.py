"""Predict step (counterpart of `spnet_tpu/train/steps.py:_prep_x` and
`make_predict_step`); the train and eval steps come with the training
slice."""

from __future__ import annotations

import torch


def _prep_x(x):
    """Datasets may be stored as uint8 (4x fewer bytes to the device);
    normalize on the device with the Inception scaling."""
    if x.dtype == torch.uint8:
        return (x.float() / 255.0 - 0.5) * 2.0
    return x


def make_predict_step(model):
    """Returns predict(x) -> y_pred (normalized), eval mode, no autograd."""
    model.eval()

    @torch.inference_mode()
    def predict(x):
        return model(_prep_x(x))

    return predict
