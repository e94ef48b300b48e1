"""Host constants on the device, copied there once.

A copy from the host cannot run while a CUDA stream is being captured, so
the constants a train step reads (the blur taps, the label encoder's
defaults and normalization) are copied by the step's first, eager call
and kept for the captured and replayed ones
(`train/steps.py::make_train_epoch`).
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def device_constant(array: np.ndarray, device,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """`array` as a tensor on `device` (cast to `dtype`), made at the first
    call with these values and returned by the later ones."""
    device = torch.device(device)
    key = (array.tobytes(), array.shape, array.dtype.str, device, dtype)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(np.array(array)).to(device,
                                                                dtype)
    return _CONSTANTS[key]
