"""Separable image resize on the device.

Counterpart of `jax.image.resize(image, shape, method)` for the methods
the port's data path uses ('lanczos3', the default of
`data/dataset.py::synthetic_dataset`, and 'linear'): the weight matrix of
`jax/_src/image/scale.py::compute_weight_mat` (half-pixel centers; with
`antialias` and a downscale the kernel widens by the inverse scale; each
output column normalized to sum 1; samples whose center falls outside
the input weigh 0) and the Lanczos kernel of `_fill_lanczos_kernel`,
applied as one float32 matrix product per resized axis.  No TF32: the
port never sets `allow_tf32`, so the products round as float32 does.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _lanczos(radius: float):
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3,
                          y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0),
                          1.0)
        return torch.where(x > radius, 0.0, out)
    return kernel


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


KERNELS = {"lanczos3": _lanczos(3.0), "linear": _triangle}


def weight_matrix(in_size: int, out_size: int, method: str = "lanczos3",
                  antialias: bool = True) -> torch.Tensor:
    """(in_size, out_size) float32 resampling weights on the CPU: output
    sample j = sum_i x[i] * w[i, j]."""
    if method not in KERNELS:
        raise ValueError(f"resize method {method!r}: one of "
                         f"{sorted(KERNELS)}")
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(images, size: tuple[int, int], method: str = "lanczos3",
           antialias: bool = True):
    """float32 (..., H, W) -> (..., size[0], size[1]) on the images'
    device; an axis whose size does not change is left as it is (as in
    JAX, whose kernels all interpolate)."""
    out = images.float()
    h, w = out.shape[-2:]
    oh, ow = size
    if ow != w:
        out = out @ weight_matrix(w, ow, method, antialias).to(out.device)
    if oh != h:
        out = weight_matrix(h, oh, method, antialias).to(out.device).T @ out
    return out
