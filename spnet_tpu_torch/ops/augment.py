"""On-device, batched, label-preserving train-time augmentation.

Counterpart of the label-preserving half of `spnet_tpu/ops/augment.py`
(`cutout`, `salt_and_pepper`, `random_blur`, `augment_on_the_fly`): the
same constants, per-image fill values and region bounds, as plain batched
tensor code on the images' device.  Randomness comes from an explicit
`torch.Generator` on that device, so the draws differ from `jax.random`'s
but follow the same distributions.  Images are (B, H, W, C), already
normalized to [-1, 1].  The geometric (label-transforming) half is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CUTOUT_MAX_REGIONS = 6
CUTOUT_MIN = 11
CUTOUT_MAX = 75
SALT_AMOUNT = 0.004
SALT_VS_PEPPER = 0.2


def _randint(low, high, size, generator, device):
    return torch.randint(low, high, size, generator=generator, device=device)


def _rand(size, generator, device):
    return torch.rand(size, generator=generator, device=device)


def cutout(images, generator: torch.Generator,
           max_regions: int = CUTOUT_MAX_REGIONS):
    """Up to `max_regions` rectangles per image, each filled with a grey
    level drawn uniformly from that image's own [min, max].  A region
    covers rows [y0, min(y0 + rh, h - 1)) and columns [x0, min(x0 + rw,
    w - 1)), as in the JAX package; later regions paint over earlier
    ones."""
    b, h, w, _ = images.shape
    dev = images.device
    nreg = _randint(0, max_regions + 1, (b,), generator, dev)
    y0 = _randint(0, h - CUTOUT_MIN, (b, max_regions), generator, dev)
    x0 = _randint(0, w - CUTOUT_MIN, (b, max_regions), generator, dev)
    rh = _randint(CUTOUT_MIN, CUTOUT_MAX, (b, max_regions), generator, dev)
    rw = _randint(CUTOUT_MIN, CUTOUT_MAX, (b, max_regions), generator, dev)
    lo = images.amin(dim=(1, 2, 3))
    hi = images.amax(dim=(1, 2, 3))
    u = _rand((b, max_regions), generator, dev)
    vals = (lo[:, None] + u * (hi - lo)[:, None]).to(images.dtype)
    y1 = torch.clamp_max(y0 + rh, h - 1)
    x1 = torch.clamp_max(x0 + rw, w - 1)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    for r in range(max_regions):
        inside = ((ys >= y0[:, r, None, None]) & (ys < y1[:, r, None, None])
                  & (xs >= x0[:, r, None, None]) & (xs < x1[:, r, None, None])
                  & (r < nreg)[:, None, None])
        images = torch.where(inside[..., None],
                             vals[:, r, None, None, None], images)
    return images


def salt_and_pepper(images, generator: torch.Generator,
                    amount: float = SALT_AMOUNT, svp: float = SALT_VS_PEPPER):
    """On about half the images (each with probability 0.5), a fraction
    amount*svp of the pixels take the image's max (salt) and
    amount*(1 - svp) its min (pepper)."""
    b = images.shape[0]
    dev = images.device
    active = _rand((b,), generator, dev) < 0.5
    r = _rand(images.shape, generator, dev)
    p_salt = amount * svp
    p_pepper = amount * (1.0 - svp)
    lo = images.amin(dim=(1, 2, 3), keepdim=True)
    hi = images.amax(dim=(1, 2, 3), keepdim=True)
    out = torch.where(r < p_salt, hi, images)
    out = torch.where((r >= p_salt) & (r < p_salt + p_pepper), lo, out)
    return torch.where(active[:, None, None, None], out, images)


def _gauss1d(ksize: int) -> np.ndarray:
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur(images, ksize: int):
    """Separable Gaussian blur, SAME with zero padding, per channel."""
    c = images.shape[-1]
    k = torch.from_numpy(_gauss1d(ksize)).to(images.device, images.dtype)
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1),
                 padding=(ksize // 2, 0), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize),
                 padding=(0, ksize // 2), groups=c)
    return x.permute(0, 2, 3, 1)


def random_blur(images, generator: torch.Generator, prob: float = 0.4):
    """Per-image Gaussian blur with probability `prob`, kernel size 3 or 7
    with equal odds."""
    b = images.shape[0]
    dev = images.device
    do = _rand((b,), generator, dev) < prob
    pick7 = _rand((b,), generator, dev) < 0.5
    sel = torch.where(pick7[:, None, None, None], _blur(images, 7),
                      _blur(images, 3))
    return torch.where(do[:, None, None, None], sel, images)


def augment_on_the_fly(images, generator: torch.Generator,
                       blur_prob: float = 0.0):
    """Cutout, then salt & pepper, then (when blur_prob > 0) blur."""
    images = cutout(images, generator)
    images = salt_and_pepper(images, generator)
    if blur_prob > 0:
        images = random_blur(images, generator, prob=blur_prob)
    return images
