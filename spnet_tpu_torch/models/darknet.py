"""DarkNet-19 backbone ("full YOLO" configuration), NHWC.

Counterpart of `spnet_tpu/models/darknet.py` (Redmon & Farhadi 2016,
arXiv:1612.08242): 21 ConvBN + LeakyReLU(0.1) layers `conv1`..`conv21`
with 1x1 bottlenecks, five VALID 2x2/2 max pools (165 -> 82 -> 41 -> 20 ->
10 -> 5 at a 331 input), and a passthrough of `conv13`'s output (10²)
through `conv21` and a 2x2 space-to-depth, concatenated in front of
`conv20`'s output: 5x5x(256 + 1024).  Every layer runs its plain
composition in both modes.
"""

from __future__ import annotations

import torch
from torch import nn

from spnet_tpu_torch.models.layers import ConvBN, max_pool_valid

# (features, kernel) of conv1..conv20, with "pool" where a 2x2/2 max pool
# sits; conv13's output is the passthrough
_LAYERS = [
    (32, 3), "pool", (64, 3), "pool",
    (128, 3), (64, 1), (128, 3), "pool",
    (256, 3), (128, 1), (256, 3), "pool",
    (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "pool",
    (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3), (1024, 3),
    (1024, 3),
]
_SKIP_AFTER = 13  # conv13
_SKIP_FEATURES = 64  # conv21, 1x1 on the passthrough


def space_to_depth_2(x):
    """JAX `_space_to_depth_2`: (B, H, W, C) -> (B, H/2, W/2, 4C) with
    output channel (dy * 2 + dx) * C + c.  `F.pixel_unshuffle` orders them
    c * 4 + dy * 2 + dx instead, and would scramble a converted conv."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


class DarkNet19(nn.Module):
    """Feature extractor: (B, H, W, C) -> (B, H/32, W/32, 1024 + 256)."""

    # Ordered top-level module names (freeze_fac masking in training).
    LAYER_ORDER = [f"conv{i}" for i in range(1, 22)]
    FEATURES = 4 * _SKIP_FEATURES + 1024

    def __init__(self, in_ch: int = 3):
        super().__init__()
        c, i = in_ch, 0
        for layer in _LAYERS:
            if layer == "pool":
                continue
            i += 1
            f, k = layer
            self.add_module(f"conv{i}", ConvBN(c, f, k, act="leaky"))
            c = f
        self.conv21 = ConvBN(512, _SKIP_FEATURES, 1, act="leaky")

    @staticmethod
    def output_hw(h: int, w: int) -> tuple[int, int]:
        """Five VALID 2x2/2 pools, each rounding down."""
        return h // 32, w // 32

    def forward(self, x):
        i, skip = 0, None
        for layer in _LAYERS:
            if layer == "pool":
                x = max_pool_valid(x, 2, 2)
                continue
            i += 1
            x = getattr(self, f"conv{i}")(x)
            if i == _SKIP_AFTER:
                skip = x
        skip = space_to_depth_2(self.conv21(skip))
        return torch.cat([skip, x], dim=-1)
