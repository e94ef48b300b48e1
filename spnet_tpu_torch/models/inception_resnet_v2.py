"""Inception-ResNet-v2 backbone (Szegedy et al. 2016, arXiv:1602.07261),
NHWC.

Counterpart of `spnet_tpu/models/inception_resnet_v2.py`: a VALID stem
with two VALID 3x3/2 max pools, mixed_5b (Inception-A, whose stride-1
average pool divides by the real cells only), 10 x block35, reduction-A,
20 x block17 (1x7 / 7x1), reduction-B, 10 x block8 (1x3 / 3x1; the last
with scale 1.0 and no ReLU) and the 1536-channel `conv_7b`.  Every BN is
gamma-less (Keras `scale=False`); each block's `up` 1x1 conv carries a
zero-initialized bias, and its output is scaled (0.17 / 0.10 / 0.20) in
the compute dtype before the residual add.  At a 331 input: 165 -> 82 ->
80 -> 39 -> 37 -> 18 -> 8 -> 3, so 3x3x1536 into the head.  Every layer
runs its plain composition in both modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spnet_tpu_torch.models.layers import (
    ConvBN,
    avg_pool3_same,
    conv2d_nhwc,
    conv_kernel,
    max_pool_valid,
)


def _cbr(in_ch, features, kernel=1, stride=1, padding="SAME", act=True):
    """JAX `_cbr`: ConvBN with gamma-less BN and ReLU (or none)."""
    return ConvBN(in_ch, features, kernel, stride, padding,
                  act="relu" if act else "", bn_scale=False)


class _Residual(nn.Module):
    """A residual block: branches -> concat -> `up` 1x1 conv with bias ->
    x + scale * up (-> ReLU).  Subclasses build `branches`, a list of
    lists of module names applied in turn."""

    branches: list[list[str]]

    def __init__(self, channels: int, mixed: int, scale: float,
                 final_relu: bool = True):
        super().__init__()
        self.up = conv_kernel(mixed, channels, 1, bias=True)
        self.scale, self.final_relu = scale, final_relu

    def forward(self, x):
        outs = []
        for names in self.branches:
            y = x
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        up = conv2d_nhwc(torch.cat(outs, dim=-1), self.up.weight,
                         bias=self.up.bias)
        out = x + self.scale * up
        return F.relu(out) if self.final_relu else out


class Block35(_Residual):
    """Inception-ResNet-A: 35x35 grid residual block."""

    branches = [["b0"], ["b1a", "b1b"], ["b2a", "b2b", "b2c"]]

    def __init__(self, c: int, scale: float = 0.17):
        super().__init__(c, 32 + 32 + 64, scale)
        self.b0 = _cbr(c, 32)
        self.b1a, self.b1b = _cbr(c, 32), _cbr(32, 32, 3)
        self.b2a, self.b2b, self.b2c = (_cbr(c, 32), _cbr(32, 48, 3),
                                        _cbr(48, 64, 3))


class Block17(_Residual):
    """Inception-ResNet-B: 17x17 grid residual block (1x7 / 7x1)."""

    branches = [["b0"], ["b1a", "b1b", "b1c"]]

    def __init__(self, c: int, scale: float = 0.10):
        super().__init__(c, 192 + 192, scale)
        self.b0 = _cbr(c, 192)
        self.b1a, self.b1b, self.b1c = (_cbr(c, 128), _cbr(128, 160, (1, 7)),
                                        _cbr(160, 192, (7, 1)))


class Block8(_Residual):
    """Inception-ResNet-C: 8x8 grid residual block (1x3 / 3x1)."""

    branches = [["b0"], ["b1a", "b1b", "b1c"]]

    def __init__(self, c: int, scale: float = 0.20, final_relu: bool = True):
        super().__init__(c, 192 + 256, scale, final_relu)
        self.b0 = _cbr(c, 192)
        self.b1a, self.b1b, self.b1c = (_cbr(c, 192), _cbr(192, 224, (1, 3)),
                                        _cbr(224, 256, (3, 1)))


class InceptionResNetV2(nn.Module):
    """Feature extractor: (B, H, W, C) -> (B, h, w, 1536)."""

    LAYER_ORDER = (
        ["stem1", "stem2", "stem3", "stem4", "stem5"]
        + ["m5b_b0", "m5b_b1a", "m5b_b1b", "m5b_b2a", "m5b_b2b",
           "m5b_b2c", "m5b_b3"]
        + [f"block35_{i + 1}" for i in range(10)]
        + ["m6a_b0", "m6a_b1a", "m6a_b1b", "m6a_b1c"]
        + [f"block17_{i + 1}" for i in range(20)]
        + ["m7a_b0a", "m7a_b0b", "m7a_b1a", "m7a_b1b", "m7a_b2a",
           "m7a_b2b", "m7a_b2c"]
        + [f"block8_{i + 1}" for i in range(10)]
        + ["conv_7b"]
    )
    FEATURES = 1536

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.stem1 = _cbr(in_ch, 32, 3, 2, "VALID")
        self.stem2 = _cbr(32, 32, 3, padding="VALID")
        self.stem3 = _cbr(32, 64, 3)
        self.stem4 = _cbr(64, 80, 1, padding="VALID")
        self.stem5 = _cbr(80, 192, 3, padding="VALID")
        # mixed_5b (Inception-A): 96 + 64 + 96 + 64 = 320
        self.m5b_b0 = _cbr(192, 96)
        self.m5b_b1a, self.m5b_b1b = _cbr(192, 48), _cbr(48, 64, 5)
        self.m5b_b2a, self.m5b_b2b, self.m5b_b2c = (
            _cbr(192, 64), _cbr(64, 96, 3), _cbr(96, 96, 3))
        self.m5b_b3 = _cbr(192, 64)
        for i in range(10):
            self.add_module(f"block35_{i + 1}", Block35(320))
        # reduction-A (mixed_6a): 384 + 384 + 320 = 1088
        self.m6a_b0 = _cbr(320, 384, 3, 2, "VALID")
        self.m6a_b1a, self.m6a_b1b, self.m6a_b1c = (
            _cbr(320, 256), _cbr(256, 256, 3), _cbr(256, 384, 3, 2, "VALID"))
        for i in range(20):
            self.add_module(f"block17_{i + 1}", Block17(1088))
        # reduction-B (mixed_7a): 384 + 288 + 320 + 1088 = 2080
        self.m7a_b0a, self.m7a_b0b = (_cbr(1088, 256),
                                      _cbr(256, 384, 3, 2, "VALID"))
        self.m7a_b1a, self.m7a_b1b = (_cbr(1088, 256),
                                      _cbr(256, 288, 3, 2, "VALID"))
        self.m7a_b2a, self.m7a_b2b, self.m7a_b2c = (
            _cbr(1088, 256), _cbr(256, 288, 3), _cbr(288, 320, 3, 2, "VALID"))
        for i in range(9):
            self.add_module(f"block8_{i + 1}", Block8(2080))
        self.block8_10 = Block8(2080, scale=1.0, final_relu=False)
        self.conv_7b = _cbr(2080, 1536)

    @staticmethod
    def output_hw(h: int, w: int) -> tuple[int, int]:
        """The VALID stem (3x3/2, 3x3, pool 3x3/2, 3x3, pool 3x3/2) and the
        two VALID 3x3/2 reductions."""
        def one(n):
            n = (n - 3) // 2 + 1 - 2  # stem1, stem2
            n = (n - 3) // 2 + 1 - 2  # pool, stem5
            for _ in range(3):  # pool, mixed_6a, mixed_7a
                n = (n - 3) // 2 + 1
            return n
        return one(h), one(w)

    def forward(self, x):
        x = self.stem3(self.stem2(self.stem1(x)))
        x = max_pool_valid(x, 3, 2)
        x = self.stem5(self.stem4(x))
        x = max_pool_valid(x, 3, 2)

        b0 = self.m5b_b0(x)
        b1 = self.m5b_b1b(self.m5b_b1a(x))
        b2 = self.m5b_b2c(self.m5b_b2b(self.m5b_b2a(x)))
        b3 = self.m5b_b3(avg_pool3_same(x))
        x = torch.cat([b0, b1, b2, b3], dim=-1)
        for i in range(10):
            x = getattr(self, f"block35_{i + 1}")(x)

        b0 = self.m6a_b0(x)
        b1 = self.m6a_b1c(self.m6a_b1b(self.m6a_b1a(x)))
        x = torch.cat([b0, b1, max_pool_valid(x, 3, 2)], dim=-1)
        for i in range(20):
            x = getattr(self, f"block17_{i + 1}")(x)

        b0 = self.m7a_b0b(self.m7a_b0a(x))
        b1 = self.m7a_b1b(self.m7a_b1a(x))
        b2 = self.m7a_b2c(self.m7a_b2b(self.m7a_b2a(x)))
        x = torch.cat([b0, b1, b2, max_pool_valid(x, 3, 2)], dim=-1)
        for i in range(10):
            x = getattr(self, f"block8_{i + 1}")(x)
        return self.conv_7b(x)
