"""Xception backbone (Chollet 2017, arXiv:1610.02357), NHWC.

Counterpart of `spnet_tpu/models/xception.py`: entry flow (2 VALID convs
+ 3 downsampling separable blocks), middle flow (8 residual blocks at 728
channels), exit flow (downsampling block + 1536/2048 separable convs).
In eval mode all 34 separable convs run through
`ops/sepconv.py::sepconv_infer`; in train mode through their plain
composition (`SeparableConvBN._train_forward`).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from spnet_tpu_torch.models.layers import ConvBN, SeparableConvBN, \
    max_pool_same


class _DownBlock(nn.Module):
    """[relu ->] sepconv -> relu -> sepconv -> SAME max-pool, plus a
    strided 1x1 projection shortcut."""

    def __init__(self, in_ch: int, features: int, first_relu: bool = True,
                 plain: bool = False):
        super().__init__()
        self.shortcut = ConvBN(in_ch, features, 1, stride=2)
        self.sep1 = SeparableConvBN(in_ch, features, plain=plain)
        self.sep2 = SeparableConvBN(features, features, plain=plain)
        self.first_relu = first_relu

    def forward(self, x):
        res = self.shortcut(x)
        if self.first_relu:
            x = F.relu(x)
        x = self.sep2(F.relu(self.sep1(x)))
        return max_pool_same(x, 3, 2) + res


class _MiddleBlock(nn.Module):
    """3x (relu -> sepconv 728) with an identity residual."""

    def __init__(self, features: int = 728, plain: bool = False):
        super().__init__()
        self.sep1 = SeparableConvBN(features, features, plain=plain)
        self.sep2 = SeparableConvBN(features, features, plain=plain)
        self.sep3 = SeparableConvBN(features, features, plain=plain)

    def forward(self, x):
        res = x
        for sep in (self.sep1, self.sep2, self.sep3):
            x = sep(F.relu(x))
        return x + res


class Xception(nn.Module):
    """Feature extractor: (B, H, W, C) -> (B, ~H/32, ~W/32, 2048)."""

    # Ordered top-level module names (freeze_fac masking in training).
    LAYER_ORDER = (
        ["conv1", "conv2", "block2", "block3", "block4"]
        + [f"middle{i + 1}" for i in range(8)]
        + ["exit_shortcut", "exit_sep1", "exit_sep2", "exit_sep3",
           "exit_sep4"]
    )
    FEATURES = 2048

    def __init__(self, in_ch: int = 3, plain: bool = False):
        super().__init__()
        self.conv1 = ConvBN(in_ch, 32, 3, stride=2, padding="VALID",
                            relu=True)
        self.conv2 = ConvBN(32, 64, 3, padding="VALID", relu=True)
        self.block2 = _DownBlock(64, 128, first_relu=False, plain=plain)
        self.block3 = _DownBlock(128, 256, plain=plain)
        self.block4 = _DownBlock(256, 728, plain=plain)
        for i in range(8):
            self.add_module(f"middle{i + 1}", _MiddleBlock(728, plain=plain))
        self.exit_shortcut = ConvBN(728, 1024, 1, stride=2)
        self.exit_sep1 = SeparableConvBN(728, 728, plain=plain)
        self.exit_sep2 = SeparableConvBN(728, 1024, plain=plain)
        self.exit_sep3 = SeparableConvBN(1024, 1536, relu=True, plain=plain)
        self.exit_sep4 = SeparableConvBN(1536, 2048, relu=True, plain=plain)

    @staticmethod
    def output_hw(h: int, w: int) -> tuple[int, int]:
        """Spatial size of the feature map for an (h, w) input."""
        def one(n):
            n = (n - 3) // 2 + 1  # conv1, 3x3/2 VALID
            n = n - 2             # conv2, 3x3 VALID
            for _ in range(4):    # block2-4 and exit: 3x3/2 SAME pools
                n = -(-n // 2)
            return n
        return one(h), one(w)

    def forward(self, x):
        x = self.block4(self.block3(self.block2(self.conv2(self.conv1(x)))))
        for i in range(8):
            x = getattr(self, f"middle{i + 1}")(x)
        res = self.exit_shortcut(x)
        x = self.exit_sep1(F.relu(x))
        x = self.exit_sep2(F.relu(x))
        x = max_pool_same(x, 3, 2) + res
        return self.exit_sep4(self.exit_sep3(x))
