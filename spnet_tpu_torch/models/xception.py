"""Xception backbone (Chollet 2017, arXiv:1610.02357), NHWC.

Counterpart of `spnet_tpu/models/xception.py`: entry flow (2 VALID convs
+ 3 downsampling separable blocks), middle flow (8 residual blocks at 728
channels), exit flow (downsampling block + 1536/2048 separable convs).
In eval mode all 34 separable convs run through
`ops/sepconv.py::sepconv_infer`; in train mode through their plain
composition (`SeparableConvBN._plain_forward`).  The ReLU in front of 31
of them is the separable conv's `relu_in`: in eval mode the kernel applies
it as it reads its input, in train mode it is `F.relu` before the
composition.
"""

from __future__ import annotations

from torch import nn

from spnet_tpu_torch.models.layers import ConvBN, SeparableConvBN, \
    max_pool_same


class _DownBlock(nn.Module):
    """[relu ->] sepconv -> relu -> sepconv -> SAME max-pool, plus a
    strided 1x1 projection shortcut (of the input before the ReLU)."""

    def __init__(self, in_ch: int, features: int, first_relu: bool = True,
                 plain: bool = False):
        super().__init__()
        self.shortcut = ConvBN(in_ch, features, 1, stride=2)
        self.sep1 = SeparableConvBN(in_ch, features, plain=plain,
                                    relu_in=first_relu)
        self.sep2 = SeparableConvBN(features, features, plain=plain,
                                    relu_in=True)

    def forward(self, x):
        res = self.shortcut(x)
        return max_pool_same(self.sep2(self.sep1(x)), 3, 2) + res


class _MiddleBlock(nn.Module):
    """3x (relu -> sepconv 728) with an identity residual."""

    def __init__(self, features: int = 728, plain: bool = False):
        super().__init__()
        self.sep1 = SeparableConvBN(features, features, plain=plain,
                                    relu_in=True)
        self.sep2 = SeparableConvBN(features, features, plain=plain,
                                    relu_in=True)
        self.sep3 = SeparableConvBN(features, features, plain=plain,
                                    relu_in=True)

    def forward(self, x):
        return self.sep3(self.sep2(self.sep1(x))) + x


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
                            act="relu")
        self.conv2 = ConvBN(32, 64, 3, padding="VALID", act="relu")
        self.block2 = _DownBlock(64, 128, first_relu=False, plain=plain)
        self.block3 = _DownBlock(128, 256, plain=plain)
        self.block4 = _DownBlock(256, 728, plain=plain)
        for i in range(8):
            self.add_module(f"middle{i + 1}", _MiddleBlock(728, plain=plain))
        self.exit_shortcut = ConvBN(728, 1024, 1, stride=2)
        self.exit_sep1 = SeparableConvBN(728, 728, plain=plain, relu_in=True)
        self.exit_sep2 = SeparableConvBN(728, 1024, plain=plain, relu_in=True)
        self.exit_sep3 = SeparableConvBN(1024, 1536, act="relu", plain=plain)
        self.exit_sep4 = SeparableConvBN(1536, 2048, act="relu", plain=plain)

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
        x = max_pool_same(self.exit_sep2(self.exit_sep1(x)), 3, 2) + res
        return self.exit_sep4(self.exit_sep3(x))
