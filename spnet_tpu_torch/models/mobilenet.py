"""MobileNet v1 backbone (Howard et al. 2017, arXiv:1704.04861), NHWC.

Counterpart of `spnet_tpu/models/mobilenet.py`: a 3x3/2 SAME conv stem
then 13 depthwise-separable blocks, each with BatchNorm + ReLU6 between
the depthwise and the pointwise conv, four of them at stride 2.  Every
layer runs its plain composition in both modes (`SeparableConvBN`'s fused
kernel covers Xception's stride-1 variant only).  `width_mult` scales the
channel counts as `max(8, int(f * width_mult))`; `MobileNetTiny` is
`width_mult=0.125`.
"""

from __future__ import annotations

from torch import nn

from spnet_tpu_torch.models.layers import ConvBN, SeparableConvBN

# (features, stride) per separable block
_BLOCKS = [
    (64, 1),
    (128, 2),
    (128, 1),
    (256, 2),
    (256, 1),
    (512, 2),
    (512, 1),
    (512, 1),
    (512, 1),
    (512, 1),
    (512, 1),
    (1024, 2),
    (1024, 1),
]


class MobileNet(nn.Module):
    """Feature extractor: (B, H, W, C) -> (B, ~H/32, ~W/32, FEATURES)."""

    # Ordered top-level module names (freeze_fac masking in training).
    LAYER_ORDER = ["conv1"] + [f"block{i + 1}" for i in range(len(_BLOCKS))]

    def __init__(self, in_ch: int = 3, width_mult: float = 1.0):
        super().__init__()

        def ch(f):
            return max(8, int(f * width_mult))

        self.conv1 = ConvBN(in_ch, ch(32), 3, stride=2, act="relu6")
        c = ch(32)
        for i, (f, s) in enumerate(_BLOCKS):
            self.add_module(f"block{i + 1}", SeparableConvBN(
                c, ch(f), stride=s, act="relu6", bn_between=True))
            c = ch(f)
        self.FEATURES = c  # ch(1024)

    @staticmethod
    def output_hw(h: int, w: int) -> tuple[int, int]:
        """Spatial size of the feature map for an (h, w) input: conv1 and
        the four stride-2 blocks each halve it, rounding up (SAME)."""
        def one(n):
            for _ in range(5):
                n = -(-n // 2)
            return n
        return one(h), one(w)

    def forward(self, x):
        x = self.conv1(x)
        for i in range(len(_BLOCKS)):
            x = getattr(self, f"block{i + 1}")(x)
        return x
