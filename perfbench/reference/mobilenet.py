"""MobileNet v1, alpha 1.0 (Howard et al. 2017, arXiv:1704.04861), as
SPNet's backbone, plain float32: a 3x3/2 SAME conv, then 13
depthwise-separable blocks with BatchNorm and ReLU6 after the depthwise
and after the pointwise conv, four of them at stride 2.  Parameter names
are those under `backbone.`."""

from __future__ import annotations

from perfbench.reference.layers import Ctx, conv_bn_shapes, sep_conv_bn_shapes

FEATURES = 1024
#: (features, stride) of each separable block
BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
          (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
          (1024, 1)]


def output_hw(h: int, w: int) -> tuple[int, int]:
    def one(n):
        for _ in range(5):  # conv1 and the four stride-2 blocks, SAME
            n = -(-n // 2)
        return n
    return one(h), one(w)


def param_shapes(prefix: str = "backbone", in_ch: int = 3) -> dict:
    """Every parameter and BatchNorm statistic, by name, with its shape."""
    s = conv_bn_shapes(f"{prefix}.conv1", in_ch, 32, 3)
    c = 32
    for i, (f, _) in enumerate(BLOCKS):
        s.update(sep_conv_bn_shapes(f"{prefix}.block{i + 1}", c, f,
                                    bn_between=True))
        c = f
    return s


def forward(c: Ctx, x, prefix: str = "backbone"):
    x = c.conv_bn(x, f"{prefix}.conv1", stride=2, act="relu6")
    for i, (_, s) in enumerate(BLOCKS):
        x = c.sep_conv_bn(x, f"{prefix}.block{i + 1}", stride=s,
                          act="relu6", bn_between=True)
    return x
