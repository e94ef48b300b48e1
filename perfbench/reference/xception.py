"""Xception (Chollet 2017, arXiv:1610.02357) as SPNet's backbone, plain
float32: entry flow (two VALID convs, three downsampling separable
blocks), middle flow (8 residual blocks of three separable convs at 728
channels), exit flow (a downsampling block, then separable convs to 1536
and 2048 features).  Parameter names are those under `backbone.`."""

from __future__ import annotations

from perfbench.reference.layers import Ctx, conv_bn_shapes, max_pool_same, \
    sep_conv_bn_shapes

FEATURES = 2048


def output_hw(h: int, w: int) -> tuple[int, int]:
    def one(n):
        n = (n - 3) // 2 + 1  # conv1, 3x3/2 VALID
        n = n - 2             # conv2, 3x3 VALID
        for _ in range(4):    # three entry blocks and the exit block
            n = -(-n // 2)
        return n
    return one(h), one(w)


def param_shapes(prefix: str = "backbone", in_ch: int = 3) -> dict:
    """Every parameter and BatchNorm statistic, by name, with its shape."""
    s = {**conv_bn_shapes(f"{prefix}.conv1", in_ch, 32, 3),
         **conv_bn_shapes(f"{prefix}.conv2", 32, 64, 3)}
    for name, cin, cout in (("block2", 64, 128), ("block3", 128, 256),
                            ("block4", 256, 728)):
        n = f"{prefix}.{name}"
        s.update(conv_bn_shapes(f"{n}.shortcut", cin, cout, 1))
        s.update(sep_conv_bn_shapes(f"{n}.sep1", cin, cout))
        s.update(sep_conv_bn_shapes(f"{n}.sep2", cout, cout))
    for i in range(8):
        for j in range(3):
            s.update(sep_conv_bn_shapes(f"{prefix}.middle{i + 1}.sep{j + 1}",
                                        728, 728))
    s.update(conv_bn_shapes(f"{prefix}.exit_shortcut", 728, 1024, 1))
    for j, (cin, cout) in enumerate(((728, 728), (728, 1024), (1024, 1536),
                                     (1536, 2048))):
        s.update(sep_conv_bn_shapes(f"{prefix}.exit_sep{j + 1}", cin, cout))
    return s


def _down(c: Ctx, x, name, first_relu=True):
    res = c.conv_bn(x, f"{name}.shortcut", stride=2)
    y = c.sep_conv_bn(x, f"{name}.sep1", relu_in=first_relu)
    y = c.sep_conv_bn(y, f"{name}.sep2", relu_in=True)
    return max_pool_same(y, 3, 2) + res


def forward(c: Ctx, x, prefix: str = "backbone"):
    x = c.conv_bn(x, f"{prefix}.conv1", stride=2, padding="VALID",
                  act="relu")
    x = c.conv_bn(x, f"{prefix}.conv2", padding="VALID", act="relu")
    x = _down(c, x, f"{prefix}.block2", first_relu=False)
    x = _down(c, x, f"{prefix}.block3")
    x = _down(c, x, f"{prefix}.block4")
    for i in range(8):
        n = f"{prefix}.middle{i + 1}"
        y = c.sep_conv_bn(x, f"{n}.sep1", relu_in=True)
        y = c.sep_conv_bn(y, f"{n}.sep2", relu_in=True)
        x = c.sep_conv_bn(y, f"{n}.sep3", relu_in=True) + x
    res = c.conv_bn(x, f"{prefix}.exit_shortcut", stride=2)
    y = c.sep_conv_bn(x, f"{prefix}.exit_sep1", relu_in=True)
    y = c.sep_conv_bn(y, f"{prefix}.exit_sep2", relu_in=True)
    x = max_pool_same(y, 3, 2) + res
    x = c.sep_conv_bn(x, f"{prefix}.exit_sep3", act="relu")
    return c.sep_conv_bn(x, f"{prefix}.exit_sep4", act="relu")
