"""NASNet-A (Mobile) backbone (Zoph et al. 2017, arXiv:1707.07012), NHWC.

Counterpart of `spnet_tpu/models/nasnet.py`: a VALID 3x3/2 stem conv and
its BN, two reduction cells (`stem_red1`, `stem_red2`), then three stacks
of four normal cells with a reduction cell (`red1`, `red2`) between them;
cell filters 44 (penultimate 1056 / 24), final ReLU.  The cells are wired
as the JAX ones: separable blocks (relu -> sepconv k/s -> BN -> relu ->
sepconv k -> BN) of 3x3, 5x5 and 7x7 with TF SAME pads, stride-1 average
pools that divide by the real cells, reduction pools over a zero pad, and
`Adjust` aligning the previous cell's tensor by a factorized reduction
(spatial mismatch) or a 1x1 projection (channel mismatch).  Every BN has
momentum 0.9997 (torch's 0.0003).  Which `Adjust` a cell holds depends on
the spatial sizes, so the module is built for one input size.  At a 331
input: stem 82 -> 41 -> 21 (normal1) -> 11 (normal2) -> 6 (normal3), so
6x6x1056 into the head.  Every layer runs its plain composition in both
modes (K1 covers Xception's 3x3 stride-1 sepconvs only).

The top-level names are JAX's, `stem_bn` a sibling of `stem_conv`: JAX's
`LAYER_ORDER` does not name `stem_bn`, so freezing never reaches it, in
either package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spnet_tpu_torch.models.layers import (
    BatchNorm,
    avg_pool3_padded,
    avg_pool3_same,
    conv2d_nhwc,
    conv_kernel,
    depthwise_conv_nhwc,
    depthwise_kernel,
    max_pool3_padded,
    pointwise_kernel,
)

BN_MOM = 0.9997
PENULTIMATE_FILTERS = 1056  # NASNet-A (4 @ 1056): cell filters 1056 / 24
NUM_BLOCKS = 4  # normal cells per stack
STEM_FILTERS = 32


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, momentum=BN_MOM)


class SepBlock(nn.Module):
    """relu -> sepconv(k, s) -> BN -> relu -> sepconv(k, 1) -> BN (Keras
    `_separable_conv_block`); flax names `sep1_dw`, `sep1_pw`, `bn1`,
    `sep2_dw`, `sep2_pw`, `bn2`."""

    def __init__(self, in_ch: int, filters: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.sep1_dw = depthwise_kernel(in_ch, kernel)
        self.sep1_pw = pointwise_kernel(in_ch, filters)
        self.bn1 = _bn(filters)
        self.sep2_dw = depthwise_kernel(filters, kernel)
        self.sep2_pw = pointwise_kernel(filters, filters)
        self.bn2 = _bn(filters)
        self.stride = stride

    def forward(self, x):
        def sep(x, dw, pw, stride):
            y = depthwise_conv_nhwc(x, dw.weight, stride)
            return torch.matmul(y, pw.weight.to(y.dtype))

        x = sep(F.relu(x), self.sep1_dw, self.sep1_pw, self.stride)
        x = self.bn1(x, "relu")
        return self.bn2(sep(x, self.sep2_dw, self.sep2_pw, 1))


def _conv1x1(x, kernel):
    return conv2d_nhwc(x, kernel.weight)


class Adjust(nn.Module):
    """Align the previous cell's tensor p with the current cell (Keras
    `_adjust_block`).  mode 'none': p is None and ip itself is used;
    'reduce': a factorized reduction (p spatially larger: relu, then
    p[::2, ::2] and the (0, 1)-padded p[1::2, 1::2] through 1x1 convs of
    filters // 2 each, concatenated, BN); 'project': relu -> 1x1 conv ->
    BN; 'pass': p as it is."""

    def __init__(self, mode: str, p_ch: int, filters: int):
        super().__init__()
        self.mode = mode
        if mode == "reduce":
            self.conv1 = conv_kernel(p_ch, filters // 2, 1)
            self.conv2 = conv_kernel(p_ch, filters // 2, 1)
            self.bn = _bn(2 * (filters // 2))
        elif mode == "project":
            self.proj = conv_kernel(p_ch, filters, 1)
            self.bn = _bn(filters)

    def forward(self, p, ip):
        if self.mode == "none":
            return ip
        if self.mode == "reduce":
            p = F.relu(p)
            p1 = _conv1x1(p[:, ::2, ::2, :], self.conv1)
            p2 = F.pad(p, (0, 0, 0, 1, 0, 1))[:, 1::2, 1::2, :]
            p2 = _conv1x1(p2, self.conv2)
            return self.bn(torch.cat([p1, p2], dim=-1))
        if self.mode == "project":
            return self.bn(_conv1x1(F.relu(p), self.proj))
        return p

    @staticmethod
    def plan(p_shape, ip_shape, filters: int) -> tuple[str, int]:
        """(mode, channels of the aligned p) for p and ip of shapes
        (h, channels), p_shape None for no previous cell; JAX compares the
        heights only."""
        if p_shape is None:
            return "none", ip_shape[1]
        if p_shape[0] != ip_shape[0]:
            return "reduce", 2 * (filters // 2)
        if p_shape[1] != filters:
            return "project", filters
        return "pass", p_shape[1]


class _Cell(nn.Module):
    """What both cells share: `adjust` of p, and h = BN(conv1(relu(ip)))."""

    def __init__(self, ip_shape, p_shape, filters: int):
        super().__init__()
        mode, self.p_ch = Adjust.plan(p_shape, ip_shape, filters)
        self.adjust = Adjust(mode, p_shape[1] if p_shape else 0, filters)
        self.conv1 = conv_kernel(ip_shape[1], filters, 1)
        self.bn1 = _bn(filters)

    def _inputs(self, ip, p):
        p = self.adjust(p, ip)
        return self.bn1(_conv1x1(F.relu(ip), self.conv1)), p


class NormalCell(_Cell):
    """Returns (concat [p, x1..x5] of 6 x filters channels, ip)."""

    def __init__(self, ip_shape, p_shape, filters: int):
        super().__init__(ip_shape, p_shape, filters)
        f, pc = filters, self.p_ch
        self.left1, self.right1 = SepBlock(f, f, 5), SepBlock(pc, f, 3)
        self.left2, self.right2 = SepBlock(pc, f, 5), SepBlock(pc, f, 3)
        self.left5 = SepBlock(f, f, 3)

    def forward(self, ip, p):
        h, p = self._inputs(ip, p)
        x1 = self.left1(h) + self.right1(p)
        x2 = self.left2(p) + self.right2(p)
        x3 = avg_pool3_same(h) + p
        x4 = avg_pool3_same(p) + avg_pool3_same(p)
        x5 = self.left5(h) + h
        return torch.cat([p, x1, x2, x3, x4, x5], dim=-1), ip


class ReductionCell(_Cell):
    """Returns (concat [x2..x5] of 4 x filters channels at half the size,
    ip)."""

    def __init__(self, ip_shape, p_shape, filters: int):
        super().__init__(ip_shape, p_shape, filters)
        f, pc = filters, self.p_ch
        self.left1, self.right1 = SepBlock(f, f, 5, 2), SepBlock(pc, f, 7, 2)
        self.right2 = SepBlock(pc, f, 7, 2)
        self.right3 = SepBlock(pc, f, 5, 2)
        self.left5 = SepBlock(f, f, 3)

    def forward(self, ip, p):
        h, p = self._inputs(ip, p)
        x1 = self.left1(h) + self.right1(p)
        x2 = max_pool3_padded(h) + self.right2(p)
        x3 = avg_pool3_padded(h) + self.right3(p)
        x4 = x2 + avg_pool3_same(x1)
        x5 = self.left5(x1) + max_pool3_padded(h)
        return torch.cat([x2, x3, x4, x5], dim=-1), ip


class NASNetMobile(nn.Module):
    """Feature extractor: (B, H, W, C) -> (B, h, w, 1056), built for an
    (H, W) input."""

    LAYER_ORDER = (
        ["stem_conv", "stem_red1", "stem_red2"]
        + [f"normal1_{i}" for i in range(NUM_BLOCKS)]
        + ["red1"]
        + [f"normal2_{i}" for i in range(NUM_BLOCKS)]
        + ["red2"]
        + [f"normal3_{i}" for i in range(NUM_BLOCKS)]
    )

    def __init__(self, in_ch: int = 3,
                 input_hw: tuple[int, int] = (165, 165)):
        super().__init__()
        f = PENULTIMATE_FILTERS // 24
        self.stem_conv = conv_kernel(in_ch, STEM_FILTERS, 3)
        self.stem_bn = _bn(STEM_FILTERS)
        # (height, channels) of the tensors the cells see, as JAX's shapes
        x = ((input_hw[0] - 3) // 2 + 1, STEM_FILTERS)
        p = None
        cells = [("stem_red1", ReductionCell, f // 4),
                 ("stem_red2", ReductionCell, f // 2)]
        cells += [(f"normal1_{i}", NormalCell, f) for i in range(NUM_BLOCKS)]
        cells += [("red1", ReductionCell, f * 2)]
        cells += [(f"normal2_{i}", NormalCell, f * 2)
                  for i in range(NUM_BLOCKS)]
        cells += [("red2", ReductionCell, f * 4)]
        cells += [(f"normal3_{i}", NormalCell, f * 4)
                  for i in range(NUM_BLOCKS)]
        self.cells = [name for name, _, _ in cells]
        for name, cls, filters in cells:
            self.add_module(name, cls(x, p, filters))
            if cls is ReductionCell:
                out = (-(-x[0] // 2), 4 * filters)
            else:
                out = (x[0], 6 * filters)
            x, p = out, x
        self.FEATURES = x[1]

    @staticmethod
    def output_hw(h: int, w: int) -> tuple[int, int]:
        """The VALID 3x3/2 stem, then four reduction cells, each rounding
        up (SAME)."""
        def one(n):
            n = (n - 3) // 2 + 1
            for _ in range(4):
                n = -(-n // 2)
            return n
        return one(h), one(w)

    def forward(self, x):
        x = self.stem_bn(conv2d_nhwc(x, self.stem_conv.weight, 2, "VALID"))
        p = None
        for name in self.cells:
            x, p = getattr(self, name)(x, p)
        return F.relu(x)
