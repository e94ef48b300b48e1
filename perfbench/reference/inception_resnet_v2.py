"""Inception-ResNet-v2 (Szegedy et al. 2016, arXiv:1602.07261) as SPNet's
backbone, plain float32, in the form Keras' `InceptionResNetV2` builds it
(keras/applications/inception_resnet_v2.py of Keras 2.1.3, the version
SPNet pins; TF-slim's form), which SPNet trains:

    stem: 3x3/2 VALID 32, 3x3 VALID 32, 3x3 SAME 64, max pool 3x3/2 VALID,
          1x1 VALID 80, 3x3 VALID 192, max pool 3x3/2 VALID
    mixed_5b (Inception-A): 1x1 96 | 1x1 48, 5x5 64 | 1x1 64, 3x3 96,
          3x3 96 | avg pool 3x3/1 SAME, 1x1 64 -> 320
    10 x block35: 1x1 32 | 1x1 32, 3x3 32 | 1x1 32, 3x3 48, 3x3 64
          -> concat -> 1x1 `up` (bias) to 320 -> x + 0.17 up -> ReLU
    mixed_6a (reduction-A): 3x3/2 VALID 384 | 1x1 256, 3x3 256, 3x3/2
          VALID 384 | max pool 3x3/2 VALID -> 1088
    20 x block17: 1x1 192 | 1x1 128, 1x7 160, 7x1 192 -> `up` to 1088,
          x + 0.10 up -> ReLU
    mixed_7a (reduction-B): 1x1 256, 3x3/2 VALID 384 | 1x1 256, 3x3/2
          VALID 288 | 1x1 256, 3x3 288, 3x3/2 VALID 320 | max pool 3x3/2
          VALID -> 2080
    10 x block8: 1x1 192 | 1x1 192, 1x3 224, 3x1 256 -> `up` to 2080,
          x + 0.20 up -> ReLU; the last with scale 1.0 and no ReLU
    conv_7b: 1x1 1536

Every conv but `up` is followed by a gamma-less BatchNorm (Keras
`scale=False`: no `weight`) and a ReLU.

Departures from the paper, all Keras' (and so SPNet's):
  * the stem is Inception-v3's plain chain above, not the paper's
    Figure 3 stem with its branch concatenations, and mixed_5b is an
    Inception-A block the paper does not have;
  * 10 / 20 / 10 residual blocks (the paper's Figure 15 draws 5 / 10 /
    5), whose widths lead to 320 / 1088 / 2080 channels (the paper's
    `up` convs give 384 / 1154 / 2048);
  * residual scales 0.17 / 0.10 / 0.20 (the paper: "between 0.1 and
    0.3"), the last block8 at 1.0 without its ReLU, and `conv_7b` to 1536
    in place of the paper's average pool and dropout.
SPNet's own: the stem of `reference/spnet.py` halves the input first
(331 -> 165), and the head is dense over the last map (3x3x1536 at 331),
with no global pool.  `scale * up` is rounded by the numerics: the program
forms it in its compute dtype before the add.  Parameter names are those
under `backbone.`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.layers import Ctx, conv

FEATURES = 1536

#: each residual block kind's branches: [(layer, out channels, kernel)]
#: applied in turn, all stride 1 SAME
BLOCK35 = [[("b0", 32, 1)], [("b1a", 32, 1), ("b1b", 32, 3)],
           [("b2a", 32, 1), ("b2b", 48, 3), ("b2c", 64, 3)]]
BLOCK17 = [[("b0", 192, 1)],
           [("b1a", 128, 1), ("b1b", 160, (1, 7)), ("b1c", 192, (7, 1))]]
BLOCK8 = [[("b0", 192, 1)],
          [("b1a", 192, 1), ("b1b", 224, (1, 3)), ("b1c", 256, (3, 1))]]
#: (block kind, its branches, how many, channels, residual scale)
REPEATS = (("block35", BLOCK35, 10, 320, 0.17),
           ("block17", BLOCK17, 20, 1088, 0.10),
           ("block8", BLOCK8, 10, 2080, 0.20))


def _pool_out(n: int) -> int:
    """A VALID 3x3/2 window's output length."""
    return (n - 3) // 2 + 1


def output_hw(h: int, w: int) -> tuple[int, int]:
    def one(n):
        n = _pool_out(n) - 2          # stem1 3x3/2, stem2 3x3 VALID
        n = _pool_out(n) - 2          # max pool, stem5 3x3 VALID
        for _ in range(3):            # max pool, mixed_6a, mixed_7a
            n = _pool_out(n)
        return n
    return one(h), one(w)


def _kernel(k) -> tuple[int, int]:
    return (k, k) if isinstance(k, int) else k


def _cbr_shapes(name: str, cin: int, cout: int, k) -> dict:
    """A conv and its gamma-less BatchNorm."""
    return {f"{name}.conv.weight": (cout, cin, *_kernel(k)),
            **{f"{name}.bn.{s}": (cout,)
               for s in ("bias", "running_mean", "running_var")}}


def _block_shapes(name: str, branches, c: int) -> dict:
    s, mixed = {}, 0
    for branch in branches:
        cin = c
        for layer, cout, k in branch:
            s.update(_cbr_shapes(f"{name}.{layer}", cin, cout, k))
            cin = cout
        mixed += cin
    s[f"{name}.up.weight"] = (c, mixed, 1, 1)
    s[f"{name}.up.bias"] = (c,)
    return s


#: the stem, mixed_5b, mixed_6a and mixed_7a: (layer, in, out, kernel)
PLAIN = [("stem1", None, 32, 3), ("stem2", 32, 32, 3), ("stem3", 32, 64, 3),
         ("stem4", 64, 80, 1), ("stem5", 80, 192, 3),
         ("m5b_b0", 192, 96, 1), ("m5b_b1a", 192, 48, 1),
         ("m5b_b1b", 48, 64, 5), ("m5b_b2a", 192, 64, 1),
         ("m5b_b2b", 64, 96, 3), ("m5b_b2c", 96, 96, 3),
         ("m5b_b3", 192, 64, 1),
         ("m6a_b0", 320, 384, 3), ("m6a_b1a", 320, 256, 1),
         ("m6a_b1b", 256, 256, 3), ("m6a_b1c", 256, 384, 3),
         ("m7a_b0a", 1088, 256, 1), ("m7a_b0b", 256, 384, 3),
         ("m7a_b1a", 1088, 256, 1), ("m7a_b1b", 256, 288, 3),
         ("m7a_b2a", 1088, 256, 1), ("m7a_b2b", 256, 288, 3),
         ("m7a_b2c", 288, 320, 3)]


def param_shapes(prefix: str = "backbone", in_ch: int = 3) -> dict:
    """Every parameter and BatchNorm statistic, by name, with its shape."""
    s = {}
    for layer, cin, cout, k in PLAIN:
        s.update(_cbr_shapes(f"{prefix}.{layer}", cin or in_ch, cout, k))
    for kind, branches, n, c, _ in REPEATS:
        for i in range(n):
            s.update(_block_shapes(f"{prefix}.{kind}_{i + 1}", branches, c))
    s.update(_cbr_shapes(f"{prefix}.conv_7b", 2080, 1536, 1))
    return s


def max_pool_valid(x):
    """3x3/2 VALID max pool, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def avg_pool3_same(x):
    """3x3/1 SAME average pool that divides each window by its real cells
    (Keras' 'same' AveragePooling2D), NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, padding=1,
                        count_include_pad=False).permute(0, 2, 3, 1)


def cbr(c: Ctx, x, name: str, stride: int = 1, padding: str = "SAME"):
    """conv -> gamma-less BatchNorm -> ReLU."""
    return c.conv_bn(x, name, stride, padding, act="relu")


def residual(c: Ctx, x, name: str, branches, scale: float,
             final_relu: bool = True):
    outs = []
    for branch in branches:
        y = x
        for layer, _, _ in branch:
            y = cbr(c, y, f"{name}.{layer}")
        outs.append(y)
    up = conv(torch.cat(outs, dim=-1), c.p[f"{name}.up.weight"], c.nm) \
        + c.p[f"{name}.up.bias"]
    x = x + c.nm.round(scale * up)
    return F.relu(x) if final_relu else x


def forward(c: Ctx, x, prefix: str = "backbone"):
    p = prefix
    x = cbr(c, x, f"{p}.stem1", 2, "VALID")
    x = cbr(c, x, f"{p}.stem2", padding="VALID")
    x = max_pool_valid(cbr(c, x, f"{p}.stem3"))
    x = cbr(c, x, f"{p}.stem4", padding="VALID")
    x = max_pool_valid(cbr(c, x, f"{p}.stem5", padding="VALID"))

    x = torch.cat([
        cbr(c, x, f"{p}.m5b_b0"),
        cbr(c, cbr(c, x, f"{p}.m5b_b1a"), f"{p}.m5b_b1b"),
        cbr(c, cbr(c, cbr(c, x, f"{p}.m5b_b2a"), f"{p}.m5b_b2b"),
            f"{p}.m5b_b2c"),
        cbr(c, avg_pool3_same(x), f"{p}.m5b_b3")], dim=-1)
    x = _repeat(c, x, p, 0)

    x = torch.cat([
        cbr(c, x, f"{p}.m6a_b0", 2, "VALID"),
        cbr(c, cbr(c, cbr(c, x, f"{p}.m6a_b1a"), f"{p}.m6a_b1b"),
            f"{p}.m6a_b1c", 2, "VALID"),
        max_pool_valid(x)], dim=-1)
    x = _repeat(c, x, p, 1)

    x = torch.cat([
        cbr(c, cbr(c, x, f"{p}.m7a_b0a"), f"{p}.m7a_b0b", 2, "VALID"),
        cbr(c, cbr(c, x, f"{p}.m7a_b1a"), f"{p}.m7a_b1b", 2, "VALID"),
        cbr(c, cbr(c, cbr(c, x, f"{p}.m7a_b2a"), f"{p}.m7a_b2b"),
            f"{p}.m7a_b2c", 2, "VALID"),
        max_pool_valid(x)], dim=-1)
    x = _repeat(c, x, p, 2)
    return cbr(c, x, f"{p}.conv_7b")


def _repeat(c: Ctx, x, prefix: str, which: int):
    kind, branches, n, _, scale = REPEATS[which]
    for i in range(n):
        last = kind == "block8" and i == n - 1
        x = residual(c, x, f"{prefix}.{kind}_{i + 1}", branches,
                     1.0 if last else scale, final_relu=not last)
    return x
