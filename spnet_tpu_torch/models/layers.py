"""Shared building blocks, NHWC, eval mode.

Counterpart of `spnet_tpu/models/layers.py`.  Activations stay NHWC, the
JAX layout and the sepconv kernel's.  Parameters are float32; a layer
casts its weights to the activations' dtype at use, as flax does with
`dtype=bfloat16` over float32 params.  Submodules and parameters carry the
flax scope names (`conv`, `bn`, `depthwise`, `pointwise`), so converting a
flax checkpoint is a per-leaf transform (`spnet_tpu_torch/convert.py`).

Only inference is ported so far: a layer in train mode raises
`NotImplementedError`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from spnet_tpu_torch.ops.sepconv import (
    fold_bn,
    sepconv_infer,
    sepconv_infer_torch,
)

BN_EPS = 1e-3  # Keras BatchNorm epsilon, as the JAX model uses


def glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator | None = None):
    """Keras `glorot_uniform` (flax `variance_scaling(1, fan_avg,
    uniform)`), with the fans of the FLAX-shaped kernel: U(-l, l),
    l = sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def _train_unsupported(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: train mode is not ported yet; "
            "call .eval()")


class Kernel(nn.Module):
    """A weight in the port's layout, with the fans flax computes for it
    (`variance_scaling(in_axis=-2, out_axis=-1)` on the flax shape)."""

    def __init__(self, shape: tuple[int, ...], fan_in: int, fan_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.fan_in, self.fan_out = fan_in, fan_out

    def reset_parameters(self, generator: torch.Generator | None = None):
        glorot_uniform_(self.weight, self.fan_in, self.fan_out, generator)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last (channel) axis: flax `scale`,
    `bias`, `mean`, `var` become `weight`, `bias`, `running_mean`,
    `running_var`."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, bias) in f32 with y = x * scale + bias."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x):
        _train_unsupported(self)
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(x.dtype)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF/flax SAME padding (low, high) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x, weight, stride: int = 1, padding: str = "SAME"):
    """Conv of NHWC `x` with an OIHW kernel, through channels-last views
    (cuDNN on the card, no copies of x)."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        kh, kw = weight.shape[2:]
        (ht, hb) = _same_pads(x.shape[1], kh, stride)
        (wl, wr) = _same_pads(x.shape[2], kw, stride)
        if ht == hb and wl == wr:
            y = F.conv2d(xc, weight.to(x.dtype), stride=stride,
                         padding=(ht, wl))
        else:
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), weight.to(x.dtype),
                         stride=stride)
    elif padding == "VALID":
        y = F.conv2d(xc, weight.to(x.dtype), stride=stride)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return y.permute(0, 2, 3, 1)


def max_pool_same(x, window: int = 3, stride: int = 2):
    """flax `max_pool(padding='SAME')` on NHWC: TF pads with -inf, and on
    an even size the padding is (0, 1), not the symmetric 1 of
    `MaxPool2d(padding=1)`."""
    (ht, hb) = _same_pads(x.shape[1], window, stride)
    (wl, wr) = _same_pads(x.shape[2], window, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (wl, wr, ht, hb),
               value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def avg_pool2_nhwc(x):
    """flax `avg_pool((2, 2), strides=(2, 2))` (VALID: an odd last row or
    column is dropped)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def leaky_relu_01(x):
    return F.leaky_relu(x, negative_slope=0.1)


class ConvBN(nn.Module):
    """Conv -> BatchNorm (-> ReLU)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: str = "SAME", relu: bool = False):
        super().__init__()
        rf = kernel * kernel
        self.conv = Kernel((features, in_ch, kernel, kernel),
                           fan_in=in_ch * rf, fan_out=features * rf)
        self.bn = BatchNorm(features)
        self.stride, self.padding, self.relu = stride, padding, relu

    def forward(self, x):
        x = self.bn(conv2d_nhwc(x, self.conv.weight, self.stride,
                                self.padding))
        return F.relu(x) if self.relu else x


class SeparableConvBN(nn.Module):
    """Depthwise 3x3 SAME -> pointwise 1x1 -> BatchNorm (-> ReLU), the
    Xception variant (no BN between depthwise and pointwise).

    In eval mode the BN running stats fold into f32 scale and bias and the
    whole layer is one `sepconv_infer` call: the fused kernel on the card,
    its plain version on the CPU.  `plain=True` calls the plain version on
    any device; it exists so that tests can hold the kernel against it."""

    def __init__(self, in_ch: int, features: int, relu: bool = False,
                 plain: bool = False):
        super().__init__()
        # flax kernels (3, 3, 1, C) and (1, 1, C, F), stored as (3, 3, C)
        # and (C, F): the layouts the kernel takes
        self.depthwise = Kernel((3, 3, in_ch), fan_in=9, fan_out=9 * in_ch)
        self.pointwise = Kernel((in_ch, features), fan_in=in_ch,
                                fan_out=features)
        self.bn = BatchNorm(features)
        self.relu, self.plain = relu, plain

    def forward(self, x):
        _train_unsupported(self)
        scale, bias = self.bn.folded()
        fn = sepconv_infer_torch if self.plain else sepconv_infer
        return fn(x.contiguous(), self.depthwise.weight,
                  self.pointwise.weight.to(x.dtype), scale, bias,
                  relu=self.relu)


def init_keras_(model: nn.Module, generator: torch.Generator | None = None):
    """Keras initialization of every layer, in module order: glorot-uniform
    kernels, zero biases, identity BatchNorm."""
    for m in model.modules():
        if isinstance(m, (Kernel, BatchNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            glorot_uniform_(m.weight, m.in_features, m.out_features,
                            generator)
            with torch.no_grad():
                m.bias.zero_()
    return model
