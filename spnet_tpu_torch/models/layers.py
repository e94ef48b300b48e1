"""Shared building blocks, NHWC, in eval and train mode.

Counterpart of `spnet_tpu/models/layers.py`.  Activations stay NHWC, the
JAX layout and the sepconv kernel's.  Parameters are float32; a layer
casts its weights to the activations' dtype at use, as flax does with
`dtype=bfloat16` over float32 params.  Submodules and parameters carry the
flax scope names (`conv`, `bn`, `depthwise`, `pointwise`), so converting a
flax checkpoint is a per-leaf transform (`spnet_tpu_torch/convert.py`).

In train mode BatchNorm normalizes with the batch statistics and updates
its running statistics as flax does, and a separable conv runs its plain
composition through autograd; in eval mode Xception's separable conv is
one `sepconv_infer` call (the fused kernel on the card), and MobileNet's
strided, BN-between variant its plain composition.
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

BN_EPS = 1e-3  # Keras BatchNorm epsilon and momentum, as the JAX model uses
BN_MOMENTUM = 0.99


def glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator | None = None):
    """Keras `glorot_uniform` (flax `variance_scaling(1, fan_avg,
    uniform)`), with the fans of the FLAX-shaped kernel: U(-l, l),
    l = sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


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
    """BatchNorm over the last (channel) axis: flax `scale`, `bias`,
    `mean`, `var` become `weight`, `bias`, `running_mean`, `running_var`.

    Train mode follows flax 0.12's `nn.BatchNorm(momentum=0.99,
    epsilon=1e-3)`: statistics reduced in float32, the fast variance
    E[x^2] - E[x]^2 clamped at 0, normalization with that biased
    variance, and running statistics r = 0.99 r + 0.01 batch, also with
    the biased variance (`F.batch_norm` would update with the unbiased
    one)."""

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
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp_min(torch.square(xf).mean(dims)
                                  - torch.square(mean), 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF/flax SAME padding (low, high) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x, weight, stride: int = 1, padding: str = "SAME",
                groups: int = 1):
    """Conv of NHWC `x` with an OIHW kernel, through channels-last views
    (cuDNN on the card, no copies of x).  SAME pads as TF does: (0, 1) on
    an even size at stride 2."""
    xc = x.permute(0, 3, 1, 2)
    w = weight.to(x.dtype)
    if padding == "SAME":
        kh, kw = weight.shape[2:]
        (ht, hb) = _same_pads(x.shape[1], kh, stride)
        (wl, wr) = _same_pads(x.shape[2], kw, stride)
        if ht == hb and wl == wr:
            y = F.conv2d(xc, w, stride=stride, padding=(ht, wl),
                         groups=groups)
        else:
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), w, stride=stride,
                         groups=groups)
    elif padding == "VALID":
        y = F.conv2d(xc, w, stride=stride, groups=groups)
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


#: Activations a layer may end with, by name ("" = none).  ReLU6 is the
#: JAX MobileNet's `min(relu(x), 6)`.
ACTIVATIONS = {"": lambda x: x, "relu": F.relu, "relu6": F.relu6}


def _activation(act: str):
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got "
                         f"{act!r}")
    return ACTIVATIONS[act]


class ConvBN(nn.Module):
    """Conv -> BatchNorm (-> activation)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: str = "SAME", act: str = ""):
        super().__init__()
        rf = kernel * kernel
        self.conv = Kernel((features, in_ch, kernel, kernel),
                           fan_in=in_ch * rf, fan_out=features * rf)
        self.bn = BatchNorm(features)
        self.stride, self.padding = stride, padding
        self.act = _activation(act)

    def forward(self, x):
        return self.act(self.bn(conv2d_nhwc(x, self.conv.weight, self.stride,
                                            self.padding)))


class SeparableConvBN(nn.Module):
    """[ReLU ->] depthwise 3x3 SAME (stride s) [-> BatchNorm 'bn_dw' ->
    activation] -> pointwise 1x1 -> BatchNorm (-> activation).

    Xception's variant (stride 1, no BN between, ReLU or none) runs in eval
    mode as one `sepconv_infer` call, with the BN running stats folded into
    f32 scale and bias and the input ReLU (`relu_in`) applied as the kernel
    reads x: the fused kernel on the card, its plain version on the CPU.
    `plain=True` calls the plain version on any device; it exists so that
    tests can hold the kernel against it.  Every other variant (MobileNet's
    strided blocks with `bn_between` and ReLU6), and every variant in train
    mode, runs `F.relu` (when `relu_in`) and then the plain composition
    (`_plain_forward`)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 act: str = "", bn_between: bool = False,
                 plain: bool = False, relu_in: bool = False):
        super().__init__()
        # flax kernels (3, 3, 1, C) and (1, 1, C, F), stored as (3, 3, C)
        # and (C, F): the layouts the kernel takes
        self.depthwise = Kernel((3, 3, in_ch), fan_in=9, fan_out=9 * in_ch)
        if bn_between:
            self.bn_dw = BatchNorm(in_ch)
        self.pointwise = Kernel((in_ch, features), fan_in=in_ch,
                                fan_out=features)
        self.bn = BatchNorm(features)
        self.stride, self.bn_between, self.plain = stride, bn_between, plain
        self.act = _activation(act)
        self.fused = stride == 1 and not bn_between and act in ("", "relu")
        self.relu, self.relu_in = act == "relu", relu_in

    def forward(self, x):
        if self.training or not self.fused:
            return self._plain_forward(F.relu(x) if self.relu_in else x)
        scale, bias = self.bn.folded()
        fn = sepconv_infer_torch if self.plain else sepconv_infer
        return fn(x.contiguous(), self.depthwise.weight,
                  self.pointwise.weight.to(x.dtype), scale, bias,
                  relu=self.relu, relu_in=self.relu_in)

    def _plain_forward(self, x):
        """Depthwise conv with TF SAME pads (cuDNN on the card) [-> BN ->
        activation] -> pointwise matmul -> BN (-> activation) in x's type,
        through autograd; the BNs use batch statistics in train mode and
        the running ones in eval mode.  The JAX package's composition."""
        k = self.depthwise.weight.permute(2, 0, 1).unsqueeze(1)  # (C,1,3,3)
        y = conv2d_nhwc(x, k, self.stride, "SAME", groups=x.shape[-1])
        if self.bn_between:
            y = self.act(self.bn_dw(y))
        z = self.bn(torch.matmul(y, self.pointwise.weight.to(x.dtype)))
        return self.act(z)


class Dropout(nn.Module):
    """flax `nn.Dropout`: in train mode each value is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed.  The
    mask is drawn from an explicit `torch.Generator` on x's device
    (`F.dropout` takes none).  The identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator on "
                             f"{x.device}")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


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
