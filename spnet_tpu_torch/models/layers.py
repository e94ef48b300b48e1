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
strided, BN-between variant its plain composition.  The pools are flax's:
SAME max pools pad with -inf, stride-1 SAME average pools divide by the
real cells only, and VALID pools drop what does not fill a window.
"""

from __future__ import annotations

import math

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from spnet_tpu_torch.parallel import mesh
from spnet_tpu_torch.utils.profiling import span

from spnet_tpu_torch.ops.batchnorm import ACTS, batchnorm_train
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
    (`variance_scaling(in_axis=-2, out_axis=-1)` on the flax shape), and
    with `bias` a zero-initialized bias over the last flax axis (flax
    `nn.Conv(use_bias=True)`)."""

    def __init__(self, shape: tuple[int, ...], fan_in: int, fan_out: int,
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None
        self.fan_in, self.fan_out = fan_in, fan_out

    def reset_parameters(self, generator: torch.Generator | None = None):
        glorot_uniform_(self.weight, self.fan_in, self.fan_out, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


def conv_kernel(in_ch: int, features: int, kernel: int | tuple[int, int],
                bias: bool = False) -> Kernel:
    """An OIHW conv kernel with the fans of flax's (kh, kw, I, O) one."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return Kernel((features, in_ch, kh, kw), fan_in=in_ch * kh * kw,
                  fan_out=features * kh * kw, bias=bias)


def depthwise_kernel(channels: int, k: int = 3) -> Kernel:
    """A (k, k, C) depthwise kernel; flax's is (k, k, 1, C), with fan_in
    k² and fan_out k²·C."""
    return Kernel((k, k, channels), fan_in=k * k, fan_out=k * k * channels)


def pointwise_kernel(in_ch: int, features: int) -> Kernel:
    """A (C, F) pointwise kernel; flax's is (1, 1, C, F)."""
    return Kernel((in_ch, features), fan_in=in_ch, fan_out=features)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis: flax `scale`, `bias`,
    `mean`, `var` become `weight`, `bias`, `running_mean`, `running_var`.

    Train mode follows flax 0.12's `nn.BatchNorm(momentum, epsilon=1e-3)`:
    statistics reduced in float32, the fast variance E[x^2] - E[x]^2
    clamped at 0, normalization with that biased variance, and running
    statistics r = momentum r + (1 - momentum) batch, also with the biased
    variance (`F.batch_norm` would update with the unbiased one).
    `momentum` is flax's (0.99 by default, NASNet's 0.9997), torch's
    1 - momentum.  scale=False is flax `use_scale=False` (Inception-ResNet-
    v2's gamma-less BN): no `weight` at all.  With `update_stats` False a
    train-mode pass normalizes with the batch statistics and leaves the
    running ones alone: the recompute of a checkpointed backbone
    (`models/spnet.py`, remat) runs so, and flax keeps only the first
    pass's update.

    Inside a process group of more than one rank (`parallel/mesh.py`) the
    train-mode statistics are the global batch's, as under JAX's mesh: the
    ranks' equal batches give their moments E[x] and E[x^2] to one
    all-reduce, so every rank normalizes alike and keeps the same running
    statistics.  Without a group the arithmetic is unchanged.

    `forward(x, act)` also applies the activation `act` (a name of
    `ACTIVATIONS`) that the calling module applies to the output.  In
    train mode on a CUDA tensor the layer and its activation run as the
    kernels of `ops/batchnorm.py::batchnorm_train` (a stats pass and a
    normalize pass forward, a sums pass and a dx pass backward; no
    fallback); everywhere else as `plain(x)` followed by the activation.
    `plain` is flax's arithmetic as float32 torch ops: the kernels' twin,
    and the only path on the CPU and in eval mode."""

    def __init__(self, features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM, scale: bool = True):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, bias) in f32 with y = x * scale + bias."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x, act: str = ""):
        if self.training and x.device.type == "cuda":
            return batchnorm_train(x, self, act)
        return _activation(act)(self.plain(x))

    def plain(self, x):
        """The layer without its activation, as float32 torch ops."""
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            mean_sq = torch.square(xf).mean(dims)
            n_ranks = mesh.world_size()
            if n_ranks > 1:
                # global-batch statistics, as XLA's all-reduce over the
                # mesh gives them: the ranks' batches are equal, so the
                # global moments are the means of the local ones.  One
                # autograd-aware all-reduce a layer; its backward
                # all-reduces the gradients of the moments.
                moments = dist_fn.all_reduce(torch.cat([mean, mean_sq]))
                mean, mean_sq = (moments / n_ranks).split(mean.shape[0])
            var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF/flax SAME padding (low, high) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x, weight, stride: int = 1, padding: str = "SAME",
                groups: int = 1, bias=None):
    """Conv of NHWC `x` with an OIHW kernel (and a bias), through
    channels-last views (cuDNN on the card, no copies of x).  SAME pads as
    TF does: (0, 1) on an even size at stride 2, (k//2 - 1, k//2) for any
    odd k."""
    xc = x.permute(0, 3, 1, 2)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if padding == "SAME":
        kh, kw = weight.shape[2:]
        (ht, hb) = _same_pads(x.shape[1], kh, stride)
        (wl, wr) = _same_pads(x.shape[2], kw, stride)
        if ht == hb and wl == wr:
            y = F.conv2d(xc, w, b, stride=stride, padding=(ht, wl),
                         groups=groups)
        else:
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), w, b, stride=stride,
                         groups=groups)
    elif padding == "VALID":
        y = F.conv2d(xc, w, b, stride=stride, groups=groups)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return y.permute(0, 2, 3, 1)


def depthwise_conv_nhwc(x, dw, stride: int = 1):
    """Depthwise k x k SAME conv of NHWC `x` with a (k, k, C) kernel."""
    k = dw.permute(2, 0, 1).unsqueeze(1)  # (C, 1, k, k)
    return conv2d_nhwc(x, k, stride, "SAME", groups=x.shape[-1])


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


def max_pool_valid(x, window: int, stride: int):
    """flax `max_pool((w, w), strides=(s, s))`, whose padding defaults to
    VALID: DarkNet's 2x2/2 (165 -> 82) and Inception-ResNet-v2's 3x3/2."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)


def avg_pool3_same(x):
    """flax `avg_pool((3, 3), strides=(1, 1), padding='SAME',
    count_include_pad=False)`: an edge window is divided by its real cells
    (Keras 'same' AveragePooling2D), not by 9 as torch's default is."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, padding=1,
                        count_include_pad=False).permute(0, 2, 3, 1)


def pad_for_pool(x):
    """NASNet's reduction-cell pad (Keras `ZeroPadding2D(correct_pad)` for
    a 3x3 window): (1 if the size is odd else 0, 1) ZEROS on each spatial
    axis.  The zeros are real cells for the VALID pool after it: counted
    by the average, compared by the max."""
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, w % 2, 1, h % 2, 1))


def max_pool3_padded(x):
    """NASNet's `_max3_padded`: zero pad, then a VALID 3x3/2 max pool."""
    return max_pool_valid(pad_for_pool(x), 3, 2)


def avg_pool3_padded(x):
    """NASNet's `_avg3_padded`: zero pad, then a VALID 3x3/2 average."""
    return F.avg_pool2d(pad_for_pool(x).permute(0, 3, 1, 2), 3,
                        2).permute(0, 2, 3, 1)


def leaky_relu_01(x):
    return F.leaky_relu(x, negative_slope=0.1)


def mish(x):
    """Mish activation, x * tanh(softplus(x)) (the reference keeps it as an
    optional experiment, `spnet/models.py:74-98`; no model of the port
    uses it, as in JAX)."""
    return x * torch.tanh(F.softplus(x))


#: Activations a layer may end with, by name ("" = none): the names of
#: `ops/batchnorm.py::ACTS`, in its order.  ReLU6 is the JAX MobileNet's
#: `min(relu(x), 6)`; "leaky" is DarkNet's LeakyReLU(0.1).
ACTIVATIONS = dict(zip(ACTS, (lambda x: x, F.relu, F.relu6, leaky_relu_01)))


def _activation(act: str):
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got "
                         f"{act!r}")
    return ACTIVATIONS[act]


class ConvBN(nn.Module):
    """Conv (k x k or kh x kw, SAME or VALID) -> BatchNorm (gamma-less when
    not bn_scale) (-> activation): the JAX `ConvBN`'s fields that a model
    of the port sets."""

    def __init__(self, in_ch: int, features: int,
                 kernel: int | tuple[int, int] = 3, stride: int = 1,
                 padding: str = "SAME", act: str = "",
                 bn_scale: bool = True):
        super().__init__()
        self.conv = conv_kernel(in_ch, features, kernel)
        self.bn = BatchNorm(features, scale=bn_scale)
        self.stride, self.padding = stride, padding
        self.act = act

    def forward(self, x):
        return self.bn(conv2d_nhwc(x, self.conv.weight, self.stride,
                                   self.padding), self.act)


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
    (`_plain_forward`).  Either path runs inside an `spnet.sepconv` span
    (`utils/profiling.py::span`)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 act: str = "", bn_between: bool = False,
                 plain: bool = False, relu_in: bool = False):
        super().__init__()
        # flax kernels (3, 3, 1, C) and (1, 1, C, F), stored as (3, 3, C)
        # and (C, F): the layouts the kernel takes
        self.depthwise = depthwise_kernel(in_ch)
        if bn_between:
            self.bn_dw = BatchNorm(in_ch)
        self.pointwise = pointwise_kernel(in_ch, features)
        self.bn = BatchNorm(features)
        self.stride, self.bn_between, self.plain = stride, bn_between, plain
        self.act = act
        self.fused = stride == 1 and not bn_between and act in ("", "relu")
        self.relu, self.relu_in = act == "relu", relu_in

    def forward(self, x):
        with span("spnet.sepconv"):
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
        y = depthwise_conv_nhwc(x, self.depthwise.weight, self.stride)
        if self.bn_between:
            y = self.bn_dw(y, self.act)
        return self.bn(torch.matmul(y, self.pointwise.weight.to(x.dtype)),
                       self.act)


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
        # inside a group the mask of the global batch is drawn and this
        # rank keeps its rows, so a run does not depend on the world size
        n_ranks = mesh.world_size()
        shape = (x.shape[0] * n_ranks,) + tuple(x.shape[1:])
        keep = mesh.local_rows(torch.rand(shape, generator=generator,
                                          device=x.device)) < keep_prob
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
