"""Plain float32 layers of SPNet, NHWC, as functions of named tensors.

The benchmark's own statement of the mathematics that the measured
program computes; it imports nothing of the program.  `Numerics` is the
one place where the control lowers the precision: with
`Numerics("fp8")` the operands and the result of every conv, depthwise
conv and matrix product, and every BatchNorm's output (the tensors the
program holds in bf16), are rounded to float8 e4m3 with a per-tensor
scale, a straight-through rounding so that autograd still runs;
`Numerics("bf16")` rounds the same tensors to bfloat16, a witness of
what the configuration's own precision does to the compared numbers.  Layouts
are the ones the parameters are stored in: conv kernels OIHW, depthwise
kernels (k, k, C), pointwise kernels (C, F), dense weights (out, in).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Numerics:
    """The arithmetic: 'f32' (the reference), 'fp8' (the control: each
    rounded tensor scaled so that its largest magnitude is FP8_MAX,
    rounded to float8 e4m3 and scaled back) or 'bf16' (rounded to
    bfloat16); the arithmetic itself in float32."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8", "bf16"):
            raise ValueError(f"numerics must be 'f32', 'fp8' or 'bf16', got "
                             f"{kind!r}")
        self.kind = kind

    def note(self, op: str, **shapes) -> None:
        """Called by every matrix operation and separable conv with its
        shapes; the counters (`perfbench/counts/`) record them, the
        reference ignores them."""

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return t
        if self.kind == "bf16":
            q = t.detach().to(torch.bfloat16).to(t.dtype)
        else:
            scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
            q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) \
                * scale
        return t + (q - t.detach())


F32 = Numerics("f32")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow SAME padding (low, high) of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, nm: Numerics, stride: int = 1, padding: str = "SAME",
         groups: int = 1):
    """NHWC conv with an OIHW kernel, TF SAME or VALID."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        kh, kw = w.shape[2:]
        ht, hb = same_pads(x.shape[1], kh, stride)
        wl, wr = same_pads(x.shape[2], kw, stride)
        xc = F.pad(xc, (wl, wr, ht, hb))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = nm.round(F.conv2d(nm.round(xc), nm.round(w), stride=stride,
                          groups=groups))
    nm.note("conv", out=tuple(y.shape), weight=tuple(w.shape))
    return y.permute(0, 2, 3, 1)


def depthwise(x, dw, nm: Numerics, stride: int = 1):
    """Depthwise k x k SAME conv with a (k, k, C) kernel."""
    k = dw.permute(2, 0, 1).unsqueeze(1)
    return conv(x, k, nm, stride, "SAME", groups=x.shape[-1])


def matmul(x, w, nm: Numerics):
    """x (..., K) @ w (K, N)."""
    y = nm.round(torch.matmul(nm.round(x), nm.round(w)))
    nm.note("matmul", out=tuple(y.shape), k=x.shape[-1])
    return y


def dense(x, w, b, nm: Numerics):
    return matmul(x, w.t(), nm) + b


def batch_norm(x, p: dict, name: str, train: bool, stats: dict | None = None):
    """BatchNorm over the channel axis.  Train mode: the batch's mean and
    biased variance E[x^2] - E[x]^2 (clamped at 0); with `stats` given,
    the batch moments are recorded there under `name`.  Eval mode: the
    running statistics.  scale is absent for a gamma-less layer."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = torch.clamp_min(torch.square(x).mean(dims)
                              - torch.square(mean), 0.0)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    mul = torch.rsqrt(var + BN_EPS)
    if f"{name}.weight" in p:
        mul = mul * p[f"{name}.weight"]
    return (x - mean) * mul + p[f"{name}.bias"]


def max_pool_same(x, window: int = 3, stride: int = 2):
    ht, hb = same_pads(x.shape[1], window, stride)
    wl, wr = same_pads(x.shape[2], window, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def avg_pool2(x):
    """2x2/2 VALID average pool."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


ACTS = {"": lambda x: x, "relu": F.relu, "relu6": F.relu6,
        "leaky": lambda x: F.leaky_relu(x, 0.1)}


class Ctx:
    """What a forward pass needs besides the input: the parameters by
    name, train or eval mode, the numerics, and where train mode records
    its batch moments."""

    def __init__(self, params: dict, train: bool, nm: Numerics = F32,
                 stats: dict | None = None):
        self.p, self.train, self.nm, self.stats = params, train, nm, stats

    def bn(self, x, name):
        return self.nm.round(batch_norm(x, self.p, name, self.train,
                                        self.stats))

    def conv_bn(self, x, name, stride=1, padding="SAME", act=""):
        y = conv(x, self.p[f"{name}.conv.weight"], self.nm, stride, padding)
        return ACTS[act](self.bn(y, f"{name}.bn"))

    def sep_conv_bn(self, x, name, stride=1, act="", bn_between=False,
                    relu_in=False):
        """[ReLU ->] depthwise 3x3 SAME [-> BN -> act] -> pointwise -> BN
        (-> act)."""
        x_in = x
        if relu_in:
            x = F.relu(x)
        y = depthwise(x, self.p[f"{name}.depthwise.weight"], self.nm, stride)
        if bn_between:
            y = ACTS[act](self.bn(y, f"{name}.bn_dw"))
        y = matmul(y, self.p[f"{name}.pointwise.weight"], self.nm)
        y = ACTS[act](self.bn(y, f"{name}.bn"))
        self.nm.note("sepconv", name=name, x=tuple(x_in.shape),
                     out=tuple(y.shape), bn_between=bn_between)
        return y


def bn_shapes(name: str, c: int) -> dict:
    return {f"{name}.{k}": (c,)
            for k in ("weight", "bias", "running_mean", "running_var")}


def conv_bn_shapes(name: str, cin: int, cout: int, k: int) -> dict:
    return {f"{name}.conv.weight": (cout, cin, k, k),
            **bn_shapes(f"{name}.bn", cout)}


def sep_conv_bn_shapes(name: str, cin: int, cout: int,
                       bn_between: bool = False) -> dict:
    return {f"{name}.depthwise.weight": (3, 3, cin),
            **(bn_shapes(f"{name}.bn_dw", cin) if bn_between else {}),
            f"{name}.pointwise.weight": (cin, cout),
            **bn_shapes(f"{name}.bn", cout)}
