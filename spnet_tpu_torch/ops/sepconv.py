"""Fused inference separable convolution: [input ReLU ->] depthwise 3x3
SAME -> pointwise -> folded BatchNorm -> optional ReLU, NHWC.

Counterpart of `spnet_tpu/ops/sepconv_pallas.py`.  `sepconv_infer` is the
wrapper the model calls: on a CUDA tensor it launches the hand-written
Hopper kernel (`csrc/sepconv.cu`), on a CPU tensor it runs the plain
PyTorch version `sepconv_infer_torch`.  There is no fallback between the
two: a CUDA launch either succeeds or raises.  `sepconv_plan` picks the
kernel's tiles for a shape.

The same two paths are registered as the operator
`spnet_tpu_torch::sepconv_infer` (the CUDA launch and the CPU twin, with a
fake that gives the output's shape), which `torch.export` records in a
serving artifact (`io/export.py`); the wrapper routes through it only
while exporting, so an eager call pays no dispatcher.  Importing this
module registers the operator: an artifact loads where it is importable.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Streaming multiprocessors of an H100 SXM: the default the tiles fill.
H100_SMS = 132


def fold_bn(gamma, beta, mean, var, eps: float = 1e-3):
    """Inference BatchNorm as y = z * scale + bias."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def sepconv_infer_torch(x, dw, pw, scale, bias, relu: bool = True,
                        relu_in: bool = False):
    """Plain twin of `sepconv_infer_jnp` (of `jnp.maximum(x, 0)` when
    `relu_in`).

    x: (B, H, W, C);  dw: (3, 3, C);  pw: (C, F);  scale/bias: (F,) f32.
    The depthwise runs with dw in x's type, accumulates in f32 and rounds
    to x's type; the pointwise accumulates in f32, as the JAX twin's
    `preferred_element_type=float32` does."""
    if relu_in:
        x = torch.clamp_min(x, 0)
    c = x.shape[-1]
    k = dw.to(x.dtype).float().permute(2, 0, 1).unsqueeze(1)  # (C,1,3,3)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1, groups=c)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    z = torch.matmul(y.float(), pw.to(x.dtype).float())
    z = z * scale + bias
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x.dtype)


def sepconv_plan(b: int, h: int, w: int, c: int, f: int,
                 sms: int = H100_SMS) -> tuple[int, int, int]:
    """Tiles of the bf16 wgmma kernel for x (b, h, w, c) and F = f:
    (TM pixels, TN output channels, number of output tiles).

    TN follows F: 64 or 128 when F fits in it (no half-empty tile at
    F = 128), else 256, the widest `wgmma` takes, so that a tile's
    depthwise feeds the most output channels (it is recomputed once per N
    tile).  TM is 128 (two consumer warpgroups of 64 rows, half the weight
    re-reads through L2 of TM = 64) unless that leaves fewer tiles than
    `sms`; then 64.  The kernel runs min(tiles, sms) persistent blocks,
    each walking tiles `sms` apart."""
    tn = 64 if f <= 64 else 128 if f <= 128 else 256
    m = b * h * w
    n_tiles = -(-f // tn)
    tm = 128 if -(-m // 128) * n_tiles >= sms else 64
    return tm, tn, -(-m // tm) * n_tiles


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _check(x, dw, pw, scale, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    if dw.shape != (3, 3, c) or dw.dtype != torch.float32:
        raise ValueError(f"dw must be (3, 3, {c}) float32, got "
                         f"{tuple(dw.shape)} {dw.dtype}")
    if pw.dim() != 2 or pw.shape[0] != c or pw.dtype != x.dtype:
        raise ValueError(f"pw must be ({c}, F) {x.dtype}, got "
                         f"{tuple(pw.shape)} {pw.dtype}")
    f = pw.shape[1]
    for name, v in (("scale", scale), ("bias", bias)):
        if v.shape != (f,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be ({f},) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for name, v in (("x", x), ("dw", dw), ("pw", pw), ("scale", scale),
                    ("bias", bias)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _wgmma_tiles(lib, x, dw, pw, scale, bias) -> tuple[int, int, int]:
    """(TM, TN, blocks) of the wgmma path, or (0, 0, 0) for the simple
    path: float32, C or F not a multiple of 8, a pointer that is not
    16-byte aligned (a view into a larger buffer), or rows so wide that a
    tile's x halo does not fit in shared memory (W above ~300)."""
    b, h, w, c = x.shape
    f = pw.shape[1]
    aligned = all(v.data_ptr() % 16 == 0 for v in (x, dw, pw, scale, bias))
    if x.dtype != torch.bfloat16 or c % 8 or f % 8 or not aligned:
        return 0, 0, 0
    sms, smem = _device_limits(x.device.index if x.device.index is not None
                               else torch.cuda.current_device())
    tm, tn, tiles = sepconv_plan(b, h, w, c, f, sms)
    if lib.spnet_sepconv_wgmma_smem(tm, tn, w) > smem:
        return 0, 0, 0
    return tm, tn, min(tiles, sms)


def sepconv_infer(x, dw, pw, scale, bias, relu: bool = True,
                  relu_in: bool = False):
    """Fused separable conv; `sepconv_infer.launches` counts kernel
    launches (CPU calls take the plain path and are not counted; launches
    from an exported artifact count too)."""
    _check(x, dw, pw, scale, bias)
    if torch.compiler.is_exporting():
        return torch.ops.spnet_tpu_torch.sepconv_infer(x, dw, pw, scale,
                                                       bias, relu, relu_in)
    if x.device.type == "cpu":
        return sepconv_infer_torch(x, dw, pw, scale, bias, relu, relu_in)
    if x.device.type != "cuda":
        raise ValueError(f"no sepconv kernel for device {x.device}")
    return _launch(x, dw, pw, scale, bias, relu, relu_in)


def _launch(x, dw, pw, scale, bias, relu, relu_in):
    """The kernel on checked CUDA tensors."""
    from spnet_tpu_torch.ops._build import load_library

    lib = load_library()
    b, h, w, c = x.shape
    f = pw.shape[1]
    if b * h * w >= 2**31:
        raise ValueError(f"B*H*W = {b * h * w} exceeds the kernel's int32 "
                         "pixel index")
    out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    tm, tn, blocks = _wgmma_tiles(lib, x, dw, pw, scale, bias)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spnet_sepconv_infer(
            x.data_ptr(), dw.data_ptr(), pw.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, h, w, c, f, int(relu),
            int(relu_in), _DTYPE_CODES[x.dtype], tm, tn, blocks, stream)
    if err != 0:
        raise RuntimeError(f"sepconv kernel launch failed: CUDA error {err}")
    sepconv_infer.launches += 1
    return out


sepconv_infer.launches = 0


@torch.library.custom_op("spnet_tpu_torch::sepconv_infer", mutates_args=(),
                         device_types="cuda")
def _sepconv_op(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor, relu: bool,
                relu_in: bool) -> torch.Tensor:
    return _launch(x, dw, pw, scale, bias, relu, relu_in)


_sepconv_op.register_kernel("cpu")(sepconv_infer_torch)


@_sepconv_op.register_fake
def _(x, dw, pw, scale, bias, relu, relu_in):
    return x.new_empty((*x.shape[:3], pw.shape[1]))
