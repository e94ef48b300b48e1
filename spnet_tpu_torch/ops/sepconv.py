"""Fused inference separable convolution: depthwise 3x3 SAME -> pointwise
-> folded BatchNorm -> optional ReLU, NHWC.

Counterpart of `spnet_tpu/ops/sepconv_pallas.py`.  `sepconv_infer` is the
wrapper the model calls: on a CUDA tensor it launches the hand-written
Hopper kernel (`csrc/sepconv.cu`), on a CPU tensor it runs the plain
PyTorch version `sepconv_infer_torch`.  There is no fallback between the
two: a CUDA launch either succeeds or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(gamma, beta, mean, var, eps: float = 1e-3):
    """Inference BatchNorm as y = z * scale + bias."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def sepconv_infer_torch(x, dw, pw, scale, bias, relu: bool = True):
    """Plain twin of `sepconv_infer_jnp`.

    x: (B, H, W, C);  dw: (3, 3, C);  pw: (C, F);  scale/bias: (F,) f32.
    The depthwise runs with dw in x's type, accumulates in f32 and rounds
    to x's type; the pointwise accumulates in f32, as the JAX twin's
    `preferred_element_type=float32` does."""
    c = x.shape[-1]
    k = dw.to(x.dtype).float().permute(2, 0, 1).unsqueeze(1)  # (C,1,3,3)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1, groups=c)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    z = torch.matmul(y.float(), pw.to(x.dtype).float())
    z = z * scale + bias
    if relu:
        z = torch.clamp_min(z, 0.0)
    return z.to(x.dtype)


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


def sepconv_infer(x, dw, pw, scale, bias, relu: bool = True):
    """Fused separable conv; `sepconv_infer.launches` counts kernel
    launches (CPU calls take the plain path and are not counted)."""
    _check(x, dw, pw, scale, bias)
    if x.device.type == "cpu":
        return sepconv_infer_torch(x, dw, pw, scale, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no sepconv kernel for device {x.device}")
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spnet_sepconv_infer(
            x.data_ptr(), dw.data_ptr(), pw.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, h, w, c, f, int(relu),
            _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sepconv kernel launch failed: CUDA error {err}")
    sepconv_infer.launches += 1
    return out


sepconv_infer.launches = 0
