"""Everything a run feeds the program, made from `--seed`.

The same seed gives the same weights, frames, labels and orders.  Weights
and frames are drawn on the run's device from `torch.Generator`s in a few
large calls; the host only computes orders and clip lengths with numpy.
Seeds for the separate streams are derived from the run's seed and a tag,
so that any whole number (also one above 2**31) is a valid seed.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from perfbench.reference import spnet as ref
from perfbench.reference.layers import exact_float32


def derive(seed: int, tag: str) -> int:
    """A 60-bit seed for the stream `tag` of the run seeded `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()
    return int(h[:15], 16)


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def _init_rule(name: str, shape: tuple) -> tuple[float, float]:
    """(offset, half-width) of the uniform draw of one tensor: kernels are
    Keras glorot-uniform with the fans of their flax shapes, BatchNorm
    scales 1 +- 0.1, biases and running means +- 0.1, running variances
    1 +- 0.25 (set again from data by `calibrate_bn`)."""
    if name.endswith(".running_var"):
        return 1.0, 0.25
    if name.endswith((".running_mean", ".bias")):
        return 0.0, 0.1
    if len(shape) == 1:  # a BatchNorm scale
        return 1.0, 0.1
    if len(shape) == 4:  # conv OIHW
        o, i, kh, kw = shape
        fan_in, fan_out = i * kh * kw, o * kh * kw
    elif len(shape) == 3:  # depthwise (k, k, C)
        k, _, c = shape
        fan_in, fan_out = k * k, k * k * c
    elif name.endswith("pointwise.weight"):  # (C, F)
        fan_in, fan_out = shape
    else:  # dense (out, in)
        fan_out, fan_in = shape
    return 0.0, math.sqrt(6.0 / (fan_in + fan_out))


def make_weights(shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device` for every entry of `shapes`
    (name -> shape, the program's state-dict names), from one uniform
    draw."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = device_generator(seed, "weights", device)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        off, half = _init_rule(name, tuple(shape))
        out[name] = (flat[at: at + n].view(shape) * half + off).contiguous()
        at += n
    return out


#: the least running variance `calibrate_bn` sets: glorot's depthwise
#: kernels leave depthwise and separable outputs with batch variances of
#: 1e-4 to 1e-3, under BatchNorm's eps; normalized to 1, the random
#: network grows rounding until bf16 lies as far from float32 as fp8
#: does (PERF.md), and no comparison could tell the two apart
VAR_FLOOR = 0.01


@torch.no_grad()
def calibrate_bn(weights: dict, cfg: dict, frames_u8) -> dict:
    """Set every BatchNorm's running statistics to the float32 batch
    moments of `frames_u8` (as a trained network's would be; the variance
    at least VAR_FLOOR), in place; so that in eval mode every layer, the
    separable convs too, carries its share of the output."""
    stats: dict = {}
    with exact_float32():
        ref.forward(weights, ref.normalize(frames_u8),
                    {**cfg, "dropout_rate": 0.0}, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"].copy_(mean)
        weights[f"{name}.running_var"].copy_(var.clamp_min(VAR_FLOOR))
    return weights


def frames(n: int, size: int, seed: int, tag: str, device):
    """(n, size, size, 1) uint8 frames, uniform in 0..255."""
    gen = device_generator(seed, tag, device)
    return torch.randint(0, 256, (n, size, size, 1), generator=gen,
                         device=device, dtype=torch.uint8)


def labels(n: int, num_outputs: int, seed: int, tag: str, device,
           p_object: float = 0.25):
    """(n, num_outputs) float32 normalized label vectors: every variable
    uniform in [-1, 1], the no-object lane 0 (an object) with probability
    p_object, else 1."""
    gen = device_generator(seed, tag, device)
    y = torch.rand((n, num_outputs), generator=gen, device=device) * 2 - 1
    y = y.view(n, -1, ref.VARS_PER_PRED)
    empty = torch.rand(y.shape[:2], generator=gen, device=device) \
        >= p_object
    y[..., ref.IND_NOOBJ] = empty.float()
    return y.view(n, num_outputs)


def epoch_rows(n: int, batch: int, seed: int, passes: int) -> np.ndarray:
    """(passes * (n // batch), batch) int64 minibatch indices: shuffled
    passes without replacement, pass r shuffled by numpy's default_rng
    seeded derive(seed, f'order{r}'), the remainder dropped (the program's
    `epoch_order`, drawn here)."""
    out = []
    for r in range(passes):
        idx = np.arange(n)
        np.random.default_rng(derive(seed, f"order{r}")).shuffle(idx)
        out.append(idx[: n - n % batch].reshape(-1, batch))
    return np.concatenate(out)
