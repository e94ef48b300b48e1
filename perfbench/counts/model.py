"""Operations and bytes of SPNet's layers, counted from their shapes.

The reference forward runs on the `meta` device (shapes only, no data)
with a `Tally` in place of its numerics; every conv, depthwise conv,
matrix product and separable conv reports its shapes, and the counts
follow from them:

  * a conv or depthwise conv: 2 * N * Ho * Wo * Cout * (Cin / groups) * kh
    * kw operations; a matrix product (..., K) @ (K, N): 2 * out * K;
  * a separable conv layer (`SeparableConvBN`): its depthwise and
    pointwise operations, and its least bytes: the input read once and
    the output written once at the activation width, and its parameters
    (depthwise and pointwise kernels, BatchNorm vectors) read once at
    their stored width, float32;
  * Adam's least bytes: every trained parameter, its gradient and both
    moments read once, the parameter and moments written once: 28 bytes a
    float32 parameter.

Elementwise work (BatchNorm, activations, pools) is not counted as
operations: the peaks these counts are held against are those of the
tensor cores.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import spnet as ref
from perfbench.reference.layers import Numerics

ADAM_BYTES_PER_PARAM = 28


class Tally(Numerics):
    """Numerics that records what the forward reports."""

    def __init__(self):
        super().__init__("f32")
        self.ops = 0
        self.sepconvs: list[dict] = []

    def note(self, op: str, **s) -> None:
        if op == "conv":
            o, i, kh, kw = s["weight"]
            self.ops += 2 * math.prod(s["out"]) * i * kh * kw
        elif op == "matmul":
            self.ops += 2 * math.prod(s["out"]) * s["k"]
        elif op == "sepconv":
            self.sepconvs.append(s)


def ref_config(cfg: dict) -> dict:
    """The flat settings the reference reads from a configuration file."""
    return {**cfg["model"], "reference": cfg["reference"]}


def _meta_forward(cfg: dict, shapes: dict, batch: int) -> Tally:
    tally = Tally()
    params = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    size = cfg["model"]["input_size"]
    x = torch.empty((batch, size, size, 1), device="meta")
    ref.forward(params, x, ref_config(cfg), train=False, nm=tally)
    return tally


def forward_flops(cfg: dict, shapes: dict) -> int:
    """Tensor-core operations of one frame's forward pass."""
    return _meta_forward(cfg, shapes, 1).ops


def sepconv_layers(cfg: dict, shapes: dict) -> list[dict]:
    """Each separable conv layer of one frame: 'ops', 'act_bytes' (its
    input and output at the activation width) and 'param_bytes'."""
    act = torch.finfo(getattr(torch, cfg["model"]["compute_dtype"])).bits // 8
    out = []
    for s in _meta_forward(cfg, shapes, 1).sepconvs:
        _, h, w, c = s["x"]
        _, ho, wo, f = s["out"]
        name = s["name"]
        n_params = sum(math.prod(shapes[k]) for k in shapes
                       if k.startswith(name + "."))
        out.append(dict(
            name=name,
            ops=2 * ho * wo * c * 9 + 2 * ho * wo * c * f,
            act_bytes=act * (h * w * c + ho * wo * f),
            param_bytes=4 * n_params))
    return out


def sepconv_least_seconds(layers: list[dict], frames: int, peaks: dict
                          ) -> float:
    """The least time of one call of every separable conv layer on a batch
    that holds `frames` frames of work: per layer the larger of its
    operations over the peak rate and its bytes over the peak bandwidth."""
    return sum(max(frames * l["ops"] / peaks["flops"],
                   (frames * l["act_bytes"] + l["param_bytes"])
                   / peaks["bytes_per_s"]) for l in layers)


def trained_params(shapes: dict) -> int:
    return sum(math.prod(s) for k, s in shapes.items() if ref.is_param(k))


def adam_least_bytes(shapes: dict) -> int:
    return ADAM_BYTES_PER_PARAM * trained_params(shapes)
