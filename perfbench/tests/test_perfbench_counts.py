"""The counters of `perfbench/counts/` against torch's own flop counter
on the program's plain forward at 331x331."""

import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from perfbench.counts import model as counts
from perfbench.reference import spnet as ref

#: GFLOP a frame that torch's counter gives on this forward
EXPECTED = {"xception331": (4.76, 34), "mobilenet331": (0.753, 13)}


def _cfg(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_forward_flops_match_torch_counter(name):
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.models.spnet import build_model

    cfg = _cfg(name)
    shapes = ref.param_shapes(counts.ref_config(cfg))
    ours = counts.forward_flops(cfg, shapes)
    model = build_model(ModelConfig(backbone=cfg["model"]["backbone"],
                                    compute_dtype="float32"),
                        device="cpu", plain_kernels=True)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.zeros(1, 331, 331, 1))
    theirs = fc.get_total_flops()
    assert abs(ours - theirs) <= 0.01 * theirs
    gflop, n_sep = EXPECTED[name]
    assert ours / 1e9 == pytest.approx(gflop, rel=0.01)
    assert len(counts.sepconv_layers(cfg, shapes)) == n_sep


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_layer_and_adam_counts(name):
    cfg = _cfg(name)
    shapes = ref.param_shapes(counts.ref_config(cfg))
    assert counts.adam_least_bytes(shapes) == 28 * cfg["parameters"]
    layers = counts.sepconv_layers(cfg, shapes)
    # a layer's operations: 9 MACs a depthwise output and C a pointwise one
    first = layers[0]
    assert first["ops"] > 0 and first["act_bytes"] > 0
    peaks = {"flops": 989e12, "bytes_per_s": 3.35e12}
    one = counts.sepconv_least_seconds(layers, 1, peaks)
    sixteen = counts.sepconv_least_seconds(layers, 16, peaks)
    assert one < sixteen < 16 * one
    assert math.isclose(
        sum(l["param_bytes"] for l in layers) / 4,
        sum(math.prod(s) for k, s in shapes.items()
            if any(k.startswith(l["name"] + ".") for l in layers)))
