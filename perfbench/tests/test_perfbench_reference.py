"""The frozen reference against the port, on the CPU at 96x96 with the
configurations' full widths, in float32 compute (where both sides should
agree to rounding) and in the configurations' bf16."""

import json

import numpy as np
import pytest
import torch

from conftest import CELLS, ROOT, small
from perfbench import core, inputs
from perfbench.counts.model import ref_config
from perfbench.reference import spnet as ref

CONFIGS = ("xception331", "mobilenet331")


def _config(name, **model):
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["model"].update(model)
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_shapes_are_the_programs(name):
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.models.spnet import build_model

    cfg = _config(name)
    model = build_model(ModelConfig(backbone=cfg["model"]["backbone"]),
                        device="meta")
    prog = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ref.param_shapes(ref_config(cfg)) == prog
    n = sum(int(np.prod(s)) for k, s in prog.items() if ref.is_param(k))
    assert n == cfg["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_port_f32(name, train):
    cfg = _config(name, input_size=96, compute_dtype="float32")
    ctx = core.Ctx(name, cfg, {}, 5, 1.0, False, torch.device("cpu"), 0.0)
    x = inputs.frames(4, 96, 5, "t", "cpu")
    model, w = core.program_model(ctx, x)
    model.train(train)
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    with torch.no_grad():
        yp = model(ref.normalize(x), dropout_generator=g1)
        yr = ref.forward(w, ref.normalize(x), ref_config(cfg), train, g2)
    assert yr.std() > 0.01
    assert torch.allclose(yp, yr, rtol=0, atol=1e-5 * float(yr.abs().max()))


#: float32 rounding: Adam's first, sign-like updates carry a leaf's
#: rounding in its smallest gradients into its change (read up to 1.2e-3
#: at this size); `window_unmoved` is exact
F32_ROUNDING = {"loss_rms_gap": 1e-5, "grad1_median_gap": 1e-4,
                "change_gap": 5e-3, "out1_gap": 1e-4, "pred_gap": 1e-4,
                "window_unmoved": 1e-12}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_follows_reference_f32(cell):
    """A whole small run in float32: the compared numbers are rounding
    (the draws of augmentation and dropout, the order and the Adam update
    follow the reference step for step)."""
    res, checks, _ = core.run_cell(cell, 2 ** 31 + 77, 0.5, False,
                                   torch.device("cpu"), 0.0,
                                   small(cell, compute_dtype="float32"))
    assert res["correct"], res["checks"]
    for name, value, _ in checks:
        assert value < F32_ROUNDING[name], (name, value)
