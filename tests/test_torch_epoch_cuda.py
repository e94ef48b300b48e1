"""The epoch form's CUDA graph (`train/steps.py::make_train_epoch`) on the
card, against the eager steps.  No jax here, so run this file on the card
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_epoch_cuda.py -q

Elsewhere every case skips."""

import numpy as np
import pytest
import torch

from spnet_tpu_torch.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu_torch.data.dataset import pad_raw_rows
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import WARMUP_STEPS, make_train_epoch, \
    make_train_step

SIZE, B, STEPS, N = 64, 4, 3, 16
TINY = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                   compute_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = det


def _data(geo: bool, device, grid=GridSpec()):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (N, SIZE, SIZE, 1), dtype=np.uint8)
    raws = []
    for _ in range(N):
        k = int(rng.integers(1, 6))
        a = rng.uniform(12, 90, k)
        raws.append(np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                              rng.uniform(grid.cy_min, grid.cy_max, k),
                              a, a * rng.uniform(0.4, 1.0, k),
                              rng.uniform(0, 180, k),
                              rng.uniform(1, 11, k)], axis=1))
    rows, mask = pad_raw_rows(raws)
    y = rng.normal(0, 0.3, (N, grid.num_outputs)).astype(np.float32)
    arrays = (x, y, rows, mask) if geo else (x, y)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [False, True], ids=["plain", "geo"])
def test_graphed_epoch_is_bitwise_the_eager_steps(cuda, geo):
    """MobileNetTiny at 64², b=4, augmentation on, dropout 0.1: two epochs
    of 3 steps through the epoch form (warm-up steps, the capture and
    replays in the first, replays only in the second) and through the
    step once a row, from the same weights and generator seeds: losses,
    weights, BN statistics, Adam moments and counts bitwise equal."""
    data = _data(geo, cuda)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, N, (2 * STEPS, B))).to(cuda)
    got = {}
    for form in ("graph", "eager"):
        model = build_model(TINY, device=cuda,
                            generator=torch.Generator().manual_seed(2))
        state = create_train_state(model, onecycle_schedule(1e-3, 20))
        step = make_train_step(model, LossWeights(), augment=True,
                               geo_augment=geo, grid=GridSpec())
        train_epoch = make_train_epoch(step, geo)
        gen = torch.Generator(device=cuda)
        losses = []
        for e in range(2):
            gen.manual_seed(10 + e)
            rows = idx[e * STEPS:(e + 1) * STEPS]
            if form == "graph":
                losses.append(train_epoch(state, *data, rows, gen)[1])
            else:
                losses.append(torch.stack(
                    [step(state, *data, r, gen)[1]["loss"] for r in rows]))
        if form == "graph":
            assert len(train_epoch.capture_seconds) == 1
        got[form] = (state, torch.cat(losses))
    (a, la), (b, lb) = got["graph"], got["eager"]
    assert STEPS > WARMUP_STEPS
    assert torch.isfinite(la).all() and torch.equal(la, lb)
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for u, v in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(u, v)
    assert torch.equal(a.opt_state.t, b.opt_state.t)
    assert a.step == b.step == a.opt_state.count == 2 * STEPS
