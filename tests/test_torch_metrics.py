"""Port of the evaluation metrics (`spnet_tpu_torch/ops/raster.py`,
`spnet_tpu_torch/eval/metrics.py`) against the JAX package on seeded
records and predictions."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import GridSpec, IND_NOOBJ, VARS_PER_PRED
from spnet_tpu.eval import metrics as jmetrics
from spnet_tpu.grid import angle_deg_to_cs2, denormalize
from spnet_tpu.ops import raster as jraster
from spnet_tpu_torch.eval import metrics as tmetrics
from spnet_tpu_torch.ops import raster as traster

torch.set_num_threads(2)

OUR_GOLDEN_IOU = 0.4380082258013877  # tests/test_metrics.py
AA_GOLDEN_IOU = 0.442308  # ops/raster.py docstring (aa mode)


def _records(rng, n, absent=0.2):
    a = rng.uniform(8, 120, n)
    b = a * rng.uniform(0.3, 1.0, n)
    c, s = angle_deg_to_cs2(rng.uniform(0, 180, n))
    return np.stack([rng.uniform(40, 470, n), rng.uniform(40, 350, n), a, b,
                     c, s, (rng.uniform(size=n) < absent).astype(float),
                     rng.uniform(0, 12, n)], axis=1).astype(np.float32)


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    t = _records(rng, n)
    p = _records(rng, n)
    p[:, :4] = t[:, :4] + rng.normal(0, 4, (n, 4)).astype(np.float32)
    return p, t


@pytest.mark.parametrize("pad", [traster.BOUNDARY_PAD,
                                 traster.BOUNDARY_PAD_AA])
def test_row_intervals_exactly_match_jax(pad):
    """Same float32 inputs -> the same covered interval on every row:
    the quadratic is solved in float32 in the same order as JAX."""
    _, t = _pairs(11, 200)
    theta = (-np.arctan2(t[:, 5], t[:, 4]) / 2).astype(np.float32)
    cols = [t[:, 0], t[:, 1], t[:, 2], t[:, 3], theta]
    lo_j, hi_j = jax.jit(jax.vmap(
        lambda *z: jraster._row_intervals(*z, 384, 512, pad)))(*cols)
    lo, hi = traster._row_intervals(*map(torch.from_numpy, cols), 384, 512,
                                    pad)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize("aa", [False, True])
def test_pair_iou_matches_jax(aa):
    """IoUs of 500 seeded pairs.  XLA's and torch's float32 cos/sin/atan2
    differ by an ulp on a few percent of inputs (measured), which moves a
    row end across a pixel boundary for ~1 pair in 2000: allow 1 % of
    the pairs to differ, by at most 1e-3 (a pixel or two of thousands)."""
    p, t = _pairs(5, 500)
    ref = np.asarray(jraster.pair_iou_jit(p, t, aa=aa))
    out = traster.pair_iou(p, t, aa=aa).numpy()
    assert out.dtype == np.float32
    assert np.array_equal(out < 0, ref < 0)  # the -1 sentinels
    assert (out != ref).mean() <= 0.01
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_golden_pair():
    def rec(cx, cy, a, b, angle_deg, noobj, rings):
        c, s = angle_deg_to_cs2(angle_deg)
        return np.array([[cx, cy, a, b, c, s, noobj, rings]], np.float32)

    r_t = rec(100, 140, 120, 60, 90, 0, 10.3)
    r_p = rec(120, 123, 120, 60, 149.97, 0, 7.8)
    assert float(traster.pair_iou(r_p, r_t)[0]) == pytest.approx(
        OUR_GOLDEN_IOU, abs=1e-6)
    assert float(traster.pair_iou(r_p, r_t, aa=True)[0]) == pytest.approx(
        AA_GOLDEN_IOU, abs=1e-5)


def _predictions(seed, n=40):
    """Seeded normalized (N, 576) truths and noisy predictions."""
    grid = GridSpec()
    rng = np.random.default_rng(seed)
    yt = np.tile(((grid.defaults.reshape(-1) - grid.means) / grid.ranges),
                 (n, 1)).astype(np.float32)
    slots = yt.reshape(n, -1, VARS_PER_PRED)
    present = rng.uniform(size=slots.shape[:2]) < 0.1
    slots[present, :6] = rng.normal(0, 0.25, (present.sum(), 6))
    slots[present, IND_NOOBJ] = 0.0
    slots[present, 7] = rng.uniform(-0.4, 0.6, present.sum())
    yp = yt + rng.normal(0, 0.05, yt.shape).astype(np.float32)
    flip = rng.uniform(size=slots.shape[:2]) < 0.05
    yp.reshape(n, -1, VARS_PER_PRED)[flip, IND_NOOBJ] = \
        1.0 - slots[flip, IND_NOOBJ]
    return denormalize(yp, grid), denormalize(yt, grid), grid


def test_calc_errors_matches_jax():
    yp, yt, _ = _predictions(2)
    ref = jmetrics.calc_errors(yp, yt)
    out = tmetrics.calc_errors(yp, yt)
    for field in dataclasses.fields(ref):
        a, b = getattr(out, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, field.name
    assert (out.class_acc, out.ring_acc, out.mean_pix_err) == \
        (ref.class_acc, ref.ring_acc, ref.mean_pix_err)


def test_class_acc_may_go_negative_like_the_reference():
    """False positives over all 72 slots count against total_obj (reference
    `callbacks.py:166`); the port keeps that, it does not clip."""
    yp, yt, grid = _predictions(3, n=4)
    yp = yp.reshape(4, -1, VARS_PER_PRED)
    yp[..., IND_NOOBJ] = 0.0  # every slot claims an object
    st = tmetrics.calc_errors(yp.reshape(4, -1), yt)
    assert st.class_acc < 0
    assert st.class_acc == jmetrics.calc_errors(yp.reshape(4, -1),
                                                yt).class_acc


def test_slot_ious_and_calc_map_match_jax():
    yp, yt, grid = _predictions(4)
    ious, fn = tmetrics.slot_ious(yp, yt, grid)
    ious_j, fn_j = jmetrics.slot_ious(yp, yt, grid)
    np.testing.assert_array_equal(fn, fn_j)
    np.testing.assert_allclose(ious, ious_j, rtol=0, atol=1e-3)
    assert tmetrics.calc_map(yp, yt, grid) == jmetrics.calc_map(yp, yt, grid)
    for th in tmetrics.MAP_THRESHOLDS:
        assert tmetrics.precision_from_ious(ious, fn, th) == \
            jmetrics.precision_from_ious(ious_j, fn_j, th)
