"""The port's label-preserving augmentation (`spnet_tpu_torch/ops/
augment.py`).  Its random draws come from a torch.Generator, not from
jax.random, so the tests pin the invariants the JAX package's ops hold
rather than bitwise equality: the region count and bounds and the fill
values of cutout, the salt and pepper rates and the share of active
images, and blur at probability 0."""

import numpy as np
import pytest
import torch

from spnet_tpu.ops import augment as jaug
from spnet_tpu_torch.ops import augment as aug
from spnet_tpu_torch.ops.augment import (
    CUTOUT_MAX_REGIONS,
    SALT_AMOUNT,
    SALT_VS_PEPPER,
    augment_on_the_fly,
    cutout,
    random_blur,
    salt_and_pepper,
)


def _images(b, h, w, seed=0):
    """Continuous values, so no pixel repeats another by chance."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, h, w, 1, generator=g) * 1.6 - 0.8


def test_constants_match_jax():
    for name in ("CUTOUT_MAX_REGIONS", "CUTOUT_MIN", "CUTOUT_MAX",
                 "SALT_AMOUNT", "SALT_VS_PEPPER"):
        assert getattr(aug, name) == getattr(jaug, name), name
    for k in (3, 7):
        np.testing.assert_array_equal(aug._gauss1d(k), jaug._gauss1d(k))


def test_cutout_regions_fills_and_bounds():
    """At most 6 regions per image, each one grey level inside the
    image's own [min, max]; the last row and column are never covered
    (the h-1 / w-1 clamp); some images get regions, some get none."""
    x = _images(64, 40, 48)
    out = cutout(x.clone(), torch.Generator().manual_seed(1))
    assert out.shape == x.shape and out.dtype == x.dtype
    changed = out != x
    n_changed = 0
    for i in range(x.shape[0]):
        vals = torch.unique(out[i][changed[i]])
        assert len(vals) <= CUTOUT_MAX_REGIONS
        if len(vals):
            n_changed += 1
            assert vals.min() >= x[i].min() and vals.max() <= x[i].max()
        assert not changed[i, -1].any() and not changed[i, :, -1].any()
    # P(no region) = 1/7 per image
    assert 40 <= n_changed <= 63


def test_salt_and_pepper_rates():
    """On active images a fraction amount*svp of pixels becomes the
    image's max and amount*(1-svp) its min; each image is active with
    probability 0.5.  Bounds: 5 binomial standard deviations."""
    b, h, w = 200, 64, 64
    x = _images(b, h, w, seed=2)
    out = salt_and_pepper(x.clone(), torch.Generator().manual_seed(3))
    changed = (out != x).flatten(1)
    active = changed.any(dim=1)
    n_act = int(active.sum())
    assert abs(n_act - b / 2) <= 5 * np.sqrt(b / 4)
    hi = x.flatten(1).amax(dim=1, keepdim=True)
    lo = x.flatten(1).amin(dim=1, keepdim=True)
    o = out.flatten(1)[active]
    n_px = n_act * h * w
    salt = int((changed[active] & (o == hi[active])).sum())
    pepper = int((changed[active] & (o == lo[active])).sum())
    assert salt + pepper == int(changed.sum())
    for count, p in ((salt, SALT_AMOUNT * SALT_VS_PEPPER),
                     (pepper, SALT_AMOUNT * (1 - SALT_VS_PEPPER))):
        assert abs(count - n_px * p) <= 5 * np.sqrt(n_px * p * (1 - p))


def test_blur_probability_zero_is_identity_and_one_blurs_all():
    x = _images(8, 20, 20, seed=4)
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(random_blur(x, gen, prob=0.0), x)
    out = random_blur(x, gen, prob=1.0)
    assert (out != x).flatten(1).any(dim=1).all()
    # a normalized kernel keeps the interior mean
    assert float((out - x)[:, 4:-4, 4:-4].mean().abs()) < 1e-2


@pytest.mark.parametrize("blur_prob", [0.0, 0.5])
def test_pipeline_keeps_shape_dtype_and_range(blur_prob):
    x = _images(6, 32, 32, seed=6)
    out = augment_on_the_fly(x.clone(), torch.Generator().manual_seed(7),
                             blur_prob=blur_prob)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.isfinite(out).all()
    assert out.min() >= x.min() - 1e-6 and out.max() <= x.max() + 1e-6


def test_same_generator_state_same_draws():
    x = _images(4, 32, 32, seed=8)
    a = augment_on_the_fly(x.clone(), torch.Generator().manual_seed(9))
    b = augment_on_the_fly(x.clone(), torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
