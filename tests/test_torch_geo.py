"""The port's on-device label encoder and geometric augmentation against
the JAX package's and the host codec on the CPU: the encoder bitwise on
the same rows (its sort, cell index and overflow drop each pinned), the
cases of `tests/test_grid_device.py` ported (identity exact, native
translate exact, flip label math, rings inside the remapped ellipse,
resized conjugation, transform-then-encode), the warp on hand-built
parameters against JAX's within a stated tolerance, the parameter
distributions, and one geometric train step against JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_erosion

from spnet_tpu.config import GridSpec as JGridSpec
from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.ops import augment as jaug
from spnet_tpu.ops.grid_encode import encode_batch_device as j_encode
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import kernel_l2 as j_kernel_l2
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.data.synth import _render_antinode
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops import augment
from spnet_tpu_torch.ops.grid_encode import encode_batch_device
from spnet_tpu_torch.ops.resize import resize
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train import steps as t_steps
from spnet_tpu_torch.train.steps import _prep_x, forward_loss, \
    make_train_epoch, make_train_step
from test_torch_train import PARAM_GROUPS, _param_group, _perturb, _rel_close

torch.set_num_threads(2)
GRID = GridSpec()
#: the warp against JAX's on hand-built parameters, float32: the sample
#: coordinates differ by rounding (XLA may contract a * x + b), which moves
#: a bilinear sample by |gradient| x |coordinate error| (measured 4.6e-5 on
#: N(0, 1) frames); the remapped rows, hundreds of pixels, within 1e-4
WARP_ATOL = 2e-4
ROWS_ATOL = 1e-4
#: the encoder's angle lanes: JAX takes cos / sin of a float32 angle, the
#: host codec (and the port) of a float64 one (measured 1.02e-6)
ANGLE_LANE_ATOL = 2e-6
#: ... and the port's float64 cos / sin are torch's, the host codec's
#: numpy's: rounded to float32 they are bitwise the same but for a rare
#: value one float32 ulp apart (53 of ~8,000 in one run of the suite under
#: 6 workers, none in the others); one ulp of a normalized angle lane
#: (cos 2t / 2 in [-0.5, 0.5]) is at most 2**-25
HOST_ANGLE_ULP = 2.0 ** -25


def _random_rows(rng, b, n=12):
    """Padded rows with invalid slots, rings <= 0, b > a swaps and centers
    outside the active region (as `tests/test_grid_device.py`)."""
    rows = np.zeros((b, n, 6), np.float32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        for j in range(rng.integers(0, 9)):
            rows[i, j] = [rng.uniform(-20, 540), rng.uniform(-20, 400),
                          rng.uniform(15, 120), rng.uniform(10, 80),
                          rng.uniform(0, 180), rng.integers(-1, 11)]
            mask[i, j] = True
    return rows, mask


def _host_encode(rows, mask, grid=GRID):
    recs = [canonicalize_records(rows[i][mask[i]])
            for i in range(rows.shape[0])]
    return normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                     grid).astype(np.float32)


def _encode(rows, mask, **kw):
    return encode_batch_device(torch.from_numpy(rows),
                               torch.from_numpy(mask), GRID, **kw).numpy()


def _angle_lanes(width):
    lanes = np.arange(width) % 8
    return (lanes == 4) | (lanes == 5)


def _assert_host_equal(got, want):
    """Bitwise the host codec on every slot lane (centres, axes, noobj,
    rings, the defaults of empty slots); the two angle lanes within one
    float32 ulp (HOST_ANGLE_ULP)."""
    angle = _angle_lanes(got.shape[-1])
    bad = np.nonzero(got[..., ~angle] != want[..., ~angle])
    assert not bad[0].size, (bad, got[..., ~angle][bad])
    np.testing.assert_allclose(got[..., angle], want[..., angle], rtol=0,
                               atol=HOST_ANGLE_ULP)


def test_encode_batch_device_bitwise():
    """512 images of random padded rows against the host codec
    (canonicalize -> ellipses_to_grid(drop) -> normalize): bitwise on the
    slot lanes, the angle lanes within a float32 ulp (`_assert_host_equal`);
    un-normalized, bitwise JAX's `encode_batch_device` on every lane but
    the two angle lanes, those within ANGLE_LANE_ATOL (JAX's own distance
    from the host codec is the same)."""
    rng = np.random.default_rng(7)
    rows, mask = _random_rows(rng, 512)
    _assert_host_equal(_encode(rows, mask), _host_encode(rows, mask))
    raw = _encode(rows, mask, normalized=False)
    jraw = np.asarray(jax.jit(lambda r, m: j_encode(
        r, m, JGridSpec(), normalized=False))(rows, mask))
    angle = _angle_lanes(raw.shape[1])
    np.testing.assert_array_equal(raw[:, ~angle], jraw[:, ~angle])
    np.testing.assert_allclose(raw[:, angle], jraw[:, angle], rtol=0,
                               atol=ANGLE_LANE_ATOL)


def test_encode_overflow_drops_to_a_scratch_row():
    """Three ellipses in one cell with 2 slots (out of sorted order): the
    first two in (cx, cy) order fill the slots, the third is dropped (it
    goes to a scratch row past the grid, which an out-of-range index
    would not allow); equal to the host codec and to JAX."""
    rows = np.zeros((1, 12, 6), np.float32)
    mask = np.zeros((1, 12), bool)
    rows[0, :3] = [[100, 60, 30, 20, 10, 3], [90, 55, 25, 15, 40, 2],
                   [95, 50, 28, 18, 70, 5]]
    mask[0, :3] = True
    got = _encode(rows, mask)
    _assert_host_equal(got, _host_encode(rows, mask))
    np.testing.assert_allclose(got, np.asarray(j_encode(rows, mask,
                                                        JGridSpec())),
                               rtol=0, atol=ANGLE_LANE_ATOL)
    flat = _encode(rows, mask, normalized=False).reshape(GRID.pred_shape)
    assert flat[0, 0, 0, 0] == 90 and flat[0, 0, 1, 0] == 95
    assert not np.isin(100.0, flat[..., 0])


def test_encode_sort_is_a_stable_lexsort():
    """`jnp.lexsort((cy, cx))` sorts by cx, then cy, stably, with invalid
    rows (key 1e9) last: rows tied on cx and on (cx, cy), interleaved with
    invalid and rings <= 0 slots, fill their cells' slots in the host
    codec's order."""
    rows = np.zeros((2, 8, 6), np.float32)
    mask = np.zeros((2, 8), bool)
    rows[0, :6] = [[300, 200, 40, 20, 30, 4], [60, 300, 40, 20, 50, 2],
                   [300, 100, 30, 20, 10, 3], [60, 290, 40, 20, 70, 5],
                   [300, 150, 50, 20, 20, 0], [60, 290, 41, 20, 80, 6]]
    mask[0, [0, 1, 2, 3, 4, 5]] = True
    rows[1] = rows[0][::-1]
    mask[1] = mask[0][::-1]
    mask[1, 0] = False  # an invalid slot between valid ones
    _assert_host_equal(_encode(rows, mask), _host_encode(rows, mask))
    flat = _encode(rows, mask, normalized=False).reshape(
        (2,) + GRID.pred_shape)
    # (60, 290) twice in cell (0, 4): the tie keeps slot order stable
    assert flat[0, 0, 4, 0, 2] == 40 and flat[0, 0, 4, 1, 2] == 41
    assert flat[1, 0, 4, 0, 2] == 41 and flat[1, 0, 4, 1, 2] == 40


def test_encode_cell_index_floors_then_clips():
    """Centers left of / above the active region and past its far edge
    land in the border cells (floor, cast, clip), as in the host codec."""
    rows = np.array([[[-5.5, -30.0, 40, 20, 0, 2], [39.9, 39.9, 40, 20, 0, 3],
                      [700.0, 500.0, 40, 20, 0, 4],
                      [111.0, 97.0, 40, 20, 0, 5]]], np.float32)
    mask = np.ones((1, 4), bool)
    _assert_host_equal(_encode(rows, mask), _host_encode(rows, mask))
    flat = _encode(rows, mask, normalized=False).reshape(GRID.pred_shape)
    assert flat[0, 0, 0, 7] == 2 and flat[0, 0, 1, 7] == 3
    assert flat[5, 5, 0, 7] == 4
    assert flat[1, 1, 0, 7] == 5  # (111 - 40) / 71 = 1.0, (97 - 40) / 51


def _params(mode, theta=None, tx=None, ty=None):
    b = len(mode)
    z = np.zeros(b, np.float32)
    return {"mode": torch.tensor(mode, dtype=torch.int32),
            "theta": torch.tensor(z if theta is None else theta,
                                  dtype=torch.float32),
            "tx": torch.tensor(z if tx is None else tx, dtype=torch.float32),
            "ty": torch.tensor(z if ty is None else ty, dtype=torch.float32)}


def test_geo_identity_is_exact():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 331, 331, 1)).astype(np.float32))
    rows = rng.uniform(10, 300, (4, 5, 6)).astype(np.float32)
    rows[..., 4] = rng.uniform(0, 180, (4, 5))
    rows = torch.from_numpy(rows)
    xo, ro = augment.apply_geo_batch(x, rows, torch.ones(4, 5, dtype=bool),
                                     _params([0] * 4))
    assert torch.equal(xo, x) and torch.equal(ro, rows)


def test_geo_translate_native_exact():
    """Integer translation at native resolution is an exact pixel shift,
    and labels move by exactly (tx, ty)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 384, 512, 1)).astype(np.float32)
    rows = np.zeros((2, 3, 6), np.float32)
    rows[:, 0] = [250, 190, 80, 40, 30, 4]
    mask = np.zeros((2, 3), bool)
    mask[:, 0] = True
    xo, ro = augment.apply_geo_batch(
        torch.from_numpy(x), torch.from_numpy(rows), torch.from_numpy(mask),
        _params([0, 0], tx=[20.0, 20.0], ty=[-10.0, -10.0]), fill=0.0)
    expected = np.zeros_like(x)
    expected[:, :384 - 10, 20:] = x[:, 10:, :512 - 20]
    np.testing.assert_array_equal(xo.numpy(), expected)
    assert tuple(ro[0, 0, :2].tolist()) == (270.0, 180.0)
    np.testing.assert_array_equal(ro[:, 1:].numpy(), rows[:, 1:])


def test_geo_flip_matches_reference_label_math():
    """v: cy -> H - cy, ang -> -ang; h: cx -> W - cx, ang -> 180 - ang;
    both: both coords, ang unchanged mod 180 (reference `flip_image`);
    and the single-image `flip_image_and_labels` the same way."""
    rows = np.zeros((3, 1, 6), np.float32)
    rows[:, 0] = [250, 190, 80, 40, 30, 4]
    _, ro = augment.apply_geo_batch(
        torch.zeros(3, 384, 512, 1), torch.from_numpy(rows),
        torch.ones(3, 1, dtype=bool), _params([1, 2, 3]), fill=0.0)
    ro = ro.numpy()
    assert tuple(ro[0, 0, :2]) == (250.0, 384.0 - 190.0)
    assert ro[0, 0, 4] == 150.0
    assert tuple(ro[1, 0, :2]) == (512.0 - 250.0, 190.0)
    assert ro[1, 0, 4] == 150.0
    assert tuple(ro[2, 0, :2]) == (512.0 - 250.0, 384.0 - 190.0)
    assert ro[2, 0, 4] % 180.0 == 30.0
    img = np.arange(384 * 512, dtype=np.float32).reshape(384, 512, 1)
    for flip_mode in (0, 1, -1, -2):
        got_i, got_r = augment.flip_image_and_labels(
            torch.from_numpy(img), torch.from_numpy(rows[0]),
            torch.ones(1, dtype=bool), flip_mode)
        want_i, want_r = jaug.flip_image_and_labels(
            img, rows[0], np.ones(1, bool), flip_mode)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def test_cleanup_angle_keeps_the_divisors_sign():
    """`jnp.mod` keeps the sign of the divisor: negative angles wrap into
    [0, 180) (`torch.fmod` would leave them negative)."""
    ang = np.array([-360.5, -180.0, -30.0, -0.5, 0.0, 179.5, 180.0, 400.0],
                   np.float32)
    got = augment._cleanup_angle(torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaug._cleanup_angle(ang)))
    assert (got >= 0).all() and (got < 180).all()


def test_rotate_and_translate_one_image_match_jax():
    """`rotate_image_and_labels` (centers rounded half to even: x.5
    centers under a 0-degree rotation) and `translate_image_and_labels`
    against JAX's, image and rows."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(48, 64, 1)).astype(np.float32)
    rows = np.array([[10.5, 11.5, 9, 5, 30, 2], [20.2, 7.7, 9, 5, 170, 3],
                     [3.0, 4.0, 9, 5, 10, 1]], np.float32)
    mask = np.array([True, True, False])
    t_args = (torch.from_numpy(img), torch.from_numpy(rows),
              torch.from_numpy(mask))
    for angle in (0.0, 13.0, -27.5):
        gi, gr = augment.rotate_image_and_labels(*t_args, angle)
        wi, wr = jaug.rotate_image_and_labels(img, rows, mask, angle)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0,
                                   atol=WARP_ATOL)
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
        if angle == 0.0:
            assert tuple(gr[0, :2].tolist()) == (10.0, 12.0)
    gi, gr = augment.translate_image_and_labels(*t_args, 5.0, -7.0)
    wi, wr = jaug.translate_image_and_labels(img, rows, mask, 5.0, -7.0)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


def test_apply_geo_batch_matches_jax():
    """Hand-built flip x rotation x translation on 64 x 80 frames standing
    for resized ones (the warp conjugated by 512/80 and 384/64), the rows
    in native coordinates: images within WARP_ATOL, rows within ROWS_ATOL
    of JAX's, padding rows untouched."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64, 80, 1)).astype(np.float32)
    rows = rng.uniform(10, 300, (8, 5, 6)).astype(np.float32)
    rows[..., 4] = rng.uniform(0, 180, (8, 5))
    mask = rng.random((8, 5)) < 0.7
    params = {"mode": np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32),
              "theta": np.array([0, 17, -19.9, 5.5, -3, 0, 12, -8],
                                np.float32),
              "tx": np.array([0, 12, -40, 3, 37, 0, -5, 21], np.float32),
              "ty": np.array([0, -7, 22, 40, -13, 9, 0, -30], np.float32)}
    want_x, want_r = jax.jit(jaug.apply_geo_batch)(x, rows, mask, params)
    got_x, got_r = augment.apply_geo_batch(
        torch.from_numpy(x), torch.from_numpy(rows), torch.from_numpy(mask),
        {k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=WARP_ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=0,
                               atol=ROWS_ATOL)
    np.testing.assert_array_equal(got_r.numpy()[~mask], rows[~mask])
    assert (got_x.numpy() == -1.0).any()  # the fill of the border


def test_geo_warp_keeps_rings_inside_transformed_ellipse():
    """Render one antinode's rings with the port's renderer, warp image
    and labels with mixed flip + rotate + translate: the warped ring
    pixels lie inside the remapped label ellipse (a sign or convention
    mismatch between the image affine and the label remap fails this)."""
    ys = torch.arange(384.0)[:, None].expand(384, 512)
    xs = torch.arange(512.0)[None, :].expand(384, 512)
    cx, cy, a, b, ang, rings = 260.0, 180.0, 90.0, 45.0, 35.0, 4.0
    t = torch.tensor
    on, _ = _render_antinode(xs, ys, t(1.0), t(cx), t(cy), t(a), t(b),
                             t(ang), t(rings), t(0.0))
    img = on.float()[None, :, :, None]
    rows = torch.zeros(1, 2, 6)
    rows[0, 0] = t([cx, cy, a, b, ang, rings])
    mask = t([[True, False]])
    yy, xx = np.mgrid[0:384, 0:512].astype(np.float64)
    for mode, theta, tx, ty in [(0, 25.0, 30.0, -20.0),
                                (2, -18.0, -25.0, 15.0),
                                (3, 12.0, 0.0, 0.0), (1, -9.0, 10.0, 35.0)]:
        xo, ro = augment.apply_geo_batch(img, rows, mask,
                                         _params([mode], [theta], [tx], [ty]),
                                         fill=0.0)
        ncx, ncy, na, nb, nang, _ = ro[0, 0].tolist()
        th = -np.deg2rad(nang)
        u = (xx - ncx) * np.cos(th) + (yy - ncy) * np.sin(th)
        v = -(xx - ncx) * np.sin(th) + (yy - ncy) * np.cos(th)
        inside = ((u / (na * 1.05 + 3)) ** 2 + (v / (nb * 1.05 + 3)) ** 2
                  <= 1.0)
        warped = xo[0, :, :, 0].numpy() > 0.5
        assert warped.sum() > 200
        frac = (warped & inside).sum() / warped.sum()
        assert frac > 0.99, (mode, theta, tx, ty, frac)


def test_geo_resized_conjugation_consistent():
    """Warping the RESIZED frame with the conjugated affine agrees with
    warping at native resolution then resizing (smooth image; compared
    where both pipelines are clearly in bounds, within 0.02)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, 384), np.linspace(0, 1, 512),
                         indexing="ij")
    smooth = (np.sin(3 * xx + 1) * np.cos(2 * yy) + 0.2 * xx).astype(
        np.float32)
    native = torch.from_numpy(smooth)[None, :, :, None]

    def down(img):  # (1, H, W, 1) -> (1, 331, 331, 1), linear
        return resize(img[..., 0], (331, 331), "linear")[..., None]

    rows, mask = torch.zeros(1, 1, 6), torch.zeros(1, 1, dtype=bool)
    params = _params([2], [17.0], [24.0], [-13.0])

    def warp(img):
        return augment.apply_geo_batch(img, rows, mask, params, fill=0.0)[0]

    resized = down(native)
    d = (warp(resized) - down(warp(native))).abs()[0, :, :, 0].numpy()
    valid = ((warp(torch.ones_like(resized)) > 0.999)
             & (down(warp(torch.ones_like(native))) > 0.999))[0, :, :, 0]
    valid = binary_erosion(valid.numpy(), iterations=3)
    assert valid.sum() > 50_000
    assert d[valid].max() < 0.02, d[valid].max()


def test_geo_transform_then_encode_on_resized_frames():
    """The train step's label path on 64 x 64 frames: the rows are
    remapped in NATIVE 512 x 384 coordinates (a pure translation moves
    them by (tx, ty) native pixels, not by resized ones), and encoding
    the transformed rows on the device equals host-encoding them."""
    rng = np.random.default_rng(3)
    rows, mask = _random_rows(rng, 16)
    x = torch.from_numpy(rng.normal(size=(16, 64, 64, 1)).astype(np.float32))
    params = augment.sample_geo_params(torch.Generator().manual_seed(42), 16)
    _, ro = augment.apply_geo_batch(x, torch.from_numpy(rows),
                                    torch.from_numpy(mask), params,
                                    GRID.img_width, GRID.img_height)
    y_dev = encode_batch_device(ro, torch.from_numpy(mask), GRID).numpy()
    _assert_host_equal(y_dev, _host_encode(ro.numpy(), mask))
    _, moved = augment.apply_geo_batch(
        x[:1], torch.from_numpy(rows[:1]), torch.from_numpy(mask[:1]),
        _params([0], tx=[16.0], ty=[-8.0]))
    m = mask[0]
    np.testing.assert_array_equal(moved[0, m, 0].numpy(), rows[0, m, 0] + 16)
    np.testing.assert_array_equal(moved[0, m, 1].numpy(), rows[0, m, 1] - 8)


def test_sample_geo_params_distributions():
    """20,000 draws: the four flip modes each ~1/4, theta uniform on
    [-20, 20), integer translations in [-40, 40] applied to ~90 %; the
    draw is a function of the generator's state; flip_prob=0.5 leaves
    half the images unflipped and spreads the rest over modes 1..3 by the
    truncated u * 3 / flip_prob."""
    p = augment.sample_geo_params(torch.Generator().manual_seed(0), 20_000)
    counts = np.bincount(p["mode"].numpy(), minlength=4) / 20_000
    np.testing.assert_allclose(counts, 0.25, atol=0.015)
    th = p["theta"].numpy()
    assert th.min() >= -20.0 and th.max() < 20.0
    assert abs(th.mean()) < 0.3 and abs(th.std() - 40 / 12 ** 0.5) < 0.2
    for k in ("tx", "ty"):
        v = p[k].numpy()
        assert (v == np.round(v)).all() and np.abs(v).max() <= 40.0
    moved = (p["tx"] != 0) | (p["ty"] != 0)
    assert abs(moved.float().mean().item() - 0.9) < 0.01
    again = augment.sample_geo_params(torch.Generator().manual_seed(0),
                                      20_000)
    assert all(torch.equal(p[k], again[k]) for k in p)
    half = augment.sample_geo_params(torch.Generator().manual_seed(1),
                                     20_000, flip_prob=0.5)
    counts = np.bincount(half["mode"].numpy(), minlength=4) / 20_000
    np.testing.assert_allclose(counts, [0.5, 1 / 6, 1 / 6, 1 / 6], atol=0.015)


# ---------------------------------------------------------------------------
# One geometric train step against JAX's
# ---------------------------------------------------------------------------
SIZE = 64
CFG = ModelConfig(input_size=SIZE, compute_dtype="float32", dropout_rate=0.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_geo_train_step_matches_jax(monkeypatch):
    """One resident-feed step with geo_augment on, augmentation off,
    dropout 0, Xception at full width on 64^2 frames: JAX's step draws its
    transform from `fold_in(rng, 0)` split in 3 (`steps.py:200`, the
    second key); the test draws the same parameters and hands them to the
    port's `sample_geo_params`.  The loss within rel 1e-4 of JAX's step
    (the three-step test's tolerance); the data loss within rel 1e-5 and
    the head-weight gradient within 1e-4 of its max (the loss-and-gradient
    test's) against JAX's loss of the same augmented batch; the encoded
    labels bitwise the host codec's of the remapped rows."""
    rng = np.random.default_rng(0)
    b = 4
    jm = jbuild(JModelConfig(**dataclasses.asdict(CFG)))
    x_all = rng.integers(0, 256, (8, SIZE, SIZE, 1), dtype=np.uint8)
    rows_all, mask_all = _random_rows(rng, 8)
    rows_all[..., 5] = np.abs(rows_all[..., 5]) + 1  # every row valid
    y_all = _host_encode(rows_all, mask_all)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), x_all[:1].astype(np.float32))
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    idx = np.array([[1, 6, 2, 5]], np.int32)
    rng_key = jax.random.key(1)
    _, geo_key, _ = jax.random.split(jax.random.fold_in(rng_key, 0), 3)
    jparams = jaug.sample_geo_params(geo_key, b)
    grid = JGridSpec()

    # JAX: the step, and the loss and gradient of its augmented batch
    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((b, SIZE, SIZE, 1)),
                             j_schedule(1e-3, 100), adam_variant="optax")
    j_state = j_state.replace(params=params, batch_stats=stats)
    j_step = j_make_train_step(jm, JLossWeights(), "same", l2_reg=1e-4,
                               augment=False, indexed="epoch",
                               pregather=False, geo_augment=True, grid=grid)
    _, j_losses = j_step(j_state, x_all, y_all, rows_all, mask_all, idx,
                         rng_key)
    xb = ((x_all[idx[0]].astype(np.float32) / 255.0) - 0.5) * 2.0
    jx, jrows = jaug.apply_geo_batch(xb, rows_all[idx[0]], mask_all[idx[0]],
                                     jparams, grid.img_width, grid.img_height)
    jy = j_encode(jrows, mask_all[idx[0]], grid)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, jx,
                          train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.key(2)})
        data = j_components(jy, out, JLossWeights(), "same")["total"]
        return data + 1e-4 * j_kernel_l2(p, "reference"), data

    (_, j_data), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    # the port, its sample_geo_params handing over JAX's draw
    drawn = []

    def jax_params(generator, n, *args):
        assert n == b
        drawn.append(n)
        return {k: torch.from_numpy(np.array(v)) for k, v in
                jparams.items()}

    monkeypatch.setattr(augment, "sample_geo_params", jax_params)
    model = build_model(CFG, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    gen = torch.Generator().manual_seed(0)
    ti = torch.from_numpy(idx[0]).long()
    xt, rt = augment.geo_augment_batch(
        _prep_x(torch.from_numpy(x_all)[ti]), torch.from_numpy(rows_all)[ti],
        torch.from_numpy(mask_all)[ti], gen)
    yt = encode_batch_device(rt, torch.from_numpy(mask_all)[ti], GRID)
    _assert_host_equal(yt.numpy(), _host_encode(rt.numpy(),
                                                mask_all[idx[0]]))
    model.train()
    names = [n for n, _ in model.named_parameters()]
    loss, data = forward_loss(model, xt, yt, None, LossWeights(), "same",
                              1e-4, "reference")
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    assert float(data.detach()) == pytest.approx(float(j_data), rel=1e-5)
    want = flax_tree_to_torch(_np_tree(j_grads), model)
    gw, ww = grads["final_output.weight"].numpy(), \
        want["final_output.weight"].numpy()
    assert np.abs(gw - ww).max() <= 1e-4 * np.abs(ww).max()

    model.load_state_dict(flax_to_state_dict(params, stats, model))
    state = create_train_state(model, onecycle_schedule(1e-3, 100),
                               adam_variant="optax")
    step = make_train_step(model, LossWeights(), "same", l2_reg=1e-4,
                           augment=False, geo_augment=True, grid=GRID)
    state, metrics = step(state, torch.from_numpy(x_all),
                          torch.from_numpy(y_all), torch.from_numpy(rows_all),
                          torch.from_numpy(mask_all), ti, gen)
    assert len(drawn) == 2 and state.step == 1
    assert float(metrics["loss"]) == pytest.approx(float(j_losses[0]),
                                                   rel=1e-4)
    with pytest.raises(ValueError, match="GridSpec"):
        make_train_step(model, geo_augment=True)


#: the geometric epoch against JAX's: the warped frames differ by float32
#: rounding (WARP_ATOL; measured 4.6e-5), which six Adam steps amplify in
#: the BN statistics and the group-pooled weight deviations past the plain
#: epoch's bounds (measured: the exit flow's shortcut BN mean 1.3e-3 of its
#: scale, the BN group's 99th percentile 0.104 of sum(lr)).  The port
#: against itself with N(0, WARP_NOISE) added to its warped frames parts
#: by as much (1.7e-3, 0.121), so those two are held to GEO_NOISE_FACTOR
#: times the port's own spread under that noise.
WARP_NOISE = 1e-5
GEO_NOISE_FACTOR = 2.0


def _deviations(got: dict, want: dict, model, sum_lr: float):
    """(the largest BN statistic error of its leaf's scale, {group: (median,
    99th percentile)} of the weights' |got - want| / sum_lr), after
    asserting the per-leaf weight bounds of `test_train_epoch_matches_jax`:
    every weight within 2 * sum(lr), each leaf's median within 0.05 and
    99th percentile within 0.5 of it."""
    stat_err, devs = 0.0, {}
    for k, v in got.items():
        g, w = v.numpy(), want[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, np.abs(g - w).max() / np.abs(w).max())
            continue
        dev = np.abs(g - w).ravel() / sum_lr
        assert dev.max() <= 2.0, (k, dev.max())
        med, q99 = np.median(dev), np.quantile(dev, 0.99)
        assert med <= 0.05 and q99 <= 0.5, (k, med, q99)
        devs.setdefault(_param_group(model, k), []).append(dev)
        devs.setdefault("all", []).append(dev)
    assert set(devs) == {"all", *PARAM_GROUPS}
    return stat_err, {grp: (np.median(np.concatenate(d)),
                            np.quantile(np.concatenate(d), 0.99))
                      for grp, d in devs.items()}


def test_geo_epoch_matches_jax(monkeypatch):
    """Two epochs of 3 steps of the port's `make_train_epoch(step,
    geo_augment=True)` against JAX's `train_epoch_geo` (`steps.py:378`),
    augmentation off, dropout 0, Xception at full width on 64^2 frames,
    perturbed BN, optax Adam under the 1-cycle schedule.  JAX draws step
    i of an epoch from `fold_in(epoch_rng, i)` split in 3 (the second
    key); the test hands the same draws, in order, to the port's
    `sample_geo_params`.  With `test_train_epoch_matches_jax`'s
    tolerances: the losses within rel 1e-4, each step's encoded labels
    bitwise the host codec's of its remapped rows, the per-leaf weight
    bounds (`_deviations`).  The BN statistics and the group-pooled
    weight deviations are held to GEO_NOISE_FACTOR times the port's
    deviation from itself when WARP_NOISE perturbs its warped frames."""
    monkeypatch.setenv("SPNET_SCAN_UNROLL", "1")
    rng = np.random.default_rng(4)
    b, lr_max, total = 4, 1e-3, 100
    jm = jbuild(JModelConfig(**dataclasses.asdict(CFG)))
    x_all = rng.integers(0, 256, (8, SIZE, SIZE, 1), dtype=np.uint8)
    rows_all, mask_all = _random_rows(rng, 8)
    rows_all[..., 5] = np.abs(rows_all[..., 5]) + 1  # every row valid
    y_all = _host_encode(rows_all, mask_all)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), x_all[:1].astype(np.float32))
    params = _perturb(_np_tree(v["params"]), rng)
    stats = _perturb(_np_tree(v["batch_stats"]), rng)
    idx_mats = [np.array([[0, 3, 5, 6], [1, 2, 4, 7], [6, 0, 2, 5]],
                         np.int32),
                np.array([[7, 1, 3, 0], [2, 5, 6, 4], [3, 7, 1, 2]],
                         np.int32)]
    rng_key = jax.random.key(1)
    epoch_keys = [jax.random.fold_in(rng_key, e) for e in range(2)]
    draws = [jaug.sample_geo_params(
        jax.random.split(jax.random.fold_in(k, i), 3)[1], b)
        for k in epoch_keys for i in range(3)]

    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((b, SIZE, SIZE, 1)),
                             j_schedule(lr_max, total), adam_variant="optax")
    j_state = j_state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    j_epoch = j_make_train_step(jm, JLossWeights(), "same", l2_reg=1e-4,
                                augment=False, indexed="epoch",
                                pregather=False, geo_augment=True,
                                grid=JGridSpec())
    j_losses = []
    for idx, key in zip(idx_mats, epoch_keys):
        j_state, losses = j_epoch(j_state, x_all, y_all, rows_all, mask_all,
                                  idx, key)
        j_losses.append(np.asarray(losses))

    pending, encoded = [], []
    warp = augment.apply_geo_batch

    def jax_draw(generator, n, *args):
        assert n == b
        return {k: torch.from_numpy(np.array(v)) for k, v in
                pending.pop(0).items()}

    def recording_encode(rows, mask, grid):
        y = encode_batch_device(rows, mask, grid)
        encoded.append((rows.numpy().copy(), mask.numpy().copy(),
                        y.numpy().copy()))
        return y

    def port_run(noise: float):
        """The port's two epochs on JAX's draws; `noise` > 0 adds
        N(0, noise) to every warped frame.  Returns (model, losses)."""
        pending[:] = draws
        noise_gen = torch.Generator().manual_seed(5)

        def noisy_warp(*a, **k):
            x, rows = warp(*a, **k)
            return x + noise * torch.randn(x.shape, generator=noise_gen), \
                rows

        monkeypatch.setattr(augment, "apply_geo_batch",
                            noisy_warp if noise else warp)
        model = build_model(CFG, device="cpu")
        model.load_state_dict(flax_to_state_dict(params, stats, model))
        state = create_train_state(model, sched, adam_variant="optax")
        train_epoch_geo = make_train_epoch(
            make_train_step(model, LossWeights(), "same", l2_reg=1e-4,
                            augment=False, geo_augment=True, grid=GRID),
            geo_augment=True)
        gen = torch.Generator().manual_seed(0)
        data = [torch.from_numpy(a)
                for a in (x_all, y_all, rows_all, mask_all)]
        losses = []
        for idx in idx_mats:
            state, loss = train_epoch_geo(state, *data,
                                          torch.from_numpy(idx).long(), gen)
            losses.append(loss.numpy())
        assert not pending and state.step == state.opt_state.count == 6
        return model, losses

    monkeypatch.setattr(augment, "sample_geo_params", jax_draw)
    monkeypatch.setattr(t_steps, "encode_batch_device", recording_encode)
    sched = onecycle_schedule(lr_max, total)
    model, losses = port_run(0.0)
    for got, want in zip(losses, j_losses):
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(encoded) == 6
    for rows, mask, y in encoded:
        _assert_host_equal(y, _host_encode(rows, mask))

    sum_lr = sum(sched(i) for i in range(6))
    got = model.state_dict()
    stat_err, groups = _deviations(got, flax_to_state_dict(
        _np_tree(j_state.params), _np_tree(j_state.batch_stats), model),
        model, sum_lr)
    noisy, _ = port_run(WARP_NOISE)
    self_err, self_groups = _deviations(noisy.state_dict(), got, model,
                                        sum_lr)
    assert stat_err <= GEO_NOISE_FACTOR * self_err, (stat_err, self_err)
    for grp, (med, q99) in groups.items():
        s_med, s_q99 = self_groups[grp]
        assert med <= GEO_NOISE_FACTOR * s_med and \
            q99 <= GEO_NOISE_FACTOR * s_q99, (grp, med, q99, s_med, s_q99)
