"""The port's synthetic ESPI generator, its resize and `synthetic_dataset`
against the JAX package's on the CPU: scenes bitwise, the noise-free
render (bands, antinodes, blur) up to float32 rounding at the field
thresholds, the noise in distribution (its streams are torch's), frames
independent of their batch, the bandpass mixup given JAX's own scale,
`jax.image.resize` (lanczos3 / linear, antialiased), the files of
`generate_dataset`, and the labels, rows and frames of
`synthetic_dataset`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spnet_tpu.data import synth as jsynth
from spnet_tpu.data.dataset import synthetic_dataset as j_synthetic_dataset
from spnet_tpu_torch.data import synth
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.ops.resize import resize, weight_matrix

torch.set_num_threads(2)
SCENE_FIELDS = ("present", "cx", "cy", "a", "b", "angle", "rings",
                "ring_start")
#: share of pixels of the noise-free render that may differ from JAX's:
#: a band or ring test that lands within float32 rounding of its threshold
#: flips (measured: 0 of 786,432 pixels on the frames below, 0.019 % on
#: seed 0 frames 0-7)
RENDER_FLIP_SHARE = 1e-3
#: resize, float32: relative to the output's scale (measured 6.6e-6 at
#: 384x512 -> 331^2; JAX sums the products in another order)
RESIZE_RTOL = 2e-5


@pytest.mark.parametrize("variant,blur", [("primary", None),
                                          ("primary", True),
                                          ("hybrid", None)])
def test_scenes_bitwise_equal_to_jax(variant, blur):
    """The host sampler is a copy: every field of every scene, and the
    stacked arrays, bitwise equal for 3 seeds x 40 frames."""
    for seed in (0, 7, 123):
        scenes, jscenes = [], []
        for f in range(40):
            s = synth.sample_scene(seed, f, variant, blur=blur)
            j = jsynth.sample_scene(seed, f, variant, blur=blur)
            for k in SCENE_FIELDS:
                np.testing.assert_array_equal(getattr(s, k), getattr(j, k))
            for k in ("amp", "wavelength", "thickness", "slope", "spacing",
                      "blur_sel", "noise_seed"):
                assert getattr(s, k) == getattr(j, k), (seed, f, k)
            assert s.caption_rows() == j.caption_rows()
            scenes.append(s)
            jscenes.append(j)
        a, b = synth.scenes_to_arrays(scenes), jsynth.scenes_to_arrays(jscenes)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert synth.MAX_ANTINODES == jsynth.MAX_ANTINODES
    assert synth.MAX_RINGS == jsynth.MAX_RINGS
    assert synth.MIN_LINE_WIDTH == jsynth.MIN_LINE_WIDTH


def _jax_clean(arrays, variant):
    """The JAX package's `render_frames` up to its noise stage, from its
    own functions."""
    h, w = jsynth.H, jsynth.W
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)

    def one(sc):
        img = jnp.full((h, w), jsynth.GREY, jnp.float32)
        dark = jsynth._render_waves(xs, ys, sc["amp"], sc["wavelength"],
                                    sc["thickness"], sc["slope"],
                                    sc["spacing"])
        img = jnp.where(dark, jsynth.DARK, img)
        for k in range(jsynth.MAX_ANTINODES):
            on, color = jsynth._render_antinode(
                xs, ys, sc["present"][k], sc["cx"][k], sc["cy"][k],
                sc["a"][k], sc["b"][k], sc["angle"][k], sc["rings"][k],
                sc["ring_start"][k])
            img = jnp.where(on, color, img)
        return img

    @jax.jit
    def run(arrays):
        imgs = jax.vmap(one)({k: arrays[k] for k in synth._RENDER_KEYS})
        b3 = jsynth._sep_blur(imgs, jsynth._gauss_kernel(3))
        b_alt = jsynth._sep_blur(imgs, jsynth._gauss_kernel(
            5 if variant == "hybrid" else 7))
        sel = arrays["blur_sel"][:, None, None]
        return jnp.where(sel == 1, b3, jnp.where(sel == 2, b_alt, imgs))

    return np.asarray(run({k: jnp.asarray(v) for k, v in arrays.items()
                           if k != "noise_seed"}))


@pytest.mark.parametrize("variant,blur,frames", [
    ("primary", None, (0, 1, 4, 6)),   # no blur: the primary default
    ("primary", True, (2, 5, 6, 7)),   # blur_sel 2, 2, 1, 0 (kernels 7, 3)
    ("hybrid", None, (1, 9, 18, 0)),   # blur_sel 2, 2, 1, 0 (kernels 5, 3)
])
def test_clean_render_matches_jax(variant, blur, frames):
    """Bands, antinodes and the per-frame blur select, noise-free: at most
    RENDER_FLIP_SHARE of the pixels differ (threshold flips); every other
    pixel within 1e-3 (the blur's float32 sums)."""
    scenes = [synth.sample_scene(0, f, variant, blur=blur) for f in frames]
    arrays = synth.scenes_to_arrays(scenes)
    if blur or variant == "hybrid":
        assert (arrays["blur_sel"] != 0).any()
    got = synth.render_clean(arrays, variant, device="cpu").numpy()
    want = _jax_clean(arrays, variant)
    assert got.shape == want.shape == (4, 384, 512)
    diff = np.abs(got - want)
    flipped = diff > 1e-3
    assert flipped.mean() <= RENDER_FLIP_SHARE, flipped.mean()
    assert set(np.unique(got[arrays["blur_sel"] == 0])) <= {0.0, 128.0, 138.0}


@pytest.mark.parametrize("variant", ["primary", "hybrid"])
def test_noise_statistics_match_jax(variant):
    """The full render (noise on): the same distribution as JAX's frames
    of the same scenes, over 4 x 196,608 pixels: the share of zero pixels
    (the primary variant's Bernoulli(0.5) mask, plus dark pixels whose
    noise clips at 0, the hybrid's only source) within 0.005, the mean
    and the standard deviation within 1 %; and the noise of a flat frame,
    N(40, 40) clipped."""
    scenes = [synth.sample_scene(3, f, variant) for f in range(4)]
    arrays = synth.scenes_to_arrays(scenes)
    got = synth.render_frames(arrays, variant=variant, device="cpu").numpy()
    want = np.asarray(jsynth.render_frames(arrays, variant=variant))
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 255.0
    z_got, z_want = (got == 0).mean(), (want == 0).mean()
    assert abs(z_got - z_want) < 0.005
    assert (z_got > 0.5) if variant == "primary" else (z_got < 0.2)
    assert abs(got.mean() - want.mean()) < 0.01 * want.mean()
    assert abs(got.std() - want.std()) < 0.01 * want.std()

    flat = torch.full((2, 384, 512), 100.0)
    noisy = synth.add_noise(flat, np.array([1, 2], np.uint32), "hybrid")
    n = (noisy - 100.0).numpy()
    clipped = np.clip(40.0 + 40.0 * np.random.default_rng(0).standard_normal(
        n.size), 0.0, 255.0)
    assert abs(n.mean() - clipped.mean()) < 0.5
    assert abs(n.std() - clipped.std()) < 0.5
    assert (n >= 0).all()


def test_frame_is_the_same_in_any_batch():
    """A frame's noise comes from its own generator: frame 3 rendered alone,
    in a batch of 3 and in a batch of 6 is bitwise the same frame, and two
    frames differ."""
    scenes = [synth.sample_scene(5, f) for f in range(6)]
    full = synth.render_frames(synth.scenes_to_arrays(scenes), device="cpu")
    alone = synth.render_frames(synth.scenes_to_arrays(scenes[3:4]),
                                device="cpu")
    mid = synth.render_frames(synth.scenes_to_arrays(scenes[2:5]),
                              device="cpu")
    assert torch.equal(full[3], alone[0]) and torch.equal(full[3], mid[1])
    assert not torch.equal(full[2], full[3])


def test_bandpass_matches_jax_given_its_scale():
    """`bandpass_mix` with the scale JAX draws from each seed
    (U(0,1) * 3 from `jax.random.key(seed)`) against JAX's
    `bandpass_mixup_batch`: within 1e-3 on the [0, 255] scale (complex64
    FFTs; measured 2.1e-4).  The port's own draw lies in [0, 3)."""
    rng = np.random.default_rng(0)
    fake = rng.uniform(0, 255, (3, 384, 512)).astype(np.float32)
    real = rng.uniform(0, 255, (3, 384, 512)).astype(np.float32)
    seeds = np.array([5, 77, 123456], np.uint32)
    want = np.asarray(jsynth.bandpass_mixup_batch(fake, real, seeds))
    scale = np.array([float(jax.random.uniform(jax.random.key(int(s)))) * 3.0
                      for s in seeds], np.float32)
    got = synth.bandpass_mix(torch.from_numpy(fake), torch.from_numpy(real),
                             torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    own = synth.bandpass_mixup_batch(torch.from_numpy(fake),
                                     torch.from_numpy(real), seeds).numpy()
    assert own.shape == want.shape and own.min() == 0.0 and \
        own.max() == pytest.approx(255.0)


@pytest.mark.parametrize("size,method", [(331, "lanczos3"), (64, "lanczos3"),
                                         (331, "linear")])
def test_resize_matches_jax(size, method):
    """`ops/resize.resize` against `jax.image.resize` (antialiased) from
    the native 384x512: float32 within RESIZE_RTOL of the output's scale;
    after clip and the truncating uint8 cast, at most 1 apart."""
    x = np.random.default_rng(1).uniform(0, 255, (3, 384, 512)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (3, size, size), method))
    got = resize(torch.from_numpy(x), (size, size), method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())
    d = np.abs(np.clip(got, 0, 255).astype(np.uint8).astype(int)
               - np.clip(want, 0, 255).astype(np.uint8))
    assert d.max() <= 1
    w = weight_matrix(512, size, method)
    np.testing.assert_allclose(w.sum(0).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="lanczos3"):
        weight_matrix(512, size, "cubic")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("variant", ["primary", "hybrid"])
def test_generate_dataset_matches_jax(variant, tmp_path):
    """The same file names, the 80/20 split by frame fraction, and
    captions byte for byte (the hybrid variant's all-zeros caption of an
    empty frame included); grayscale 512x384 PNGs; with --bandpass the
    `_bp` pairs, their captions the frame's."""
    real = tmp_path / "real"
    real.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (384, 512), dtype=np.uint8)
                        ).save(real / f"r{i}.png")
    kw = dict(num_frames=10, seed=4, train_only=False, batch=4,
              variant=variant, verbose=False,
              bandpass=str(real) if variant == "primary" else None)
    jsynth.generate_dataset(str(tmp_path / "jax"), **kw)
    synth.generate_dataset(str(tmp_path / "port"), device="cpu", **kw)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    per = 4 if variant == "primary" else 2  # png + csv (+ _bp pair)
    assert sum(f.startswith("Train") for f in files) == 8 * per
    assert sum(f.startswith("Val") for f in files) == 2 * per
    empty = 0
    for f in files:
        if f.endswith(".csv"):
            text = (tmp_path / "port" / f).read_text()
            assert text == (tmp_path / "jax" / f).read_text(), f
            empty += text == "0,0,0,0,0,0.0"
        else:
            img = Image.open(tmp_path / "port" / f)
            assert img.mode == "L" and img.size == (512, 384)
    if variant == "hybrid":
        assert empty >= 1  # seed 4 has an empty hybrid frame in the ten


def test_synthetic_dataset_matches_jax():
    """y, rows, row_mask and file names bitwise the JAX package's; x uint8
    of the same shape with the same statistics (the noise is torch's),
    and bitwise the port's own render -> resize -> clip -> truncating
    cast of the same frames (not quantize_u8's rounding, which differs
    on a share of the pixels)."""
    kw = dict(num_frames=7, seed=2, input_size=64, batch_size=3)
    j = j_synthetic_dataset(**kw)
    t = synthetic_dataset(**kw, device="cpu")
    assert t.x.shape == j.x.shape == (6, 64, 64, 1)
    assert t.x.dtype == j.x.dtype == np.uint8
    np.testing.assert_array_equal(t.y, j.y)
    np.testing.assert_array_equal(t.rows, j.rows)
    np.testing.assert_array_equal(t.row_mask, j.row_mask)
    assert t.file_list == j.file_list
    assert t.grid == type(t.grid).from_json(j.grid.to_json())
    assert abs(t.x.mean() - j.x.mean()) < 0.01 * j.x.mean()
    assert abs(t.x.std() - j.x.std()) < 0.02 * j.x.std()

    arrays = synth.scenes_to_arrays([synth.sample_scene(2, f)
                                     for f in range(6)])
    imgs = torch.clamp(resize(synth.render_frames(arrays, device="cpu"),
                              (64, 64)), 0, 255)
    np.testing.assert_array_equal(t.x[..., 0], imgs.to(torch.uint8).numpy())
    assert (np.rint(imgs.numpy()) != t.x[..., 0]).mean() > 0.1
    f32 = synthetic_dataset(6, seed=2, input_size=64, uint8=False,
                            device="cpu")
    np.testing.assert_array_equal(
        f32.x, ((t.x.astype(np.float32) / 255.0) - 0.5) * 2.0)
