"""Synthetic ESPI frame generator ("fake backend").

Counterpart of `spnet_tpu/data/synth.py`, in two halves:

  * SCENE SAMPLING (host, numpy), copied unchanged: wave parameters,
    rejection-sampled non-overlapping ellipse placement, ring counts.  One
    `np.random.Generator` per (seed, frame), so a frame's scene, and with
    it its labels, is bitwise the JAX package's whatever the batching.
  * RENDERING (torch, on `device`): interference bands as a modular cosine
    field, antinode rings as constant-pixel-width annuli of the normalized
    ellipse radius, Gaussian blur (3/7; 3/5 for the hybrid variant) with a
    branchless per-frame select, then the noise stage (`add_noise`:
    clipped N(40, 40) and a Bernoulli(0.5) pixel mask, which the hybrid
    variant skips), and an optional FFT bandpass background mixup.

Noise: each frame draws from its own `torch.Generator` on the device,
seeded with the scene's `noise_seed`, so a frame is the same in any batch
on one device.  JAX's `jax.random.key(seed)` streams cannot be reproduced
in torch, so the noise (and the bandpass scale) equals the JAX package's
in distribution, not in bits; the noise-free render (`render_clean`)
equals it up to float32 rounding at the field thresholds.  CUDA and CPU
generators give different streams, so a frame's noise also differs
between devices.

Label contract preserved exactly: caption CSV rows `cx,cy,a,b,angle,rings`,
file names `steelpan_%07d.png`, the 80/20 Train/Val split by frame
fraction.  Scene parameter distributions: see the JAX module's docstring
(reference `gen_fake_espi.py` lines cited inline below).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from spnet_tpu_torch.config import ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH
from spnet_tpu_torch.data.csvio import caption_from_records

MAX_ANTINODES = 7
MAX_RINGS = 11
MIN_LINE_WIDTH = 4  # px per dark-light ring pair (`gen_fake_espi.py:46`)

W, H = ORIG_IMG_WIDTH, ORIG_IMG_HEIGHT


# ---------------------------------------------------------------------------
# Host-side scene sampling (copied from the JAX package: bitwise equal)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Scene:
    """All parameters needed to render one frame, in plain arrays."""

    # waves
    amp: float
    wavelength: float
    thickness: float
    slope: float
    spacing: float
    # antinodes: fixed MAX_ANTINODES slots
    present: np.ndarray  # (MAX_ANTINODES,) bool
    cx: np.ndarray
    cy: np.ndarray
    a: np.ndarray
    b: np.ndarray
    angle: np.ndarray  # degrees
    rings: np.ndarray  # int
    ring_start: np.ndarray  # 0/1: center dark or bright
    # post-processing
    blur_sel: int  # 0 = none, 1 = ksize 3, 2 = ksize 7
    noise_seed: int

    def caption_rows(self) -> list[list[float]]:
        rows = []
        for i in range(MAX_ANTINODES):
            if self.present[i]:
                rows.append(
                    [
                        float(self.cx[i]),
                        float(self.cy[i]),
                        float(self.a[i]),
                        float(self.b[i]),
                        float(self.angle[i]),
                        float(self.rings[i]),
                    ]
                )
        return rows


def _ellipse_bbox(cx, cy, a, b, angle_deg):
    """Loose axis-aligned bbox of a rotated ellipse (the reference's
    rejection test uses this, `gen_fake_espi.py:82-98`)."""
    rad = np.radians(angle_deg)
    dx = np.sqrt(a**2 * np.cos(rad) ** 2 + b**2 * np.sin(rad) ** 2)
    dy = np.sqrt(a**2 * np.sin(rad) ** 2 + b**2 * np.cos(rad) ** 2)
    return (cx - dx, cy - dy, cx + dx, cy + dy)


def _boxes_overlap(p, q):
    return not (p[2] < q[0] or p[0] > q[2] or p[3] < q[1] or p[1] > q[3])


def sample_scene(seed: int, frame: int, variant: str = "primary",
                 blur: bool | None = None) -> Scene:
    """Deterministic scene for one frame.

    variant='hybrid' reproduces the reference's OLDER generator
    (`gen_fake_espi_hybrid.py`): 0..6 antinodes per frame (vs 1..7), blur
    kernel {3, 5} (vs {3, 7}); its other deltas (no pixel dropout, no
    bandpass variant) live in the renderer.

    blur: None = the variant's EFFECTIVE reference behavior.  The primary
    generator's blur is a silent no-op — `blur_inplace` discards the
    cv2.GaussianBlur result (`gen_fake_espi.py:257` ->
    `augmentation.py:66-70`), so reference Dataset-A frames are NEVER
    blurred — while the hybrid generator's blur is real
    (`gen_fake_espi_hybrid.py:313-316` keeps the return value).  Pass
    True/False to override (True = the primary author's INTENDED 30 %
    blur).  The dice rolls are drawn either way so every other sampled
    value (incl. noise_seed) is blur-setting-independent."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, frame]))

    # waves
    thickness = float(rng.integers(15, 41))
    slope = float(3.0 * (rng.random() - 0.5))
    lo = thickness + thickness * int(abs(1.5 * slope))
    spacing = float(rng.integers(int(lo), max(int(lo) + 1, H // 3 + 1)))
    amp = float(rng.integers(10, 201))
    wavelength = float(rng.integers(100, W // 2 + 1))

    # antinodes (hybrid: 0..6, `gen_fake_espi_hybrid.py:309-310`)
    if variant == "hybrid":
        n_an = int(rng.integers(0, MAX_ANTINODES))
    else:
        n_an = int(rng.integers(1, MAX_ANTINODES + 1))
    present = np.zeros(MAX_ANTINODES, bool)
    cxs = np.zeros(MAX_ANTINODES, np.float32)
    cys = np.zeros(MAX_ANTINODES, np.float32)
    aas = np.ones(MAX_ANTINODES, np.float32)
    bbs = np.ones(MAX_ANTINODES, np.float32)
    angs = np.zeros(MAX_ANTINODES, np.float32)
    rgs = np.zeros(MAX_ANTINODES, np.int32)
    starts = np.zeros(MAX_ANTINODES, np.int32)

    boxes: list[tuple] = []
    for k in range(n_an):
        ax = sorted(
            (int(rng.integers(15, int(W / 3.5) + 1)),
             int(rng.integers(15, int(H / 3.5) + 1))),
            reverse=True,
        )
        max_rings = min(ax[1] // 8, MAX_RINGS)
        n_rings = int(rng.integers(1, max(max_rings, 1) + 1))
        if ax[1] / n_rings < MIN_LINE_WIDTH:
            n_rings = ax[1] // MIN_LINE_WIDTH
        cx = int(rng.integers(ax[0], W - ax[0] + 1))
        cy = int(rng.integers(ax[1], H - ax[1] + 1))
        ang = int(rng.integers(1, 180))
        box = _ellipse_bbox(cx, cy, ax[0], ax[1], ang)

        tries = 0
        while (
            any(_boxes_overlap(box, bb) for bb in boxes)
            or box[0] < 0
            or box[2] > W
            or box[1] < 0
            or box[3] > H
        ) and tries < 2000:
            tries += 1
            ax = sorted(
                (int(rng.integers(25, W // 3 + 1)),
                 int(rng.integers(25, H // 3 + 1))),
                reverse=True,
            )
            if ax[1] / n_rings < MIN_LINE_WIDTH:
                n_rings = ax[1] // MIN_LINE_WIDTH
            cx = int(rng.integers(ax[0], W - ax[0] + 1))
            cy = int(rng.integers(ax[1], H - ax[1] + 1))
            ang = int(rng.integers(1, 181))
            box = _ellipse_bbox(cx, cy, ax[0], ax[1], ang)

        if tries >= 2000:
            continue  # skip this antinode (reference `gen_fake_espi.py:197-199`)
        boxes.append(box)
        present[k] = True
        cxs[k], cys[k] = cx, cy
        aas[k], bbs[k] = ax[0], ax[1]
        angs[k] = ang
        rgs[k] = max(n_rings, 1)
        starts[k] = int(rng.integers(0, 2))

    blur_sel = 0
    if rng.random() <= 0.3:
        blur_sel = 1 if rng.random() < 0.5 else 2
    if blur is None:
        blur = variant == "hybrid"  # primary's blur is a no-op (docstring)
    if not blur:
        blur_sel = 0
    noise_seed = int(rng.integers(0, 2**31 - 1))

    return Scene(
        amp=amp,
        wavelength=wavelength,
        thickness=thickness,
        slope=slope,
        spacing=spacing,
        present=present,
        cx=cxs,
        cy=cys,
        a=aas,
        b=bbs,
        angle=angs,
        rings=rgs,
        ring_start=starts,
        blur_sel=blur_sel,
        noise_seed=noise_seed,
    )


def scenes_to_arrays(scenes: list[Scene]) -> dict[str, np.ndarray]:
    """Stack scenes into a dict of batched arrays for the device renderer."""
    f32 = np.float32
    return {
        "amp": np.array([s.amp for s in scenes], f32),
        "wavelength": np.array([s.wavelength for s in scenes], f32),
        "thickness": np.array([s.thickness for s in scenes], f32),
        "slope": np.array([s.slope for s in scenes], f32),
        "spacing": np.array([s.spacing for s in scenes], f32),
        "present": np.stack([s.present for s in scenes]).astype(f32),
        "cx": np.stack([s.cx for s in scenes]).astype(f32),
        "cy": np.stack([s.cy for s in scenes]).astype(f32),
        "a": np.stack([s.a for s in scenes]).astype(f32),
        "b": np.stack([s.b for s in scenes]).astype(f32),
        "angle": np.stack([s.angle for s in scenes]).astype(f32),
        "rings": np.stack([s.rings for s in scenes]).astype(f32),
        "ring_start": np.stack([s.ring_start for s in scenes]).astype(f32),
        "blur_sel": np.array([s.blur_sel for s in scenes], np.int32),
        "noise_seed": np.array([s.noise_seed for s in scenes], np.uint32),
    }


# ---------------------------------------------------------------------------
# Device-side rendering
# ---------------------------------------------------------------------------
GREY = 128.0
DARK = 0.0
BRIGHT = GREY + 10.0

#: The per-frame scene fields the renderer reads, each (B,) or
#: (B, MAX_ANTINODES).
_RENDER_KEYS = ("amp", "wavelength", "thickness", "slope", "spacing",
                "present", "cx", "cy", "a", "b", "angle", "rings",
                "ring_start")


def _render_waves(xs, ys, amp, wavelength, thickness, slope, spacing):
    """Dark interference bands: pixels within thickness/2 (vertically) of
    any polyline y = j*spacing - W*|slope| + slope*x + amp*cos(x/lam)
    (`gen_fake_espi.py:60-80`).  The family is periodic in y with period
    `spacing`, so membership is a modular distance test (`remainder`
    keeps the divisor's sign, as `jnp.mod` does)."""
    phase = (ys - slope * xs - amp * torch.cos(xs / wavelength)
             + W * torch.abs(slope))
    m = torch.remainder(phase, spacing)
    dist = torch.minimum(m, spacing - m)
    return dist <= thickness / 2.0  # bool field, True = dark band


def _render_antinode(xs, ys, present, cx, cy, a, b, angle_deg, rings, start):
    """Coverage mask + color of one antinode's concentric rings: 2*rings
    alternating dark/bright outlines at normalized radii (j+1)/(2*rings+1),
    each an annulus |r - s_j| <= (t/2)*|grad r| of constant pixel width
    (`gen_fake_espi.py:101-114`).  The label angle is negated: annotations
    have y upward, the pixel grid y downward."""
    th = torch.deg2rad(-angle_deg)
    c, s = torch.cos(th), torch.sin(th)
    dx, dy = xs - cx, ys - cy
    u = dx * c + dy * s
    v = -dx * s + dy * c
    r2 = (u / a) ** 2 + (v / b) ** 2
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    # |grad r| (exact, rotation-invariant)
    grad_r = torch.sqrt((u / (a * a)) ** 2 + (v / (b * b)) ** 2) / r

    n_wb = 2.0 * rings  # dark+bright ring count
    t_half = torch.clamp(torch.minimum(a, b) / n_wb, min=1.0) / 2.0
    band = r * (n_wb + 1.0)  # ring j sits at band == j+1
    # jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi); round is
    # half-to-even in both
    j = torch.minimum(torch.clamp(torch.round(band) - 1.0, min=0.0),
                      n_wb - 1.0)
    dist_r = torch.abs(band - (j + 1.0)) / (n_wb + 1.0)
    on_ring = (dist_r <= t_half * grad_r) & (r <= 1.1) & (present > 0.5)
    dark = torch.remainder(start + j, 2.0) < 0.5
    color = torch.where(dark, DARK, BRIGHT)
    return on_ring, color


def _gauss_kernel(ksize: int, sigma: float | None = None) -> np.ndarray:
    """OpenCV-compatible Gaussian kernel (sigma = 0.3*((k-1)*0.5-1)+0.8)."""
    if sigma is None:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _sep_blur(img, k1d):
    """Separable blur of (B, H, W), SAME size with edge padding (rows,
    then columns)."""
    k = torch.from_numpy(k1d).to(img.device)
    pad = len(k1d) // 2
    h, w = img.shape[1], img.shape[2]
    x = torch.nn.functional.pad(img[:, None], (0, 0, pad, pad),
                                mode="replicate")[:, 0]
    x = torch.einsum("bkhw,k->bhw",
                     torch.stack([x[:, i:i + h] for i in range(len(k1d))],
                                 1), k)
    x = torch.nn.functional.pad(x[:, None], (pad, pad, 0, 0),
                                mode="replicate")[:, 0]
    return torch.einsum("bkhw,k->bhw",
                        torch.stack([x[:, :, i:i + w]
                                     for i in range(len(k1d))], 1), k)


def _on_device(scene_arrays: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(scene_arrays[k])).to(device)
            for k in _RENDER_KEYS}


def render_clean(scene_arrays: dict, variant: str = "primary",
                 device: str | torch.device = "cuda"):
    """The noise-free frames of a batch of scenes: bands, antinodes and
    the per-frame blur select.  float32 (B, H, W) on `device`, in
    {0, 128, 138} before blur."""
    device = torch.device(device)
    sc = _on_device(scene_arrays, device)
    bsz = sc["amp"].shape[0]
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    ys, xs = ys.expand(H, W), xs.expand(H, W)

    def per_frame(v):
        return v.reshape(bsz, 1, 1)

    dark = _render_waves(xs, ys, *(per_frame(sc[k]) for k in (
        "amp", "wavelength", "thickness", "slope", "spacing")))
    imgs = torch.where(dark, DARK, GREY)
    for k in range(MAX_ANTINODES):
        on, color = _render_antinode(xs, ys, *(
            per_frame(sc[n][:, k]) for n in (
                "present", "cx", "cy", "a", "b", "angle", "rings",
                "ring_start")))
        imgs = torch.where(on, color, imgs)

    # blur (none / 3 / {7 or 5}), branchless per-frame select; the hybrid
    # variant uses ksize 5 (`gen_fake_espi_hybrid.py:314-316`).  The
    # selector is host data: a batch that blurs no frame skips the work.
    sel_np = np.asarray(scene_arrays["blur_sel"])
    if (sel_np != 0).any():
        sel = torch.as_tensor(sel_np).to(device).view(bsz, 1, 1)
        b3 = _sep_blur(imgs, _gauss_kernel(3))
        b_alt = _sep_blur(imgs, _gauss_kernel(5 if variant == "hybrid"
                                              else 7))
        imgs = torch.where(sel == 1, b3, torch.where(sel == 2, b_alt, imgs))
    return imgs


def _frame_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def add_noise(imgs, noise_seeds, variant: str = "primary"):
    """The noise stage: additive clipped Gaussian noise N(40, 40), then a
    Bernoulli(0.5) pixel mask (the hybrid variant stops at the noise).
    Frame i draws from a generator on the frames' device seeded with
    noise_seeds[i]: the same frame whatever batch it is in."""
    out = torch.empty_like(imgs)
    shape = imgs.shape[1:]
    for i, seed in enumerate(np.asarray(noise_seeds)):
        g = _frame_generator(seed, imgs.device)
        noise = torch.randn(shape, generator=g, device=imgs.device)
        noise = torch.clamp(40.0 + 40.0 * noise, 0.0, 255.0)
        img = torch.clamp(imgs[i] + noise, 0.0, 255.0)
        if variant != "hybrid":
            img = img * (torch.rand(shape, generator=g, device=imgs.device)
                         < 0.5)
        out[i] = img
    return out


def render_frames(scene_arrays: dict, bandpass: bool = False,
                  real_images=None, variant: str = "primary",
                  device: str | torch.device = "cuda"):
    """Render a batch of frames from stacked scene parameters.

    Returns float32 (B, H, W) images in [0, 255] on `device`.  If
    `bandpass` and `real_images` (B, H, W) is given, also returns the
    bandpass-mixup variant (low frequencies swapped in from real frames).
    """
    imgs = add_noise(render_clean(scene_arrays, variant, device),
                     scene_arrays["noise_seed"], variant)
    if bandpass and real_images is not None:
        real = torch.as_tensor(np.asarray(real_images, np.float32)).to(
            imgs.device)
        return imgs, bandpass_mixup_batch(imgs, real,
                                          scene_arrays["noise_seed"])
    return imgs


def bandpass_mix(fake, real, scale, low_width: int = 8):
    """FFT background swap with a given per-frame scale (B,): keep an
    8-px low-pass box of the centered spectrum from the REAL frame times
    `scale`, the rest from the fake; magnitude of the inverse transform,
    min-max normalized to [0, 255] per frame."""
    fake = torch.as_tensor(fake, dtype=torch.float32)
    real = torch.as_tensor(real, dtype=torch.float32).to(fake.device)
    dims = (-2, -1)
    ft_f = torch.fft.fftshift(torch.fft.fft2(fake), dim=dims)
    ft_r = torch.fft.fftshift(torch.fft.fft2(real), dim=dims)
    h, w = fake.shape[-2:]
    cy, cx = h // 2, w // 2
    yy = torch.arange(h, device=fake.device)[:, None]
    xx = torch.arange(w, device=fake.device)[None, :]
    mask = ((yy >= cy - low_width) & (yy < cy + low_width)
            & (xx >= cx - low_width) & (xx < cx + low_width))
    scale = torch.as_tensor(scale, dtype=torch.float32).to(fake.device)
    out = torch.where(mask, scale.view(-1, 1, 1) * ft_r, ft_f)
    img = torch.abs(torch.fft.ifft2(torch.fft.ifftshift(out, dim=dims)))
    lo = img.amin(dim=dims, keepdim=True)
    hi = img.amax(dim=dims, keepdim=True)
    return torch.clamp((img - lo) / torch.clamp(hi - lo, min=1e-9) * 255.0,
                       0.0, 255.0)


def bandpass_mixup_batch(fake, real, seeds, low_width: int = 8):
    """FFT background swap (twin of reference `augmentation.bandpass_mixup`,
    `spnet/augmentation.py:10-62`), each frame's scale U(0, 3) drawn from
    a generator on the frames' device seeded with its seed."""
    fake = torch.as_tensor(fake, dtype=torch.float32)
    scale = torch.stack([
        torch.rand((), generator=_frame_generator(s, fake.device),
                   device=fake.device) * 3.0
        for s in np.asarray(seeds)])
    return bandpass_mix(fake, real, scale, low_width)


# ---------------------------------------------------------------------------
# Dataset generation (files on disk, reference data contract)
# ---------------------------------------------------------------------------
def _load_real_pool(path: str, limit: int = 64) -> np.ndarray:
    """Load up to `limit` real frames (grayscale, native 512x384) to act
    as bandpass-mixup backgrounds (reference `augmentation.py:22`)."""
    import glob

    from PIL import Image

    files = sorted(glob.glob(os.path.join(path, "*.png")))[:limit]
    if not files:
        raise ValueError(f"no real images found in {path} for bandpass")
    out = []
    for f in files:
        img = Image.open(f).convert("L")
        if img.size != (W, H):
            img = img.resize((W, H))
        out.append(np.asarray(img, np.float32))
    return np.stack(out)


def _to_u8(imgs) -> np.ndarray:
    """float frames in [0, 255] -> uint8 on the host; the cast truncates,
    as numpy's `astype(np.uint8)` does."""
    return imgs.to(torch.uint8).cpu().numpy()


def generate_dataset(
    out_dir: str,
    num_frames: int,
    seed: int = 0,
    train_only: bool = True,
    batch: int = 64,
    frame_start: int = 0,
    bandpass: str | None = None,
    variant: str = "primary",
    blur: bool | None = None,
    verbose: bool = True,
    device: str | torch.device = "cuda",
) -> None:
    """Write `steelpan_%07d.png` + `.csv` pairs under Train/ (and Val/ for
    the last 20% when not train_only — reference `gen_fake_espi.py:219-227`
    splits by task index; this splits by frame fraction, same 80/20
    ratio).  Frames render on `device`.

    bandpass: optional directory of REAL frames; when given, also writes
    `*_bp.png` variants whose low-frequency background is swapped in from
    a random real frame (reference `gen_fake_espi.py:271-275`)."""
    from PIL import Image

    train_dir = os.path.join(out_dir, "Train")
    os.makedirs(train_dir, exist_ok=True)
    if not train_only:
        os.makedirs(os.path.join(out_dir, "Val"), exist_ok=True)

    real_pool = None
    if bandpass:
        real_pool = _load_real_pool(bandpass)

    for b0 in range(0, num_frames, batch):
        nb = min(batch, num_frames - b0)
        scenes = [sample_scene(seed, frame_start + b0 + i, variant,
                               blur=blur)
                  for i in range(nb)]
        arrays = scenes_to_arrays(scenes)
        if real_pool is not None:
            ridx = np.random.default_rng(seed + b0).integers(
                0, real_pool.shape[0], nb
            )
            imgs_f, imgs_bp = render_frames(
                arrays, bandpass=True, real_images=real_pool[ridx],
                variant=variant, device=device,
            )
            imgs, bps = _to_u8(imgs_f), _to_u8(imgs_bp)
        else:
            imgs = _to_u8(render_frames(arrays, variant=variant,
                                        device=device))
            bps = None
        for i, sc in enumerate(scenes):
            frame = frame_start + b0 + i
            frac = (b0 + i) / num_frames
            sub = "Train" if (train_only or frac < 0.8) else "Val"
            prefix = os.path.join(
                out_dir, sub, f"steelpan_{frame:07d}"
            )
            rows = sc.caption_rows()
            # the hybrid variant writes an explicit all-zeros row for
            # empty frames (`gen_fake_espi_hybrid.py:302-303`); the
            # rings<=0 parse filter drops it downstream, like the
            # reference's parse_meta_file
            caption = (caption_from_records(rows) if rows
                       else "0,0,0,0,0,0.0")
            Image.fromarray(imgs[i]).save(prefix + ".png")
            with open(prefix + ".csv", "w") as f:
                f.write(caption)
            if bps is not None:
                # the reference writes *_bp.png with NO metadata twin
                # (`gen_fake_espi.py:275`), which breaks its own paired
                # loader; the matching .csv is written as well.
                Image.fromarray(bps[i]).save(prefix + "_bp.png")
                with open(prefix + "_bp.csv", "w") as f:
                    f.write(caption)
        if verbose:
            print(f"  generated {min(b0 + nb, num_frames)}/{num_frames}",
                  end="\r")
    if verbose:
        print()


def generate_arrays(
    num_frames: int, seed: int = 0, frame_start: int = 0, batch: int = 64,
    device: str | torch.device = "cuda",
):
    """In-memory fast path: yields (images_uint8 (B,H,W), list[Scene]) —
    lets training consume synthetic data without a PNG round-trip."""
    for b0 in range(0, num_frames, batch):
        nb = min(batch, num_frames - b0)
        scenes = [sample_scene(seed, frame_start + b0 + i) for i in range(nb)]
        arrays = scenes_to_arrays(scenes)
        yield _to_u8(render_frames(arrays, device=device)), scenes
