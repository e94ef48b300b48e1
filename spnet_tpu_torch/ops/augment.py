"""On-device, batched train-time augmentation.

Counterpart of `spnet_tpu/ops/augment.py`, both halves, as plain batched
tensor code on the images' device:

  * label-preserving (`cutout`, `salt_and_pepper`, `random_blur`,
    `augment_on_the_fly`): the same constants, per-image fill values and
    region bounds;
  * label-transforming (flip / rotate / translate with the ellipse rows
    remapped; `apply_geo_batch` composes them into one affine per image):
    the replacement for the reference's offline 42x dataset inflation.

Randomness comes from an explicit `torch.Generator` on that device, so the
draws differ from `jax.random`'s but follow the same distributions.  Inside
a process group (`parallel/mesh.py`) the images are this rank's rows of the
global batch: every draw is made for the global batch, from the generator
every rank seeds alike, and the rank keeps its own rows, so each image is
augmented as the one-process run augments it and no rank warps another's.
Images are (B, H, W, C), already normalized to [-1, 1]; raw rows are
[cx, cy, a, b, angle_deg, rings] in native image coordinates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spnet_tpu_torch.ops.constants import device_constant
from spnet_tpu_torch.parallel import mesh

CUTOUT_MAX_REGIONS = 6
CUTOUT_MIN = 11
CUTOUT_MAX = 75
SALT_AMOUNT = 0.004
SALT_VS_PEPPER = 0.2


def _global(size) -> tuple:
    """The global batch's draw shape for this rank's `size` (b, ...)."""
    return (size[0] * mesh.world_size(),) + tuple(size[1:])


def _randint(low, high, size, generator, device):
    return mesh.local_rows(torch.randint(low, high, _global(size),
                                         generator=generator, device=device))


def _rand(size, generator, device):
    return mesh.local_rows(torch.rand(_global(size), generator=generator,
                                      device=device))


def cutout(images, generator: torch.Generator,
           max_regions: int = CUTOUT_MAX_REGIONS):
    """Up to `max_regions` rectangles per image, each filled with a grey
    level drawn uniformly from that image's own [min, max].  A region
    covers rows [y0, min(y0 + rh, h - 1)) and columns [x0, min(x0 + rw,
    w - 1)), as in the JAX package; later regions paint over earlier
    ones."""
    b, h, w, _ = images.shape
    dev = images.device
    nreg = _randint(0, max_regions + 1, (b,), generator, dev)
    y0 = _randint(0, h - CUTOUT_MIN, (b, max_regions), generator, dev)
    x0 = _randint(0, w - CUTOUT_MIN, (b, max_regions), generator, dev)
    rh = _randint(CUTOUT_MIN, CUTOUT_MAX, (b, max_regions), generator, dev)
    rw = _randint(CUTOUT_MIN, CUTOUT_MAX, (b, max_regions), generator, dev)
    lo = images.amin(dim=(1, 2, 3))
    hi = images.amax(dim=(1, 2, 3))
    u = _rand((b, max_regions), generator, dev)
    vals = (lo[:, None] + u * (hi - lo)[:, None]).to(images.dtype)
    y1 = torch.clamp_max(y0 + rh, h - 1)
    x1 = torch.clamp_max(x0 + rw, w - 1)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    for r in range(max_regions):
        inside = ((ys >= y0[:, r, None, None]) & (ys < y1[:, r, None, None])
                  & (xs >= x0[:, r, None, None]) & (xs < x1[:, r, None, None])
                  & (r < nreg)[:, None, None])
        images = torch.where(inside[..., None],
                             vals[:, r, None, None, None], images)
    return images


def salt_and_pepper(images, generator: torch.Generator,
                    amount: float = SALT_AMOUNT, svp: float = SALT_VS_PEPPER):
    """On about half the images (each with probability 0.5), a fraction
    amount*svp of the pixels take the image's max (salt) and
    amount*(1 - svp) its min (pepper)."""
    b = images.shape[0]
    dev = images.device
    active = _rand((b,), generator, dev) < 0.5
    r = _rand(images.shape, generator, dev)
    p_salt = amount * svp
    p_pepper = amount * (1.0 - svp)
    lo = images.amin(dim=(1, 2, 3), keepdim=True)
    hi = images.amax(dim=(1, 2, 3), keepdim=True)
    out = torch.where(r < p_salt, hi, images)
    out = torch.where((r >= p_salt) & (r < p_salt + p_pepper), lo, out)
    return torch.where(active[:, None, None, None], out, images)


def _gauss1d(ksize: int) -> np.ndarray:
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur(images, ksize: int):
    """Separable Gaussian blur, SAME with zero padding, per channel."""
    c = images.shape[-1]
    k = device_constant(_gauss1d(ksize), images.device, images.dtype)
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1),
                 padding=(ksize // 2, 0), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize),
                 padding=(0, ksize // 2), groups=c)
    return x.permute(0, 2, 3, 1)


def random_blur(images, generator: torch.Generator, prob: float = 0.4):
    """Per-image Gaussian blur with probability `prob`, kernel size 3 or 7
    with equal odds."""
    b = images.shape[0]
    dev = images.device
    do = _rand((b,), generator, dev) < prob
    pick7 = _rand((b,), generator, dev) < 0.5
    sel = torch.where(pick7[:, None, None, None], _blur(images, 7),
                      _blur(images, 3))
    return torch.where(do[:, None, None, None], sel, images)


def augment_on_the_fly(images, generator: torch.Generator,
                       blur_prob: float = 0.0):
    """Cutout, then salt & pepper, then (when blur_prob > 0) blur."""
    images = cutout(images, generator)
    images = salt_and_pepper(images, generator)
    if blur_prob > 0:
        images = random_blur(images, generator, prob=blur_prob)
    return images


# ---------------------------------------------------------------------------
# Label-transforming ops (raw metadata rows [cx, cy, a, b, angle_deg, rings],
# angle in degrees like the files)
# ---------------------------------------------------------------------------


def _cleanup_angle(angle):
    """Wrap into [0, 180) (reference `cleanup_angle`,
    `augmentation.py:74-79`): `remainder` keeps the divisor's sign, as
    `jnp.mod` does (`fmod` would keep the angle's)."""
    return torch.remainder(angle, 180.0)


def flip_image_and_labels(img, rows, mask, flip_mode: int):
    """flip_mode: 0 = vertical (flip y), 1 = horizontal (flip x),
    -1 = both, -2 = none (reference `flip_image`,
    `augmentation.py:82-112`).  img: (H, W, C); rows: (N, 6) padded;
    mask: (N,) row validity."""
    h, w = img.shape[0], img.shape[1]
    cx, cy, a, b, ang, rings = rows.unbind(-1)
    if flip_mode == -2:
        return img, rows
    if flip_mode in (0, -1):
        img = torch.flip(img, dims=(0,))
        cy = h - cy
        ang = _cleanup_angle(-ang)
    if flip_mode in (1, -1):
        img = torch.flip(img, dims=(1,))
        cx = w - cx
        ang = _cleanup_angle(180.0 - ang)
    out = torch.stack([cx, cy, a, b, ang, rings], dim=-1)
    return img, torch.where(mask[:, None], out, rows)


def _bilinear_sample(img, yq, xq):
    """img (B, H, W, C) or (H, W, C); query grids (B, H, W) or (H, W) ->
    the same layout as img, zero outside: four corner gathers from the
    flattened batch."""
    single = img.dim() == 3
    if single:
        img, yq, xq = img[None], yq[None], xq[None]
    b, h, w, c = img.shape
    y0 = torch.floor(yq)
    x0 = torch.floor(xq)
    wy = (yq - y0)[..., None]
    wx = (xq - x0)[..., None]
    y0i = y0.long()
    x0i = x0.long()
    flat = img.reshape(b * h * w, c)
    base = (torch.arange(b, device=img.device) * (h * w)).view(b, 1, 1)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, 0.0)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return out[0] if single else out


def _iota(h: int, w: int, device):
    """(ys, xs) float32 pixel-index grids of shape (h, w)."""
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys.expand(h, w), xs.expand(h, w)


def rotate_image_and_labels(img, rows, mask, rot_angle_deg):
    """Rotate about the image center; centers follow the rotation matrix
    (rounded half-to-even) and the ellipse angle shifts by rot_angle
    (reference `rotate_image`, `augmentation.py:184-207`; cv2's
    getRotationMatrix2D rotates counter-clockwise in image space)."""
    h, w = img.shape[0], img.shape[1]
    cx0, cy0 = w / 2.0, h / 2.0
    rot = torch.as_tensor(rot_angle_deg, dtype=torch.float32,
                          device=img.device)
    th = torch.deg2rad(rot)
    c, s = torch.cos(th), torch.sin(th)

    # inverse map for resampling: dest (x, y) <- src rot^-1
    ys, xs = _iota(h, w, img.device)
    ys, xs = ys - cy0, xs - cx0
    xsrc = c * xs - s * ys + cx0
    ysrc = s * xs + c * ys + cy0
    out_img = _bilinear_sample(img, ysrc, xsrc)

    cx, cy, a, b, ang, rings = rows.unbind(-1)
    dx, dy = cx - cx0, cy - cy0
    ncx = c * dx + s * dy + cx0
    ncy = -s * dx + c * dy + cy0
    nang = _cleanup_angle(ang + rot)
    out = torch.stack([torch.round(ncx), torch.round(ncy), a, b, nang,
                       rings], dim=-1)
    return out_img, torch.where(mask[:, None], out, rows)


def translate_image_and_labels(img, rows, mask, tx, ty):
    """Shift image by (tx, ty) pixels (zero fill) and move centers
    (reference `translate_image`, `augmentation.py:216-239`,
    trans_max 40)."""
    h, w = img.shape[0], img.shape[1]
    ys, xs = _iota(h, w, img.device)
    out_img = _bilinear_sample(img, ys - ty, xs - tx)
    cx, cy, a, b, ang, rings = rows.unbind(-1)
    out = torch.stack([cx + tx, cy + ty, a, b, ang, rings], dim=-1)
    return out_img, torch.where(mask[:, None], out, rows)


def sample_geo_params(generator: torch.Generator, b: int,
                      rot_max: float = 20.0, trans_max: float = 40.0,
                      trans_prob: float = 0.9, flip_prob: float = 0.75):
    """Per-image random transform parameters on the generator's device,
    with the reference's offline distributions (`augment_preproc.py:74-95`):
      * flip mode uniform over {none, v, h, vh} at flip_prob 0.75 (mode 0
        = none; the float32 draw times 3 / flip_prob, truncated),
      * rotation angle U(-rot_max, rot_max) degrees,
      * integer translation round(U(-trans_max, trans_max)) (half to
        even), applied with probability trans_prob.
    Returns dict(mode, theta, tx, ty), each (b,)."""
    dev = generator.device
    u_flip = _rand((b,), generator, dev)
    mode = torch.where(u_flip >= flip_prob, 0,
                       1 + (u_flip * (3.0 / max(flip_prob, 1e-9))).int())
    mode = mode.clamp(0, 3).int()
    theta = _rand((b,), generator, dev) * (2 * rot_max) - rot_max
    do_t = _rand((b,), generator, dev) < trans_prob
    tx = torch.round(_rand((b,), generator, dev) * (2 * trans_max)
                     - trans_max) * do_t
    ty = torch.round(_rand((b,), generator, dev) * (2 * trans_max)
                     - trans_max) * do_t
    return {"mode": mode, "theta": theta, "tx": tx, "ty": ty}


def apply_geo_batch(images, rows, mask, params, img_w: int = 512,
                    img_h: int = 384, fill: float = -1.0):
    """Apply per-image flip+rotate+translate (from `sample_geo_params` or
    hand-built) as ONE composed affine per image.

    The raw ellipse rows are remapped in NATIVE (img_w x img_h)
    coordinates, exactly like the reference's flip/rotate/translate label
    math; the image, stored resized (Hr, Wr), is warped with one bilinear
    resample by the native affine conjugated by the resized-to-native
    scales, so image and labels stay consistent.  Pixels whose source lies
    outside [0, Hr-1] x [0, Wr-1] take `fill` (-1.0 == black in the
    Inception scaling).

    images: (B, Hr, Wr, C) float; rows: (B, N, 6); mask: (B, N).
    Returns (images_aug, rows_aug)."""
    hr, wr = images.shape[1], images.shape[2]
    mode = params["mode"]
    theta = params["theta"]
    tx = params["tx"]
    ty = params["ty"]

    vflip = (mode == 1) | (mode == 3)
    hflip = (mode == 2) | (mode == 3)
    fx = torch.where(hflip, -1.0, 1.0)
    ox_f = torch.where(hflip, float(img_w), 0.0)
    fy = torch.where(vflip, -1.0, 1.0)
    oy_f = torch.where(vflip, float(img_h), 0.0)

    th = torch.deg2rad(theta)
    c, s = torch.cos(th), torch.sin(th)
    cx0, cy0 = img_w / 2.0, img_h / 2.0

    # forward native affine p' = A p + o  with A = R diag(fx, fy),
    # o = R (f_off - ctr) + ctr + t ; R = [[c, s], [-s, c]] (cv2's
    # y-down screen convention, like rotate_image_and_labels above)
    a11 = c * fx
    a12 = s * fy
    a21 = -s * fx
    a22 = c * fy
    dox = ox_f - cx0
    doy = oy_f - cy0
    o_x = c * dox + s * doy + cx0 + tx
    o_y = -s * dox + c * doy + cy0 + ty

    # ---- labels (native coords) ----
    cx, cy, aa, bb, ang, rings = rows.unbind(-1)
    ncx = a11[:, None] * cx + a12[:, None] * cy + o_x[:, None]
    ncy = a21[:, None] * cx + a22[:, None] * cy + o_y[:, None]
    m = mode[:, None]
    ang_f = torch.where(m == 1, -ang,
                        torch.where(m == 2, 180.0 - ang,
                                    torch.where(m == 3, 180.0 + ang, ang)))
    nang = _cleanup_angle(ang_f + theta[:, None])
    new_rows = torch.stack([ncx, ncy, aa, bb, nang, rings], dim=-1)
    new_rows = torch.where(mask[..., None], new_rows, rows)

    # ---- image warp (resized coords) ----
    # p_src_r = D_n2r . A^-1 . (D_r2n p_dst_r - o); the diagonal scales
    # fold into the 2x2 coefficients and the offset
    det = a11 * a22 - a12 * a21  # = fx * fy = +/-1
    i11 = a22 / det
    i12 = -a12 / det
    i21 = -a21 / det
    i22 = a11 / det
    sx_r2n = img_w / wr
    sy_r2n = img_h / hr
    c11 = i11
    c12 = i12 * sy_r2n / sx_r2n
    c21 = i21 * sx_r2n / sy_r2n
    c22 = i22
    bx = -(i11 * o_x + i12 * o_y) / sx_r2n
    by = -(i21 * o_x + i22 * o_y) / sy_r2n

    def per_image(v):
        return v.view(-1, 1, 1)

    yd, xd = _iota(hr, wr, images.device)
    xs = per_image(c11) * xd + per_image(c12) * yd + per_image(bx)
    ys = per_image(c21) * xd + per_image(c22) * yd + per_image(by)
    out = _bilinear_sample(images, ys, xs)
    inb = (ys >= 0) & (ys <= hr - 1) & (xs >= 0) & (xs <= wr - 1)
    return torch.where(inb[..., None], out, fill), new_rows


def geo_augment_batch(images, rows, mask, generator: torch.Generator,
                      img_w: int = 512, img_h: int = 384,
                      rot_max: float = 20.0, trans_max: float = 40.0,
                      trans_prob: float = 0.9, flip_prob: float = 0.75,
                      fill: float = -1.0):
    """Batched train-time geometric augmentation WITH label remap: samples
    per-image flip / rotation / translation (`sample_geo_params`) and
    applies them as one affine (`apply_geo_batch`)."""
    params = sample_geo_params(generator, images.shape[0], rot_max,
                               trans_max, trans_prob, flip_prob)
    return apply_geo_batch(images, rows, mask, params, img_w, img_h, fill)
