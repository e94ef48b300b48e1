"""Rasterized-ellipse IoU by row-interval counting, in float32.

Counterpart of `spnet_tpu/ops/raster.py` (`pair_iou` with its `aa` mode).
For each row y of the (h, w) frame, the pixel centers covered by a rotated
ellipse form one integer interval, found by solving a quadratic in x;
counting integers in interval intersections gives the pixel IoU of a
center-sampled rasterization without building masks.  The arithmetic is
float32, in the JAX version's order: `ceil` and `floor` at pixel
boundaries change the count when the quadratic is solved in another
precision.  The work is (pairs x rows) elementwise tensor math, run on
whatever device the records are on.
"""

from __future__ import annotations

import torch

from spnet_tpu_torch.config import ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH

#: Half-pixel boundary dilation (see the JAX module's docstring).
BOUNDARY_PAD = 0.5
#: Dilation reproducing the reference's AA-rim-as-opaque masks.
BOUNDARY_PAD_AA = 1.5


def _row_intervals(cx, cy, a, b, theta, h: int, w: int,
                   pad: float = BOUNDARY_PAD):
    """Integer coverage interval per row for K ellipses.

    cx, cy, a, b, theta: (K,) float32.  Returns (lo, hi), int32 (K, h):
    row y covers integer x in [lo, hi] (empty iff lo > hi)."""
    a = (torch.clamp_min(a, 0.0) + pad)[:, None]
    b = (torch.clamp_min(b, 0.0) + pad)[:, None]
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    cx, cy = cx[:, None], cy[:, None]
    inv_a2 = 1.0 / (a * a)
    inv_b2 = 1.0 / (b * b)

    y = torch.arange(h, dtype=torch.float32, device=cx.device)[None, :]
    dy = y - cy
    # quadratic A*dx^2 + B*dx + C <= 0
    A = c * c * inv_a2 + s * s * inv_b2
    B = 2.0 * c * s * dy * (inv_a2 - inv_b2)
    C = dy * dy * (s * s * inv_a2 + c * c * inv_b2) - 1.0
    disc = B * B - 4.0 * A * C
    valid = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    x0 = cx + (-B - sq) / (2.0 * A)
    x1 = cx + (-B + sq) / (2.0 * A)
    lo = torch.clamp_min(torch.ceil(x0), 0.0).to(torch.int32)
    hi = torch.clamp_max(torch.floor(x1), float(w - 1)).to(torch.int32)
    lo = torch.where(valid, lo, 1)
    hi = torch.where(valid, hi, 0)
    return lo, hi


def _params_to_geom(recs):
    """(K, 8) records -> (cx, cy, a, b, theta_rad, present), each (K,).

    theta is NEGATED to match the reference's drawing convention; present
    iff noobj < 0.5."""
    cx, cy, a, b, cos2t, sin2t, noobj = recs[:, :7].unbind(1)
    theta = -torch.atan2(sin2t, cos2t) / 2.0
    return cx, cy, a, b, theta, noobj < 0.5


def pair_counts(recs_p, recs_t, h: int = ORIG_IMG_HEIGHT,
                w: int = ORIG_IMG_WIDTH, pad: float = BOUNDARY_PAD):
    """Covered-pixel counts (pred, true, intersection), each (K,) int64.
    An absent ellipse covers nothing."""
    cxp, cyp, ap, bp, thp, pres_p = _params_to_geom(recs_p)
    cxt, cyt, at, bt, tht, pres_t = _params_to_geom(recs_t)
    lo_p, hi_p = _row_intervals(cxp, cyp, ap, bp, thp, h, w, pad)
    lo_t, hi_t = _row_intervals(cxt, cyt, at, bt, tht, h, w, pad)
    lo_p = torch.where(pres_p[:, None], lo_p, 1)
    hi_p = torch.where(pres_p[:, None], hi_p, 0)
    lo_t = torch.where(pres_t[:, None], lo_t, 1)
    hi_t = torch.where(pres_t[:, None], hi_t, 0)
    cnt_p = torch.clamp_min(hi_p - lo_p + 1, 0).sum(1)
    cnt_t = torch.clamp_min(hi_t - lo_t + 1, 0).sum(1)
    cnt_i = torch.clamp_min(
        torch.minimum(hi_p, hi_t) - torch.maximum(lo_p, lo_t) + 1, 0).sum(1)
    return cnt_p, cnt_t, cnt_i


def pair_iou(recs_p, recs_t, h: int = ORIG_IMG_HEIGHT,
             w: int = ORIG_IMG_WIDTH, aa: bool = False):
    """Batched pairwise ellipse IoU of (K, 8) denormalized records
    [cx, cy, a, b, cos2t, sin2t, noobj, rings].

    Returns (K,) float32: -1 where the true object is absent
    (noobj > 0.99) or both masks are empty, else |A & B| / |A | B|.
    aa=True dilates by 1.5 px, reproducing the reference's
    anti-aliased-rim-as-opaque masks."""
    recs_p = torch.as_tensor(recs_p, dtype=torch.float32)
    recs_t = torch.as_tensor(recs_t, dtype=torch.float32)
    pad = BOUNDARY_PAD_AA if aa else BOUNDARY_PAD
    num_p, num_t, num_i = pair_counts(recs_p, recs_t, h, w, pad)
    num_u = num_p + num_t - num_i
    iou = torch.where(num_u > 0,
                      num_i.float() / torch.clamp_min(num_u, 1).float(),
                      -1.0)
    return torch.where(recs_t[:, 6] > 0.99, -1.0, iou)
