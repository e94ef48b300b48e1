"""Ellipse-record <-> predictor-grid codec.

Pure functions replacing the reference's stateful grid assignment
(`spnet/utils.py:144-320`).  Everything takes an explicit
`GridSpec`; normalization statistics are never module globals.

Canonical ellipse record (one row, float32), matching the reference layout:
    [cx, cy, a, b, cos(2*theta), sin(2*theta), noobj, rings]
with a >= b enforced at parse time (swapping adds 90 deg to theta, which
leaves (cos 2t, sin 2t) well-defined) — reference `utils.py:272-279`.
"""

from __future__ import annotations

import numpy as np

from spnet_tpu_torch.config import (
    GridSpec,
    IND_A,
    IND_ANGLE1,
    IND_ANGLE2,
    IND_B,
    IND_CX,
    IND_CY,
    IND_NOOBJ,
    IND_RINGS,
    VARS_PER_PRED,
)


class GridOverflowError(ValueError):
    """More ellipses fell into one grid cell than there are predictor slots
    (reference behavior: bare assert at `utils.py:240`)."""


# ---------------------------------------------------------------------------
# Angle codec
# ---------------------------------------------------------------------------
def angle_deg_to_cs2(angle_deg):
    """Degrees -> (cos 2t, sin 2t) pair (reference `utils.py:279`)."""
    rad2 = 2.0 * np.deg2rad(angle_deg)
    return np.cos(rad2), np.sin(rad2)


def cs2_to_angle_deg(cos2t, sin2t):
    """(cos 2t, sin 2t) -> angle in (0, 180] degrees
    (reference `utils.py:62-63`)."""
    ang = np.rad2deg(np.arctan2(sin2t, cos2t) / 2.0)
    return np.where(ang > 0, ang, ang + 180.0)


# ---------------------------------------------------------------------------
# Record canonicalization
# ---------------------------------------------------------------------------
def canonicalize_records(raw: np.ndarray) -> np.ndarray:
    """Convert raw rows [cx, cy, a, b, angle_deg, rings] into canonical
    8-var records, applying the reference's parse rules
    (`utils.py:260-286`):

      * enforce a >= b (swap + 90 deg on violation)
      * encode angle as (cos 2t, sin 2t)
      * drop rows with rings <= 0
      * sort by (cx, cy)
      * noobj = 0 for every surviving row

    raw: (N, 6) array-like.  Returns (M, 8) float32, M <= N.
    """
    raw = np.asarray(raw, dtype=np.float64).reshape(-1, 6)
    if raw.shape[0] == 0:
        return np.zeros((0, VARS_PER_PRED), dtype=np.float32)

    keep = raw[:, 5] > 0.0
    raw = raw[keep]
    cx, cy, a, b, angle, rings = (raw[:, k] for k in range(6))

    swap = b > a
    a2 = np.where(swap, b, a)
    b2 = np.where(swap, a, b)
    angle = np.where(swap, angle + 90.0, angle)

    cos2t, sin2t = angle_deg_to_cs2(angle)
    out = np.stack(
        [cx, cy, a2, b2, cos2t, sin2t, np.zeros_like(cx), rings], axis=1
    ).astype(np.float32)

    # sort by (cx, cy) — reference sorts with itemgetter(0, 1) (`utils.py:284`)
    order = np.lexsort((out[:, IND_CY], out[:, IND_CX]))
    return out[order]


# ---------------------------------------------------------------------------
# Grid assignment (encode)
# ---------------------------------------------------------------------------
def ellipses_to_grid(
    records: np.ndarray, grid: GridSpec, on_overflow: str = "raise"
) -> np.ndarray:
    """Assign canonical ellipse records of one image to the predictor grid.

    Mirrors `true_to_pred_grid` (`utils.py:191-244`): each record lands in
    the cell containing its center (indices clipped to the grid), filling
    slots in order; empty slots keep `grid.defaults`.

    Returns an un-normalized array of shape grid.pred_shape (float32).
    on_overflow: 'raise' -> GridOverflowError when a cell receives more
    records than slots (the reference's assert, `utils.py:240`);
    'drop' -> silently skip the extra record (useful for heavily
    augmented data where rotations/translations can crowd a cell).
    """
    g = grid.defaults.copy()
    counts = np.zeros((grid.nx, grid.ny), dtype=np.int64)
    records = np.asarray(records, dtype=np.float32).reshape(-1, VARS_PER_PRED)
    for rec in records:
        ix = int((rec[IND_CX] - grid.cx_min) / grid.xbinsize)
        iy = int((rec[IND_CY] - grid.cy_min) / grid.ybinsize)
        ix = min(max(ix, 0), grid.nx - 1)
        iy = min(max(iy, 0), grid.ny - 1)
        if counts[ix, iy] >= grid.preds_per_cell:
            if on_overflow == "drop":
                continue
            raise GridOverflowError(
                f"cell ({ix},{iy}) already holds {counts[ix, iy]} ellipses; "
                f"increase preds_per_cell (currently {grid.preds_per_cell}) "
                f"or encode with on_overflow='drop'"
            )
        g[ix, iy, counts[ix, iy]] = rec
        counts[ix, iy] += 1
    return g


def batch_ellipses_to_grid(
    record_lists: list[np.ndarray], grid: GridSpec,
    on_overflow: str = "raise",
) -> np.ndarray:
    """Encode a batch of images' records. Returns (B, num_outputs) float32
    (un-normalized, flattened like the reference's Y)."""
    out = np.zeros((len(record_lists), grid.num_outputs), dtype=np.float32)
    for i, recs in enumerate(record_lists):
        out[i] = ellipses_to_grid(recs, grid, on_overflow).reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def grid_to_ellipses(
    flat_y: np.ndarray, grid: GridSpec, noobj_thresh: float = 0.5
) -> np.ndarray:
    """Decode one image's un-normalized flat grid output into ellipse
    records (K, 8) for slots whose noobj < thresh (i.e. object present)."""
    y = np.asarray(flat_y).reshape(-1, VARS_PER_PRED)
    return y[y[:, IND_NOOBJ] < noobj_thresh]


# ---------------------------------------------------------------------------
# Normalization — works on numpy arrays or tensors via broadcasting
# ---------------------------------------------------------------------------
def normalize(y, grid: GridSpec):
    """(Y - means) / ranges  (reference `norm_Y`, `utils.py:179-184`)."""
    return (y - grid.means) / grid.ranges


def denormalize(y_norm, grid: GridSpec):
    """Inverse of normalize (reference `denorm_Y`, `utils.py:186-188`)."""
    return y_norm * grid.ranges + grid.means
