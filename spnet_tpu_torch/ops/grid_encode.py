"""On-device grid label encoding.

Counterpart of `spnet_tpu/ops/grid_encode.py`: the host codec of
`grid.py` (reference `true_to_pred_grid`, `spnet/utils.py:191-244`) as
batched tensor code with no Python loop over images, so the train step
can re-encode the labels of geometrically augmented frames on the
device.

    rows  (B, N, 6) float32  [cx, cy, a, b, angle_deg, rings]  (padded)
    mask  (B, N)    bool     slot validity
 -> flat target (B, num_outputs) float32

Semantics of the host codec: a >= b swap (+90 deg), (cos 2t, sin 2t)
from the angle in float64 as `grid.angle_deg_to_cs2` computes it, rings
<= 0 rows dropped, records sorted by (cx, cy), the cell index floored
then clipped into the grid, slots filled in sorted order, and a cell's
records past its slots dropped (on_overflow='drop').  Every slot lane is
bitwise the host codec's; the two angle lanes are torch's float64 cos /
sin rounded to float32, which can land a float32 ulp from numpy's on a
rare value.  The JAX package computes the angle lanes in float32, so its
encoder differs from the host codec (and from this one) by float32
rounding in those two lanes only.
"""

from __future__ import annotations

import torch

from spnet_tpu_torch.config import IND_CX, IND_CY, VARS_PER_PRED, GridSpec

#: Sort key of an invalid row: after every real center.
_INVALID_KEY = 1e9


def canonicalize_rows_device(rows, mask):
    """(..., N, 6) raw rows + validity mask -> (..., N, 8) canonical
    records + updated mask (rings <= 0 dropped).  The twin of
    `grid.canonicalize_records` minus the sort (done in the encoder)."""
    cx, cy, a, b, angle, rings = rows.unbind(-1)
    valid = mask & (rings > 0.0)

    swap = b > a
    a2 = torch.where(swap, b, a)
    b2 = torch.where(swap, a, b)
    # the host adds 90 and takes the cosine in float64
    angle = angle.double()
    angle = torch.where(swap, angle + 90.0, angle)
    rad2 = 2.0 * torch.deg2rad(angle)
    rec = torch.stack(
        [cx, cy, a2, b2, torch.cos(rad2).float(), torch.sin(rad2).float(),
         torch.zeros_like(cx), rings], dim=-1,
    ).float()
    return rec, valid


def encode_rows_device(rows, mask, grid: GridSpec):
    """Encode a batch of padded rows (B, N, 6) to the un-normalized flat
    grid (B, num_outputs), all images at once."""
    rows = torch.as_tensor(rows, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=rows.device)
    rec, valid = canonicalize_rows_device(rows, mask)
    b, n = valid.shape

    # sort by (cx, cy), invalid rows last: lexsort((cy, cx)) is a stable
    # sort on the secondary key, then a stable sort on the primary one
    key_cx = torch.where(valid, rec[..., IND_CX], _INVALID_KEY)
    key_cy = torch.where(valid, rec[..., IND_CY], _INVALID_KEY)
    order = torch.sort(key_cy, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(key_cx.gather(1, order), dim=1,
                                       stable=True).indices)
    rec = rec.gather(1, order[..., None].expand(b, n, VARS_PER_PRED))
    valid = valid.gather(1, order)

    # cell index: floor, then the integer, then the clip (the host's int()
    # truncates, which differs only below 0, where the clip agrees)
    ix = torch.floor((rec[..., IND_CX] - grid.cx_min) / grid.xbinsize
                     ).long().clamp(0, grid.nx - 1)
    iy = torch.floor((rec[..., IND_CY] - grid.cy_min) / grid.ybinsize
                     ).long().clamp(0, grid.ny - 1)
    cell = ix * grid.ny + iy

    # slot within cell = how many earlier (sorted) valid records share
    # the cell; N is a dozen, so the N x N mask sum is free
    same = (cell[:, None, :] == cell[:, :, None]) & valid[:, None, :]
    lower = torch.ones(n, n, dtype=torch.bool, device=rows.device).tril(-1)
    slot = (same & lower).sum(dim=-1)

    # records that do not get a slot go to one scratch row past the grid,
    # sliced off after the scatter (an out-of-range index would raise)
    slots = grid.nx * grid.ny * grid.preds_per_cell
    keep = valid & (slot < grid.preds_per_cell)
    flat_idx = torch.where(keep, cell * grid.preds_per_cell + slot, slots)
    g = torch.cat([torch.from_numpy(grid.defaults.reshape(-1, VARS_PER_PRED)),
                   torch.zeros(1, VARS_PER_PRED)]).to(rows.device)
    g = g.expand(b, slots + 1, VARS_PER_PRED).clone()
    g.scatter_(1, flat_idx[..., None].expand(b, n, VARS_PER_PRED), rec)
    return g[:, :slots].reshape(b, -1)


def encode_batch_device(rows, mask, grid: GridSpec, normalized: bool = True):
    """Batched encode: rows (B, N, 6), mask (B, N) -> (B, num_outputs).

    normalized=True applies the GridSpec normalization (the training
    target convention), (y - means) / ranges in float32 as `grid.normalize`
    does."""
    flat = encode_rows_device(rows, mask, grid)
    if normalized:
        dev = flat.device
        flat = ((flat - torch.from_numpy(grid.means).to(dev))
                / torch.from_numpy(grid.ranges).to(dev))
    return flat
