"""Test-time augmentation (flip ensembling) for evaluation/prediction.

Counterpart of `spnet_tpu/eval/tta.py`: its numpy functions copied as
they are, and `predict_tta` over the port's `predict_in_batches`, with
the flips on the device when the frames are there.

A capability the reference does not have (its eval path is a single
`model.predict`, `evaluate_spnet.py:64-68`).

Mechanics.  The predictor grid (GridSpec, `grid.py`) is (nx, ny,
slots, 8) with x-major cells.  A mirrored input image produces a
mirrored prediction grid; `flipback_grid` maps it back into the direct
frame:

  * 'h' (left-right mirror): reverse the nx axis; cx := W - cx;
    ellipse mirror negates the angle, i.e. sin2θ := -sin2θ.
  * 'v' (top-bottom): reverse ny; cy := H - cy; sin2θ := -sin2θ.
  * 'hv' (180° rotation): both reversals and reflections; sin2θ (and
    cos2θ) unchanged (θ+180° ≡ θ for an ellipse).

The flipped-back views are merged into the DIRECT view's cell/slot
structure (which is the convention the truth grid uses) at the OBJECT
level, not the slot level.  Slot-level merging is unsound here: the
grid's active region ([cx_min, cx_min + nx*xbinsize] etc., config.py)
is NOT symmetric under cx -> W - cx, so the flipped view's cell
partition, mapped back into the direct frame, is a ~6 px-shifted
partition of the image — an object within that shift of a cell
boundary legitimately sits in a DIFFERENT cell than the index
reversal predicts (~8-15 % of objects per view), and any per-cell
pairing then votes "absent" in two cells at once (measured: FP rate
2.6 % -> 7.4 % on a 96.2 %-ring-acc checkpoint).  Instead:

  * decode every view to ellipse records (slots with noobj < 0.5) in
    absolute direct-frame coordinates — which cell a record came from
    no longer matters;
  * match each DIRECT detection to at most one record per view by
    nearest center within `match_radius`; geometry/rings are averaged
    weighted by each view's existence probability (1 - noobj), and
    existence becomes the ensemble mean over ALL views (a view that
    saw nothing votes 0) — all IN PLACE in the direct slot, so the
    direct view's learned cell/slot convention (the one the truth grid
    uses) is preserved;
  * leftover flipped-view records are clustered among themselves; a
    cluster whose ensemble existence clears 0.5 is a detection the
    direct view missed and is written into a free slot of the cell
    containing its center.
"""

from __future__ import annotations

import numpy as np
import torch

from spnet_tpu_torch.config import (
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

TTA_MODES = ("h", "v", "hv")


def flip_images(x, mode: str):
    """Mirror a (B, H, W, C) image batch: a numpy array (copied, so that
    torch can take it), or a tensor on its own device."""
    dims = {"h": (2,), "v": (1,), "hv": (1, 2)}.get(mode)
    if dims is None:
        raise ValueError(f"unknown TTA mode {mode!r} (use one of "
                         f"{TTA_MODES})")
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(np.flip(x, axis=dims))
    return torch.flip(x, dims)


def flipback_grid(yp_denorm: np.ndarray, mode: str, grid) -> np.ndarray:
    """Map a DENORMALIZED prediction tensor obtained from flipped inputs
    back into the direct frame.  yp_denorm: (B, num_outputs) or
    (B, nx, ny, slots, 8).  Returns (B, nx, ny, slots, 8)."""
    g = np.array(yp_denorm, dtype=np.float32).reshape(
        (-1,) + grid.pred_shape)
    if "h" in mode:
        g = g[:, ::-1]
        g[..., IND_CX] = grid.img_width - g[..., IND_CX]
        g[..., IND_ANGLE2] = -g[..., IND_ANGLE2]
    if "v" in mode:
        g = g[:, :, ::-1]
        g[..., IND_CY] = grid.img_height - g[..., IND_CY]
        g[..., IND_ANGLE2] = -g[..., IND_ANGLE2]
    return np.ascontiguousarray(g)


_GEOM = (IND_CX, IND_CY, IND_A, IND_B, IND_ANGLE1, IND_ANGLE2, IND_RINGS)


def _decode_view(v_img: np.ndarray) -> np.ndarray:
    """One image's (nx, ny, S, 8) denormalized grid -> (K, 8) records of
    the slots with an object (noobj < 0.5)."""
    flat = v_img.reshape(-1, v_img.shape[-1])
    return flat[flat[:, IND_NOOBJ] < 0.5]


def merge_views(direct_denorm: np.ndarray, views_denorm: list[np.ndarray],
                grid, match_radius: float = 20.0) -> np.ndarray:
    """Object-level ensemble of flipped-back views into the direct
    prediction (see module docstring for why slot-level is unsound).

    All inputs DENORMALIZED; direct: (B, num_outputs) or 5-D; views:
    5-D tensors from `flipback_grid`.  Returns (B, num_outputs)
    denormalized, preserving the direct view's cell/slot structure for
    every direct detection."""
    d = np.array(direct_denorm, dtype=np.float32).reshape(
        (-1,) + grid.pred_shape)
    nv = 1 + len(views_denorm)
    geom = list(_GEOM)
    nx, ny, s = grid.pred_shape[:3]
    for ib in range(d.shape[0]):
        img = d[ib]
        flat = img.reshape(-1, img.shape[-1])
        det_idx = np.flatnonzero(flat[:, IND_NOOBJ] < 0.5)
        # per-view unconsumed decoded records
        view_recs = [_decode_view(v[ib]) for v in views_denorm]
        used = [np.zeros(len(r), bool) for r in view_recs]
        for k in det_idx:
            rec = flat[k]
            p = np.clip(1.0 - rec[IND_NOOBJ], 0.0, 1.0)
            wsum, gsum, psum = p, p * rec[geom], p
            for vi, recs in enumerate(view_recs):
                if len(recs) == 0:
                    continue
                dist = np.hypot(recs[:, IND_CX] - rec[IND_CX],
                                recs[:, IND_CY] - rec[IND_CY])
                dist = np.where(used[vi], np.inf, dist)
                j = int(np.argmin(dist))
                if dist[j] <= match_radius:
                    used[vi][j] = True
                    pv = np.clip(1.0 - recs[j, IND_NOOBJ], 0.0, 1.0)
                    wsum += pv
                    gsum = gsum + pv * recs[j, geom]
                    psum += pv
            if wsum > 1e-6:
                flat[k, geom] = gsum / wsum
            flat[k, IND_NOOBJ] = 1.0 - psum / nv
        # leftover view records: cluster among themselves; strong
        # clusters are detections the direct view missed
        rest = [r[~u] for r, u in zip(view_recs, used)]
        pool = (np.concatenate(rest, axis=0)
                if rest else np.zeros((0, flat.shape[1]), np.float32))
        taken = np.zeros(len(pool), bool)
        order = np.argsort(pool[:, IND_NOOBJ]) if len(pool) else []
        for k in order:
            if taken[k]:
                continue
            taken[k] = True
            members = [pool[k]]
            for j in range(len(pool)):
                if taken[j]:
                    continue
                if np.hypot(pool[j, IND_CX] - pool[k, IND_CX],
                            pool[j, IND_CY] - pool[k, IND_CY]) \
                        <= match_radius:
                    taken[j] = True
                    members.append(pool[j])
            ps = np.clip(1.0 - np.array([m[IND_NOOBJ] for m in members]),
                         0.0, 1.0)
            p_ens = float(ps.sum()) / nv
            if p_ens < 0.5:
                continue
            g = (ps[:, None] * np.stack(members)).sum(0) / max(
                float(ps.sum()), 1e-6)
            ix = min(max(int((g[IND_CX] - grid.cx_min) / grid.xbinsize),
                         0), nx - 1)
            iy = min(max(int((g[IND_CY] - grid.cy_min) / grid.ybinsize),
                         0), ny - 1)
            free = np.flatnonzero(img[ix, iy, :, IND_NOOBJ] >= 0.5)
            if len(free) == 0:
                continue
            img[ix, iy, free[0], geom] = g[geom]
            img[ix, iy, free[0], IND_NOOBJ] = 1.0 - p_ens
    return d.reshape(len(d), grid.num_outputs)


def reencode_view(view_denorm: np.ndarray, grid) -> np.ndarray:
    """Re-encode one flipped-back view into the truth grid convention.

    The flipped view's cell partition mapped back to the direct frame is
    a shifted partition (module docstring), so slot-aligned metrics on
    the raw flipped-back grid unfairly count boundary-band objects as
    FN+FP pairs.  Decoding to records and re-assigning by the truth rule
    (cell containing the center, slots in (cx, cy) order) makes a single
    view's quality directly comparable to the direct view's.  Returns
    (B, num_outputs) denormalized."""
    from spnet_tpu_torch.grid import batch_ellipses_to_grid

    v = np.asarray(view_denorm, np.float32).reshape(
        (-1,) + grid.pred_shape)
    record_lists = []
    for ib in range(v.shape[0]):
        recs = _decode_view(v[ib])
        order = np.lexsort((recs[:, IND_CY], recs[:, IND_CX]))
        record_lists.append(recs[order])
    out = batch_ellipses_to_grid(record_lists, grid, on_overflow="drop")
    # batch_ellipses_to_grid leaves empty slots at grid.defaults
    # (noobj=1); occupied slots keep their decoded noobj (<0.5)
    return out


def predict_tta(predict_fn, x_eval, infer_bs: int, device, grid,
                modes=TTA_MODES, decode_noobj=None, verbose: int = 0):
    """Run the direct sweep plus one sweep per flip mode and merge.

    Returns (y_pred_normalized (B, num_outputs) np.ndarray, fps) where
    fps counts frames / TOTAL predict time over all views (the honest
    ensemble throughput).  x_eval may live on `device` (preferred: the
    flips then run there with no extra host traffic).

    decode_noobj: optional callable applied IN PLACE of the raw noobj
    columns of each view's normalized output before merging — pass a
    sigmoid when the model emits existence logits (loss_type != 'same',
    the reference's post-hoc decode at `evaluate_spnet.py:70-71`).
    """
    from spnet_tpu_torch.grid import denormalize, normalize
    from spnet_tpu_torch.train.loop import predict_in_batches

    def sweep(x):
        y, fps = predict_in_batches(predict_fn, x, infer_bs, device,
                                    verbose=verbose)
        if decode_noobj is not None:
            y[:, IND_NOOBJ::VARS_PER_PRED] = decode_noobj(
                y[:, IND_NOOBJ::VARS_PER_PRED])
        return y, fps

    y_d, fps_d = sweep(x_eval)
    n = y_d.shape[0]
    total_t = n / max(fps_d, 1e-9)
    views = []
    for mode in modes:
        y_v, fps_v = sweep(flip_images(x_eval, mode))
        total_t += n / max(fps_v, 1e-9)
        views.append(flipback_grid(denormalize(y_v, grid), mode, grid))
    merged = merge_views(denormalize(y_d, grid), views, grid)
    return np.asarray(normalize(merged, grid), dtype=np.float32), (
        n / total_t)
