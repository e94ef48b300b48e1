"""Evaluation metrics: detection/ring confusion stats, precision @ IoU, mAP.

Counterpart of `spnet_tpu/eval/metrics.py` (which imports jax for its
IoU), with the same reference semantics and quirks
(the reference's `spnet/diagnostics.py`):

  * a grid slot with no true object is skipped entirely, so false
    positives are structurally impossible in the precision metric;
  * a (pred present, true present) pair whose IoU fails the threshold is
    NOT counted in the denominator;
  * precision = tp / (tp + fp + fn) with fp always 0;
  * `class_acc` counts false positives over all slots against
    `total_obj`, so it can go negative (reference `callbacks.py:166`).

The IoUs come from the port's row-interval counter (`ops/raster.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spnet_tpu_torch.ops.raster import pair_iou
from spnet_tpu_torch.config import (
    IND_NOOBJ, IND_RINGS, VARS_PER_PRED, GridSpec,
)

#: COCO-style IoU thresholds (reference `diagnostics.py:155`).
MAP_THRESHOLDS = tuple(np.arange(0.50, 0.951, 0.05).round(2))


@dataclasses.dataclass
class ErrorStats:
    """Field-for-field equivalent of the reference's `calc_errors` return
    (`diagnostics.py:13-59`)."""

    ring_miscounts: int
    ring_truecounts: int
    total_obj: int
    false_obj_pos: int
    false_obj_neg: int
    true_obj_pos: int
    true_obj_neg: int
    pix_err: np.ndarray  # (N,) center error of grid slot 0, per image
    ipem: int  # index of max pixel error

    @property
    def mistakes(self) -> int:
        # reference `callbacks.py:165`
        return self.ring_miscounts + self.false_obj_pos + self.false_obj_neg

    @property
    def class_acc(self) -> float:
        # "accuracy from lack of any mistakes" (reference `callbacks.py:166`)
        if self.total_obj == 0:
            return float("nan")
        return (self.total_obj - self.mistakes) / self.total_obj * 100.0

    @property
    def ring_acc(self) -> float:
        if self.total_obj == 0:
            return float("nan")
        return self.ring_truecounts / self.total_obj * 100.0

    @property
    def mean_pix_err(self) -> float:
        return float(np.mean(self.pix_err))


def calc_errors(Yp: np.ndarray, Yt: np.ndarray) -> ErrorStats:
    """Confusion and ring stats of denormalized (N, num_outputs) arrays.
    Like the reference, pix_err uses only the FIRST grid slot's (cx, cy)
    (`diagnostics.py:25`)."""
    Yp = np.asarray(Yp, dtype=np.float64)
    Yt = np.asarray(Yt, dtype=np.float64)
    n, m = Yt.shape
    s = m // VARS_PER_PRED
    p3 = Yp.reshape(n, s, VARS_PER_PRED)
    t3 = Yt.reshape(n, s, VARS_PER_PRED)

    diff = Yp - Yt
    pix_err = np.sqrt(diff[:, 0] ** 2 + diff[:, 1] ** 2)
    ipem = int(np.argmax(pix_err))

    t_obj = np.rint(t3[..., IND_NOOBJ]) == 0
    p_obj = np.rint(p3[..., IND_NOOBJ]) == 0
    tp = t_obj & p_obj
    ring_off = np.abs(t3[..., IND_RINGS] - p3[..., IND_RINGS]) > 0.5

    return ErrorStats(
        ring_miscounts=int((tp & ring_off).sum()),
        ring_truecounts=int((tp & ~ring_off).sum()),
        total_obj=int(t_obj.sum()),
        false_obj_pos=int((~t_obj & p_obj).sum()),
        false_obj_neg=int((t_obj & ~p_obj).sum()),
        true_obj_pos=int(tp.sum()),
        true_obj_neg=int((~t_obj & ~p_obj).sum()),
        pix_err=pix_err,
        ipem=ipem,
    )


def slot_ious(
    Yp: np.ndarray,
    Yt: np.ndarray,
    grid: GridSpec | None = None,
    chunk: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """IoU for every (image, slot) pair where a TRUE object exists.

    Returns (ious, fn_mask): (K,) float32 IoUs of the true-present slots
    in row-major (image, slot) order, and (K,) bool, True where the
    prediction is absent (pred noobj >= 0.5, unrounded, as the reference
    rasterizer decides, `diagnostics.py:75`)."""
    h = grid.img_height if grid is not None else 384
    w = grid.img_width if grid is not None else 512
    Yp = np.asarray(Yp, dtype=np.float32)
    Yt = np.asarray(Yt, dtype=np.float32)
    n, m = Yt.shape
    s = m // VARS_PER_PRED
    p3 = Yp.reshape(n * s, VARS_PER_PRED)
    t3 = Yt.reshape(n * s, VARS_PER_PRED)

    idx = np.nonzero(t3[:, IND_NOOBJ] <= 0.99)[0]
    if idx.size == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), bool)

    ious = np.empty((idx.size,), dtype=np.float32)
    for st in range(0, idx.size, chunk):
        sl = idx[st : st + chunk]
        ious[st : st + chunk] = pair_iou(p3[sl], t3[sl], h=h, w=w).numpy()
    fn_mask = p3[idx, IND_NOOBJ] >= 0.5
    return ious, fn_mask


def precision_from_ious(
    ious: np.ndarray, fn_mask: np.ndarray, thresh: float
) -> tuple[float, int, int, int]:
    """precision, tp, fp, fn at one threshold (reference semantics, see
    module docstring)."""
    tp = int((ious > thresh).sum())
    fn = int(fn_mask.sum())
    fp = 0  # structurally unreachable in the reference metric
    denom = tp + fp + fn
    prec = tp / denom if denom > 0 else 0.0
    return prec, tp, fp, fn


def calc_map(
    Yp: np.ndarray,
    Yt: np.ndarray,
    grid: GridSpec | None = None,
    verbose: bool = False,
) -> float:
    """Mean precision over IoU 0.50:0.05:0.95 (reference
    `diagnostics.py:152-161`); the IoUs are computed once and reused
    across thresholds."""
    ious, fn_mask = slot_ious(Yp, Yt, grid)
    total = 0.0
    for t in MAP_THRESHOLDS:
        prec, tp, fp, fn = precision_from_ious(ious, fn_mask, float(t))
        if verbose:
            print(
                f"precision: thresh = {t}, tp, fp, fn = {tp} {fp} {fn} "
                f"-> {prec}"
            )
        total += prec
    return total / len(MAP_THRESHOLDS)
