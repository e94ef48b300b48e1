"""Ring accuracy of a checkpoint, broken down: where do the misses live?

    python -m spnet_tpu_torch.tools.eval_breakdown <ckpt_dir> [n_val] \\
        [seed] [--device cuda]
    python -m spnet_tpu_torch.tools.eval_breakdown <ckpt_dir> refgen \\
        [--device cuda]

Counterpart of the JAX package's `scripts/eval_breakdown.py`: ring
correctness (|pred - true| <= 0.5, reference `diagnostics.py:45`) of
every detected object, bucketed by true ring count, by semi-minor axis
and by ring line width b / (2 rings), beside the detection confusion.
That separates "the ring regression is imprecise" from "the detector
misses".  The val set is `n_val` (4992) synthetic frames of `seed`
(777777) at the checkpoint's input size, through the disk cache
(`tools/synth_cache.py`: the same frames `tools/dataset_a.py` scored).
The `refgen` form reads the val split of the reference generator's frames
instead (`tools/refgen_run.py::load_refgen`, the N_VAL frames after
N_TRAIN, at the checkpoint's input size or 331 for a native-resolution
checkpoint, as the JAX script reads them).  Prints one line
`BREAKDOWN {json}`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from spnet_tpu_torch.cli.common import load_model_and_state
from spnet_tpu_torch.config import IND_B, IND_NOOBJ, IND_RINGS, \
    VARS_PER_PRED
from spnet_tpu_torch.grid import denormalize
from spnet_tpu_torch.tools import refgen_run
from spnet_tpu_torch.tools.runtime import add_device_arg, memory, \
    tool_device
from spnet_tpu_torch.tools.synth_cache import cached_synth
from spnet_tpu_torch.train.loop import predict_in_batches
from spnet_tpu_torch.train.steps import make_predict_step

B_BUCKETS = ((0, 25), (25, 40), (40, 60), (60, 90), (90, 1000))
LINE_WIDTH_BUCKETS = ((0, 3), (3, 5), (5, 8), (8, 1000))


def breakdown(yt_denorm: np.ndarray, yp_denorm: np.ndarray) -> dict:
    """The breakdown of denormalized truth and predictions, (N, M) each:
    detection confusion over the slots, ring accuracy in all and given a
    true positive, and the latter by true rings, semi-minor axis and ring
    line width (buckets without true positives are left out)."""
    n = yt_denorm.shape[0]
    yt = yt_denorm.reshape(n, -1, VARS_PER_PRED)
    yp = yp_denorm.reshape(n, -1, VARS_PER_PRED)
    t_obj = np.rint(yt[..., IND_NOOBJ]) == 0
    p_obj = np.rint(yp[..., IND_NOOBJ]) == 0
    tp = t_obj & p_obj
    ring_err = np.abs(yt[..., IND_RINGS] - yp[..., IND_RINGS])
    ok = ring_err <= 0.5

    out = {
        "n_true": int(t_obj.sum()),
        "tp_rate": round(float(tp.sum() / t_obj.sum()) * 100, 2),
        "fn": int((t_obj & ~p_obj).sum()),
        "fp": int((~t_obj & p_obj).sum()),
        "ring_acc_total": round(
            float((tp & ok).sum() / t_obj.sum()) * 100, 2),
        "ring_acc_given_tp": round(
            float((tp & ok).sum() / tp.sum()) * 100, 2),
        "mean_ring_err_tp": round(float(ring_err[tp].mean()), 4),
    }
    rings_t = np.rint(yt[..., IND_RINGS]).astype(int)
    by_rings = {}
    for r in range(1, 12):
        m = tp & (rings_t == r)
        if m.sum():
            by_rings[r] = round(float(ok[m].mean()) * 100, 1)
    out["ring_acc_by_true_rings"] = by_rings
    b_t = yt[..., IND_B]
    by_b = {}
    for lo, hi in B_BUCKETS:
        m = tp & (b_t >= lo) & (b_t < hi)
        if m.sum():
            by_b[f"{lo}-{hi}"] = round(float(ok[m].mean()) * 100, 1)
    out["ring_acc_by_b"] = by_b
    lw = b_t / np.maximum(2 * rings_t, 1)
    by_lw = {}
    for lo, hi in LINE_WIDTH_BUCKETS:
        m = tp & (lw >= lo) & (lw < hi)
        if m.sum():
            by_lw[f"{lo}-{hi}px"] = round(float(ok[m].mean()) * 100, 1)
    out["ring_acc_by_line_width"] = by_lw
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt")
    p.add_argument("n_val", nargs="?", default="4992")
    p.add_argument("seed", type=int, nargs="?", default=777777)
    add_device_arg(p)
    args = p.parse_args(argv)
    refgen = args.n_val == "refgen"
    n_val = refgen_run.N_VAL if refgen else int(args.n_val)
    device = tool_device(args.device)
    cfg, model, _ = load_model_and_state(args.ckpt, device)
    if refgen:
        _, ds = refgen_run.load_refgen(refgen_run.N_TRAIN, n_val, cfg.grid,
                                       size=cfg.model.input_size or 331)
    else:
        ds = cached_synth(n_val, cfg, seed=args.seed, device=device)
    y_pred, _ = predict_in_batches(make_predict_step(model), ds.x, 256,
                                   device)
    out = breakdown(denormalize(ds.y, cfg.grid),
                    denormalize(y_pred, cfg.grid))
    memory("after eval_breakdown", device)
    print("BREAKDOWN " + json.dumps(out, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
