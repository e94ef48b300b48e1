"""Evaluation workflow: timed inference + mAP + confusion metrics +
overlay renders + Zooniverse CSV.

Counterpart of `spnet_tpu/eval/evaluate.py` (reference
`evaluate_spnet.py:38-94`), with flip test-time augmentation
(`tta="h,v,hv"`, `eval/tta.py`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from spnet_tpu_torch.eval.metrics import calc_errors, calc_map
from spnet_tpu_torch.eval.tta import predict_tta
from spnet_tpu_torch.config import IND_NOOBJ, VARS_PER_PRED, ExperimentConfig
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.grid import denormalize
from spnet_tpu_torch.io.render import show_pred_ellipses
from spnet_tpu_torch.train.loop import predict_in_batches
from spnet_tpu_torch.train.steps import make_predict_step


def evaluate_network(
    cfg: ExperimentConfig,
    model,
    test_ds: Dataset,
    device: str | torch.device,
    log_dir: str = "logs/Testing/",
    num_draw: int | None = None,
    compute_map: bool = True,
    tta: str = "",
    verbose: int = 1,
) -> dict:
    """Returns a metrics dict (mAP, accuracies, pixel error, FPS).  tta:
    comma-separated flip modes ('h', 'v', 'hv') ensembled with the direct
    view; fps is then frames over the time of all views.  With verbose,
    it prints the host seconds of `calc_map`."""
    os.makedirs(log_dir, exist_ok=True)
    # eval predictions do not depend on the batch size: sweep the test set
    # in large batches, as the JAX package does
    infer_bs = cfg.model.clamp_infer_batch(
        max(cfg.train.batch_size, min(256, int(test_ds.x.shape[0]))))
    # stage the test set on the device once, outside the timed window
    x_eval = test_ds.x
    if getattr(x_eval, "nbytes", 0) < 4 * 1024**3:
        x_eval = torch.as_tensor(np.asarray(x_eval)).to(device)
    predict_fn = make_predict_step(model)
    decode = None
    if cfg.model.loss_type != "same":  # 'hybrid': noobj is a logit
        decode = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    if tta:
        modes = tuple(m for m in tta.split(",") if m)
        y_pred, fps = predict_tta(predict_fn, x_eval, infer_bs, device,
                                  cfg.grid, modes=modes, decode_noobj=decode,
                                  verbose=verbose)
        if verbose:
            print(f"    TTA ensemble over views: direct + {modes}")
    else:
        y_pred, fps = predict_in_batches(predict_fn, x_eval, infer_bs,
                                         device, verbose=verbose)
        if decode is not None:
            y_pred[:, IND_NOOBJ::VARS_PER_PRED] = decode(
                y_pred[:, IND_NOOBJ::VARS_PER_PRED])
    yt = denormalize(test_ds.y, cfg.grid)
    yp = denormalize(y_pred, cfg.grid)

    results = {"fps": fps}
    if compute_map:
        t0 = time.perf_counter()
        results["mAP"] = calc_map(yp, yt, cfg.grid, verbose=verbose > 1)
        map_s = time.perf_counter() - t0
        if verbose:
            print(f"mAP = {results['mAP']}")
            print(f"    (calc_map: {yp.shape[0]} frames in {map_s:.3f} s "
                  "on the host)")
    st = calc_errors(yp, yt)
    results.update(
        ring_acc=st.ring_acc,
        class_acc=st.class_acc,
        mean_pix_err=st.mean_pix_err,
        ring_truecounts=st.ring_truecounts,
        ring_miscounts=st.ring_miscounts,
        total_obj=st.total_obj,
        false_obj_pos=st.false_obj_pos,
        false_obj_neg=st.false_obj_neg,
        true_obj_pos=st.true_obj_pos,
        true_obj_neg=st.true_obj_neg,
    )
    if verbose:
        t = st.total_obj or 1
        print(f"Mean pixel error = {st.mean_pix_err}")
        print(f"    Ring correct counts = {st.ring_truecounts} / "
              f"{st.total_obj}.   = {st.ring_acc} % ring-class accuracy")
        print(f"         Ring miscounts = {st.ring_miscounts} / "
              f"{st.total_obj}.   = {100 * st.ring_miscounts / t} "
              f"% ring-miscount rate")
        print(f"        False positives = {st.false_obj_pos} / "
              f"{st.total_obj}.   = {100 * st.false_obj_pos / t} % FP rate")
        print(f"        False negatives = {st.false_obj_neg} / "
              f"{st.total_obj}.   = {100 * st.false_obj_neg / t} % FN rate")
        print(f"         True positives = {st.true_obj_pos} / "
              f"{st.total_obj}.   = {100 * st.true_obj_pos / t} % TP rate")
        print(f"         True negatives = {st.true_obj_neg}")
        print(f"    Total Mistakes = {st.mistakes} / {st.total_obj}.   "
              f"=> {st.class_acc} % class. accuracy rate (lack of "
              f"mistakes)")

    show_pred_ellipses(
        yt, yp, test_ds.file_list,
        num_draw=(num_draw if num_draw is not None else yp.shape[0]),
        log_dir=log_dir,
        out_csv=os.path.join(log_dir, "hawley_spnet.csv"),
    )
    return results
