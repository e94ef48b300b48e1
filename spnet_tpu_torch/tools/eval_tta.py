"""Flip test-time augmentation of a trained checkpoint on its val set.

    python -m spnet_tpu_torch.tools.eval_tta <ckpt_dir> [synth|refgen] \\
        [modes] [--device cuda]

Counterpart of the JAX package's `scripts/eval_tta.py`: `evaluate_network`
once as a single sweep (the reference's protocol) and once with the flip
ensemble (direct + `modes`, default 'h,v,hv'); between them, unless
SPNET_TTA_PER_VIEW=0, each flipped view alone, flipped back and
re-encoded into the truth's cell convention (`eval/tta.py`), scored by
`calc_errors`.  A view far below the direct one means the model is not
flip-equivariant and no merge can help.  The val set ('synth') is the
4,992 synthetic frames of seed 777777 at the checkpoint's input size from
the disk cache (`tools/synth_cache.py`; generated when absent), or
('refgen') the val split of the reference generator's frames
(`tools/refgen_run.py::load_refgen`: the N_VAL frames after N_TRAIN, at
the checkpoint's input size or 331 for a native-resolution checkpoint, as
the JAX script reads them).  Prints one line `EVAL_TTA_RESULT {json}`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from spnet_tpu_torch.cli.common import load_model_and_state
from spnet_tpu_torch.config import IND_NOOBJ, VARS_PER_PRED
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.eval.metrics import calc_errors
from spnet_tpu_torch.eval.tta import flip_images, flipback_grid, \
    reencode_view
from spnet_tpu_torch.grid import denormalize
from spnet_tpu_torch.tools import refgen_run
from spnet_tpu_torch.tools.runtime import add_device_arg, memory, \
    tool_device
from spnet_tpu_torch.tools.synth_cache import cached_synth
from spnet_tpu_torch.train.loop import predict_in_batches
from spnet_tpu_torch.train.steps import make_predict_step

VAL_FRAMES, VAL_SEED = 4992, 777777


def per_view(cfg, model, val_ds, modes: str, device) -> dict:
    """{mode: ring_acc, class_acc, mean_pix_err, fp, fn} of each flipped
    view alone, in the direct frame's slot convention."""
    predict_fn = make_predict_step(model)
    x_dev = torch.as_tensor(np.asarray(val_ds.x)).to(device)
    yt = denormalize(val_ds.y, cfg.grid)
    out = {}
    for mode in [m for m in modes.split(",") if m]:
        y_v, _ = predict_in_batches(predict_fn, flip_images(x_dev, mode),
                                    256, device, verbose=False)
        if cfg.model.loss_type != "same":  # 'hybrid': noobj is a logit
            y_v[:, IND_NOOBJ::VARS_PER_PRED] = 1.0 / (
                1.0 + np.exp(-y_v[:, IND_NOOBJ::VARS_PER_PRED]))
        yp_v = reencode_view(
            flipback_grid(denormalize(y_v, cfg.grid), mode, cfg.grid),
            cfg.grid)
        st = calc_errors(yp_v, yt)
        out[mode] = {"ring_acc": st.ring_acc, "class_acc": st.class_acc,
                     "mean_pix_err": st.mean_pix_err,
                     "fp": st.false_obj_pos, "fn": st.false_obj_neg}
        print(f"  view {mode!r}: ring_acc {st.ring_acc:.2f}%  "
              f"class_acc {st.class_acc:.2f}%  pix_err "
              f"{st.mean_pix_err:.2f}  FP {st.false_obj_pos}  "
              f"FN {st.false_obj_neg}", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt")
    p.add_argument("source", nargs="?", default="synth")
    p.add_argument("modes", nargs="?", default="h,v,hv")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.source not in ("synth", "refgen"):
        raise SystemExit(f"eval_tta: source {args.source!r}: 'synth' or "
                         "'refgen'")
    device = tool_device(args.device)
    cfg, model, step = load_model_and_state(args.ckpt, device)
    print(f"checkpoint {args.ckpt}: {cfg.model.backbone} "
          f"input_size={cfg.model.input_size} step={step}")
    if args.source == "refgen":
        _, val_ds = refgen_run.load_refgen(
            refgen_run.N_TRAIN, refgen_run.N_VAL, cfg.grid,
            size=cfg.model.input_size or 331)
    else:
        val_ds = cached_synth(VAL_FRAMES, cfg, seed=VAL_SEED, device=device)
    print(f"val set: {val_ds.x.shape} from {args.source}")

    out = {"ckpt": args.ckpt, "source": args.source, "modes": args.modes}
    res_plain = evaluate_network(cfg, model, val_ds, device,
                                 log_dir="logs/tta_eval/plain/",
                                 num_draw=0, verbose=1)
    out["plain"] = res_plain
    if os.environ.get("SPNET_TTA_PER_VIEW", "1") == "1":
        out["per_view"] = per_view(cfg, model, val_ds, args.modes, device)
    res_tta = evaluate_network(cfg, model, val_ds, device,
                               log_dir="logs/tta_eval/tta/", num_draw=0,
                               tta=args.modes, verbose=1)
    out["tta"] = res_tta
    memory("after eval_tta", device)
    print(f"\nplain: ring_acc {res_plain['ring_acc']:.2f}%  "
          f"mAP {res_plain.get('mAP', 0):.4f}  fps {res_plain['fps']:.0f}")
    print(f"tta:   ring_acc {res_tta['ring_acc']:.2f}%  "
          f"mAP {res_tta.get('mAP', 0):.4f}  fps {res_tta['fps']:.0f}")
    print("EVAL_TTA_RESULT " + json.dumps(out, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
