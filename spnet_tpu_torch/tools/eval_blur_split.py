"""A checkpoint scored on blurred and on blur-free val frames.

    python -m spnet_tpu_torch.tools.eval_blur_split <ckpt_dir> [n_val] \\
        [--device cuda]

Counterpart of the JAX package's `scripts/eval_blur_split.py`: the same
`n_val` (4992) synthetic scenes of seed 777777 at the checkpoint's input
size, rendered with the generator's 30 % Gaussian blur and without it
(the reference's effective behaviour: its generator's blur is a no-op,
`gen_fake_espi.py:257`), each scored by `evaluate_network` (no mAP).  The
gap says how much of the ring-accuracy deficit blur explains.  Prints
one `BLUR_SPLIT {json}` line a set (val, ring_acc, class_acc,
mean_pix_err).  Runs on the card unless `--device cpu` (or
SPNET_DEVICE=cpu) asks for the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from spnet_tpu_torch.cli.common import load_model_and_state
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.tools.runtime import add_device_arg, card, memory, \
    tool_device

VAL_SEED = 777777
SETS = (("blurred(30%)", True), ("blur-free", False))


def main(argv=None) -> list:
    """The two sets' lines, as dicts."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt")
    p.add_argument("n_val", type=int, nargs="?", default=4992)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)
    card(device)
    cfg, model, _ = load_model_and_state(args.ckpt, device)
    out = []
    for label, blur in SETS:
        print(f"rendering val ({label})...", flush=True)
        ds = synthetic_dataset(args.n_val, cfg.grid, seed=VAL_SEED,
                               input_size=cfg.model.input_size, blur=blur,
                               device=device)
        res = evaluate_network(
            cfg, model, ds, device,
            log_dir=f"logs/blur_split_eval_torch_{torch.device(device).type}",
            num_draw=0, compute_map=False, verbose=1)
        line = {"val": label, **{k: res[k] for k in (
            "ring_acc", "class_acc", "mean_pix_err")}}
        print("BLUR_SPLIT " + json.dumps(line, default=float), flush=True)
        out.append(line)
    memory("after eval_blur_split", device)
    return out


if __name__ == "__main__":
    main()
