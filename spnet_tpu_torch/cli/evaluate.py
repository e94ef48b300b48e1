"""`python -m spnet_tpu_torch evaluate` — score a model on a labeled
dataset.

Flags mirror `spnet_tpu/cli/evaluate.py` (reference
`evaluate_spnet.py:97-111`), plus `--device`.  `--tta h,v,hv` ensembles
flipped views with the direct one (`eval/tta.py`).
"""

from __future__ import annotations

import argparse
import os

from spnet_tpu_torch.cli.common import (
    add_device_arg,
    load_model_and_state,
    resolve_device,
)
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.io.checkpoint import save_checkpoint
from spnet_tpu_torch.data.dataset import build_dataset


def main(argv=None):
    p = argparse.ArgumentParser(
        description="tests network on test dataset",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-w", "--weights", default="ckpt",
                   help="port checkpoint directory (state.pt + "
                        "experiment.json)")
    p.add_argument("-d", "--datapath", default="Test/")
    p.add_argument("-f", "--fraction", type=float, default=1.0)
    p.add_argument("-l", "--logdir", default="logs/Testing/")
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("--no-map", action="store_true",
                   help="skip the (rasterized-IoU) mAP computation")
    p.add_argument("--tta", default="",
                   help="test-time flip augmentation: comma-separated "
                        "modes from h,v,hv (e.g. 'h,v,hv'); empty = off")
    add_device_arg(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model, step = load_model_and_state(args.weights, device)
    ds = build_dataset(
        args.datapath, cfg.grid, load_frac=args.fraction,
        batch_size=args.batch_size, shuffle=False,
        input_size=cfg.model.input_size or None,
    )
    evaluate_network(cfg, model, ds, device, log_dir=args.logdir,
                     compute_map=not args.no_map, tta=args.tta)

    # post-evaluation weights artifact (reference saves
    # `eval_end_weights.hdf5` after evaluating, evaluate_spnet.py:118-120)
    out_dir = os.path.join(args.logdir, "eval_end_weights")
    save_checkpoint(out_dir, model.state_dict(), cfg, step)
    print(f"eval-end weights + config saved to {out_dir}")


if __name__ == "__main__":
    main()
