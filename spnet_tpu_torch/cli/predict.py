"""`python -m spnet_tpu_torch predict` — label-free inference over a
directory of frames.

Flags mirror `spnet_tpu/cli/predict.py` (reference
`predict_spnet.py:100-115`), plus `--device`.
"""

from __future__ import annotations

import argparse

from spnet_tpu_torch.cli.common import (
    add_device_arg,
    load_model_and_state,
    resolve_device,
)
from spnet_tpu_torch.eval.predict import predict_network


def main(argv=None):
    p = argparse.ArgumentParser(
        description="predicts ellipses + ring counts on unlabeled images",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-w", "--weights", default="ckpt",
                   help="port checkpoint directory (state.pt + "
                        "experiment.json)")
    p.add_argument("-d", "--datapath", required=True,
                   help="directory of *.png / *.bmp frames")
    p.add_argument("-f", "--fraction", type=float, default=1.0)
    p.add_argument("-l", "--logdir", default="logs/Predicting/")
    p.add_argument("-b", "--batch_size", type=int, default=16)
    add_device_arg(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model, _ = load_model_and_state(args.weights, device)
    predict_network(
        cfg, model, args.datapath, device, log_dir=args.logdir,
        fraction=args.fraction, batch_size=args.batch_size,
    )


if __name__ == "__main__":
    main()
