"""`python -m spnet_tpu_torch export` — a port checkpoint -> a
`torch.export` serving artifact (`io/export.py`).  Flags mirror
`spnet_tpu/cli/export.py`, with `--device` (default `cuda`) in place of
`--platforms`: the artifact runs on the device it was exported on."""

from __future__ import annotations

import argparse

from spnet_tpu_torch.cli.common import add_device_arg, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(
        description="export a trained checkpoint as a torch.export "
                    "inference artifact",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-w", "--weights", default="ckpt",
                   help="checkpoint directory")
    p.add_argument("-o", "--out", default="export",
                   help="output artifact directory")
    p.add_argument("-b", "--batch_size", type=int, default=0,
                   help="0 = symbolic batch dimension")
    add_device_arg(p)
    args = p.parse_args(argv)

    from spnet_tpu_torch.io.export import export_predictor

    out = export_predictor(args.weights, args.out,
                           batch_size=args.batch_size or None,
                           device=resolve_device(args.device))
    print(f"exported serving artifact to {out}")


if __name__ == "__main__":
    main()
