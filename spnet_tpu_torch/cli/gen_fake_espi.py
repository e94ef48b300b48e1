"""`python -m spnet_tpu_torch gen-fake-espi` — synthesize fake ESPI frames
and their labels.

Argparse surface of `spnet_tpu/cli/gen_fake_espi.py` (reference
`gen_fake_espi.py:319-328`): -n numframes, -d datapath, -a/--all
(Train-only vs 80/20 Train/Val), plus `--device` (default `cuda`) for the
renderer.
"""

from __future__ import annotations

import argparse

from spnet_tpu_torch.cli.common import add_device_arg, resolve_device
from spnet_tpu_torch.data.synth import generate_dataset


def main(argv=None):
    p = argparse.ArgumentParser(
        description="generates synthetic ESPI-like training data",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-d", "--datapath", default=".",
                   help="directory for Train/ (and maybe Val/) subdirs")
    p.add_argument("-n", "--numframes", type=int, default=500)
    p.add_argument("-a", "--all", action="store_true",
                   help="generate Val too (80/20); default Train only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64,
                   help="frames per device render batch")
    p.add_argument("--bandpass", default=None, metavar="REAL_DIR",
                   help="directory of real frames; also emit *_bp.png "
                        "variants with real low-frequency backgrounds")
    p.add_argument("--hybrid", action="store_true",
                   help="reproduce the reference's older hybrid generator "
                        "(gen_fake_espi_hybrid.py): 0-6 antinodes/frame "
                        "with all-zeros captions for empty frames, blur "
                        "kernel {3,5}, no pixel dropout")
    p.add_argument("--blur", choices=("auto", "on", "off"), default="auto",
                   help="Gaussian blur of 30%% of frames.  'auto' = the "
                        "variant's EFFECTIVE reference behavior: OFF for "
                        "the primary generator (its blur_inplace discards "
                        "the cv2 result, gen_fake_espi.py:257), ON for "
                        "--hybrid.  'on' = the author's intended blur.")
    add_device_arg(p)
    args = p.parse_args(argv)

    generate_dataset(
        args.datapath, args.numframes, seed=args.seed,
        train_only=not args.all, batch=args.batch,
        bandpass=args.bandpass,
        variant="hybrid" if args.hybrid else "primary",
        blur=None if args.blur == "auto" else args.blur == "on",
        device=resolve_device(args.device),
    )


if __name__ == "__main__":
    main()
