"""The data half of the Dataset-D experiment: generation, then the offline
inflation.

    python -m spnet_tpu_torch.tools.dataset_d_prep [n_train] [n_val] \\
        [n_augs] [--device cuda]

Counterpart of the JAX package's `scripts/dataset_d_prep.py` (defaults
1,280 / 640 / 42): the generation stage of `tools/dataset_d.py` (same
seeds, same directory), then its inflation with the marker, so that a
later `tools.dataset_d` finds Train/, Val/ and `inflate_done.json` and
goes straight to training.  Prints `DATAGEN_DONE <s>s`, then `already
complete: <marker>` or `INFLATE_DONE <s>s`.  Runs on the card unless
`--device cpu` (or SPNET_DEVICE=cpu) asks for the CPU; the JAX script
forces the CPU, where its warps were cheaper than on its relayed TPU.
"""

from __future__ import annotations

import argparse
import os

from spnet_tpu_torch.tools import dataset_d
from spnet_tpu_torch.tools.runtime import add_device_arg, tool_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_train", type=int, nargs="?", default=1280)
    p.add_argument("n_val", type=int, nargs="?", default=640)
    p.add_argument("n_augs", type=int, nargs="?", default=42)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)
    wd = dataset_d.workdir(device)
    seconds = dataset_d.generate(wd, args.n_train, args.n_val, device)
    print(f"DATAGEN_DONE {seconds:.1f}s", flush=True)
    finish_inflation(wd, args.n_augs, device)


def finish_inflation(wd: str, n_augs: int, device) -> None:
    """Reuse a complete inflation, else (re)do it; the JAX tools' lines."""
    marker = dataset_d.marker_path(wd)
    if os.path.exists(marker):
        with open(marker) as f:
            print(f"already complete: {f.read()}")
        return
    wall = dataset_d.inflate(wd, n_augs, device)
    print(f"INFLATE_DONE {wall}s", flush=True)


if __name__ == "__main__":
    main()
