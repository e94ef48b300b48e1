"""The offline inflation of the Dataset-D experiment, alone.

    python -m spnet_tpu_torch.tools.dataset_d_inflate [n_augs] \\
        [--device cuda]

Counterpart of the JAX package's `scripts/dataset_d_inflate.py` (default
42): `augment` over a copy of the experiment's Train/ split
(`tools/dataset_d.py`'s directory for the device type) into TrainAug/,
then the marker `inflate_done.json` with the wall seconds, which
`tools.dataset_d` reuses.  A TrainAug/ without the marker is partial and
is redone; with it, the tool prints `already complete: <marker>`.  Runs
on the card unless `--device cpu` (or SPNET_DEVICE=cpu) asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

from spnet_tpu_torch.tools import dataset_d
from spnet_tpu_torch.tools.dataset_d_prep import finish_inflation
from spnet_tpu_torch.tools.runtime import add_device_arg, tool_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_augs", type=int, nargs="?", default=42)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = tool_device(args.device)
    wd = dataset_d.workdir(device)
    if not os.path.exists(f"{wd}/Train"):
        raise SystemExit(f"{wd}/Train missing — run the generation stage "
                         "of tools.dataset_d (or tools.dataset_d_prep) "
                         "first")
    finish_inflation(wd, args.n_augs, device)


if __name__ == "__main__":
    main()
