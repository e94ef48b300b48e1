"""`python -m spnet_tpu_torch setup-data` — distribute real data into
Train/ and Val/, then augment Train/.

Counterpart of `spnet_tpu/cli/setup_data.py` (reference `setup_data.py`):
the source pairs are shuffled by `random.Random(seed + k)`, the first 80 %
by rank go to Train/ and the rest to Val/ (copied for k = 0, symlinked for
the later folds), fold k > 0 goes to `<name>_k{k+1}/`, each fold's
Test/, Train/ and Val/ are removed first, and Train/ is then inflated by
`augment` (seed 0) on `--device`.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import shutil

from spnet_tpu_torch.cli.augment_preproc import augment_data
from spnet_tpu_torch.cli.common import add_device_arg
from spnet_tpu_torch.data.csvio import META_EXTENSION


def copy_or_link(src: str, dst_dir: str, link: bool = False) -> None:
    dst = os.path.join(dst_dir, os.path.basename(src))
    if link:
        os.symlink(os.path.abspath(src), dst)
    else:
        shutil.copy(src, dst)


def distribute_dataset(real_data_dir: str, new_dir: str, k: int = 1,
                       seed: int = 1) -> int:
    print(f"distribute_dataset: {real_data_dir} -> {new_dir} Train/, Val/")
    imgs = sorted(glob.glob(os.path.join(real_data_dir, "*.png")))
    metas = sorted(glob.glob(os.path.join(real_data_dir,
                                          "*" + META_EXTENSION)))
    if len(imgs) != len(metas):
        raise ValueError(f"{real_data_dir}: {len(imgs)} images but "
                         f"{len(metas)} metadata files")
    n = len(imgs)
    print(f"Found {n} original data files")
    idx = list(range(n))
    random.Random(seed + k).shuffle(idx)

    for d in [new_dir, os.path.join(new_dir, "Train"),
              os.path.join(new_dir, "Val")]:
        os.makedirs(d, exist_ok=True)
    for rank, i in enumerate(idx):
        dest = os.path.join(new_dir, "Train" if rank / n < 0.80 else "Val")
        copy_or_link(imgs[i], dest, link=(k > 0))
        copy_or_link(metas[i], dest, link=(k > 0))
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        description="sets up real data, augments in Train/",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-o", "--original", required=True,
                   help="directory containing original data")
    p.add_argument("--name", default=".",
                   help="name of directory for new dataset")
    p.add_argument("-a", "--augs", type=int, default=42)
    p.add_argument("-k", "--kfold", type=int, default=1)
    add_device_arg(p)
    args = p.parse_args(argv)

    for k in range(args.kfold):
        if args.kfold > 1:
            print(f"\n***** Cross-val: k = {k + 1}/{args.kfold} *****\n")
        new_dir = f"{args.name}_k{k + 1}/" if k > 0 else args.name + "/"
        for sub in ("Test", "Train", "Val"):
            shutil.rmtree(os.path.join(new_dir, sub), ignore_errors=True)
        distribute_dataset(args.original, new_dir, k=k)
        augment_data(path=os.path.join(new_dir, "Train"),
                     n_augs=args.augs, device=args.device)


if __name__ == "__main__":
    main()
