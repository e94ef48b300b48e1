"""Per-image CSV metadata IO.

File format (shared data contract with the reference, see
`spnet/utils.py:260-286` and `gen_fake_espi.py:195`):
headerless CSV, one ellipse per line: ``cx,cy,a,b,angle_deg,rings``.
A line of all zeros (or rings <= 0) means "no object".
"""

from __future__ import annotations

import os

import numpy as np

from spnet_tpu_torch.grid import canonicalize_records

META_EXTENSION = ".csv"


def read_raw_meta(path: str) -> np.ndarray:
    """Read a metadata CSV into raw rows (N, 6) [cx, cy, a, b, angle, rings].

    Duplicate rows are dropped (Zooniverse data sometimes has them —
    reference `utils.py:263`).  Rows are NOT canonicalized.
    """
    rows: list[tuple[float, ...]] = []
    seen: set[tuple[float, ...]] = set()
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = tuple(float(v) for v in line.split(","))
            if len(vals) != 6:
                raise ValueError(f"{path}: expected 6 fields, got {len(vals)}")
            if vals in seen:
                continue
            seen.add(vals)
            rows.append(vals)
    if not rows:
        return np.zeros((0, 6), dtype=np.float64)
    return np.array(rows, dtype=np.float64)


def parse_meta_file(path: str) -> np.ndarray:
    """Read + canonicalize: returns (M, 8) canonical ellipse records
    (reference `parse_meta_file`, `utils.py:260-286`)."""
    return canonicalize_records(read_raw_meta(path))


def caption_from_records(raw_rows) -> str:
    """Raw rows [cx, cy, a, b, angle, rings] -> CSV caption string
    (reference `augment_preproc.py:41-52` / `gen_fake_espi.py:195`)."""
    lines = []
    for row in raw_rows:
        cx, cy, a, b, angle, rings = row
        lines.append(f"{_fmt(cx)},{_fmt(cy)},{_fmt(a)},{_fmt(b)},{_fmt(angle)},{_fmt(rings)}")
    return "\n".join(lines)


def _fmt(v) -> str:
    """Format numbers compactly: ints without decimal point."""
    fv = float(v)
    if fv == int(fv):
        return str(int(fv))
    return repr(round(fv, 6))


def write_meta_file(path: str, raw_rows) -> None:
    with open(path, "w") as f:
        f.write(caption_from_records(raw_rows))


def paired_file_lists(path: str) -> tuple[list[str], list[str]]:
    """Sorted (images, metas) lists from a directory; asserts pairing
    (reference `build_dataset`, `utils.py:455-459`)."""
    import glob

    imgs = sorted(glob.glob(os.path.join(path, "*.png")))
    metas = sorted(glob.glob(os.path.join(path, "*" + META_EXTENSION)))
    if len(imgs) != len(metas):
        raise ValueError(
            f"{path}: {len(imgs)} images but {len(metas)} metadata files"
        )
    return imgs, metas
