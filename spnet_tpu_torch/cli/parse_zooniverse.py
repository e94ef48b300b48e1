"""`python -m spnet_tpu_torch parse-zooniverse` — crowd-label CSV ->
per-image metadata files.

Counterpart of `spnet_tpu/cli/parse_zooniverse.py` (reference
`parse_zooniverse_csv.py`), on the host: reads the aggregated Zooniverse
CSV (`x, y, filename, fringe_count, rx, ry, angle`), keeps rows of exactly
7 fields that parse as numbers, drops NaN and zero-ring rows and exact
duplicates, renames `bmp.png` to `png`, swaps a < b with +90 degrees,
appends one `<image>.csv` line per ellipse in the output directory (whose
old CSVs it removes first) and copies each labelled image alongside
(unless `--no-copy`).
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from shutil import copy2


def parse_zooniverse_csv(in_filename: str, inpath: str, outpath: str,
                         copy_images: bool = True,
                         meta_extension: str = ".csv") -> int:
    os.makedirs(outpath, exist_ok=True)
    for f in glob.glob(os.path.join(outpath, "*" + meta_extension)):
        os.remove(f)  # previous metadata outputs

    seen_rows: set[tuple] = set()
    written = 0
    with open(in_filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) != 7:
                continue
            cx_s, cy_s, ref_filename, rings_s, a_s, b_s, angle_s = parts
            try:
                cx, cy = float(cx_s), float(cy_s)
                rings = float(rings_s)
                a, b = float(a_s), float(b_s)
                angle = float(angle_s)
            except ValueError:
                continue  # header or malformed row
            if any(math.isnan(v) for v in (cx, cy, rings, a, b, angle)):
                continue
            if rings == 0:
                continue
            key = (cx, cy, ref_filename, rings, a, b, angle)
            if key in seen_rows:
                continue
            seen_rows.add(key)

            ref_filename = ref_filename.replace("bmp.png", "png")
            if b > a:
                a, b = b, a
                angle += 90.0

            meta_name = os.path.splitext(ref_filename)[0] + meta_extension
            meta_path = os.path.join(outpath, meta_name)
            if copy_images and not os.path.exists(meta_path):
                src = os.path.join(inpath, ref_filename)
                if os.path.exists(src):
                    copy2(src, os.path.join(outpath, ref_filename))
            with open(meta_path, "a") as mf:
                mf.write(f"{cx},{cy},{a},{b},{angle},{rings}\n")
            written += 1
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        description="parses aggregated Zooniverse ellipse CSV into "
                    "per-image metadata files",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-i", "--infile", required=True,
                   help="aggregated CSV (x,y,filename,fringe_count,"
                        "rx,ry,angle)")
    p.add_argument("-p", "--inpath", default="zooniverse_steelpan",
                   help="directory where ALL images are stored")
    p.add_argument("-o", "--outpath",
                   default="parsed_zooniverze_steelpan",
                   help="output dir for labeled images + CSVs")
    p.add_argument("--no-copy", action="store_true",
                   help="do not copy images alongside metadata")
    args = p.parse_args(argv)
    n = parse_zooniverse_csv(args.infile, args.inpath, args.outpath,
                             copy_images=not args.no_copy)
    print(f"wrote {n} annotation rows into {args.outpath}")
    return n


if __name__ == "__main__":
    main()
