"""`python -m spnet_tpu_torch gen-bboxes` — axis-aligned bounding boxes of
the rotated ellipses, for external object detectors.

Counterpart of `spnet_tpu/cli/gen_bboxes.py` (reference
`gen_bboxes_csv.py`), on the host in numpy: the exact box of each ellipse
(semi-axes a, b, as in the per-image CSVs), clipped to the frame and
truncated to int, skipping rows with rings < 1e-6, into one CSV
`filename,width,height,label,xmin,ymin,xmax,ymax` (label `object`, or
`<rings>_rings` with `--label-by-rings`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from spnet_tpu_torch.config import ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH
from spnet_tpu_torch.data.csvio import paired_file_lists, read_raw_meta


def ellipse_bbox(cx, cy, a, b, angle_deg, clip=True,
                 width=ORIG_IMG_WIDTH, height=ORIG_IMG_HEIGHT):
    """Exact axis-aligned box (xmin, ymin, xmax, ymax) of the rotated
    ellipse: half-widths dx = sqrt(a^2 cos^2 th + b^2 sin^2 th) and
    dy = sqrt(a^2 sin^2 th + b^2 cos^2 th), the extrema of the parametric
    curve in closed form."""
    th = np.radians(angle_deg)
    dx = np.sqrt((a * np.cos(th)) ** 2 + (b * np.sin(th)) ** 2)
    dy = np.sqrt((a * np.sin(th)) ** 2 + (b * np.cos(th)) ** 2)
    xmin, xmax = cx - dx, cx + dx
    ymin, ymax = cy - dy, cy + dy
    if clip:
        xmin, xmax = np.clip(xmin, 0, width), np.clip(xmax, 0, width)
        ymin, ymax = np.clip(ymin, 0, height), np.clip(ymax, 0, height)
    return int(xmin), int(ymin), int(xmax), int(ymax)


def gen_bboxes(datapath: str, out_filename: str,
               label_by_rings: bool = False,
               width=ORIG_IMG_WIDTH, height=ORIG_IMG_HEIGHT) -> int:
    imgs, metas = paired_file_lists(
        datapath if datapath.endswith(os.sep) else datapath + os.sep)
    rows = ["filename,width,height,label,xmin,ymin,xmax,ymax"]
    for img, meta in zip(imgs, metas):
        base = os.path.basename(img)
        for cx, cy, a, b, ang, rings in read_raw_meta(meta):
            if rings < 1e-6:
                continue
            xmin, ymin, xmax, ymax = ellipse_bbox(cx, cy, a, b, ang,
                                                  width=width, height=height)
            label = (f"{int(round(rings))}_rings" if label_by_rings
                     else "object")
            rows.append(f"{base},{width},{height},{label},"
                        f"{xmin},{ymin},{xmax},{ymax}")
    with open(out_filename, "w") as f:
        f.write("\n".join(rows) + "\n")
    return len(rows) - 1


def main(argv=None):
    p = argparse.ArgumentParser(
        description="exports bounding boxes from ellipse metadata",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-d", "--datapath", required=True,
                   help="directory of paired *.png + *.csv")
    p.add_argument("-o", "--outfile", default="bounding_boxes.csv")
    p.add_argument("--label-by-rings", action="store_true",
                   help="class label = rounded ring count (default: "
                        "single 'object' class)")
    args = p.parse_args(argv)
    n = gen_bboxes(args.datapath, args.outfile,
                   label_by_rings=args.label_by_rings)
    print(f"wrote {n} boxes to {args.outfile}")
    return n


if __name__ == "__main__":
    main()
