"""Overlay rendering: true/predicted ellipses + ring counts on frames.

Capability twin of `show_pred_ellipses` / `draw_ellipse`
(`spnet/utils.py:35-137`): true ellipses yellow, predicted
purple, ring count printed at each center, source filename at the bottom,
output files `steelpan_pred_%05d.png`, and an optional Zooniverse-format
prediction CSV (`cx,cy,filename,rings,a,b,angle` per row, zeros row when
an image has no predictions).

Implementation uses PIL (polygon-sampled rotated ellipses) instead of
OpenCV; display convention preserved: the label angle is NEGATED on the
y-down pixel grid (`utils.py:50`).
"""

from __future__ import annotations

import os

import numpy as np

from spnet_tpu_torch.config import VARS_PER_PRED
from spnet_tpu_torch.grid import cs2_to_angle_deg

TRUE_COLOR = (254, 228, 76)     # yellow (reference cf.truecolor)
PRED_COLOR = (72, 18, 84)       # dark purple (reference cf.predcolor)
PRED_BG = (210, 210, 210)
TRUE_BG = (0, 0, 0)


def _ellipse_points(cx, cy, a, b, angle_deg, n=180):
    t = np.linspace(0, 2 * np.pi, n)
    th = np.deg2rad(-angle_deg)  # display negation, see module docstring
    c, s = np.cos(th), np.sin(th)
    x = cx + a * np.cos(t) * c - b * np.sin(t) * s
    y = cy + a * np.cos(t) * s + b * np.sin(t) * c
    return list(zip(x.tolist(), y.tolist()))


def _decode_slots(flat_row: np.ndarray):
    """Yield (cx, cy, a, b, angle_deg, noobj_round, rings) per slot with
    the reference's display rounding (`utils.py:56-64`)."""
    slots = np.asarray(flat_row).reshape(-1, VARS_PER_PRED)
    for sl in slots:
        cx, cy, a, b = (int(round(float(v))) for v in sl[:4])
        angle = float(cs2_to_angle_deg(sl[4], sl[5]))
        noobj = int(round(float(sl[6])))
        rings = float(sl[7])
        yield cx, cy, a, b, angle, noobj, rings


def render_overlay(
    img_path: str,
    y_true: np.ndarray | None,
    y_pred: np.ndarray,
    out_path: str,
) -> list[str]:
    """Render one frame; returns Zooniverse CSV rows for the predictions."""
    from PIL import Image, ImageDraw

    img = Image.open(img_path).convert("RGB")
    draw = ImageDraw.Draw(img)
    csv_rows: list[str] = []
    base = os.path.basename(img_path)

    layers = []
    if y_true is not None:
        layers.append((y_true, TRUE_COLOR, TRUE_BG, 0, False))
    layers.append((y_pred, PRED_COLOR, PRED_BG, 27, True))

    for y, color, bg, yoff, is_pred in layers:
        for cx, cy, a, b, ang, noobj, rings in _decode_slots(y):
            if noobj != 0 or rings <= 0 or a < 0 or b < 0:
                continue
            draw.line(_ellipse_points(cx, cy, a, b, ang), fill=color,
                      width=3)
            txt = f"{rings:3.1f}"
            draw.text((cx - 12, cy + yoff), txt, fill=bg)
            draw.text((cx - 10, cy + yoff), txt, fill=color)
            if is_pred:
                csv_rows.append(
                    f"{cx},{cy},{base},{rings},{a},{b},{ang}"
                )
    draw.text((7, img.height - 13), base, fill=(255, 255, 255))
    img.save(out_path)
    if not csv_rows:
        csv_rows = [f"0,0,{base},0,0,0,0"]
    return csv_rows


def show_pred_ellipses(
    y_true: np.ndarray | None,
    y_pred: np.ndarray,
    file_list: list[str],
    num_draw: int = 40,
    log_dir: str = "./logs/",
    out_csv: str | None = None,
    show_true: bool = True,
) -> None:
    """Render up to num_draw frames (denormalized Y arrays)."""
    os.makedirs(log_dir, exist_ok=True)
    m = y_pred.shape[0]
    num_draw = min(num_draw, m, len(file_list))
    all_rows: list[str] = []
    for j in range(num_draw):
        if file_list[j].startswith("synthetic://"):
            continue
        rows = render_overlay(
            file_list[j],
            y_true[j] if (show_true and y_true is not None) else None,
            y_pred[j],
            os.path.join(log_dir, f"steelpan_pred_{j:05d}.png"),
        )
        all_rows.extend(rows)
    if out_csv is not None:
        with open(out_csv, "w") as f:
            f.write("\n".join(all_rows) + ("\n" if all_rows else ""))
