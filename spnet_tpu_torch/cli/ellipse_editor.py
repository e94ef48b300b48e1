"""`python -m spnet_tpu_torch ellipse-editor` — Tk GUI for hand-editing
ellipse annotations.

Counterpart of `spnet_tpu/cli/ellipse_editor.py` (reference
`ellipse_editor.py`): walks a directory of paired `<img>.png` +
`<img>.csv` files and lets you

  * drag an ellipse body to move it
  * drag the END handle (on the major axis) to resize/rotate
  * drag the SIDE handle (on the minor axis) to change b
  * double-click empty space to create a new ellipse
  * right-click an ellipse to edit its ring count
  * press Delete (or drag off-screen) to remove the selected ellipse
  * Left/Right arrows to change file, 's' to save the CSV

Host tooling only: no torch and no device.  `tkinter` is imported inside
`EditorApp` and `main`, so the module (and its `Ellipse` data model)
imports on a host without a display.
"""

from __future__ import annotations

import argparse
import math
import os

from spnet_tpu_torch.data.csvio import (
    paired_file_lists,
    read_raw_meta,
    write_meta_file,
)


class Ellipse:
    def __init__(self, cx, cy, a, b, angle, rings):
        self.cx, self.cy, self.a, self.b = cx, cy, a, b
        self.angle, self.rings = angle, rings

    def row(self):
        return [self.cx, self.cy, self.a, self.b, self.angle, self.rings]

    def poly_points(self, n=72):
        # display convention: negate angle on the y-down canvas
        th = math.radians(-self.angle)
        c, s = math.cos(th), math.sin(th)
        pts = []
        for i in range(n):
            t = 2 * math.pi * i / n
            x = self.cx + self.a * math.cos(t) * c - self.b * math.sin(t) * s
            y = self.cy + self.a * math.cos(t) * s + self.b * math.sin(t) * c
            pts.extend((x, y))
        return pts

    def handles(self):
        th = math.radians(-self.angle)
        end = (self.cx + self.a * math.cos(th),
               self.cy + self.a * math.sin(th))
        side = (self.cx - self.b * math.sin(th),
                self.cy + self.b * math.cos(th))
        return end, side

    def contains(self, x, y):
        th = math.radians(-self.angle)
        dx, dy = x - self.cx, y - self.cy
        u = dx * math.cos(th) + dy * math.sin(th)
        v = -dx * math.sin(th) + dy * math.cos(th)
        if self.a <= 0 or self.b <= 0:
            return False
        return (u / self.a) ** 2 + (v / self.b) ** 2 <= 1.0


class EditorApp:
    HANDLE_R = 5

    def __init__(self, root, img_files, meta_files):
        import tkinter as tk

        self.tk = tk
        self.root = root
        self.img_files = img_files
        self.meta_files = meta_files
        self.index = 0
        self.canvas = tk.Canvas(root, width=512, height=384)
        self.canvas.pack()
        self.status = tk.Label(root, anchor="w")
        self.status.pack(fill="x")
        self.ellipses: list[Ellipse] = []
        self.selected: Ellipse | None = None
        self.drag_mode = None  # 'move' | 'end' | 'side'
        self.photo = None

        c = self.canvas
        c.bind("<ButtonPress-1>", self.on_press)
        c.bind("<B1-Motion>", self.on_drag)
        c.bind("<ButtonRelease-1>", self.on_release)
        c.bind("<Double-Button-1>", self.on_double)
        c.bind("<ButtonPress-3>", self.on_rightclick)
        root.bind("<Left>", lambda e: self.change_file(-1))
        root.bind("<Right>", lambda e: self.change_file(1))
        root.bind("s", lambda e: self.save())
        root.bind("<Delete>", lambda e: self.delete_selected())
        self.load()

    # ---- file IO ----
    def load(self):
        from PIL import Image, ImageTk

        img = Image.open(self.img_files[self.index]).convert("RGB")
        self.photo = ImageTk.PhotoImage(img)
        self.canvas.config(width=img.width, height=img.height)
        self.ellipses = [
            Ellipse(*row) for row in
            read_raw_meta(self.meta_files[self.index]).tolist()
        ]
        self.selected = None
        self.redraw()

    def save(self):
        write_meta_file(self.meta_files[self.index],
                        [e.row() for e in self.ellipses])
        self.set_status("saved")

    def change_file(self, delta):
        self.index = (self.index + delta) % len(self.img_files)
        self.load()

    # ---- drawing ----
    def redraw(self):
        c = self.canvas
        c.delete("all")
        c.create_image(0, 0, image=self.photo, anchor="nw")
        for e in self.ellipses:
            color = "red" if e is self.selected else "yellow"
            c.create_polygon(*e.poly_points(), outline=color, fill="",
                             width=2)
            c.create_text(e.cx, e.cy, text=f"{e.rings:g}", fill=color)
            if e is self.selected:
                for hx, hy in e.handles():
                    c.create_oval(hx - self.HANDLE_R, hy - self.HANDLE_R,
                                  hx + self.HANDLE_R, hy + self.HANDLE_R,
                                  fill=color)
        self.set_status(
            f"[{self.index + 1}/{len(self.img_files)}] "
            f"{os.path.basename(self.img_files[self.index])}  "
            f"({len(self.ellipses)} ellipses)  "
            "drag=move, handles=resize/rotate, dbl-click=new, "
            "right-click=rings, s=save"
        )

    def set_status(self, msg):
        self.status.config(text=msg)

    # ---- interactions ----
    def on_press(self, ev):
        if self.selected is not None:
            end, side = self.selected.handles()
            for mode, (hx, hy) in (("end", end), ("side", side)):
                if abs(ev.x - hx) <= self.HANDLE_R + 2 and \
                        abs(ev.y - hy) <= self.HANDLE_R + 2:
                    self.drag_mode = mode
                    return
        for e in reversed(self.ellipses):
            if e.contains(ev.x, ev.y):
                self.selected = e
                self.drag_mode = "move"
                self.off = (ev.x - e.cx, ev.y - e.cy)
                self.redraw()
                return
        self.selected = None
        self.drag_mode = None
        self.redraw()

    def on_drag(self, ev):
        e = self.selected
        if e is None or self.drag_mode is None:
            return
        if self.drag_mode == "move":
            e.cx, e.cy = ev.x - self.off[0], ev.y - self.off[1]
        elif self.drag_mode == "end":
            dx, dy = ev.x - e.cx, ev.y - e.cy
            e.a = max(5.0, math.hypot(dx, dy))
            e.angle = -math.degrees(math.atan2(dy, dx)) % 180
        elif self.drag_mode == "side":
            th = math.radians(-e.angle)
            dx, dy = ev.x - e.cx, ev.y - e.cy
            v = -dx * math.sin(th) + dy * math.cos(th)
            e.b = max(3.0, abs(v))
        self.redraw()

    def on_release(self, ev):
        e = self.selected
        if e is not None and self.drag_mode == "move":
            w = int(self.canvas["width"])
            h = int(self.canvas["height"])
            if not (0 <= e.cx < w and 0 <= e.cy < h):
                self.ellipses.remove(e)  # dragged off-screen = delete
                self.selected = None
                self.redraw()
        self.drag_mode = None

    def on_double(self, ev):
        e = Ellipse(ev.x, ev.y, 50, 30, 90, 1)
        self.ellipses.append(e)
        self.selected = e
        self.redraw()

    def on_rightclick(self, ev):
        for e in reversed(self.ellipses):
            if e.contains(ev.x, ev.y):
                from tkinter import simpledialog

                val = simpledialog.askfloat(
                    "Ring count", "rings:", initialvalue=e.rings,
                    minvalue=0.0, maxvalue=11.0, parent=self.root,
                )
                if val is not None:
                    e.rings = val
                self.redraw()
                return

    def delete_selected(self):
        if self.selected in self.ellipses:
            self.ellipses.remove(self.selected)
            self.selected = None
            self.redraw()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Tk editor for ellipse annotation CSVs",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-d", "--datapath", default=".",
                   help="directory of paired *.png + *.csv")
    args = p.parse_args(argv)

    import tkinter as tk

    imgs, metas = paired_file_lists(
        args.datapath if args.datapath.endswith(os.sep)
        else args.datapath + os.sep
    )
    if not imgs:
        raise SystemExit(f"no image/csv pairs in {args.datapath}")
    root = tk.Tk()
    root.title("spnet_tpu_torch ellipse editor")
    EditorApp(root, imgs, metas)
    root.mainloop()


if __name__ == "__main__":
    main()
