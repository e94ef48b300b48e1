"""Run observability: losses.dat appender + 3-panel progress plot.

Twin of the reference's per-epoch diagnostics in `MyProgressCallback`
(`spnet/callbacks.py:58-267`): an append-only
`losses.dat` (`# epoch Train_total Val_total center size angle noobj
class`) and a `progress.png` with (1) sample true/pred centroids, (2)
log-log loss history per component, (3) accuracy history.
"""

from __future__ import annotations

import os

import numpy as np

from spnet_tpu_torch.config import IND_CX, IND_CY, IND_NOOBJ, VARS_PER_PRED


class LossLog:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "losses.dat")
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self.history: list[dict] = []
        with open(self.path, "a") as f:
            f.write("# epoch Train_total Val_total center size angle "
                    "noobj class\n")

    def append(self, epoch: int, train_total: float, val_comps: dict,
               class_acc: float, extra: dict | None = None) -> None:
        row = {
            "epoch": epoch,
            "train": train_total,
            "val": float(val_comps["total"]),
            "center": float(val_comps["center"]),
            "size": float(val_comps["size"]),
            "angle": float(val_comps["angle"]),
            "noobj": float(val_comps["noobj"]),
            "rings": float(val_comps["rings"]),
            "acc": class_acc,
        }
        self.history.append(row)
        with open(self.path, "a") as f:
            f.write(
                f"{epoch} {train_total} {row['val']} {row['center']} "
                f"{row['size']} {row['angle']} {row['noobj']} "
                f"{row['rings']}\n"
            )
        # machine-readable twin (the modern analogue of the reference's
        # optional TensorBoard summaries, `callbacks.py:88-90,239-248`)
        import json

        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({**row, **(extra or {})}) + "\n")


def _obj_centroids(y: np.ndarray, limit: int):
    """Centroid list of present objects, scanning rows until `limit`
    points are collected (reference `make_obj_centroid_list`,
    `callbacks.py:92-110`)."""
    xs, ys = [], []
    s = y.shape[1] // VARS_PER_PRED
    y3 = y.reshape(y.shape[0], s, VARS_PER_PRED)
    for row in y3:
        for sl in row:
            if int(round(float(sl[IND_NOOBJ]))) == 0:
                xs.append(float(sl[IND_CX]))
                ys.append(float(sl[IND_CY]))
        if len(xs) >= limit:
            break
    return xs, ys


def save_progress_plot(
    log_dir: str,
    log: LossLog,
    y_val_denorm: np.ndarray,
    y_pred_denorm: np.ndarray,
    img_dims=(512, 384),
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 3.75))

    ax = plt.subplot(131, autoscale_on=False,
                     aspect=img_dims[0] / img_dims[1],
                     xlim=[0, img_dims[0]], ylim=[0, img_dims[1]])
    tx, ty = _obj_centroids(y_val_denorm, 45)
    px, py = _obj_centroids(y_pred_denorm, 45)
    ax.plot(tx, ty, "ro", label="Expected")
    ax.plot(px, py, "go", label="Predicted")
    ax.set_title("Sample Centroids (cx, cy)")
    ax.legend(loc="upper right", fancybox=True, framealpha=0.8)

    h = log.history
    if h:
        ep = [r["epoch"] + 1 for r in h]
        ax = plt.subplot(132, ylim=[5e-6, 0.1])
        for key, label in [
            ("train", "Train"), ("val", "Val: Total"),
            ("center", "Val: Center"), ("size", "Val: Size"),
            ("angle", "Val: Angle"), ("noobj", "Val: NoObj"),
            ("rings", "Val: Rings"),
        ]:
            ax.loglog(ep, [max(r[key], 1e-12) for r in h], "-",
                      label=label)
        ax.set_xlabel("(Global) Epoch")
        ax.set_ylabel("Loss")
        ax.legend(loc="lower left", fancybox=True, framealpha=0.8)
        ax.set_xlim(left=1)

        ax = plt.subplot(133, ylim=[0, 100])
        ax.plot(ep, [r["acc"] for r in h], "-", color="orange",
                label=f"Acc = {h[-1]['acc']:5.2f} %")
        ax.set_xlabel("(Global) Epoch")
        ax.set_ylabel("Accuracy (%)")
        ax.legend(loc="lower right", fancybox=True, framealpha=0.8)
        ax.set_xlim(left=1)

    fig.tight_layout()
    fig.savefig(os.path.join(log_dir, "progress.png"))
    plt.close(fig)
