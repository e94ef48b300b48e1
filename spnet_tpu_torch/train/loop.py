"""The training orchestrator and batched inference.

Counterpart of `spnet_tpu/train/loop.py` for its device-resident feed on
one device:

  * the uint8 training set and the val frames live on the device (with
    geometric augmentation, the padded raw ellipse rows and their mask
    too); each step gathers its minibatch there, with the epoch's order
    from the numpy `data.dataset.batches` under the JAX package's seeds:
    an epoch is `epoch_repeats` shuffled passes, pass r of epoch e seeded
    `seed + e * repeats + r`, then one val sweep;
  * augmentation and dropout draw from a `torch.Generator` on the device,
    seeded per epoch, so a resumed run draws what an unbroken one would;
  * the 1-cycle schedule keys off the train state's step, and the epoch
    loss reaches the host once per epoch, not once per step;
  * frozen phase -> unfreeze is an optimizer swap (`train/state.py`);
  * per epoch: a val sweep through the eval-mode model (the fused
    separable-conv kernel on the card), component losses, confusion and
    ring metrics, `losses.dat`, `progress.png`, overlays, TensorBoard
    scalars and the overlay image (`use_tb`, into `<log_dir>/tb`), and a
    checkpoint every `save_every` epochs and at the last one, with
    auto-resume from it.

The chunked and host-fed feeds, `pretrained` and multi-device training
are not ported yet and raise.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from spnet_tpu_torch.eval.metrics import calc_errors
from spnet_tpu_torch.io.checkpoint import restore_if_exists, save_train_state
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops.losses import loss_components
from spnet_tpu_torch.config import IND_NOOBJ, VARS_PER_PRED, ExperimentConfig
from spnet_tpu_torch.data.dataset import Dataset, batches
from spnet_tpu_torch.grid import denormalize
from spnet_tpu_torch.io.logs import LossLog, save_progress_plot
from spnet_tpu_torch.io.tb import TBWriter
from spnet_tpu_torch.io.render import show_pred_ellipses
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state, unfreeze
from spnet_tpu_torch.train.steps import make_predict_step, make_train_step

#: Share of the card's memory the resident train + val frames and labels
#: may take; the rest is left to parameters, optimizer state and the
#: activations of a step.
RESIDENT_FRACTION = 0.5


def predict_in_batches(predict_fn, x, batch_size: int,
                       device: str | torch.device,
                       verbose: bool = True) -> tuple[np.ndarray, float]:
    """Run predict_fn over x (numpy or a tensor) in batches on `device`.

    The last partial batch is padded with zeros and its padding trimmed.
    A warm-up batch (kernel build, cuDNN autotuning, allocator growth)
    runs outside the timed window, as in JAX where the first dispatch
    compiles.  All batches are enqueued before any result is copied back,
    and the window ends with the last host copy (`.cpu()`), so FPS counts
    the device work, not launches.  Returns (y (N, num_outputs) float32
    numpy, frames per second)."""
    device = torch.device(device)
    m = x.shape[0]
    xt = torch.as_tensor(x)
    wb = torch.zeros((batch_size,) + tuple(xt.shape[1:]), dtype=xt.dtype,
                     device=device)
    predict_fn(wb).cpu()
    start = time.perf_counter()
    outs, trims = [], []
    for s in range(0, m, batch_size):
        xb = xt[s : s + batch_size].to(device, non_blocking=True)
        trim = xb.shape[0]
        if trim < batch_size:  # pad the final partial batch
            xb = torch.cat([xb, xb.new_zeros((batch_size - trim,)
                                             + tuple(xb.shape[1:]))])
        outs.append(predict_fn(xb))
        trims.append(trim)
    y = np.concatenate([o.cpu().float().numpy()[:t]
                        for o, t in zip(outs, trims)])
    elapsed = time.perf_counter() - start
    fps = m / max(elapsed, 1e-9)
    if verbose:
        print(f"    predict: {m} frames in {elapsed:.2f}s  FPS = {fps:.1f}")
    return y, fps


def _unported(cfg: ExperimentConfig) -> list[str]:
    return ["pretrained"] if cfg.model.pretrained else []


def epoch_order(n: int, batch_size: int, seed: int, epoch: int,
                repeats: int = 1) -> np.ndarray:
    """(repeats * (n // batch_size), batch_size) int64 minibatch indices of
    one epoch: `repeats` shuffled passes, pass r seeded with
    seed + epoch * repeats + r (the seed the (epoch * repeats + r)'th
    one-pass epoch would use)."""
    return np.concatenate([
        np.stack(list(batches(n, batch_size, shuffle=True,
                              seed=seed + epoch * repeats + r)))
        for r in range(repeats)])


def _to_device(ds: Dataset, val_ds: Dataset, device: torch.device,
               geo: bool = False):
    """The resident arrays (x, y, val x, and with `geo` the raw rows and
    their mask, else None); raises when they do not fit the card."""
    rows_bytes = ds.rows.nbytes + ds.row_mask.nbytes if geo else 0
    need = ds.x.nbytes + ds.y.nbytes + rows_bytes + val_ds.x.nbytes
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        if need > RESIDENT_FRACTION * total:
            raise MemoryError(
                f"the resident dataset takes {need / 1e9:.2f} GB (train "
                f"{ds.x.nbytes / 1e9:.2f} GB frames + labels"
                + (" + raw rows" if geo else "") + ", val "
                f"{val_ds.x.nbytes / 1e9:.2f} GB frames), more than "
                f"{RESIDENT_FRACTION:.0%} of the card's "
                f"{total / 1e9:.2f} GB; the chunked and host-fed feeds are "
                "not ported to spnet_tpu_torch yet")

    def put(a):
        return torch.as_tensor(a).to(device)

    return (put(ds.x), put(ds.y), put(val_ds.x),
            put(ds.rows) if geo else None,
            put(ds.row_mask) if geo else None)


def _tb_epoch(tb: TBWriter, log_dir: str, epoch: int, scalars) -> None:
    """One epoch's TensorBoard record: the scalars, then the val overlay
    image (the first overlay, else the progress plot) when one was
    drawn (reference `callbacks.py:239-248`)."""
    for tag, v in scalars:
        tb.add_scalar(tag, v, epoch)
    try:  # the image needs PIL; a missing one skips it, as in JAX
        from PIL import Image

        src = os.path.join(log_dir, "steelpan_pred_00000.png")
        if not os.path.exists(src):
            src = os.path.join(log_dir, "progress.png")
        if os.path.exists(src):
            tb.add_image("val/overlay",
                         np.asarray(Image.open(src).convert("RGB")), epoch)
    except Exception as e:  # noqa: BLE001 (the JAX loop does the same)
        print(f"    (tb image skipped: {e!r})")


def train_network(cfg: ExperimentConfig, train_ds: Dataset,
                  val_ds: Dataset, device: str | torch.device = "cuda",
                  log_dir: str = "./logs/run", ckpt_dir: str | None = None,
                  render_overlays: bool = True, verbose: int = 1):
    """Full training run on one device; returns (state, history)."""
    bad = _unported(cfg)
    if bad:
        raise NotImplementedError(f"not ported to spnet_tpu_torch yet: {bad}")
    tc, mc, grid = cfg.train, cfg.model, cfg.grid
    device = torch.device(device)
    geo = tc.geo_augment
    if geo and train_ds.rows is None:
        raise ValueError("geo_augment requires the dataset to carry raw "
                         "ellipse rows (Dataset.rows); build it with "
                         "build_dataset or synthetic_dataset")
    model = build_model(mc, num_outputs=grid.num_outputs, device=device,
                        generator=torch.Generator().manual_seed(tc.seed))
    n_train = train_ds.x.shape[0]
    repeats = max(int(tc.epoch_repeats), 1)
    steps_per_epoch = (n_train // tc.batch_size) * repeats
    if steps_per_epoch == 0:
        raise ValueError(f"{n_train} training frames: fewer than one batch "
                         f"of {tc.batch_size}")
    sched = onecycle_schedule(tc.lr_max, steps_per_epoch * tc.epochs,
                              tc.onecycle_pct_start, tc.onecycle_div_factor,
                              tc.onecycle_final_div)
    state = create_train_state(model, sched, freeze_fac=tc.freeze_fac,
                               adam_variant=tc.adam_variant)
    if ckpt_dir:
        state = restore_if_exists(ckpt_dir, state)

    x_all, y_all, x_val, rows_all, mask_all = _to_device(train_ds, val_ds,
                                                         device, geo)
    if verbose:
        print(f"    device-resident dataset: "
              f"{(train_ds.x.nbytes + val_ds.x.nbytes) / 1e9:.2f} GB on "
              f"{device}")
    train_step = make_train_step(
        model, cfg.loss_weights, mc.loss_type, l2_reg=mc.l2_reg,
        augment=tc.augment, blur_prob=tc.blur_prob, geo_augment=geo,
        grid=grid)
    feed = (x_all, y_all, rows_all, mask_all) if geo else (x_all, y_all)
    predict_fn = make_predict_step(model)
    log = LossLog(log_dir)
    tb = TBWriter(f"{log_dir}/tb") if tc.use_tb else None
    history = []
    frozen_left = tc.frozen_epochs if tc.freeze_fac > 0 else 0

    # resume mid-run: skip the epochs the restored step already covers
    start_epoch = state.step // steps_per_epoch
    if start_epoch > 0:
        if start_epoch >= tc.epochs:
            print(f"    checkpoint already at epoch {start_epoch}; "
                  f"nothing to train")
        else:
            print(f"    resuming at epoch {start_epoch + 1}/{tc.epochs}")
        if tc.freeze_fac > 0:
            frozen_left = max(tc.frozen_epochs - start_epoch, 0)
            if frozen_left == 0:
                state = unfreeze(state, adam_variant=tc.adam_variant)

    for epoch in range(start_epoch, tc.epochs):
        t0 = time.perf_counter()
        idx_mat = torch.from_numpy(epoch_order(
            n_train, tc.batch_size, tc.seed, epoch, repeats)).to(device)
        gen = torch.Generator(device=device).manual_seed(
            tc.seed * 1_000_003 + epoch)
        losses = []
        for idx in idx_mat:
            state, metrics = train_step(state, *feed, idx, gen)
            losses.append(metrics["loss"])
        ep_loss = float(torch.stack(losses).mean())  # the epoch's one sync
        train_time = time.perf_counter() - t0
        img_per_sec = len(losses) * tc.batch_size / max(train_time, 1e-9)

        # ---- unfreeze transition (reference `train_spnet.py:74-78`) ----
        if tc.freeze_fac > 0 and frozen_left > 0:
            frozen_left -= 1
            if frozen_left == 0:
                if verbose:
                    print("    unfreezing backbone")
                state = unfreeze(state, adam_variant=tc.adam_variant)

        # ---- epoch-end diagnostics ----
        infer_bs = mc.clamp_infer_batch(
            max(tc.batch_size, min(256, int(x_val.shape[0]))))
        y_pred, fps = predict_in_batches(predict_fn, x_val, infer_bs, device,
                                         verbose=verbose > 1)
        comps = loss_components(torch.from_numpy(val_ds.y),
                                torch.from_numpy(y_pred), cfg.loss_weights,
                                mc.loss_type)
        comps_np = {k: float(v) for k, v in comps.items()}
        if mc.loss_type != "same":  # decode noobj logits
            y_pred[:, IND_NOOBJ::VARS_PER_PRED] = 1.0 / (
                1.0 + np.exp(-y_pred[:, IND_NOOBJ::VARS_PER_PRED]))
        yv = denormalize(val_ds.y, grid)
        yp = denormalize(y_pred, grid)
        st = calc_errors(yp, yv)
        log.append(epoch, ep_loss, comps_np, st.class_acc, extra={
            "ring_acc": st.ring_acc,
            "mean_pix_err": st.mean_pix_err,
            "img_per_sec": img_per_sec,
            "val_fps": fps,
            "lr": state.schedule(state.step),
        })
        history.append({
            "epoch": epoch,
            "train_loss": ep_loss,
            "val_comps": comps_np,
            "ring_acc": st.ring_acc,
            "class_acc": st.class_acc,
            "mean_pix_err": st.mean_pix_err,
            "img_per_sec": img_per_sec,
            "val_fps": fps,
        })
        if verbose:
            print(f"epoch {epoch + 1}/{tc.epochs}  loss {ep_loss:.5f}  "
                  f"val {comps_np['total']:.5f}  "
                  f"ring_acc {st.ring_acc:.2f}%  "
                  f"class_acc {st.class_acc:.2f}%  "
                  f"pix_err {st.mean_pix_err:.2f}  "
                  f"{img_per_sec:.1f} img/s  val_fps {fps:.0f}")
        try:  # plots are diagnostics: a missing matplotlib or PIL skips them
            save_progress_plot(log_dir, log, yv, yp,
                               (grid.img_width, grid.img_height))
            if render_overlays:
                show_pred_ellipses(yv, yp, val_ds.file_list, num_draw=40,
                                   log_dir=log_dir)
        except Exception as e:  # noqa: BLE001 (the JAX loop does the same)
            print(f"    (plot/render skipped: {e!r})")
        if tb is not None:
            _tb_epoch(tb, log_dir, epoch, (
                ("loss/train", ep_loss),
                ("loss/val", comps_np["total"]),
                ("metrics/ring_acc", st.ring_acc),
                ("metrics/class_acc", st.class_acc),
                ("metrics/mean_pix_err", st.mean_pix_err),
                ("perf/img_per_sec", img_per_sec),
                ("lr", state.schedule(state.step))))

        if ckpt_dir and ((epoch + 1) % tc.save_every == 0
                         or epoch == tc.epochs - 1):
            save_train_state(ckpt_dir, state, cfg)
            if verbose:
                print(f"    checkpoint saved to {ckpt_dir}")

    if tb is not None:  # each record was flushed as it was written
        tb.close()
    return state, history
