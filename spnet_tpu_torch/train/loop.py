"""The training orchestrator and batched inference.

Counterpart of `spnet_tpu/train/loop.py` on one device, with its three
feeds (`device_data`):

  * resident (True; the default when train + val fit in RESIDENT_FRACTION
    of the card): the uint8 training set and the val frames live on the
    device (with geometric augmentation, the padded raw ellipse rows and
    their mask too); each step gathers its minibatch there, with the
    epoch's order from the numpy `data.dataset.batches` under the JAX
    package's seeds: an epoch is `epoch_repeats` shuffled passes, pass r
    of epoch e seeded `seed + e * repeats + r`, then one val sweep;
  * chunked ("chunked"; the default when the set does not fit):
    `train/chunked.py` streams equal chunks one ahead, pass r running
    `run_chunked_epoch` with epoch `e * repeats + r`; the val frames stay
    on the device;
  * host-fed (False): each minibatch, in the resident feed's order, is
    sliced on the host and copied one batch ahead through pinned memory
    (`chunked.Stager`); the step takes the batch itself, and the val
    sweep copies the host val frames batch by batch;
  * on one rank without remat the resident feed trains an epoch through
    the step's epoch form (`train/steps.py::make_train_epoch`): on the
    card one CUDA graph of the step, replayed once a minibatch, and one
    host sync for the epoch's loss; the other feeds, remat and a process
    group call the step once a minibatch;
  * augmentation and dropout draw from one `torch.Generator` on the
    device (the one a CUDA graph of the step holds), reseeded each epoch,
    so a resumed run draws what an unbroken one would;
  * the 1-cycle schedule keys off the train state's step, and the epoch
    loss reaches the host once per epoch, not once per step;
  * `pretrained` (Keras backbone weights, `io/keras_import.py`) is
    applied after the train state is made and before the checkpoint
    restore, so a checkpoint wins;
  * frozen phase -> unfreeze is an optimizer swap (`train/state.py`);
  * per epoch: a val sweep through the eval-mode model (the fused
    separable-conv kernel on the card), component losses, confusion and
    ring metrics, the epoch form's captures and their host seconds (in
    the epoch line, so a recapture shows; the history keeps JAX's keys),
    `losses.dat`, `progress.png`, overlays, TensorBoard scalars and the
    overlay image (`use_tb`, into `<log_dir>/tb`), and a
    checkpoint every `save_every` epochs and at the last one, with
    auto-resume from it.

Data-parallel training (JAX's multi-device and multi-process branches):
when a `torch.distributed` group runs (`parallel/multihost.py::
maybe_initialize`), each rank passes its own file shard and keeps only
that shard resident on its device (`ShardedRows`); the training set is
the union of the equal shards in rank order, as JAX lays it out, so the
steps, the schedule and a resume count global steps.  Every rank walks
the same seeded epoch order over the global set, receives its own rows
of each global batch from the ranks that hold them (one all-to-all a
step, planned on the host once an epoch), and augments and trains on
them inside `DistributedDataParallel` (`train/steps.py`), with the
augmentation and dropout draws and the BatchNorm statistics of the
global batch.  Each
rank scores its own val shard, as in JAX.  Rank 0 alone writes
`losses.dat`, the plots, TensorBoard and the checkpoint; every rank
restores from it.

JAX's val-monitoring slice and `chunked_device_put` are TPU workarounds the
port does not carry.
"""

from __future__ import annotations

import os
import sys
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
from spnet_tpu_torch.parallel import mesh
from spnet_tpu_torch.parallel.multihost import ShardedRows, global_length
from spnet_tpu_torch.train.chunked import ChunkStreamer, Stager, \
    plan_chunks, run_chunked_epoch
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state, unfreeze
from spnet_tpu_torch.train.steps import make_predict_step, \
    make_train_epoch, make_train_step
from spnet_tpu_torch.utils.profiling import span

#: Share of the card's memory the resident train + val frames and labels
#: may take (and the chunked feed's chunks + val frames); the rest is left
#: to parameters, optimizer state and the activations of a step.
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
    the device work, not launches.  Its host phases are spans
    (`utils/profiling.py::span`), leaves that do not overlap:
    `spnet.predict.warmup`, then per batch `spnet.predict.copy_in` (the
    slice, the copy to the device, the padding) and
    `spnet.predict.forward`, then `spnet.predict.copy_out`.  Returns
    (y (N, num_outputs) float32 numpy, frames per second)."""
    device = torch.device(device)
    m = x.shape[0]
    xt = torch.as_tensor(x)
    with span("spnet.predict.warmup"):
        wb = torch.zeros((batch_size,) + tuple(xt.shape[1:]),
                         dtype=xt.dtype, device=device)
        predict_fn(wb).cpu()
    start = time.perf_counter()
    outs, trims = [], []
    for s in range(0, m, batch_size):
        with span("spnet.predict.copy_in"):
            xb = xt[s : s + batch_size].to(device, non_blocking=True)
            trim = xb.shape[0]
            if trim < batch_size:  # pad the final partial batch
                xb = torch.cat([xb, xb.new_zeros((batch_size - trim,)
                                                 + tuple(xb.shape[1:]))])
        with span("spnet.predict.forward"):
            outs.append(predict_fn(xb))
        trims.append(trim)
    with span("spnet.predict.copy_out"):
        y = np.concatenate([o.cpu().float().numpy()[:t]
                            for o, t in zip(outs, trims)])
    elapsed = time.perf_counter() - start
    fps = m / max(elapsed, 1e-9)
    if verbose:
        print(f"    predict: {m} frames in {elapsed:.2f}s  FPS = {fps:.1f}")
    return y, fps


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


def _train_arrays(ds: Dataset, geo: bool) -> tuple:
    """The per-frame arrays a train step reads: (x, y[, rows, mask])."""
    return (ds.x, ds.y) + ((ds.rows, ds.row_mask) if geo else ())


def _resident_bytes(ds: Dataset, val_ds: Dataset, geo: bool) -> int:
    """Bytes of the resident feed's data: the train arrays and val x."""
    return sum(a.nbytes for a in _train_arrays(ds, geo)) + val_ds.x.nbytes


def _budget(device: torch.device) -> int:
    """Bytes the feed's data may hold on `device` (no limit on the CPU)."""
    if device.type != "cuda":
        return sys.maxsize
    return int(RESIDENT_FRACTION * torch.cuda.get_device_properties(
        device).total_memory)


def _to_device(ds: Dataset, val_ds: Dataset, device: torch.device,
               geo: bool = False):
    """The resident arrays (x, y, val x, and with `geo` the raw rows and
    their mask, else None); raises when they do not fit the card (the
    chunked and host-fed feeds take such a set).  In a group `ds` is this
    rank's shard, and the shard is what must fit."""
    need = _resident_bytes(ds, val_ds, geo)
    if need > _budget(device):
        raise MemoryError(
            f"the resident dataset takes {need / 1e9:.2f} GB (train "
            f"{ds.x.nbytes / 1e9:.2f} GB frames + labels"
            + (" + raw rows" if geo else "") + ", val "
            f"{val_ds.x.nbytes / 1e9:.2f} GB frames), more than "
            f"{RESIDENT_FRACTION:.0%} of the card's memory; "
            + ("spread the set over more ranks" if mesh.world_size() > 1
               else "train with device_data='chunked' or False"))

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


def _pick_feed(device_data, train_ds: Dataset, val_ds: Dataset,
               device: torch.device, geo: bool):
    """JAX's choice: None -> resident when train + val fit the budget, else
    'chunked'; True, False and 'chunked' as given."""
    if device_data not in (None, True, False, "chunked"):
        raise ValueError(f"device_data must be None, True, False or "
                         f"'chunked', got {device_data!r}")
    if device_data is None:
        fits = _resident_bytes(train_ds, val_ds, geo) <= _budget(device)
        device_data = True if fits else "chunked"
    return device_data


def _capture_seconds(train_epoch) -> list:
    """The host seconds of each capture the epoch form has made (none
    where an epoch runs another way)."""
    return list(getattr(train_epoch, "capture_seconds", ()))


def train_network(cfg: ExperimentConfig, train_ds: Dataset,
                  val_ds: Dataset, device: str | torch.device = "cuda",
                  log_dir: str = "./logs/run", ckpt_dir: str | None = None,
                  render_overlays: bool = True,
                  device_data: bool | str | None = None,
                  chunk_budget: int | None = None, verbose: int = 1):
    """Full training run on one device, or data-parallel on this rank's
    when a process group runs; returns (state, history).

    device_data: None picks the resident feed when the set fits, else the
    chunked one; True (resident), "chunked", False (host-fed).
    chunk_budget: the bytes the chunked feed's chunks may take on the
    device (`plan_chunks` sizes ~3 in flight); None = RESIDENT_FRACTION of
    the card less the val frames.  In a group of W > 1 ranks, train_ds and
    val_ds are this rank's shards (equal lengths on every rank), the batch
    size is global (W must divide it), the feed is the resident one with
    only this rank's shard on its card (the budget holds the shard), and a
    bare 'cuda' device is `cuda:LOCAL_RANK` (`mesh.local_device`)."""
    tc, mc, grid = cfg.train, cfg.model, cfg.grid
    device = mesh.local_device(device)
    geo = tc.geo_augment
    if geo and train_ds.rows is None:
        raise ValueError("geo_augment requires the dataset to carry raw "
                         "ellipse rows (Dataset.rows); build it with "
                         "build_dataset or synthetic_dataset")
    n_ranks, main = mesh.world_size(), mesh.rank() == 0
    if n_ranks > 1:
        if tc.batch_size % n_ranks:
            raise ValueError(f"batch size {tc.batch_size} does not split "
                             f"over {n_ranks} ranks")
        # each rank's shard is resident on its card, as in JAX: chunks or
        # host batches would need coordination between the ranks
        device_data = True
    model = build_model(mc, num_outputs=grid.num_outputs, device=device,
                        generator=torch.Generator().manual_seed(tc.seed))
    n_train = global_length(train_ds.x.shape[0])  # JAX: x.shape[0] * n_proc
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
    if mc.pretrained:
        # Keras backbone weights (reference `models.py:349-355`); a
        # checkpoint restore below still wins
        from spnet_tpu_torch.io.keras_import import (
            apply_backbone_weights, load_keras_backbone,
        )

        apply_backbone_weights(model, *load_keras_backbone(mc.pretrained,
                                                           mc.backbone))
        if verbose:
            print(f"    pretrained backbone loaded from {mc.pretrained}")
    if ckpt_dir:
        state = restore_if_exists(ckpt_dir, state)
    state = mesh.replicate_state(state)

    device_data = _pick_feed(device_data, train_ds, val_ds, device, geo)
    arrays = _train_arrays(train_ds, geo)
    if device_data == "chunked":
        budget = (chunk_budget if chunk_budget is not None
                  else _budget(device) - val_ds.x.nbytes)
        item_bytes = sum(a.nbytes for a in arrays) // max(n_train, 1)
        chunk_len, n_chunks = plan_chunks(n_train, item_bytes,
                                          tc.batch_size, budget)
        streamer = ChunkStreamer(arrays, chunk_len, n_chunks, device)
        x_val = torch.as_tensor(val_ds.x).to(device)
        if verbose:
            print(f"    chunk-streamed dataset: "
                  f"{train_ds.x.nbytes / 1e9:.2f} GB in {n_chunks} chunks "
                  f"of {chunk_len} frames "
                  f"({chunk_len * item_bytes / 1e9:.3f} GB each, "
                  f"1-chunk-ahead prefetch)")
    elif device_data:
        x_all, y_all, x_val, rows_all, mask_all = _to_device(
            train_ds, val_ds, device, geo)
        feed = (x_all, y_all, rows_all, mask_all) if geo else (x_all, y_all)
        if n_ranks > 1:
            shard = ShardedRows(feed)
        if verbose:
            print(f"    device-resident dataset: "
                  f"{(train_ds.x.nbytes + val_ds.x.nbytes) / 1e9:.2f} GB on "
                  f"{device}" + (f" (rank {mesh.rank()}'s shard of "
                                 f"{n_train} frames)" if n_ranks > 1
                                 else ""))
    else:
        stager = Stager(arrays, tc.batch_size, device)
        x_val = val_ds.x
        if verbose:
            print("    host-fed batches (one batch ahead through pinned "
                  "memory)")
    train_step = make_train_step(
        model, cfg.loss_weights, mc.loss_type, l2_reg=mc.l2_reg,
        augment=tc.augment, blur_prob=tc.blur_prob,
        indexed=("rows" if n_ranks > 1 else "epoch") if device_data
        else False, geo_augment=geo,
        grid=grid)
    # the epoch form where the step is one rank's and has no remat region
    train_epoch = (make_train_epoch(train_step, geo)
                   if device_data is True and not mesh.active()
                   and not mc.remat else None)
    predict_fn = make_predict_step(model)
    log = LossLog(log_dir) if main else None
    tb = TBWriter(f"{log_dir}/tb") if tc.use_tb and main else None
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

    gen = torch.Generator(device=device)
    for epoch in range(start_epoch, tc.epochs):
        t0 = time.perf_counter()
        # the epoch form's captures so far: a recapture shows in the epoch
        n_cap = len(_capture_seconds(train_epoch))
        gen.manual_seed(tc.seed * 1_000_003 + epoch)
        if device_data == "chunked":
            loss_sum, nb = 0.0, 0
            for r in range(repeats):
                state, r_loss, r_nb = run_chunked_epoch(
                    train_step, state, streamer, tc.batch_size, gen,
                    epoch * repeats + r, tc.seed)
                loss_sum, nb = loss_sum + r_loss * r_nb, nb + r_nb
            ep_loss = float(loss_sum / nb)  # the epoch's one sync
        else:
            order = epoch_order(n_train, tc.batch_size, tc.seed, epoch,
                                repeats)
            if n_ranks > 1:
                plan = shard.plan(order)
            elif device_data:
                idx_mat = torch.from_numpy(order).to(device)
            if train_epoch is not None:
                state, losses = train_epoch(state, *feed, idx_mat, gen)
            else:
                if n_ranks > 1:
                    feed_iter = (shard.rows(plan, i)
                                 for i in range(len(order)))
                elif device_data:
                    feed_iter = ((*feed, idx) for idx in idx_mat)
                else:
                    feed_iter = stager.stream_rows(order)
                losses = []
                for batch in feed_iter:
                    state, metrics = train_step(state, *batch, gen)
                    losses.append(metrics["loss"])
                losses = torch.stack(losses)
            nb = len(losses)
            ep_loss = float(losses.mean())  # the one sync
        train_time = time.perf_counter() - t0
        img_per_sec = nb * tc.batch_size / max(train_time, 1e-9)
        captures = _capture_seconds(train_epoch)[n_cap:]

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
                  f"{img_per_sec:.1f} img/s  val_fps {fps:.0f}"
                  + (f"  captures {len(captures)} ({sum(captures):.2f}s)"
                     if train_epoch is not None else "")
                  + (f"  [rank {mesh.rank()}/{n_ranks}, its val shard]"
                     if n_ranks > 1 else ""))
        if main:  # rank 0 alone writes (the state is replicated)
            log.append(epoch, ep_loss, comps_np, st.class_acc, extra={
                "ring_acc": st.ring_acc,
                "mean_pix_err": st.mean_pix_err,
                "img_per_sec": img_per_sec,
                "val_fps": fps,
                "lr": state.schedule(state.step),
            })
            # plots are diagnostics: a missing matplotlib or PIL skips them
            try:
                save_progress_plot(log_dir, log, yv, yp,
                                   (grid.img_width, grid.img_height))
                if render_overlays:
                    show_pred_ellipses(yv, yp, val_ds.file_list,
                                       num_draw=40, log_dir=log_dir)
            except Exception as e:  # noqa: BLE001 (as the JAX loop does)
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
            if main:
                save_train_state(ckpt_dir, state, cfg)
                if verbose:
                    print(f"    checkpoint saved to {ckpt_dir}")
            if n_ranks > 1:  # no rank reads it before it is whole
                torch.distributed.barrier()

    if tb is not None:  # each record was flushed as it was written
        tb.close()
    return state, history
