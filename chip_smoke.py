"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Phases, one or more lines each; any failed
check raises and the run exits non-zero:

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions; TF32 is switched off for the float32 checks;
  2. build   - compiles the CUDA kernels from `spnet_tpu_torch/csrc`;
  3. kernel  - the fused separable-conv kernel against its plain PyTorch
               version at the 10 Xception-331 shapes (b=16, ReLU on and off;
               b=256, the train path's val-sweep batch, ReLU as the model
               has it) and two ragged shapes, in float32 and bfloat16, with
               the median time of each (CUDA events);
  4. slice   - the serving path at full width: SPNet Xception-331 (bf16,
               seeded Keras init, seeded BN running stats) saved as a port
               checkpoint, reloaded through the CLI's loader, 64 seeded
               uint8 frames through `predict_in_batches` at b=16, then
               denormalize, calc_errors, calc_map and the prediction CSV.
               Checks the kernel's launch count on that run, finite outputs,
               and float32 agreement of the whole model between the kernel
               and the plain separable conv;
  5. loss    - the fused loss kernels K2 (forward) and K3 (backward) against
               the plain PyTorch twin at B = 16, 128, 256 x M = 576 and two
               ragged shapes, 'same' and 'hybrid', float32: loss rel 1e-5,
               gradient max-abs error <= 1e-5 max|grad|, two forward calls
               bitwise equal, and the median time of each (CUDA events);
  6. train   - the training path at full width through `train_network`:
               SPNet Xception-331 bf16, b=128, 512 seeded uint8 train frames
               and 256 val frames resident on the card, augmentation on,
               2 epochs with a checkpoint each, then the same run asked for 3
               epochs, which must resume at epoch 3 from the saved step and
               optimizer count.  Checks K2 and K3 launches = train steps, K1
               launches = 34 per val batch (warm-up included), finite losses,
               moved BN statistics, losses.dat and the checkpoint; prints the
               train images/s.  Then 30 steps on one b=16 batch (no
               augmentation, no dropout, lr 1e-4) must lower the loss, and
               one float32 train step with the kernel loss must agree with
               the same step on the plain twin (loss rel 1e-6, head-weight
               gradient rel 1e-5);
  7. heads   - the selective-sigmoid kernel K4 (forward and backward)
               against its plain twins at B = 16, 128, 256 x M = 576 and two
               ragged shapes (rel 1e-6, median time of each); the 'ss' head
               (Xception-331 bf16 + K4) served from a port checkpoint whose
               `experiment.json` selects it: 64 frames at b=16, K4 launches
               = batches + warm-up, K1 34 per batch, noobj lanes in (0, 1),
               and the f32 model with the kernels against the plain versions
               (rel 1e-4); the 'ss' head trained through `train_network`
               (b=128, 2 epochs of 4 steps; K4's backward, K2 and K3 launch
               once per step) and one f32 train step with K4 against the
               twin (loss rel 1e-6, head-weight gradient rel 1e-5); then the
               compound head (Xception-331) and MobileNet-331, bf16, each
               served (b=16) and trained (b=128, 2 epochs) the same way,
               with their frames/s and train images/s.

Every model path runs with all five launch counts set to 0 just before it
and checks them all just after.  The line before the last is the kernels'
JSON record; the last line is `{"ok": true, "device": {...}}`.  Exits
non-zero without a result when no CUDA device is available.  Needs torch
and numpy, no jax and no PIL.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

F32_RTOL = 1e-4   # kernel vs plain, float32: only the summation order differs
BF16_RTOL = 2e-2  # bfloat16: the two versions round at different points
MODEL_F32_RTOL = 1e-4  # whole model, float32, 34 separable convs deep
LOSS_RTOL = 1e-5       # K2 vs twin, K3 vs twin's gradient (summation order)
STEP_LOSS_RTOL = 1e-6  # float32 train step, kernel loss vs plain twin
STEP_GRAD_RTOL = 1e-5  # ... its head-weight gradient

# (B, H, W, C, F, relu, uses per predict batch) on the Xception-331 path
XCEPTION_SHAPES = [
    (16, 80, 80, 64, 128, False, 1),
    (16, 80, 80, 128, 128, False, 1),
    (16, 40, 40, 128, 256, False, 1),
    (16, 40, 40, 256, 256, False, 1),
    (16, 20, 20, 256, 728, False, 1),
    (16, 20, 20, 728, 728, False, 1),
    (16, 10, 10, 728, 728, False, 25),
    (16, 10, 10, 728, 1024, False, 1),
    (16, 5, 5, 1024, 1536, True, 1),
    (16, 5, 5, 1536, 2048, True, 1),
]
RAGGED_SHAPES = [(2, 7, 5, 24, 40), (3, 9, 9, 33, 70)]
SEPCONVS_PER_BATCH = sum(s[-1] for s in XCEPTION_SHAPES)  # 34
# the val sweep's batch on the train path: max(b, min(256, val frames))
# (`train/loop.py`), 256 for phase 6
VAL_BATCH = 256
# (B, M) of the loss kernels: the train batch and its neighbours, and two
# shapes that leave a ragged last block of 256 slots
LOSS_SHAPES = [(16, 576), (128, 576), (256, 576), (3, 8 * 37), (5, 8 * 250)]
SIGMOID_RTOL = 1e-6  # K4 vs twin: the same float32 formula, expf vs exp
TRAIN_BATCH, TRAIN_FRAMES, VAL_FRAMES = 128, 512, 256
DEVICE = "cuda"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_median_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}  torch {torch.__version__}  CUDA "
          f"{torch.version.cuda}  python {sys.version.split()[0]}  "
          "(TF32 off for cuDNN and matmul)")
    return smi


def phase_build():
    from spnet_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)}: nvcc {seconds:.2f} s"
          + (" (cached library of the same sources)" if seconds == 0 else ""))


def _sepconv_inputs(b, h, w, c, f, dtype, gen):
    dev = "cuda"
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    dw = torch.randn(3, 3, c, device=dev, generator=gen) * 0.3
    pw = (torch.randn(c, f, device=dev, generator=gen) / c ** 0.5).to(dtype)
    scale = torch.rand(f, device=dev, generator=gen) + 0.5
    bias = torch.randn(f, device=dev, generator=gen) * 0.1
    return x, dw, pw, scale, bias


def phase_kernel(seed: int, smi: str) -> dict:
    from spnet_tpu_torch.ops.sepconv import sepconv_infer, \
        sepconv_infer_torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (shape, relu, uses per bf16 predict batch with that ReLU setting)
    cases = [(s[:5], relu, s[6] if relu == s[5] else 0)
             for s in XCEPTION_SHAPES for relu in (False, True)]
    cases += [((VAL_BATCH, *s[1:5]), s[5], s[6]) for s in XCEPTION_SHAPES]
    cases += [(s, relu, 0) for s in RAGGED_SHAPES for relu in (False, True)]
    max_err = 0.0
    # bf16 time of one batch of 34 sepconvs: kernel, plain; b=16 predict
    # batch and b=VAL_BATCH val-sweep batch
    batch_ms = {16: [0.0, 0.0], VAL_BATCH: [0.0, 0.0]}
    for dtype, rtol in ((torch.float32, F32_RTOL),
                        (torch.bfloat16, BF16_RTOL)):
        for (b, h, w, c, f), relu, uses in cases:
            args = _sepconv_inputs(b, h, w, c, f, dtype, gen)
            out = sepconv_infer(*args, relu=relu)
            torch.cuda.synchronize()
            ref = sepconv_infer_torch(*args, relu=relu)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            t_k = cuda_median_ms(lambda: sepconv_infer(*args, relu=relu))
            t_p = cuda_median_ms(
                lambda: sepconv_infer_torch(*args, relu=relu))
            name = str(dtype).replace("torch.", "")
            print(f"[kernel] {name:8s} B={b} {h}x{w} {c}->{f} relu={relu:d}"
                  f"  max_abs_err {err:.3e} (rel {rel:.2e}, tol {rtol})"
                  f"  kernel {t_k:.4f} ms  plain {t_p:.4f} ms  [{smi}]")
            if not (rel <= rtol):
                fail(f"sepconv {dtype} {(b, h, w, c, f)} relu={relu}: "
                     f"relative error {rel} > {rtol}")
            max_err = max(max_err, err)
            if dtype == torch.bfloat16 and uses:
                batch_ms[b][0] += uses * t_k
                batch_ms[b][1] += uses * t_p
    for b, (t_k, t_p) in batch_ms.items():
        print(f"[kernel] one bf16 batch of b={b} (34 sepconvs): kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms  [{smi}]")
    ms, plain_ms = batch_ms[16]
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _seeded_dataset(n: int, size: int, grid, seed: int):
    """n uint8 (size, size, 1) frames and their normalized grid labels,
    from numpy only."""
    from spnet_tpu_torch.shared import batch_ellipses_to_grid, \
        canonicalize_records, normalize

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8)
    recs = []
    for _ in range(n):
        k = int(rng.integers(1, 7))
        a = rng.uniform(12, 90, k)
        raw = np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                        rng.uniform(grid.cy_min, grid.cy_max, k),
                        a, a * rng.uniform(0.4, 1.0, k),
                        rng.uniform(0, 180, k),
                        rng.uniform(1, 11, k)], axis=1)
        recs.append(canonicalize_records(raw))
    y = normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                  grid).astype(np.float32)
    return x, y


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches
    in `.launches`."""
    from spnet_tpu_torch.ops.activations import selective_sigmoid_bwd, \
        selective_sigmoid_fwd
    from spnet_tpu_torch.ops.losses import spnet_loss_bwd, spnet_loss_fwd
    from spnet_tpu_torch.ops.sepconv import sepconv_infer

    return {f.__name__: f for f in (
        sepconv_infer, spnet_loss_fwd, spnet_loss_bwd,
        selective_sigmoid_fwd, selective_sigmoid_bwd)}


def _zero_counts():
    for f in _wrappers().values():
        f.launches = 0


def _counts() -> dict:
    return {name: f.launches for name, f in _wrappers().items()}


def _want_counts(model_cfg, predict_batches=0, train_steps=0) -> dict:
    """Launches of each kernel for `predict_batches` eval-mode batches and
    `train_steps` train steps of a model of `model_cfg`: K1 carries
    Xception's 34 separable convs in eval mode only, K2/K3 the train loss,
    K4 the 'ss' head in both modes (its backward in train steps)."""
    sep = SEPCONVS_PER_BATCH if model_cfg.backbone == "Xception" else 0
    ss = int(model_cfg.selective_sigmoid)
    return {"sepconv_infer": sep * predict_batches,
            "spnet_loss_fwd": train_steps,
            "spnet_loss_bwd": train_steps,
            "selective_sigmoid_fwd": ss * (predict_batches + train_steps),
            "selective_sigmoid_bwd": ss * train_steps}


def _serve(cfg, seed: int, smi: str, tag: str, n_frames: int = 64,
           batch: int = 16):
    """The serving path of `cfg`: the model (seeded Keras init, seeded BN
    running statistics) saved as a port checkpoint and reloaded through
    the CLI's loader, then n_frames seeded uint8 frames through
    `predict_in_batches` at b=batch, with every launch count set to 0 just
    before and checked just after.  Returns (cfg, model, x, y, y_pred,
    counts)."""
    from spnet_tpu_torch.cli.common import load_model_and_state
    from spnet_tpu_torch.io.checkpoint import save_checkpoint
    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.loop import predict_in_batches
    from spnet_tpu_torch.train.steps import make_predict_step

    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg.model, num_outputs=cfg.grid.num_outputs,
                        generator=gen)
    with torch.no_grad():  # non-trivial running stats: the fold is no identity
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, model.state_dict(), cfg, step=0)
        loaded, model, _ = load_model_and_state(ckpt, DEVICE)
    if loaded != cfg:
        fail(f"{tag}: the checkpoint's config came back as {loaded}")
    print(f"[{tag}] SPNet {cfg.model.backbone}-{cfg.model.input_size} "
          f"{cfg.model.compute_dtype}, selective_sigmoid "
          f"{cfg.model.selective_sigmoid}, compound_head "
          f"{cfg.model.compound_head}: {n_params / 1e6:.2f} M params")
    x, y = _seeded_dataset(n_frames, cfg.model.input_size, cfg.grid, seed)
    predict = make_predict_step(model)
    _zero_counts()
    y_pred, fps = predict_in_batches(predict, x, batch, DEVICE,
                                     verbose=False)
    counts = _counts()
    want = _want_counts(cfg.model, predict_batches=n_frames // batch + 1)
    print(f"[{tag}] predict {n_frames} frames at b={batch}: {fps:.1f} "
          f"frames/s (time to host values)  [{smi}]")
    print(f"[{tag}] launches in that run (warm-up batch included): "
          f"{counts}")
    if counts != want:
        fail(f"{tag}: launches {counts} != {want}")
    if y_pred.shape != (n_frames, cfg.grid.num_outputs) or \
            not np.isfinite(y_pred).all():
        fail(f"{tag}: predictions of shape {y_pred.shape}, finite "
             f"{np.isfinite(y_pred).all()}")
    return model, x, y, y_pred, fps, counts


def _f32_kernels_vs_plain(model_cfg, state: dict, x, tag: str):
    """The same weights in float32, eval mode, with the kernels and with
    their plain versions (`plain_kernels`): relative error <=
    MODEL_F32_RTOL."""
    import dataclasses

    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.steps import make_predict_step

    f32 = dataclasses.replace(model_cfg, compute_dtype="float32",
                              backbone_dtype="")
    outs = []
    for plain in (False, True):
        mf = build_model(f32, device=DEVICE, plain_kernels=plain)
        mf.load_state_dict(state)
        outs.append(make_predict_step(mf)(
            torch.from_numpy(x).to(DEVICE)).float())
        del mf
    err = (outs[0] - outs[1]).abs().max().item()
    rel = err / max(outs[1].abs().max().item(), 1e-30)
    print(f"[{tag}] float32 model, kernels vs plain versions: max_abs_err "
          f"{err:.3e} (rel {rel:.2e}, tol {MODEL_F32_RTOL})")
    if not (torch.isfinite(outs[0]).all() and rel <= MODEL_F32_RTOL):
        fail(f"{tag}: float32 model, kernels vs plain relative error {rel}")


def phase_slice(seed: int, smi: str) -> int:
    from spnet_tpu_torch.eval.metrics import calc_errors, calc_map
    from spnet_tpu_torch.shared import ExperimentConfig, denormalize, \
        show_pred_ellipses

    cfg = ExperimentConfig()  # Xception-331, bf16 compute, f32 params
    model, x, y, y_pred, _, counts = _serve(cfg, seed, smi, "slice")
    n_frames = len(x)
    with tempfile.TemporaryDirectory() as tmp:
        yp, yt = denormalize(y_pred, cfg.grid), denormalize(y, cfg.grid)
        st = calc_errors(yp, yt)
        m_ap = calc_map(yp, yt, cfg.grid)
        files = [f"synthetic://{seed}/{i}" for i in range(n_frames)]
        csv = os.path.join(tmp, "hawley_spnet.csv")
        show_pred_ellipses(yt, yp, files, num_draw=0, log_dir=tmp,
                           out_csv=csv)
        if not (np.isfinite(m_ap) and np.isfinite(st.mean_pix_err)
                and os.path.exists(csv)):
            fail(f"metrics: mAP {m_ap}, pix err {st.mean_pix_err}, "
                 f"csv {os.path.exists(csv)}")
    print(f"[slice] mAP {m_ap:.6f}  mean_pix_err {st.mean_pix_err:.3f}"
          f"  total_obj {st.total_obj}  ring_acc {st.ring_acc:.3f}  "
          f"class_acc {st.class_acc:.3f}  (random weights; checks that "
          "the metrics run)")
    _f32_kernels_vs_plain(cfg.model, model.state_dict(), x[:16], "slice")
    return counts["sepconv_infer"]


def _loss_inputs(b, m, gen):
    """Targets with a 0/1 noobj flag on every slot (80% empty), predictions
    scattered around them."""
    yt = torch.randn(b, m, device=DEVICE, generator=gen)
    yt.view(b, -1, 8)[..., 6] = (torch.rand(b, m // 8, device=DEVICE,
                                            generator=gen) < 0.8).float()
    yp = yt + 0.3 * torch.randn(b, m, device=DEVICE, generator=gen)
    return yt, yp


def phase_loss(seed: int, smi: str) -> dict:
    from spnet_tpu_torch.ops.losses import spnet_loss, spnet_loss_bwd, \
        spnet_loss_fwd
    from spnet_tpu_torch.shared import LossWeights

    w = LossWeights()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = torch.full((), 0.75, device=DEVICE)
    res = dict(fwd_err=0.0, bwd_err=0.0)
    for loss_type in ("same", "hybrid"):
        for b, m in LOSS_SHAPES:
            yt, yp = _loss_inputs(b, m, gen)
            out = spnet_loss_fwd(yt, yp, w, loss_type)
            again = spnet_loss_fwd(yt, yp, w, loss_type)
            dyp = spnet_loss_bwd(yt, yp, g, w, loss_type)
            torch.cuda.synchronize()
            p = yp.clone().requires_grad_(True)
            ref = spnet_loss(yt, p, w, loss_type)
            (ref_grad,) = torch.autograd.grad(ref, p, g, retain_graph=True)
            f_err = abs(float(out) - float(ref.detach()))
            f_rel = f_err / max(abs(float(ref.detach())), 1e-30)
            b_err = (dyp - ref_grad).abs().max().item()
            b_rel = b_err / max(ref_grad.abs().max().item(), 1e-30)
            t_f = cuda_median_ms(lambda: spnet_loss_fwd(yt, yp, w, loss_type))
            t_fp = cuda_median_ms(lambda: spnet_loss(yt, yp, w, loss_type))
            t_b = cuda_median_ms(
                lambda: spnet_loss_bwd(yt, yp, g, w, loss_type))
            t_bp = cuda_median_ms(lambda: torch.autograd.grad(
                ref, p, g, retain_graph=True))
            print(f"[loss] {loss_type:6s} B={b} M={m}  fwd err {f_err:.3e} "
                  f"(rel {f_rel:.2e}, tol {LOSS_RTOL})  bwd max_abs_err "
                  f"{b_err:.3e} (rel {b_rel:.2e}, tol {LOSS_RTOL})  fwd "
                  f"kernel {t_f:.4f} ms plain {t_fp:.4f} ms  bwd kernel "
                  f"{t_b:.4f} ms plain {t_bp:.4f} ms  [{smi}]")
            if not torch.equal(out, again):
                fail(f"loss forward {loss_type} {(b, m)} is not bitwise "
                     f"reproducible: {float(out)!r} vs {float(again)!r}")
            if not (f_rel <= LOSS_RTOL and b_rel <= LOSS_RTOL):
                fail(f"loss kernels {loss_type} {(b, m)}: forward rel "
                     f"{f_rel}, backward rel {b_rel} > {LOSS_RTOL}")
            res["fwd_err"] = max(res["fwd_err"], f_err)
            res["bwd_err"] = max(res["bwd_err"], b_err)
            if (b, loss_type) == (TRAIN_BATCH, "same"):  # the train path's
                res.update(fwd_ms=t_f, fwd_plain_ms=t_fp, bwd_ms=t_b,
                           bwd_plain_ms=t_bp)
    return res


def _seeded_split(sizes, size: int, grid, seed: int):
    """Datasets of the given sizes from one seeded `_seeded_dataset`."""
    from spnet_tpu_torch.shared import Dataset

    x, y = _seeded_dataset(sum(sizes), size, grid, seed)
    out, s0 = [], 0
    for n in sizes:
        out.append(Dataset(x=x[s0:s0 + n], y=y[s0:s0 + n], grid=grid,
                           file_list=[f"synthetic://{seed}/{i}"
                                      for i in range(s0, s0 + n)]))
        s0 += n
    return out


def _train_run(cfg, train_ds, val_ds, tmp, smi, tag="train"):
    """One `train_network` call with every launch count set to 0 before
    and read after; checks what a run must show."""
    from spnet_tpu_torch.io.checkpoint import load_checkpoint
    from spnet_tpu_torch.train.loop import train_network

    log_dir, ckpt = os.path.join(tmp, "log"), os.path.join(tmp, "ckpt")
    tc = cfg.train
    start = (load_checkpoint(ckpt)[0]["step"] if os.path.exists(ckpt)
             else 0) // (len(train_ds.x) // tc.batch_size)
    _zero_counts()
    t0 = time.perf_counter()
    state, hist = train_network(cfg, train_ds, val_ds, DEVICE,
                                log_dir=log_dir, ckpt_dir=ckpt,
                                render_overlays=False)
    seconds = time.perf_counter() - t0
    counts = _counts()
    epochs = tc.epochs - start
    steps = epochs * (len(train_ds.x) // tc.batch_size)
    val_batches = -(-len(val_ds.x) // max(tc.batch_size,
                                          min(VAL_BATCH, len(val_ds.x))))
    want = _want_counts(cfg.model, predict_batches=(val_batches + 1) * epochs,
                        train_steps=steps)
    print(f"[{tag}] epochs {start + 1}..{tc.epochs}: {seconds:.1f} s; "
          f"{steps} steps, {val_batches} val batch(es) + 1 warm-up per "
          f"epoch; launches {counts}")
    if counts != want:
        fail(f"{tag}: train launches {counts} != {want}")
    if [h["epoch"] for h in hist] != list(range(start, tc.epochs)):
        fail(f"epochs run {[h['epoch'] for h in hist]}, want "
             f"{list(range(start, tc.epochs))}")
    for h in hist:
        vals = [h["train_loss"], *h["val_comps"].values()]
        print(f"[{tag}] epoch {h['epoch'] + 1}: loss {h['train_loss']:.6f} "
              f"val {h['val_comps']['total']:.6f}  {h['img_per_sec']:.1f} "
              f"train images/s (b={tc.batch_size}, time to the host value "
              f"of the epoch loss)  val {h['val_fps']:.1f} frames/s  [{smi}]")
        if not all(np.isfinite(v) for v in vals):
            fail(f"non-finite loss in epoch {h['epoch'] + 1}: {vals}")
    payload = load_checkpoint(ckpt)[0]
    with open(os.path.join(log_dir, "losses.dat")) as f:
        rows = [r for r in f if not r.startswith("#")]
    if payload["step"] != state.step or \
            payload["opt_state"]["count"] != state.opt_state.count or \
            len(rows) != tc.epochs:
        fail(f"checkpoint step {payload['step']} / count "
             f"{payload['opt_state']['count']} vs state {state.step} / "
             f"{state.opt_state.count}; losses.dat rows {len(rows)}")
    return state, hist, counts


def _f32_step_agreement(model_cfg, x16, y16, seed: int, tag: str,
                        swap: str):
    """One float32 train-mode forward + loss + head-weight gradient from
    the same weights, dropout mask and batch, twice: with the kernels and
    with the plain versions of those `swap` names.  swap='loss': the fused
    loss (K2/K3) against its twin; swap='model': the model's kernels (K4,
    in train mode) against their plain versions, both with the fused loss.
    Loss rel <= STEP_LOSS_RTOL, gradient rel <= STEP_GRAD_RTOL."""
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.shared import LossWeights
    from spnet_tpu_torch.train.steps import _prep_x, forward_loss

    init, res = None, []
    for plain in (False, True):
        model = build_model(
            model_cfg, device=DEVICE,
            generator=torch.Generator().manual_seed(seed),
            plain_kernels=plain and swap == "model")
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        model.train()
        loss, _ = forward_loss(
            model, _prep_x(x16), y16,
            torch.Generator(device=DEVICE).manual_seed(seed), LossWeights(),
            model_cfg.loss_type, fused=not (plain and swap == "loss"))
        head = (model.sigmoid_output if model.compound_head
                else model.final_output)
        (gw,) = torch.autograd.grad(loss, head.weight)
        res.append((float(loss.detach()), gw))
        del model
    l_rel = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    g_rel = ((res[0][1] - res[1][1]).abs().max()
             / res[1][1].abs().max()).item()
    print(f"[{tag}] float32 step, {swap} kernels vs plain: loss rel "
          f"{l_rel:.2e} "
          f"(tol {STEP_LOSS_RTOL}), head-weight gradient rel {g_rel:.2e} "
          f"(tol {STEP_GRAD_RTOL})")
    if not (l_rel <= STEP_LOSS_RTOL and g_rel <= STEP_GRAD_RTOL):
        fail(f"{tag}: float32 step, loss rel {l_rel}, head gradient rel "
             f"{g_rel}")


def phase_train(seed: int, smi: str) -> dict:
    import dataclasses

    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.shared import ExperimentConfig, ModelConfig, \
        TrainConfig
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_step

    cfg = ExperimentConfig(train=TrainConfig(
        batch_size=TRAIN_BATCH, epochs=2, save_every=1, seed=seed))
    train_ds, val_ds = _seeded_split((TRAIN_FRAMES, VAL_FRAMES),
                                     cfg.model.input_size, cfg.grid, seed)
    with tempfile.TemporaryDirectory() as tmp:
        state, hist, counts = _train_run(cfg, train_ds, val_ds, tmp, smi)
        n_params = sum(p.numel() for p in state.model.parameters())
        bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
        if any(torch.equal(m.running_var, torch.ones_like(m.running_var))
               or torch.equal(m.running_mean,
                              torch.zeros_like(m.running_mean))
               for m in bns):  # initialized at mean 0, var 1
            fail("a BatchNorm's running statistics did not move")
        print(f"[train] SPNet Xception-{cfg.model.input_size} "
              f"{cfg.model.compute_dtype}: {n_params / 1e6:.2f} M params, "
              f"{len(bns)} BatchNorms moved, step {state.step}, optimizer "
              f"count {state.opt_state.count}")
        del state
        cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, epochs=3))
        state, hist3, _ = _train_run(cfg3, train_ds, val_ds, tmp, smi)
        steps_per_epoch = TRAIN_FRAMES // TRAIN_BATCH
        if state.step != 3 * steps_per_epoch or \
                state.opt_state.count != 3 * steps_per_epoch:
            fail(f"resumed run ended at step {state.step}, count "
                 f"{state.opt_state.count}")
        img_s = hist[-1]["img_per_sec"]
        del state
    torch.cuda.empty_cache()

    # overfit one fixed batch: no augmentation, no dropout, constant lr
    x16 = torch.from_numpy(train_ds.x[:16]).to(DEVICE)
    y16 = torch.from_numpy(train_ds.y[:16]).to(DEVICE)
    idx = torch.arange(16, device=DEVICE)
    model = build_model(ModelConfig(dropout_rate=0.0), device=DEVICE,
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, lambda step: 1e-4,
                               adam_variant="optax")
    step = make_train_step(model, cfg.loss_weights, augment=False)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    losses = [float(step(state, x16, y16, idx, gen)[1]["data_loss"])
              for _ in range(30)]
    print(f"[train] overfit b=16, 30 steps at lr 1e-4: data loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"30 steps on one batch did not lower the loss: {losses}")
    del state, model, step

    # float32 (TF32 off): one step with the kernel loss vs the plain twin
    _f32_step_agreement(ModelConfig(compute_dtype="float32"), x16, y16,
                        seed, "train", swap="loss")
    return dict(fwd_launches=counts["spnet_loss_fwd"],
                bwd_launches=counts["spnet_loss_bwd"], img_per_sec=img_s)


def phase_k4(seed: int, smi: str) -> dict:
    """K4's forward and backward against their twins at LOSS_SHAPES (the
    head outputs of the serving and train batches, and two ragged ones)."""
    from spnet_tpu_torch.ops.activations import selective_sigmoid_bwd, \
        selective_sigmoid_fwd, selective_sigmoid_grad_torch, \
        selective_sigmoid_torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    res = dict(fwd_err=0.0, bwd_err=0.0)
    for b, m in LOSS_SHAPES:
        x = 4 * torch.randn(b, m, device=DEVICE, generator=gen)
        g = torch.randn(b, m, device=DEVICE, generator=gen)
        y = selective_sigmoid_fwd(x)
        dx = selective_sigmoid_bwd(y, g)
        torch.cuda.synchronize()
        ref = selective_sigmoid_torch(x)
        ref_dx = selective_sigmoid_grad_torch(ref, g)
        f_err = (y - ref).abs().max().item()
        b_err = (dx - ref_dx).abs().max().item()
        f_rel = f_err / ref.abs().max().item()
        b_rel = b_err / ref_dx.abs().max().item()
        t_f = cuda_median_ms(lambda: selective_sigmoid_fwd(x))
        t_fp = cuda_median_ms(lambda: selective_sigmoid_torch(x))
        t_b = cuda_median_ms(lambda: selective_sigmoid_bwd(y, g))
        t_bp = cuda_median_ms(lambda: selective_sigmoid_grad_torch(y, g))
        print(f"[k4] B={b} M={m}  fwd max_abs_err {f_err:.3e} (rel "
              f"{f_rel:.2e}, tol {SIGMOID_RTOL})  bwd max_abs_err "
              f"{b_err:.3e} (rel {b_rel:.2e}, tol {SIGMOID_RTOL})  fwd "
              f"kernel {t_f:.4f} ms plain {t_fp:.4f} ms  bwd kernel "
              f"{t_b:.4f} ms plain {t_bp:.4f} ms  [{smi}]")
        if not (f_rel <= SIGMOID_RTOL and b_rel <= SIGMOID_RTOL):
            fail(f"selective sigmoid {(b, m)}: forward rel {f_rel}, "
                 f"backward rel {b_rel} > {SIGMOID_RTOL}")
        res["fwd_err"] = max(res["fwd_err"], f_err)
        res["bwd_err"] = max(res["bwd_err"], b_err)
        if b == TRAIN_BATCH and m == 576:
            res.update(fwd_ms=t_f, fwd_plain_ms=t_fp, bwd_ms=t_b,
                       bwd_plain_ms=t_bp)
    return res


def phase_heads(seed: int, smi: str) -> dict:
    """The other heads and the MobileNet backbone, served and trained."""
    import dataclasses

    from spnet_tpu_torch.shared import ExperimentConfig, ModelConfig, \
        TrainConfig

    train_cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=2, save_every=1,
                            seed=seed)
    configs = {
        "ss": ModelConfig(selective_sigmoid=True),
        "compound": ModelConfig(compound_head=True),
        "mobilenet": ModelConfig(backbone="MobileNet"),
    }
    train_ds = val_ds = None
    out = {}
    for tag, mc in configs.items():
        cfg = ExperimentConfig(model=mc, train=train_cfg)
        model, x, _, y_pred, fps, counts = _serve(cfg, seed, smi, tag)
        noobj = y_pred[:, 6::8]
        if mc.selective_sigmoid or mc.compound_head:
            if not ((noobj > 0) & (noobj < 1)).all():
                fail(f"{tag}: noobj lanes outside (0, 1): "
                     f"{noobj.min()}..{noobj.max()}")
            print(f"[{tag}] noobj lanes in {noobj.min():.4f}..."
                  f"{noobj.max():.4f}")
        if mc.selective_sigmoid:
            _f32_kernels_vs_plain(mc, model.state_dict(), x[:16], tag)
        del model
        if train_ds is None:
            train_ds, val_ds = _seeded_split(
                (TRAIN_FRAMES, VAL_FRAMES), mc.input_size, cfg.grid, seed)
        with tempfile.TemporaryDirectory() as tmp:
            state, hist, train_counts = _train_run(cfg, train_ds, val_ds,
                                                   tmp, smi, tag)
            del state
        torch.cuda.empty_cache()
        out[tag] = dict(predict_fps=fps, img_per_sec=hist[-1]["img_per_sec"],
                        predict_counts=counts, train_counts=train_counts)
        if mc.selective_sigmoid:
            x16 = torch.from_numpy(train_ds.x[:16]).to(DEVICE)
            y16 = torch.from_numpy(train_ds.y[:16]).to(DEVICE)
            _f32_step_agreement(dataclasses.replace(
                mc, compute_dtype="float32"), x16, y16, seed, tag,
                swap="model")
    for tag, r in out.items():
        print(f"[heads] {tag}: predict {r['predict_fps']:.1f} frames/s at "
              f"b=16, train {r['img_per_sec']:.1f} images/s at "
              f"b={TRAIN_BATCH} (epoch 2)  [{smi}]")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        raise SystemExit(1)
    smi = phase_device()
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernel(args.seed, smi)
    launches = phase_slice(args.seed, smi)
    loss = phase_loss(args.seed, smi)
    train = phase_train(args.seed, smi)
    k4 = phase_k4(args.seed, smi)
    heads = phase_heads(args.seed, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase; "
          f"train {train['img_per_sec']:.1f} images/s at b={TRAIN_BATCH} "
          f"[{smi}]")
    loss_src = "spnet_tpu_torch/csrc/loss.cu"
    k4_src = "spnet_tpu_torch/csrc/activations.cu"
    print(json.dumps({"kernels": [{
        "name": "sepconv_infer",
        "route": "cuda",
        "source": "spnet_tpu_torch/csrc/sepconv.cu",
        "replaces": "spnet_tpu/ops/sepconv_pallas.py:76",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }, {
        "name": "spnet_loss_fwd",
        "route": "cuda",
        "source": loss_src,
        "replaces": "spnet_tpu/ops/losses.py:135",
        "launches": train["fwd_launches"],
        "max_abs_err": loss["fwd_err"],
        "ms": loss["fwd_ms"],
        "plain_ms": loss["fwd_plain_ms"],
    }, {
        "name": "spnet_loss_bwd",
        "route": "cuda",
        "source": loss_src,
        "replaces": "spnet_tpu/ops/losses.py:176",
        "launches": train["bwd_launches"],
        "max_abs_err": loss["bwd_err"],
        "ms": loss["bwd_ms"],
        "plain_ms": loss["bwd_plain_ms"],
    }, {
        "name": "selective_sigmoid_fwd",
        "route": "cuda",
        "source": k4_src,
        "replaces": "spnet_tpu/ops/activations.py:36",
        "launches": heads["ss"]["predict_counts"]["selective_sigmoid_fwd"],
        "max_abs_err": k4["fwd_err"],
        "ms": k4["fwd_ms"],
        "plain_ms": k4["fwd_plain_ms"],
    }, {
        "name": "selective_sigmoid_bwd",
        "route": "cuda",
        "source": k4_src,
        "replaces": "spnet_tpu/ops/activations.py:36",
        "launches": heads["ss"]["train_counts"]["selective_sigmoid_bwd"],
        "max_abs_err": k4["bwd_err"],
        "ms": k4["bwd_ms"],
        "plain_ms": k4["bwd_plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
