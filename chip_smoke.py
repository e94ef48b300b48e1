"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Phases, one or more lines each; any failed
check raises and the run exits non-zero:

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions; TF32 is switched off for the float32 checks;
  2. build   - compiles the CUDA kernels from `spnet_tpu_torch/csrc`;
  3. kernel  - the fused separable-conv kernel against its plain PyTorch
               version at the 10 Xception-331 shapes (b=16 with the input
               and output ReLU as the model has them and flipped; b=256,
               the train path's val-sweep batch, as the model has them) and
               two ragged shapes, in float32 and bfloat16, with the median
               time of each (CUDA events); for bf16 at b=16 and b=256 each
               shape's bound (bytes and operations from the shapes, which
               one binds), % of bound, and the time of the unfused library
               pair (cuDNN depthwise conv + torch.matmul, two calls, no
               BN/ReLU epilogue: a yardstick the port never calls); and
               the b=16 batch of 34 replayed from a CUDA graph;
  4. slice   - the serving path at full width: SPNet Xception-331 (bf16,
               seeded Keras init, seeded BN running stats) saved as a port
               checkpoint, reloaded through the CLI's loader, 64 seeded
               uint8 frames through `predict_in_batches` at b=16, then
               denormalize, calc_errors, calc_map and the prediction CSV.
               Checks the kernel's launch count on that run, finite outputs,
               and agreement of the whole model, float32 and bfloat16, between
               the kernels and their plain versions;
  5. loss    - the loss kernel (K2 and K3 in one pass) and the backward's
               scale kernel against the plain PyTorch twin at B = 16, 128,
               256 x M = 576 and two ragged shapes, 'same' and 'hybrid',
               float32: loss rel 1e-5 (`spnet_loss_fwd` and the fused
               forward), gradient max-abs error <= 1e-5 max|grad|
               (`spnet_loss_bwd`, and the fused forward's gradient x g
               through the backward), the latter within rel 1e-6 of the
               former; three forward calls, three replays of a CUDA graph of
               one call and an eager call after them bitwise equal.  At
               every shape ('same') the device time per call of the loss,
               the standalone gradient, the fused forward with its gradient,
               the scale kernel and the plain versions, from CUDA graphs of
               100 calls (`graph_ms`); the event time of one call; the host
               time per eager call; and the launch floor (a one-element
               `add_` timed as the kernels are).  Then the loss kernel's
               'ss' variant (the selective sigmoid K4 in the same pass, on
               the pre-activation z = 4 randn) at the same 5 shapes x 2
               loss types: the loss bitwise equal to K4's forward then the
               loss kernel, and rel 1e-5 of the twins' composition; the
               gradient with respect to z within rel 1e-6 of max|grad| of
               K4's backward of the loss kernel's gradient x g, for g = 1
               (bitwise or not, printed) and 0.75, and 1e-5 of the twins';
               3 calls, 3 graph replays and a call after them bitwise
               equal; at every shape ('same') its times as above, and the
               'ss' step's loss from one graph, the fused route (2
               launches) beside the composition (K4, the loss kernel, the
               scale, K4's backward: 4 launches);
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
               ragged shapes (rel 1e-6; graph, event and host times as in
               phase 5); the 'ss' head
               (Xception-331 bf16 + K4) served from a port checkpoint whose
               `experiment.json` selects it: 64 frames at b=16, K4 launches
               = batches + warm-up, K1 34 per batch, noobj lanes in (0, 1),
               and the f32 model with the kernels against the plain versions
               (rel 1e-4); the 'ss' head trained through `train_network`
               (b=128, 2 epochs of 4 steps; the loss kernel's 'ss' variant
               and the scale launch once per step, K4 only in the val
               sweeps) and one f32 train step on the fused route against
               the plain model with the kernel loss, under 'same' and
               'hybrid' (loss rel 1e-6, head-weight gradient rel 1e-5), and
               one with fused=False, which drives K4's forward and backward
               on the model (launch counts checked), against the twins;
               then the
               compound head (Xception-331) and MobileNet-331, bf16, each
               served (b=16) and trained (b=128, 2 epochs) the same way,
               with their frames/s and train images/s.

Every model path runs with all five launch counts (and the loss kernel's
count of 'ss' launches) set to 0 just before it and checks them all just
after.  The line before the last is the kernels' JSON record (for K2-K4
`ms` is the graph-timed device time at 128 x 576, beside `call_ms`,
`host_us` and `floor_ms`; K2 adds `ss_fused_ms` and `ss_launches`); the
last line is
`{"ok": true, "device": {...}}`.  Exits
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
# whole model, bfloat16: per sepconv the kernel rounds the depthwise with f32
# taps, the plain version with bf16 taps (as the JAX twin); 34 layers deep
# the outputs drift apart by a few bf16 ulps of their scale (measured on an
# H100: see PERF.md)
MODEL_BF16_RTOL = 5e-3
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
LOSS_RTOL = 1e-5       # K2 vs twin, K3 vs twin's gradient (summation order)
# the fused forward's gradient x g vs the standalone gradient kernel: the
# same formula, scaled by g after (backward) or inside (standalone) it
FUSED_BWD_RTOL = 1e-6
STEP_LOSS_RTOL = 1e-6  # float32 train step, kernel loss vs plain twin
STEP_GRAD_RTOL = 1e-5  # ... its head-weight gradient

# (B, H, W, C, F, relu, relu_in, uses per predict batch) on the
# Xception-331 path
XCEPTION_SHAPES = [
    (16, 80, 80, 64, 128, False, False, 1),
    (16, 80, 80, 128, 128, False, True, 1),
    (16, 40, 40, 128, 256, False, True, 1),
    (16, 40, 40, 256, 256, False, True, 1),
    (16, 20, 20, 256, 728, False, True, 1),
    (16, 20, 20, 728, 728, False, True, 1),
    (16, 10, 10, 728, 728, False, True, 25),
    (16, 10, 10, 728, 1024, False, True, 1),
    (16, 5, 5, 1024, 1536, True, False, 1),
    (16, 5, 5, 1536, 2048, True, False, 1),
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
# the 'ss' variant's gradient x g vs K4's backward of the loss kernel's: g
# multiplies after the sigmoid's factor in one, before it in the other
SS_GRAD_RTOL = 1e-6
TRAIN_BATCH, TRAIN_FRAMES, VAL_FRAMES = 128, 512, 256
DEVICE = "cuda"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_median_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median of `reps` CUDA-event timings of one fn() call each: for a
    small kernel this brackets its wrapper's host time (`call_ms`)."""
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


_capture_stream = None


def capture(fn, calls: int = 1):
    """(graph, outputs of the last call) of `calls` fn() calls captured
    into one CUDA graph, on one side stream after an eager call there (the
    loss kernel makes its workspace at a stream's first call)."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    s = _capture_stream
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        for _ in range(calls):
            out = fn()
    return graph, out


def graph_ms(fn, calls: int = 100, replays: int = 10) -> float:
    """Device time of one fn() call: `calls` calls captured into one CUDA
    graph, one warm-up replay, then `replays` replays between two CUDA
    events; their time / (calls * replays).  No host work in between."""
    graph, _ = capture(fn, calls)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per fn() call: `calls` eager calls with no sync
    in between, then one synchronize, on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def launch_floor_ms() -> float:
    """graph_ms of a one-element add_: the least one launch costs."""
    x = torch.zeros(1, device=DEVICE)
    return graph_ms(lambda: x.add_(1.0))


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
    import re

    from spnet_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)}: nvcc {seconds:.2f} s"
          + (" (cached library of the same sources)" if seconds == 0 else ""))
    # ptxas -v of K1's wgmma kernels: registers, spills (per <NC, TN>)
    name = None
    for line in _build.build.log.splitlines():
        m = re.search(
            r"Compiling entry function '.*wgmma_kernelILi(\d)ELi(\d+)E", line)
        if m:
            name = f"wgmma_kernel<NC={m[1]}, TN={m[2]}>"
        elif name and ("spill" in line or "Used" in line):
            print(f"[build] ptxas {name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None


def _sepconv_inputs(b, h, w, c, f, dtype, gen):
    dev = "cuda"
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    dw = torch.randn(3, 3, c, device=dev, generator=gen) * 0.3
    pw = (torch.randn(c, f, device=dev, generator=gen) / c ** 0.5).to(dtype)
    scale = torch.rand(f, device=dev, generator=gen) + 0.5
    bias = torch.randn(f, device=dev, generator=gen) * 0.1
    return x, dw, pw, scale, bias


def sepconv_bound(b, h, w, c, f) -> tuple[float, str]:
    """(least time in ms, what binds it) of one fused bf16 sepconv on an
    H100: x read once, out written once, the weights (bf16 pointwise, f32
    taps, f32 scale and bias) read once; 2 M C F + 18 M C operations
    (pointwise and depthwise multiply-adds)."""
    m = b * h * w
    nbytes = 2 * (m * c + m * f + c * f) + 4 * (9 * c + 2 * f)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * m * c * f + 18 * m * c) / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_pair(x, dw, pw):
    """The unfused yardstick of one sepconv: cuDNN's depthwise conv on the
    channels-last view of x, then torch.matmul (two calls, no BN/ReLU)."""
    k = dw.to(x.dtype).permute(2, 0, 1).unsqueeze(1)
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
    groups = x.shape[-1]

    def run():
        y = torch.nn.functional.conv2d(xc, k, padding=1, groups=groups)
        return torch.matmul(y.permute(0, 2, 3, 1), pw)
    return run


def phase_kernel(seed: int, smi: str) -> dict:
    from spnet_tpu_torch.ops.sepconv import sepconv_infer, \
        sepconv_infer_torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (shape, relu, relu_in, uses per bf16 batch with that setting)
    cases = []
    for *shape, relu, relu_in, uses in XCEPTION_SHAPES:
        cases.append((tuple(shape), relu, relu_in, uses))
        cases.append((tuple(shape), not relu, not relu_in, 0))
    cases += [((VAL_BATCH, *s[1:5]), s[5], s[6], s[7])
              for s in XCEPTION_SHAPES]
    cases += [(s, relu, relu_in, 0) for s in RAGGED_SHAPES
              for relu in (False, True) for relu_in in (False, True)]
    max_err = 0.0
    # bf16 sums over one batch of 34 sepconvs (b=16 predict, b=VAL_BATCH
    # val sweep): kernel, plain, library pair, bound; bound kinds
    sums = {b: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    bytes_ms=0.0) for b in (16, VAL_BATCH)}
    batch16 = []  # the bf16 b=16 predict batch: (args, kw, uses)
    for dtype, rtol in ((torch.float32, F32_RTOL),
                        (torch.bfloat16, BF16_RTOL)):
        for (b, h, w, c, f), relu, relu_in, uses in cases:
            args = _sepconv_inputs(b, h, w, c, f, dtype, gen)
            kw = dict(relu=relu, relu_in=relu_in)
            out = sepconv_infer(*args, **kw)
            torch.cuda.synchronize()
            ref = sepconv_infer_torch(*args, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            t_k = cuda_median_ms(lambda: sepconv_infer(*args, **kw))
            t_p = cuda_median_ms(lambda: sepconv_infer_torch(*args, **kw))
            name = str(dtype).replace("torch.", "")
            line = (f"[kernel] {name:8s} B={b} {h}x{w} {c}->{f} relu={relu:d}"
                    f" relu_in={relu_in:d}  max_abs_err {err:.3e} (rel "
                    f"{rel:.2e}, tol {rtol})  kernel {t_k:.4f} ms  plain "
                    f"{t_p:.4f} ms")
            if dtype == torch.bfloat16 and uses:
                t_l = cuda_median_ms(_library_pair(*args[:3]))
                bound, kind = sepconv_bound(b, h, w, c, f)
                line += (f"  library pair {t_l:.4f} ms  bound {bound:.4f} ms"
                         f" ({kind})  {100 * bound / t_k:.1f}% of bound"
                         f"  x{uses}")
                acc = sums[b]
                if b == 16:
                    batch16.append((args, kw, uses))
                acc["ms"] += uses * t_k
                acc["plain_ms"] += uses * t_p
                acc["library_ms"] += uses * t_l
                acc["bound_ms"] += uses * bound
                acc["bytes_ms"] += uses * bound * (kind == "bytes")
            print(f"{line}  [{smi}]")
            if not (rel <= rtol):
                fail(f"sepconv {dtype} {(b, h, w, c, f)} relu={relu} "
                     f"relu_in={relu_in}: relative error {rel} > {rtol}")
            max_err = max(max_err, err)
    for b, acc in sums.items():
        print(f"[kernel] one bf16 batch of b={b} (34 sepconvs): kernel "
              f"{acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, library "
              f"pair {acc['library_ms']:.4f} ms, bound {acc['bound_ms']:.4f} "
              f"ms ({100 * acc['bound_ms'] / acc['ms']:.1f}% of bound)  "
              f"[{smi}]")

    def batch():
        for args, kw, uses in batch16:
            for _ in range(uses):
                sepconv_infer(*args, **kw)

    res = dict(sums[16], max_abs_err=max_err,
               graph_ms=graph_ms(batch, calls=10, replays=5))
    print(f"[kernel] one bf16 batch of b=16 (34 sepconvs) replayed from a CUDA "
          f"graph of 10 batches: {res['graph_ms']:.4f} ms of device time "
          f"(the sum of single-call event medians above: {res['ms']:.4f} "
          f"ms)  [{smi}]")
    res["bound_by"] = ("bytes" if 2 * res.pop("bytes_ms") >= res["bound_ms"]
                       else "operations")
    return res


def _seeded_dataset(n: int, size: int, grid, seed: int):
    """n uint8 (size, size, 1) frames and their normalized grid labels,
    from numpy only."""
    from spnet_tpu_torch.grid import (
        batch_ellipses_to_grid, canonicalize_records, normalize,
    )

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


SS_COUNT = "spnet_loss_fwd[ss]"  # the loss kernel's launches with K4 in it


def _zero_counts():
    for f in _wrappers().values():
        f.launches = 0
    _wrappers()["spnet_loss_fwd"].ss_launches = 0


def _counts() -> dict:
    counts = {name: f.launches for name, f in _wrappers().items()}
    counts[SS_COUNT] = _wrappers()["spnet_loss_fwd"].ss_launches
    return counts


def _want_counts(model_cfg, predict_batches=0, train_steps=0) -> dict:
    """Launches of each kernel for `predict_batches` eval-mode batches and
    `train_steps` train steps of a model of `model_cfg`: K1 carries
    Xception's 34 separable convs in eval mode only, K2/K3 the train loss,
    K4 the 'ss' head in eval mode; in a train step the loss kernel's 'ss'
    variant carries K4 (forward and backward) in its own pass."""
    sep = SEPCONVS_PER_BATCH if model_cfg.backbone == "Xception" else 0
    ss = int(model_cfg.selective_sigmoid)
    return {"sepconv_infer": sep * predict_batches,
            "spnet_loss_fwd": train_steps,
            "spnet_loss_bwd": train_steps,
            "selective_sigmoid_fwd": ss * predict_batches,
            "selective_sigmoid_bwd": 0,
            SS_COUNT: ss * train_steps}


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
                        device="cpu", generator=gen)
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


def _kernels_vs_plain(model_cfg, state: dict, x, tag: str,
                      dtype: str = "float32"):
    """The same weights in `dtype`, eval mode, with the kernels and with
    their plain versions (`plain_kernels`): relative error <=
    MODEL_F32_RTOL (float32) or MODEL_BF16_RTOL (bfloat16)."""
    import dataclasses

    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.steps import make_predict_step

    tol = MODEL_F32_RTOL if dtype == "float32" else MODEL_BF16_RTOL
    cfg = dataclasses.replace(model_cfg, compute_dtype=dtype,
                              backbone_dtype="")
    outs = []
    for plain in (False, True):
        mf = build_model(cfg, device=DEVICE, plain_kernels=plain)
        mf.load_state_dict(state)
        outs.append(make_predict_step(mf)(
            torch.from_numpy(x).to(DEVICE)).float())
        del mf
    err = (outs[0] - outs[1]).abs().max().item()
    rel = err / max(outs[1].abs().max().item(), 1e-30)
    print(f"[{tag}] {dtype} model, kernels vs plain versions: max_abs_err "
          f"{err:.3e} (rel {rel:.2e}, tol {tol})")
    if not (torch.isfinite(outs[0]).all() and rel <= tol):
        fail(f"{tag}: {dtype} model, kernels vs plain relative error {rel}")


def phase_slice(seed: int, smi: str) -> int:
    from spnet_tpu_torch.eval.metrics import calc_errors, calc_map
    from spnet_tpu_torch.config import ExperimentConfig
    from spnet_tpu_torch.grid import denormalize
    from spnet_tpu_torch.io.render import show_pred_ellipses

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
    for dtype in ("float32", "bfloat16"):
        _kernels_vs_plain(cfg.model, model.state_dict(), x[:16], "slice",
                          dtype)
    return counts["sepconv_infer"]


def _loss_inputs(b, m, gen):
    """Targets with a 0/1 noobj flag on every slot (80% empty), predictions
    scattered around them."""
    yt = torch.randn(b, m, device=DEVICE, generator=gen)
    yt.view(b, -1, 8)[..., 6] = (torch.rand(b, m // 8, device=DEVICE,
                                            generator=gen) < 0.8).float()
    yp = yt + 0.3 * torch.randn(b, m, device=DEVICE, generator=gen)
    return yt, yp


def _timings(fn) -> dict:
    """ms: device time per call from a CUDA graph of 100 calls; call_ms:
    the median event time of single calls; host_us: host time per eager
    call."""
    return dict(ms=graph_ms(fn), call_ms=cuda_median_ms(fn),
                host_us=host_us(fn))


def _timing_line(tag: str, t: dict) -> str:
    """One line of `_timings` results (and plain versions' `ms`)."""
    parts = (("device ms per call (graph of 100)", "ms", ".5f"),
             ("one call, event ms", "call_ms", ".4f"),
             ("host us per call", "host_us", ".2f"))
    return f"[{tag}]   " + "; ".join(
        title + ":" + "".join(f" {k} {v[key]:{fmt}}" for k, v in t.items()
                              if key in v) for title, key, fmt in parts)


def phase_loss(seed: int, smi: str, floor_ms: float) -> dict:
    """The loss kernel (K2/K3 in one pass) and the backward's scale kernel
    against the twin, eagerly and from CUDA graphs, with their times at
    every shape ('same')."""
    from spnet_tpu_torch.config import LossWeights
    from spnet_tpu_torch.ops.losses import spnet_loss, spnet_loss_bwd, \
        spnet_loss_fused, spnet_loss_fwd, spnet_loss_grad_scale, \
        spnet_loss_grad_torch

    w = LossWeights()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = torch.full((), 0.75, device=DEVICE)
    res = dict(fwd_err=0.0, bwd_err=0.0)
    for loss_type in ("same", "hybrid"):
        for b, m in LOSS_SHAPES:
            yt, yp = _loss_inputs(b, m, gen)
            outs = [spnet_loss_fwd(yt, yp, w, loss_type) for _ in range(3)]
            dyp = spnet_loss_bwd(yt, yp, g, w, loss_type)
            p = yp.clone().requires_grad_(True)
            fused = spnet_loss_fused(yt, p, w, loss_type)
            kept = fused.grad_fn.saved_tensors[0]  # freed by the backward
            (f_grad,) = torch.autograd.grad(fused, p, g)
            graph, static = capture(
                lambda: spnet_loss_fwd(yt, yp, w, loss_type))
            replays = []
            for _ in range(3):
                graph.replay()
                replays.append(static.clone())
            del graph
            after = spnet_loss_fwd(yt, yp, w, loss_type)
            torch.cuda.synchronize()
            q = yp.clone().requires_grad_(True)
            ref = spnet_loss(yt, q, w, loss_type)
            (ref_grad,) = torch.autograd.grad(ref, q, g)
            ref = float(ref.detach())
            scale = ref_grad.abs().max().item()
            f_err = abs(float(outs[0]) - ref)
            f_rel = f_err / max(abs(ref), 1e-30)
            fused_rel = abs(float(fused) - ref) / max(abs(ref), 1e-30)
            b_err = (dyp - ref_grad).abs().max().item()
            b_rel = b_err / max(scale, 1e-30)
            fg_rel = (f_grad - ref_grad).abs().max().item() / max(scale,
                                                                  1e-30)
            fg_vs_bwd = ((f_grad - dyp).abs().max()
                         / dyp.abs().max().clamp_min(1e-30)).item()
            line = (f"[loss] {loss_type:6s} B={b} M={m}  fwd err {f_err:.3e} "
                    f"(rel {f_rel:.2e}, tol {LOSS_RTOL})  bwd max_abs_err "
                    f"{b_err:.3e} (rel {b_rel:.2e}, tol {LOSS_RTOL})  fused "
                    f"fwd rel {fused_rel:.2e}, fused grad x g rel "
                    f"{fg_rel:.2e} vs twin, {fg_vs_bwd:.2e} vs spnet_loss_bwd "
                    f"(tol {FUSED_BWD_RTOL}); 3 calls, 3 graph replays and a "
                    "call after them bitwise equal")
            if not all(torch.equal(o, outs[0]) for o in outs + replays +
                       [after]):
                fail(f"loss forward {loss_type} {(b, m)} is not bitwise "
                     f"reproducible: calls {[float(o) for o in outs]}, "
                     f"replays {[float(o) for o in replays]}, after "
                     f"{float(after)!r}")
            if not (f_rel <= LOSS_RTOL and b_rel <= LOSS_RTOL and
                    fused_rel <= LOSS_RTOL and fg_rel <= LOSS_RTOL and
                    fg_vs_bwd <= FUSED_BWD_RTOL):
                fail(f"loss kernels {loss_type} {(b, m)}: forward rel "
                     f"{f_rel}, backward rel {b_rel}, fused forward rel "
                     f"{fused_rel}, fused gradient rel {fg_rel} (twin) / "
                     f"{fg_vs_bwd} (spnet_loss_bwd)")
            res["fwd_err"] = max(res["fwd_err"], f_err)
            res["bwd_err"] = max(res["bwd_err"], b_err)
            if loss_type == "same":
                t = {
                    "fwd": _timings(lambda: spnet_loss_fwd(yt, yp, w)),
                    "bwd": _timings(lambda: spnet_loss_bwd(yt, yp, g, w)),
                    "fused": _timings(lambda: spnet_loss_fused(yt, p, w)),
                    "scale": _timings(lambda: spnet_loss_grad_scale(kept, g)),
                    "fwd_plain": dict(ms=graph_ms(
                        lambda: spnet_loss(yt, yp, w))),
                    "bwd_plain": dict(ms=graph_ms(
                        lambda: spnet_loss_grad_torch(yt, yp, w) * g)),
                }
                line += (f"\n{_timing_line('loss', t)}; launch floor "
                         f"{floor_ms:.5f} ms")
                if b == TRAIN_BATCH:  # the train path's
                    res.update(t)
            print(f"{line}  [{smi}]")
    return res


def phase_loss_ss(seed: int, smi: str, floor_ms: float) -> dict:
    """The loss kernel's 'ss' variant (K4 in the loss's pass) against K4
    then the loss kernel, and against the twins, eagerly and from CUDA
    graphs, with its times at every shape ('same')."""
    from spnet_tpu_torch.config import LossWeights
    from spnet_tpu_torch.ops.activations import SelectiveSigmoid, \
        selective_sigmoid_bwd, selective_sigmoid_fwd, \
        selective_sigmoid_grad_torch, selective_sigmoid_torch
    from spnet_tpu_torch.ops.losses import spnet_loss, spnet_loss_bwd, \
        spnet_loss_fused, spnet_loss_fwd, spnet_loss_grad_torch

    w = LossWeights()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    res = dict(err=0.0)
    for loss_type in ("same", "hybrid"):
        for b, m in LOSS_SHAPES:
            yt, _ = _loss_inputs(b, m, gen)
            z = 4 * torch.randn(b, m, device=DEVICE, generator=gen)

            def ss_loss():
                return spnet_loss_fused(yt, z, w, loss_type,
                                        selective_sigmoid=True)

            def ss_grad(p, g):
                """dloss/dz of the fused route at the leaf p (a copy of z).
                Each caller has its own leaf and keeps no loss alive: a
                leaf's gradient accumulator stays on the stream it was
                made on, which a graph captured on another stream must not
                wait for."""
                loss = spnet_loss_fused(yt, p, w, loss_type,
                                        selective_sigmoid=True)
                return torch.autograd.grad(loss, p, g)[0]

            def leaf():
                return z.clone().requires_grad_(True)

            outs = [ss_loss() for _ in range(3)]
            graph, static = capture(ss_loss)
            replays = []
            for _ in range(3):
                graph.replay()
                replays.append(static.clone())
            del graph
            after = ss_loss()
            s = selective_sigmoid_fwd(z)
            k4_k2 = spnet_loss_fwd(yt, s, w, loss_type)
            s_twin = selective_sigmoid_torch(z)
            twin = spnet_loss(yt, s_twin, w, loss_type)
            twin_grad = selective_sigmoid_grad_torch(
                s_twin, spnet_loss_grad_torch(yt, s_twin, w, loss_type))
            g_rel, bitwise = {}, None
            for gv in (1.0, 0.75):
                g = torch.full((), gv, device=DEVICE)
                grad = ss_grad(leaf(), g)
                ref = selective_sigmoid_bwd(s, spnet_loss_bwd(yt, s, g, w,
                                                              loss_type))
                g_rel[gv] = ((grad - ref).abs().max()
                             / ref.abs().max().clamp_min(1e-30)).item()
                if gv == 1.0:
                    bitwise = torch.equal(grad, ref)
                    t_rel = ((grad - twin_grad).abs().max()
                             / twin_grad.abs().max().clamp_min(1e-30)).item()
                    err = (grad - twin_grad).abs().max().item()
            torch.cuda.synchronize()
            l_rel = abs(float(outs[0]) - float(twin)) / max(abs(float(twin)),
                                                            1e-30)
            line = (f"[loss-ss] {loss_type:6s} B={b} M={m}  loss "
                    f"{'bitwise equal' if torch.equal(outs[0], k4_k2) else 'DIFFERS'}"
                    f" to K4 -> K2 ({float(outs[0]).hex()}), rel {l_rel:.2e} "
                    f"vs the twins (tol {LOSS_RTOL}); grad wrt z vs K4 bwd o "
                    f"K2 grad x g: rel {g_rel[1.0]:.2e} at g=1 (bitwise "
                    f"{bitwise}), {g_rel[0.75]:.2e} at g=0.75 (tol "
                    f"{SS_GRAD_RTOL}); vs the twins {t_rel:.2e} (tol "
                    f"{LOSS_RTOL}); 3 calls, 3 graph replays and a call "
                    "after them bitwise equal")
            if not torch.equal(outs[0], k4_k2):
                fail(f"ss loss {loss_type} {(b, m)}: {float(outs[0])!r} is "
                     f"not bitwise K4 -> K2's {float(k4_k2)!r}")
            if not all(torch.equal(o, outs[0]) for o in outs + replays +
                       [after]):
                fail(f"ss loss {loss_type} {(b, m)} is not bitwise "
                     f"reproducible: calls {[float(o) for o in outs]}, "
                     f"replays {[float(o) for o in replays]}, after "
                     f"{float(after)!r}")
            if not (max(g_rel.values()) <= SS_GRAD_RTOL and
                    l_rel <= LOSS_RTOL and t_rel <= LOSS_RTOL):
                fail(f"ss loss {loss_type} {(b, m)}: gradient rel {g_rel} "
                     f"(K4 bwd o K2), {t_rel} (twins); loss rel {l_rel}")
            res["err"] = max(res["err"], err)
            if loss_type == "same":
                g = torch.full((), 0.75, device=DEVICE)
                p1, p2, p3 = leaf(), leaf(), leaf()

                def composed():  # the parent's route: 4 launches
                    loss = spnet_loss_fused(yt, SelectiveSigmoid.apply(p3),
                                            w)
                    return torch.autograd.grad(loss, p3, g)[0]

                t = {
                    "ss_fused": _timings(lambda: spnet_loss_fused(
                        yt, p1, w, selective_sigmoid=True)),
                    "ss_step": dict(ms=graph_ms(lambda: ss_grad(p2, g))),
                    "ss_step_composed": dict(ms=graph_ms(composed)),
                }
                line += (f"\n{_timing_line('loss-ss', t)}; launch floor "
                         f"{floor_ms:.5f} ms")
                if b == TRAIN_BATCH:
                    res.update(t)
            print(f"{line}  [{smi}]")
    return res


def _seeded_split(sizes, size: int, grid, seed: int):
    """Datasets of the given sizes from one seeded `_seeded_dataset`."""
    from spnet_tpu_torch.data.dataset import Dataset

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
                        swap: str, fused: bool = True) -> dict:
    """One float32 train-mode forward + loss + head-weight gradient from
    the same weights, dropout mask and batch, twice: with the kernels and
    with the plain versions of those `swap` names.  swap='loss': the fused
    loss (K2/K3) against its twin; swap='model': the model's kernels
    against their plain versions (`plain_kernels`), both with the fused
    loss, or both with the twin when not `fused`.  On an 'ss' head the
    kernel side of swap='model' takes the fused route (K4 in the loss
    kernel's pass), or with fused=False K4's own forward and backward.
    Loss rel <= STEP_LOSS_RTOL, gradient rel <= STEP_GRAD_RTOL.  Returns
    the launch counts of the kernel side's step."""
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.config import LossWeights
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
        xp = _prep_x(x16)
        _zero_counts()
        loss, _ = forward_loss(
            model, xp, y16,
            torch.Generator(device=DEVICE).manual_seed(seed), LossWeights(),
            model_cfg.loss_type,
            fused=fused and not (plain and swap == "loss"))
        head = (model.sigmoid_output if model.compound_head
                else model.final_output)
        (gw,) = torch.autograd.grad(loss, head.weight)
        res.append((float(loss.detach()), gw))
        if not plain:
            counts = _counts()
        del model
    l_rel = abs(res[0][0] - res[1][0]) / abs(res[1][0])
    g_rel = ((res[0][1] - res[1][1]).abs().max()
             / res[1][1].abs().max()).item()
    print(f"[{tag}] float32 step, {model_cfg.loss_type}, {swap} kernels vs "
          f"plain{'' if fused else ' (fused=False)'}: loss rel {l_rel:.2e} "
          f"(tol {STEP_LOSS_RTOL}), head-weight gradient rel {g_rel:.2e} "
          f"(tol {STEP_GRAD_RTOL}); kernel side's launches {counts}")
    if not (l_rel <= STEP_LOSS_RTOL and g_rel <= STEP_GRAD_RTOL):
        fail(f"{tag}: float32 step, loss rel {l_rel}, head gradient rel "
             f"{g_rel}")
    return counts


def phase_train(seed: int, smi: str) -> dict:
    import dataclasses

    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.config import (
        ExperimentConfig, ModelConfig, TrainConfig,
    )
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
        print(f"[k4] B={b} M={m}  fwd max_abs_err {f_err:.3e} (rel "
              f"{f_rel:.2e}, tol {SIGMOID_RTOL})  bwd max_abs_err "
              f"{b_err:.3e} (rel {b_rel:.2e}, tol {SIGMOID_RTOL})")
        if not (f_rel <= SIGMOID_RTOL and b_rel <= SIGMOID_RTOL):
            fail(f"selective sigmoid {(b, m)}: forward rel {f_rel}, "
                 f"backward rel {b_rel} > {SIGMOID_RTOL}")
        res["fwd_err"] = max(res["fwd_err"], f_err)
        res["bwd_err"] = max(res["bwd_err"], b_err)
        t = {
            "fwd": _timings(lambda: selective_sigmoid_fwd(x)),
            "bwd": _timings(lambda: selective_sigmoid_bwd(y, g)),
            "fwd_plain": dict(ms=graph_ms(lambda: selective_sigmoid_torch(x))),
            "bwd_plain": dict(ms=graph_ms(
                lambda: selective_sigmoid_grad_torch(y, g))),
        }
        print(f"{_timing_line('k4', t)}  [{smi}]")
        if b == TRAIN_BATCH and m == 576:
            res.update(t)
    return res


def phase_heads(seed: int, smi: str) -> dict:
    """The other heads and the MobileNet backbone, served and trained."""
    import dataclasses

    from spnet_tpu_torch.config import (
        ExperimentConfig, ModelConfig, TrainConfig,
    )

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
            _kernels_vs_plain(mc, model.state_dict(), x[:16], tag)
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
            for loss_type in ("same", "hybrid"):
                f32 = dataclasses.replace(mc, compute_dtype="float32",
                                          loss_type=loss_type)
                counts = _f32_step_agreement(f32, x16, y16, seed, tag,
                                             swap="model")
                if counts != _want_counts(f32, train_steps=1):
                    fail(f"{tag}: f32 step launches {counts}")
            # fused=False: K4's own forward and backward on the model
            counts = _f32_step_agreement(f32, x16, y16, seed, tag,
                                         swap="model", fused=False)
            want = dict(_want_counts(f32), selective_sigmoid_fwd=1,
                        selective_sigmoid_bwd=1)
            if counts != want:
                fail(f"{tag}: f32 step with fused=False, launches {counts} "
                     f"!= {want}")
            out[tag]["k4_bwd_launches"] = counts["selective_sigmoid_bwd"]
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
    floor_ms = launch_floor_ms()
    loss = phase_loss(args.seed, smi, floor_ms)
    loss_ss = phase_loss_ss(args.seed, smi, floor_ms)
    train = phase_train(args.seed, smi)
    k4 = phase_k4(args.seed, smi)
    heads = phase_heads(args.seed, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase; "
          f"train {train['img_per_sec']:.1f} images/s at b={TRAIN_BATCH} "
          f"[{smi}]")
    # K2-K4 at their timed shapes (TRAIN_BATCH x 576 float32): each input
    # read once, each output written once; their few operations an element
    # are far below the bytes' time.  ms: device time per call from a CUDA
    # graph; call_ms: one call between two events; host_us: host time per
    # eager call; floor_ms: a one-element add_ timed as ms is.
    n = TRAIN_BATCH * 576 * 4

    def small(name, source, replaces, launches, err, t, plain, nbytes,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": plain["ms"],
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "bound_by": "bytes", "library_ms": None,
                "call_ms": t["call_ms"], "host_us": t["host_us"],
                "floor_ms": floor_ms, **extra}

    loss_src = "spnet_tpu_torch/csrc/loss.cu"
    k4_src = "spnet_tpu_torch/csrc/activations.cu"
    k4_at = "spnet_tpu/ops/activations.py:36"
    print(json.dumps({"kernels": [{
        "name": "sepconv_infer",
        "route": "cuda",
        "source": "spnet_tpu_torch/csrc/sepconv.cu",
        "replaces": "spnet_tpu/ops/sepconv_pallas.py:76",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "graph_ms": kern["graph_ms"],  # the b=16 batch from a CUDA graph
    },
        # the loss alone; the train step's forward also writes the
        # gradient (fused_ms, fused_bound_ms)
        # ss_fused_ms: the 'ss' train step's forward (K4 in the pass, the
        # gradient wrt the pre-activation); ss_launches: its launches in
        # phase 7's 'ss' training run
        small("spnet_loss_fwd", loss_src, "spnet_tpu/ops/losses.py:135",
              train["fwd_launches"], loss["fwd_err"], loss["fwd"],
              loss["fwd_plain"], 2 * n + 4, fused_ms=loss["fused"]["ms"],
              fused_bound_ms=1e3 * (3 * n + 4) / HBM_BYTES_PER_S,
              ss_fused_ms=loss_ss["ss_fused"]["ms"],
              ss_launches=heads["ss"]["train_counts"][SS_COUNT],
              ss_max_abs_err=loss_ss["err"],
              ss_step_ms=loss_ss["ss_step"]["ms"],
              ss_step_composed_ms=loss_ss["ss_step_composed"]["ms"]),
        # g * dloss/dy_pred from y_true, y_pred and g; the train step's
        # backward scales the kept gradient (scale_ms, scale_bound_ms)
        small("spnet_loss_bwd", loss_src, "spnet_tpu/ops/losses.py:176",
              train["bwd_launches"], loss["bwd_err"], loss["bwd"],
              loss["bwd_plain"], 3 * n + 4, scale_ms=loss["scale"]["ms"],
              scale_bound_ms=1e3 * (2 * n + 4) / HBM_BYTES_PER_S),
        small("selective_sigmoid_fwd", k4_src, k4_at,
              heads["ss"]["predict_counts"]["selective_sigmoid_fwd"],
              k4["fwd_err"], k4["fwd"], k4["fwd_plain"], 2 * n),
        # on the 'ss' train step K4 runs inside the loss kernel's pass:
        # its backward's launches are those of phase 7's fused=False step
        small("selective_sigmoid_bwd", k4_src, k4_at,
              heads["ss"]["k4_bwd_launches"],
              k4["bwd_err"], k4["bwd"], k4["bwd_plain"], 3 * n),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
