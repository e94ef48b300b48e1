"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Phases, one or more lines each; any failed
check raises and the run exits non-zero:

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions; TF32 is switched off for the float32 checks;
  2. build   - compiles the CUDA kernels from `spnet_tpu_torch/csrc`;
  3. kernel  - the fused separable-conv kernel against its plain PyTorch
               version at the 10 Xception-331 shapes (b=16, ReLU on and off)
               and two ragged shapes, in float32 and bfloat16, with the
               median time of each (CUDA events);
  4. slice   - the serving path at full width: SPNet Xception-331 (bf16,
               seeded Keras init, seeded BN running stats) saved as a port
               checkpoint, reloaded through the CLI's loader, 64 seeded
               uint8 frames through `predict_in_batches` at b=16, then
               denormalize, calc_errors, calc_map and the prediction CSV.
               Checks the kernel's launch count on that run, finite outputs,
               and float32 agreement of the whole model between the kernel
               and the plain separable conv.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`.  Exits non-zero without a result when no
CUDA device is available.  Needs torch and numpy, no jax and no PIL.
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
    cases += [(s, relu, 0) for s in RAGGED_SHAPES for relu in (False, True)]
    max_err = 0.0
    ms = plain_ms = 0.0
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
            if dtype == torch.bfloat16:
                ms += uses * t_k
                plain_ms += uses * t_p
    print(f"[kernel] one bf16 predict batch (b=16, 34 sepconvs): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms  [{smi}]")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _seeded_dataset(n: int, size: int, grid, seed: int):
    """n uint8 (size, size, 1) frames and their normalized grid labels,
    from numpy only."""
    from spnet_tpu.grid import batch_ellipses_to_grid, \
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


def phase_slice(seed: int, smi: str) -> int:
    from spnet_tpu.config import ExperimentConfig, ModelConfig
    from spnet_tpu.grid import denormalize
    from spnet_tpu.io.render import show_pred_ellipses
    from spnet_tpu_torch.cli.common import load_model_and_state
    from spnet_tpu_torch.eval.metrics import calc_errors, calc_map
    from spnet_tpu_torch.io.checkpoint import save_checkpoint
    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.ops.sepconv import sepconv_infer
    from spnet_tpu_torch.train.loop import predict_in_batches
    from spnet_tpu_torch.train.steps import make_predict_step

    cfg = ExperimentConfig()  # Xception-331, bf16 compute, f32 params
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg.model, num_outputs=cfg.grid.num_outputs,
                        generator=gen)
    with torch.no_grad():  # non-trivial running stats: the fold is no identity
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[slice] SPNet Xception-{cfg.model.input_size} "
          f"{cfg.model.compute_dtype}: {n_params / 1e6:.2f} M params")
    batch, n_frames = 16, 64
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, model.state_dict(), cfg, step=0)
        cfg, model, _ = load_model_and_state(ckpt, "cuda")
        x, y = _seeded_dataset(n_frames, cfg.model.input_size, cfg.grid,
                               seed)
        predict = make_predict_step(model)

        sepconv_infer.launches = 0
        y_pred, fps = predict_in_batches(predict, x, batch, "cuda",
                                         verbose=False)
        launches = sepconv_infer.launches
        want = SEPCONVS_PER_BATCH * (n_frames // batch + 1)  # + warm-up
        print(f"[slice] predict {n_frames} frames at b={batch}: "
              f"{fps:.1f} frames/s (time to host values)  [{smi}]")
        print(f"[slice] sepconv kernel launches in that run: {launches} "
              f"(want {SEPCONVS_PER_BATCH} x {n_frames // batch + 1} = "
              f"{want})")
        if launches != want:
            fail(f"sepconv launches {launches} != {want}")
        if y_pred.shape != (n_frames, cfg.grid.num_outputs) or \
                not np.isfinite(y_pred).all():
            fail(f"predictions: shape {y_pred.shape}, finite "
                 f"{np.isfinite(y_pred).all()}")

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

        # the same weights in float32, kernel vs plain separable conv
        state = model.state_dict()
        f32 = ModelConfig(compute_dtype="float32")
        outs = []
        for plain in (False, True):
            mf = build_model(f32, cfg.grid.num_outputs, device="cuda",
                             plain_sepconv=plain)
            mf.load_state_dict(state)
            outs.append(make_predict_step(mf)(
                torch.from_numpy(x[:batch]).cuda()).float())
            del mf
        err = (outs[0] - outs[1]).abs().max().item()
        rel = err / max(outs[1].abs().max().item(), 1e-30)
        print(f"[slice] float32 model, kernel vs plain sepconv: max_abs_err "
              f"{err:.3e} (rel {rel:.2e}, tol {MODEL_F32_RTOL})")
        if not (torch.isfinite(outs[0]).all() and rel <= MODEL_F32_RTOL):
            fail(f"float32 model: kernel vs plain relative error {rel}")
    return launches


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
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase")
    print(json.dumps({"kernels": [{
        "name": "sepconv_infer",
        "route": "cuda",
        "source": "spnet_tpu_torch/csrc/sepconv.cu",
        "replaces": "spnet_tpu/ops/sepconv_pallas.py:76",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
