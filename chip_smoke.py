"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Phases, one or more lines each; any failed
check raises and the run exits non-zero:

  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
               versions; TF32 is switched off for the float32 checks;
  2. build   - compiles the CUDA kernels from `spnet_tpu_torch/csrc`;
  3. kernel  - the fused separable-conv kernel against its plain PyTorch
               version at the 10 Xception-331 shapes (b=16 with the input
               and output ReLU as the model has them and flipped; b=64,
               `bench_infer`'s batch, and b=256, the train path's val-sweep
               batch, as the model has them; b=512, `movie_predict`'s
               batch, five timings each) and two ragged shapes, in float32
               and bfloat16, with the median
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
               scale kernel against the plain PyTorch twin at B = 16, 32, 128,
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
               the pre-activation z = 4 randn) at the same 6 shapes x 2
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
               optimizer count.  Checks K2 and K3 launches (on the epoch
               form, the CUDA graph of phase 20: its eager warm-up steps
               and the captured step; elsewhere every step), K1
               launches = 34 per val batch (warm-up included), finite losses,
               moved BN statistics, losses.dat and the checkpoint; prints the
               train images/s.  Then 30 steps on one b=16 batch (no
               augmentation, no dropout, lr 1e-4) must lower the loss, and
               one float32 train step with the kernel loss must agree with
               the same step on the plain twin (loss rel 1e-6, head-weight
               gradient rel 1e-5);
  7. heads   - the selective-sigmoid kernel K4 (forward and backward)
               against its plain twins at B = 16, 32, 128, 256 x M = 576 and two
               ragged shapes (rel 1e-6; graph, event and host times as in
               phase 5); the 'ss' head
               (Xception-331 bf16 + K4) served from a port checkpoint whose
               `experiment.json` selects it: 64 frames at b=16, K4 launches
               = batches + warm-up, K1 34 per batch, noobj lanes in (0, 1),
               and the f32 model with the kernels against the plain versions
               (rel 1e-4); the 'ss' head trained through `train_network`
               (b=128, 2 epochs of 4 steps; the loss kernel's 'ss' variant
               and the scale launch in each eager or captured step, K4
               only in the val
               sweeps) and one f32 train step on the fused route against
               the plain model with the kernel loss, under 'same' and
               'hybrid' (loss rel 1e-6, head-weight gradient rel 1e-5), and
               one with fused=False, which drives K4's forward and backward
               on the model (launch counts checked), against the twins;
               then the
               compound head (Xception-331) and MobileNet-331, bf16, each
               served (b=16) and trained (b=128, 2 epochs) the same way,
               with their frames/s and train images/s;
  8. zoo     - DarkNet19, InceptionResNetV2 and NASNetMobile at 331, bf16
               compute with f32 params, each served (port checkpoint, the
               CLI's loader, 64 frames at b=16) and trained (b=128, 2
               epochs of 4 steps, then resumed to 3), with every launch
               count checked (no K1 or K4; K2 = K3 as in phase 6); one f32
               step with the kernel loss against the plain twin; the f32
               eval output on the card against the same model on the CPU
               on 2 frames (TF32 off, rel ZOO_CPU_RTOL); predict frames/s,
               train images/s and the peak of `max_memory_allocated` of
               each path;
  9. tta     - the flip ensemble (direct + h, v, hv) on Xception-331 from a
               port checkpoint: `predict_tta` over 64 frames at b=16 (K1 34
               per batch per view, warm-ups included, finite merged
               predictions), then `evaluate_network(..., tta="h,v,hv")` on
               the same frames (its own sweep batch, 64) with its launch
               count and metrics; the ensemble frames/s of both.
  10. synth  - the synthetic feed and geometric training: one render batch
               of 256 frames timed stage by stage, twice (scene sampling,
               the noise-free render, the noise stage with its 256
               generators, the resize, the uint8 copy, and PIL's PNG of 32
               native frames); `synthetic_dataset` on the card
               (512 train + 256 val frames at 331^2, frames/s); the
               noise-free render (share of flipped pixels <= 1e-3) and the
               resize (rel 2e-5) on the card against the CPU; the geo warp
               of 32 frames against the CPU (image 2e-4, rows 1e-4) and the
               encoder on the card against the host codec (slot lanes
               bitwise, angle lanes 2e-6, bitwise or not printed);
               `train_network` with geo_augment, epoch_repeats 2 and use_tb
               (Xception-331 bf16, b=128, 2 epochs, then resumed to 3: K2 =
               K3 = 16 a 2-epoch run, K1 34 per val batch, the 7 TensorBoard
               scalars each epoch); 10 + 10 train steps with and without
               geo in turns and 3 geo steps under `utils.profiling.trace`
               (the geo stages' share of the device time from the trace);
               then `gen-fake-espi -n 96 --all` and `train --geo_augment
               --epoch_repeats 2 --use_tb --profile` (1 epoch, b=16)
               through the CLI's `main`, with its
               launch counts, its trace's kernel names (the repo's kernels
               among them) and the geo stages' share.
  11. feeds  - `train_network` with device_data True (resident), False
               (host-fed: each batch sliced on the host and copied one
               ahead through pinned memory on a side stream) and "chunked"
               (a chunk budget that `plan_chunks` turns into 4 chunks of
               512): Xception-331 bf16, b=128, 2048 seeded frames + 256
               val, augmentation on, 2 epochs a run, two runs of each in
               turns (resident, host-fed, chunked, then reversed), with
               their images/s and launch counts (K2 = K3 = steps; the
               resident feed's as in phase 6, K1 34
               per val batch);
               every host-fed batch and every chunk on the card equal to
               its host rows, and the chunked visit order equal to the
               same streamer's on the CPU; 2 steps with augmentation off,
               host-fed losses bitwise the resident ones (cuDNN
               deterministic); 5 steps of each feed under torch.profiler,
               in turns, and the device's idle share from the traces;
  12. remat  - Xception-331 bf16 train steps at b=128 with the backbone
               checkpointed and not, in turns: step time and the peak of
               `max_memory_allocated`; one float32 b=16 step both ways:
               loss and gradients (rel 1e-5) and BN running statistics
               (rel 1e-6), bitwise or not printed;
  13. export - Xception-331 bf16 port checkpoints (default and 'ss'
               head) exported on the card (`io/export.py`, symbolic
               batch) and loaded; 256 seeded frames at b=16 through
               `predict_in_batches`, eager and artifact in turns, and a
               b=7 batch: bitwise equal, K1 34 per batch and K4 1 per
               batch through the artifact's operators; export and load
               seconds, frames/s and host ms per batch of each;
  14. pretrained - if keras and h5py import (Keras on its torch backend,
               its optional jax import refused): a random-weight Keras
               Xception's `.weights.h5` -> `train_network(pretrained=...)`,
               2 steps at b=128, the backbone before the first step
               bitwise the file's; else one line that says so.
  15. prep   - the data-preparation commands through their CLI `main`:
               `gen-fake-espi` (16 native 512x384 frames on the card) -> an
               aggregated Zooniverse CSV of their labels (swapped axes, a
               duplicate) -> `parse-zooniverse` (rows as the labels) ->
               `gen-bboxes` (a box a row) -> `setup-data -a 4` (Train/ and
               Val/ counts); `augment -n 42` of 8 files on the card (336
               variants: files/s and the warp's share of the command's
               time), 2 of them on the CPU against it (names identical,
               rows within 1e-4, pixels within 1 gray level); the
               editor's data model (no display here);
  16. dp     - data-parallel training, Xception-331 bf16 with f32 params:
               (a) a 1-rank NCCL group through `train_network` (b=128, 512
               + 256 frames, 2 epochs, resumed to 3; K2 = K3 = steps: a
               group trains eager steps, K1 34
               per val batch), 2 steps (augmentation and dropout off)
               bitwise the same without a group, train images/s with
               and without the group in turns, and the step with and
               without it in turns, timed and traced (a step's device
               time, its NCCL kernels and copies, the idle share, the
               kernels the group adds); (b) two NCCL ranks on the
               one card (refused: "Duplicate GPU", printed), then two gloo
               ranks (`chip_smoke.py --dp-child`, the backend passed
               explicitly) through `train_network` on their shards (b=128
               global, 2 epochs of 4 steps): each rank's resident training
               bytes (its own shard: half the union's), train losses and
               BatchNorm running statistics equal on both, launches per
               rank, the shared card's images/s (labelled, no claim); the
               sharded set's exchange (`ShardedRows`) on the card for one
               epoch's steps: each rank's rows bitwise the union's [idx_r];
               and one float32 b=16 step: loss and head-kernel gradient
               against one process (rel 1e-5);
  17. bench  - the port's benchmarks as a user runs them:
               `tools/bench.py::main` (Xception-331 bf16, b=128, the
               synthetic set, a warm-up and a timed epoch of BENCH_STEPS
               steps, through the epoch form and the eager steps in turns:
               its four keys, a finite positive rate, K2 = K3 = the graphed
               turns' warm-up steps and captures + the eager turns'
               steps), then `tools/bench_infer.py`'s two modes (pipelined
               batches; the sweep captured once as a CUDA graph and
               replayed) at b=64 and b=16 over 4096 seeded frames: frames/s
               of each, the two outputs bitwise equal, K1 34 a batch (the
               sweep's counted in the captured graph);
  18. native - native resolution (`input_size=0`, uncut 512x384 frames):
               (a) K1 against its plain version at the ten shapes of
               Xception at 384x512 (`NATIVE_SHAPES`), b=16, 64 and 256,
               float32 and bfloat16, with the path each takes (wgmma tiles
               or the simple kernel) and, in bf16, its time, bound, % of
               bound and the library pair; (b) Xception-384x512 bf16
               served from a port checkpoint (256 frames at b=16: frames/s,
               launches) and held, float32 and bf16, against its plain
               version; (c) `train_network` at b=128 on 512 + 256 seeded
               native frames, 2 epochs: finite losses, launches, the run's
               peak of `max_memory_allocated`.  Each of 17 and 18 prints
               its seconds.
  19. validation - the accuracy-validation tools through their `main`,
               at a small depth and full width, in a temporary directory:
               `tools.dataset_a 2 32 1e-4 1024 bfloat16 331 Xception` with
               SPNET_NVAL=256 (its result line parses, the train loss falls
               from epoch 1 to 2, the final evaluation holds mAP, ring_acc
               and class_acc), then on its checkpoint `eval_breakdown`
               (256 frames), `eval_tta` (4,992 frames: plain, each flipped
               view, the flip ensemble) and `movie_predict` (512 native
               .bmp frames at b=512); each tool's K1-K3 launches checked and
               its memory readings printed.
  20. epoch  - the epoch form (`train/steps.py::make_train_epoch`: the
               train step captured once as a CUDA graph, with the
               augmentation and dropout generator registered, and replayed
               once a minibatch), which `train_network` trains the resident
               feed through on one rank, against the eager steps from the
               same seeded model and generator seeds, cuDNN deterministic:
               Xception-331 bf16 with f32 params at b=16 and b=128, the
               'ss' head and geometric augmentation at b=16; 8 steps with
               augmentation on, as two epochs of 4 with `unfreeze` between
               (freeze_fac 0.5 before it, so the graph is captured again
               after it): losses, parameters, BN statistics, Adam moments
               and counts bitwise equal, and so between two eager runs
               (cuDNN deterministic makes them so: the pools' backward
               passes gather, with no atomics); K2 / K3 (and the 'ss'
               variant's) launches = the warm-up steps and the captured
               step of each
               capture; capture seconds; both ways, the peak of
               `max_memory_allocated` above what was in use before the run
               and the reserved memory `empty_cache` cannot free that the
               run added (the graph's private pool); then train images/s
               both ways in turns (graph, eager, eager, graph; 32 steps an
               epoch at b=16 and b=32, 16 at b=128).  (b) The same pair
               for DarkNet19, InceptionResNetV2, MobileNet and
               NASNetMobile at 331, bf16 with f32 params, b=32 (the
               25-epoch sweep's batch) on the same 256 frames: every
               leaf bitwise as above; K2 = K3 = 6 launches a pair (2
               warm-up steps + 1 captured step, twice), so
               `epoch_launches` holds 8 pairs of 6; capture seconds, peak
               and held memory, images/s in turns; 20(b)'s seconds.
  21. dataset_d - the Dataset-D tools through their `main`, at a small
               depth and full width, in a temporary directory:
               `dataset_d_prep 48 16 4` (gen-fake-espi's native PNG frames,
               the train split inflated 4x by `augment`: the file names
               those of augment's own draws, no kernel launched), then
               `dataset_d 48 1 --arm offline` (the inflation reused
               through its marker) and `--arm onthefly --rep R` (R = the
               offline frames // 48): both on the resident feed's epoch
               form, each run's K1-K3 launches, finite results, images
               seen, images/s and stage seconds; then `eval_blur_split` (64
               frames a set) on a checkpoint of the offline arm's state.
  22. refgen - the reference generator's frames and their training run
               through the tools' `main`, at a small depth and full width,
               in a temporary directory: 2 shards of 64 frames at 331
               drawn serially and over the pool of `os.cpu_count()`
               workers (bitwise equal), a rerun that skips both, a shard
               of altered versions refused; `refgen_run 1 32 1e-4 bfloat16
               331` on 96 + 32 of them (the resident feed's epoch form,
               its K1-K3 launches, finite results), then `eval_breakdown
               <ckpt> refgen` and `eval_tta <ckpt> refgen h` on its
               checkpoint, each with its K1 launches; frames/s serial and
               pooled, and the stage seconds.
  23. profile - `tools/profile_step.py` through its `main`, Xception-331
               bf16: the epoch form (the graphed step) at b=16 and b=128
               and the eager step at b=16, 5 traced steps each after a
               warm-up: the step's ms, the busy share, the top kernels and
               the device time by kernel class, printed with the card's
               name and power limit; the b=16 epoch form must show the
               loss kernel 5 times inside the graph replays (else the tool
               raises); the class sums add up to the total; each run's
               K1-K3 launches (the replays pass no wrapper).

Every model path runs with all five launch counts (and the loss kernel's
count of 'ss' launches) set to 0 just before it and checks them all just
after.  The line before the last is the kernels' JSON record (for K2-K4
`ms` is the graph-timed device time at 128 x 576, beside `call_ms`,
`host_us` and `floor_ms`; K2 adds `ss_fused_ms` and `ss_launches`;
`feeds_launches`, `remat_launches`, `pretrained_launches` and
`export_launches` are the counts of phases 11-14, `dp_launches` of K1-K3
those of phase 16, `bench_launches` and `native_launches` those of phases
17 and 18; K1 adds its native b=16 batch's `native_ms`, `native_plain_ms`,
`native_bound_ms` and `native_library_ms`; K1-K3 add
`validation_launches`, each tool's count in phase 19; K2-K3 add
`epoch_launches`, phase 20's graphed runs (Xception's four and 20(b)'s
four backbones), and K2 `epoch_ss_launches`;
K1-K3 add `dataset_d_launches`, phase 21's runs, `refgen_launches`,
phase 22's, and `profile_launches`, phase 23's; K2 `profile_trace_calls`,
the loss kernel's calls in each phase-23 trace);
the last line is
`{"ok": true, "device": {...}}`.  Exits
non-zero without a result when no CUDA device is available.  Needs torch
and numpy, no jax; phase 10 writes and reads PNG files with PIL.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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
# the same 34 separable convs at native resolution (`input_size=0`, uncut
# 512x384 frames): odd widths and heights the 331 path never has
NATIVE_HW = [(93, 125), (93, 125), (47, 63), (47, 63), (24, 32), (24, 32),
             (12, 16), (12, 16), (6, 8), (6, 8)]
NATIVE_SHAPES = [(16, h, w, *s[3:])
                 for (h, w), s in zip(NATIVE_HW, XCEPTION_SHAPES)]
RAGGED_SHAPES = [(2, 7, 5, 24, 40), (3, 9, 9, 33, 70)]
SEPCONVS_PER_BATCH = sum(s[-1] for s in XCEPTION_SHAPES)  # 34
# the val sweep's batch on the train path: max(b, min(256, val frames))
# (`train/loop.py`), 256 for phase 6
VAL_BATCH = 256
# `tools/bench_infer.py`'s default batch (phase 17; checked in 3 and 18(a))
INFER_BATCH = 64
# `tools/movie_predict.py`'s batch (phase 19; checked in 3)
MOVIE_BATCH = 512
# (B, M) of the loss kernels: the train batch and its neighbours, and two
# shapes that leave a ragged last block of 256 slots
LOSS_SHAPES = [(16, 576), (32, 576), (128, 576), (256, 576), (3, 8 * 37),
               (5, 8 * 250)]
SIGMOID_RTOL = 1e-6  # K4 vs twin: the same float32 formula, expf vs exp
# the 'ss' variant's gradient x g vs K4's backward of the loss kernel's: g
# multiplies after the sigmoid's factor in one, before it in the other
SS_GRAD_RTOL = 1e-6
TRAIN_BATCH, TRAIN_FRAMES, VAL_FRAMES = 128, 512, 256
DEVICE = "cuda"
# f32 eval, the card (cuDNN, cuBLAS, TF32 off) against the CPU: the same
# formulas, summed in other orders
ZOO_CPU_RTOL = 1e-4
ZOO_BACKBONES = ("DarkNet19", "InceptionResNetV2", "NASNetMobile")
TTA_MODES = ("h", "v", "hv")


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
    cases += [((INFER_BATCH, *s[1:5]), s[5], s[6], 0)
              for s in XCEPTION_SHAPES]
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
    max_err = max(max_err, _movie_batch_kernel(gen, smi))
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
    _descriptor_ring(gen)
    return res


def _movie_batch_kernel(gen, smi: str) -> float:
    """K1 against its plain version at the ten Xception-331 shapes at
    MOVIE_BATCH (`tools/movie_predict.py`'s batch), float32 and bfloat16,
    five timings each; returns the largest absolute error.  The kernel's
    widest 32-bit quantity is the pixel count M = B H W (an int kernel
    argument and TMA row coordinate); element offsets are 64-bit."""
    from spnet_tpu_torch.ops.sepconv import sepconv_infer, \
        sepconv_infer_torch

    max_err = 0.0
    for dtype, rtol in ((torch.float32, F32_RTOL),
                        (torch.bfloat16, BF16_RTOL)):
        total = 0.0
        for _, h, w, c, f, relu, relu_in, uses in XCEPTION_SHAPES:
            args = _sepconv_inputs(MOVIE_BATCH, h, w, c, f, dtype, gen)
            kw = dict(relu=relu, relu_in=relu_in)
            out = sepconv_infer(*args, **kw)
            ref = sepconv_infer_torch(*args, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            t_k = cuda_median_ms(lambda: sepconv_infer(*args, **kw), reps=5)
            total += uses * t_k
            m = MOVIE_BATCH * h * w
            name = str(dtype).replace("torch.", "")
            print(f"[kernel] {name:8s} B={MOVIE_BATCH} {h}x{w} {c}->{f} "
                  f"relu={relu:d} relu_in={relu_in:d}  max_abs_err "
                  f"{err:.3e} (rel {rel:.2e}, tol {rtol})  kernel "
                  f"{t_k:.4f} ms  M = B*H*W = {m} ({(2**31 - 1) / m:.0f}x "
                  f"below the int32 range)  [{smi}]")
            if not rel <= rtol:
                fail(f"sepconv {dtype} B={MOVIE_BATCH} {(h, w, c, f)}: "
                     f"relative error {rel} > {rtol}")
            max_err = max(max_err, err)
            del args, out, ref
        print(f"[kernel] one {str(dtype).replace('torch.', '')} batch of "
              f"b={MOVIE_BATCH} (34 sepconvs): kernel {total:.4f} ms  "
              f"[{smi}]")
    torch.cuda.empty_cache()
    return max_err


#: launches of the descriptor-ring check: more than the launcher's ring of
#: 256 cached TMA descriptors can hold, with one new one a launch
RING_LAUNCHES = 300


def _descriptor_ring(gen):
    """K1's launcher caches TMA descriptors in a ring of 256 and looks up
    three a launch (weight, x, taps).  RING_LAUNCHES bf16 launches with one
    weight and a fresh x each (all kept alive: distinct addresses) walk the
    ring past the weight's entry; every output must match the plain
    version, the launch whose x descriptor takes the weight's slot too."""
    from spnet_tpu_torch.ops.sepconv import sepconv_infer, \
        sepconv_infer_torch

    dw, pw, scale, bias = _sepconv_inputs(2, 8, 8, 64, 64, torch.bfloat16,
                                          gen)[1:]
    xs = [_sepconv_inputs(2, 8, 8, 64, 64, torch.bfloat16, gen)[0]
          for _ in range(RING_LAUNCHES)]
    worst = 0.0
    for x in xs:
        out = sepconv_infer(x, dw, pw, scale, bias)
        ref = sepconv_infer_torch(x, dw, pw, scale, bias)
        worst = max(worst, ((out.float() - ref.float()).abs().max()
                            / ref.float().abs().max()).item())
    torch.cuda.synchronize()
    print(f"[kernel] descriptor ring: {RING_LAUNCHES} launches, one weight, "
          f"a new x each: worst rel err {worst:.2e} (tol {BF16_RTOL})")
    if not worst <= BF16_RTOL:
        fail(f"sepconv after the descriptor ring wrapped: rel err {worst}")


def _seeded_dataset(n: int, size: int, grid, seed: int, raw: bool = False):
    """n uint8 (size, size, 1) frames (native 384 x 512 for size 0) and
    their normalized grid labels, from numpy only; with `raw` also each
    frame's raw ellipse rows (native coordinates)."""
    from spnet_tpu_torch.grid import (
        batch_ellipses_to_grid, canonicalize_records, normalize,
    )

    rng = np.random.default_rng(seed)
    hw = (size, size) if size else (grid.img_height, grid.img_width)
    x = rng.integers(0, 256, (n, *hw, 1), dtype=np.uint8)
    recs, raws = [], []
    for _ in range(n):
        k = int(rng.integers(1, 7))
        a = rng.uniform(12, 90, k)
        raws.append(np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                              rng.uniform(grid.cy_min, grid.cy_max, k),
                              a, a * rng.uniform(0.4, 1.0, k),
                              rng.uniform(0, 180, k),
                              rng.uniform(1, 11, k)], axis=1))
        recs.append(canonicalize_records(raws[-1]))
    y = normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                  grid).astype(np.float32)
    return (x, y, raws) if raw else (x, y)


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


def _train_run(cfg, train_ds, val_ds, tmp, smi, tag="train", **feed):
    """One `train_network` call (`feed`: its device_data, chunk_budget)
    with every launch count set to 0 before and read after; checks what a
    run must show."""
    from spnet_tpu_torch.io.checkpoint import load_checkpoint
    from spnet_tpu_torch.parallel import mesh
    from spnet_tpu_torch.train.loop import train_network

    log_dir, ckpt = os.path.join(tmp, "log"), os.path.join(tmp, "ckpt")
    tc = cfg.train
    steps_per_epoch = (len(train_ds.x) // tc.batch_size) * tc.epoch_repeats
    start = (load_checkpoint(ckpt)[0]["step"] if os.path.exists(ckpt)
             else 0) // steps_per_epoch
    _zero_counts()
    t0 = time.perf_counter()
    state, hist = train_network(cfg, train_ds, val_ds, DEVICE,
                                log_dir=log_dir, ckpt_dir=ckpt,
                                render_overlays=False, **feed)
    seconds = time.perf_counter() - t0
    counts = _counts()
    epochs = tc.epochs - start
    steps = epochs * steps_per_epoch
    val_batches = -(-len(val_ds.x) // max(tc.batch_size,
                                          min(VAL_BATCH, len(val_ds.x))))
    # the resident feed on one rank without remat trains through the
    # epoch form: its warm-up steps and one capture pass the wrappers
    epoch_form = feed.get("device_data") in (None, True) and \
        not mesh.active() and not cfg.model.remat
    want = _want_counts(cfg.model, predict_batches=(val_batches + 1) * epochs,
                        train_steps=_epoch_calls(steps) if epoch_form
                        else steps)
    print(f"[{tag}] epochs {start + 1}..{tc.epochs}: {seconds:.1f} s; "
          f"{steps} steps ({'the epoch form' if epoch_form else 'eager'}), "
          f"{val_batches} val batch(es) + 1 warm-up per epoch; launches "
          f"{counts}")
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


def _card_vs_cpu(model_cfg, state: dict, x, tag: str) -> float:
    """The same weights in float32, eval mode, on the card and on the CPU:
    relative error <= ZOO_CPU_RTOL of the CPU output's scale."""
    import dataclasses

    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.steps import make_predict_step

    cfg = dataclasses.replace(model_cfg, compute_dtype="float32",
                              backbone_dtype="")
    outs = []
    for device in (DEVICE, "cpu"):
        m = build_model(cfg, device=device)
        m.load_state_dict(state)
        outs.append(make_predict_step(m)(torch.from_numpy(x).to(device))
                    .float().cpu())
        del m
    err = (outs[0] - outs[1]).abs().max().item()
    rel = err / max(outs[1].abs().max().item(), 1e-30)
    print(f"[{tag}] float32 eval on the card vs the CPU, {len(x)} frames: "
          f"max_abs_err {err:.3e} (rel {rel:.2e}, tol {ZOO_CPU_RTOL})")
    if not (torch.isfinite(outs[0]).all() and rel <= ZOO_CPU_RTOL):
        fail(f"{tag}: float32 eval, card vs CPU relative error {rel}")
    return rel


def phase_zoo(seed: int, smi: str) -> dict:
    """DarkNet19, InceptionResNetV2 and NASNetMobile at 331: served,
    trained with a resume, one f32 step with the kernel loss against the
    twin, and the f32 eval output on the card against the CPU."""
    import dataclasses

    from spnet_tpu_torch.config import (
        ExperimentConfig, ModelConfig, TrainConfig,
    )

    train_cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=2, save_every=1,
                            seed=seed)
    train_ds = val_ds = None
    out = {}
    gib = 2.0 ** 30
    for backbone in ZOO_BACKBONES:
        tag = f"zoo {backbone}"
        cfg = ExperimentConfig(model=ModelConfig(backbone=backbone),
                               train=train_cfg)
        torch.cuda.reset_peak_memory_stats()
        model, x, _, _, fps, _ = _serve(cfg, seed, smi, tag)
        serve_mem = torch.cuda.max_memory_allocated() / gib
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
        rel = _card_vs_cpu(cfg.model, state, x[:2], tag)
        if train_ds is None:
            train_ds, val_ds = _seeded_split(
                (TRAIN_FRAMES, VAL_FRAMES), cfg.model.input_size, cfg.grid,
                seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            st, hist, counts = _train_run(cfg, train_ds, val_ds, tmp, smi,
                                          tag)
            train_mem = torch.cuda.max_memory_allocated() / gib
            del st
            cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, epochs=3))
            st, _, _ = _train_run(cfg3, train_ds, val_ds, tmp, smi, tag)
            steps = 3 * (TRAIN_FRAMES // TRAIN_BATCH)
            if st.step != steps or st.opt_state.count != steps:
                fail(f"{tag}: resumed run ended at step {st.step}, count "
                     f"{st.opt_state.count}")
            del st
        torch.cuda.empty_cache()
        x16 = torch.from_numpy(train_ds.x[:16]).to(DEVICE)
        y16 = torch.from_numpy(train_ds.y[:16]).to(DEVICE)
        step_counts = _f32_step_agreement(
            dataclasses.replace(cfg.model, compute_dtype="float32"), x16,
            y16, seed, tag, swap="loss")
        if step_counts != _want_counts(cfg.model, train_steps=1):
            fail(f"{tag}: f32 step launches {step_counts}")
        del x16, y16
        torch.cuda.empty_cache()
        out[backbone] = dict(size=cfg.model.input_size, predict_fps=fps,
                             img_per_sec=hist[-1]["img_per_sec"],
                             serve_gib=serve_mem, train_gib=train_mem,
                             train_counts=counts, cpu_rel=rel)
    for backbone, r in out.items():
        print(f"[zoo] {backbone}-{r['size']} bf16: predict "
              f"{r['predict_fps']:.1f} "
              f"frames/s at b=16 (peak {r['serve_gib']:.2f} GiB), train "
              f"{r['img_per_sec']:.1f} images/s at b={TRAIN_BATCH} (epoch "
              f"2; peak {r['train_gib']:.2f} GiB)  [{smi}]")
    return out


def phase_tta(seed: int, smi: str) -> dict:
    """The flip ensemble on Xception-331 from a port checkpoint: predict_tta
    at b=16, then evaluate_network(..., tta='h,v,hv')."""
    from spnet_tpu_torch.config import ExperimentConfig
    from spnet_tpu_torch.data.dataset import Dataset
    from spnet_tpu_torch.eval.evaluate import evaluate_network
    from spnet_tpu_torch.eval.tta import predict_tta
    from spnet_tpu_torch.train.steps import make_predict_step

    cfg = ExperimentConfig()  # Xception-331, bf16 compute, f32 params
    model, x, y, _, _, _ = _serve(cfg, seed, smi, "tta")
    n, views = len(x), 1 + len(TTA_MODES)
    xd = torch.from_numpy(x).to(DEVICE)
    _zero_counts()
    y_tta, fps = predict_tta(make_predict_step(model), xd, 16, DEVICE,
                             cfg.grid, modes=TTA_MODES)
    counts = _counts()
    want = _want_counts(cfg.model, predict_batches=views * (-(-n // 16) + 1))
    print(f"[tta] predict_tta, direct + {TTA_MODES}, {n} frames at b=16: "
          f"{fps:.1f} frames/s over all views (time to host values)  "
          f"[{smi}]")
    print(f"[tta] launches in that run (a warm-up batch per view): {counts}")
    if counts != want:
        fail(f"tta: predict_tta launches {counts} != {want}")
    if y_tta.shape != (n, cfg.grid.num_outputs) or \
            not np.isfinite(y_tta).all():
        fail(f"tta: merged predictions of shape {y_tta.shape}, finite "
             f"{np.isfinite(y_tta).all()}")
    ds = Dataset(x=x, y=y, grid=cfg.grid,
                 file_list=[f"synthetic://{seed}/{i}" for i in range(n)])
    infer_bs = max(cfg.train.batch_size, min(256, n))  # evaluate's own
    _zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        res = evaluate_network(cfg, model, ds, DEVICE, log_dir=tmp,
                               num_draw=0, tta=",".join(TTA_MODES),
                               verbose=0)
    eval_counts = _counts()
    want = _want_counts(cfg.model,
                        predict_batches=views * (-(-n // infer_bs) + 1))
    print(f"[tta] evaluate_network(tta='h,v,hv'), {n} frames at its sweep "
          f"batch {infer_bs}: {res['fps']:.1f} frames/s over all views, mAP "
          f"{res['mAP']:.6f}, mean_pix_err {res['mean_pix_err']:.3f} "
          f"(random weights); launches {eval_counts}  [{smi}]")
    if eval_counts != want:
        fail(f"tta: evaluate launches {eval_counts} != {want}")
    if not (np.isfinite(res["mAP"]) and np.isfinite(res["mean_pix_err"])
            and res["total_obj"] > 0):
        fail(f"tta: metrics {res}")
    del model
    torch.cuda.empty_cache()
    return dict(predict_fps=fps, eval_fps=res["fps"],
                launches=counts["sepconv_infer"],
                eval_launches=eval_counts["sepconv_infer"])


# ---------------------------------------------------------------------------
# Phase 10: the synthetic feed and geometric training
# ---------------------------------------------------------------------------
SYNTH_TRAIN, SYNTH_VAL, GEO_REPEATS = 512, 256, 2
#: the geo step's spans (`utils/profiling.py::span`) by their short names
GEO_STAGES = {"spnet.step.geo_augment": "geo_augment",
              "spnet.step.grid_encode": "grid_encode"}
# the noise-free render, card vs CPU: share of pixels a float32 threshold
# test may flip (the tests' bound against JAX)
RENDER_FLIP_SHARE = 1e-3
RESIZE_RTOL = 2e-5       # float32 resize, card vs CPU (TF32 off)
WARP_ATOL = 2e-4         # geo warp of [-1, 1] frames, card vs CPU
ROWS_ATOL = 1e-4         # remapped rows (native pixels), card vs CPU
ANGLE_LANE_ATOL = 2e-6   # the encoder's cos / sin lanes (float64 cos)
GEN_FRAMES, PROFILE_BATCH = 96, 16
RENDER_BATCH = 256  # synthetic_dataset's render batch


def _sync_s(fn):
    """(result, seconds) of fn() between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trace_summary(path: str) -> dict:
    """From a torch.profiler chrome trace: the device time of all kernels,
    of the kernels launched inside each GEO_STAGES span (a launch's
    correlation id joins the host call to its kernel), and the kernel
    names, in microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    names = {}
    for e in events:
        if e.get("cat") == "kernel":
            corr = e.get("args", {}).get("correlation")
            kernels[corr] = kernels.get(corr, 0.0) + e.get("dur", 0.0)
            names[e["name"]] = names.get(e["name"], 0) + 1
    launches = [e for e in events  # runtime and low-level API calls
                if e.get("cat", "").startswith("cuda_")
                and "correlation" in e.get("args", {})]
    stages = {k: 0.0 for k in GEO_STAGES.values()}
    for a in events:
        if a.get("cat") != "cpu_op" or a.get("name") not in GEO_STAGES:
            continue
        t0, t1 = a["ts"], a["ts"] + a["dur"]
        stages[GEO_STAGES[a["name"]]] += sum(
            kernels.get(c["args"]["correlation"], 0.0) for c in launches
            if c.get("tid") == a.get("tid") and t0 <= c["ts"] <= t1)
    return dict(total_us=sum(kernels.values()), stages_us=stages,
                names=names)


def _ours(names: dict) -> dict:
    """Launches of the repo's kernels among a trace's kernel names."""
    ours = ("wgmma_kernel", "simple_kernel", "loss_kernel",
            "grad_scale_kernel", "sel_sigmoid_fwd_kernel",
            "sel_sigmoid_bwd_kernel")
    found = {}
    for name, n in names.items():
        for k in ours:
            if k in name:
                found[k] = found.get(k, 0) + n
    return found


def _synth_breakdown(seed: int, smi: str) -> dict:
    """One render batch of RENDER_BATCH frames, stage by stage: scene
    sampling (host numpy), the noise-free render, the noise stage (a
    generator a frame), the resize to 331^2, the truncating uint8 copy to
    the host, and the PNG encoding of 32 of the native frames (what
    gen-fake-espi writes); twice, the first a warm-up."""
    import io

    from PIL import Image

    from spnet_tpu_torch.data import synth
    from spnet_tpu_torch.ops.resize import resize

    for rep in ("first", "second"):
        scenes, t_scene = _sync_s(lambda: [synth.sample_scene(seed, f)
                                           for f in range(RENDER_BATCH)])
        arrays = synth.scenes_to_arrays(scenes)
        clean, t_clean = _sync_s(lambda: synth.render_clean(arrays,
                                                            device=DEVICE))
        noisy, t_noise = _sync_s(lambda: synth.add_noise(
            clean, arrays["noise_seed"]))
        small, t_resize = _sync_s(lambda: resize(noisy, (331, 331)))
        _, t_copy = _sync_s(lambda: torch.clamp(small, 0, 255).to(
            torch.uint8).cpu().numpy())
        _, t_gens = _sync_s(lambda: [
            torch.Generator(device=DEVICE).manual_seed(int(s))
            for s in arrays["noise_seed"]])
        native = noisy[:32].to(torch.uint8).cpu().numpy()
        _, t_png = _sync_s(lambda: [
            Image.fromarray(f).save(io.BytesIO(), format="PNG")
            for f in native])
        res = dict(scene_s=t_scene, clean_s=t_clean, noise_s=t_noise,
                   generators_s=t_gens, resize_s=t_resize, copy_s=t_copy,
                   png32_s=t_png)
        print(f"[synth] one batch of {RENDER_BATCH} frames ({rep} time), "
              "seconds between synchronizes: "
              + ", ".join(f"{k[:-2]} {v:.4f}" for k, v in res.items())
              + f" (generators: creating and seeding {RENDER_BATCH} alone;"
              f" png32: PIL's PNG of 32 native frames)  [{smi}]")
    return res


def _card_vs_cpu_synth(seed: int, train_ds) -> dict:
    """The noise-free render and the resize, the geo warp and the encoder:
    each on the card against the same call on the CPU (the encoder against
    the host codec)."""
    from spnet_tpu_torch.data import synth
    from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
        canonicalize_records, normalize
    from spnet_tpu_torch.ops import augment
    from spnet_tpu_torch.ops.grid_encode import encode_batch_device
    from spnet_tpu_torch.ops.resize import resize
    from spnet_tpu_torch.train.steps import _prep_x

    # frames 2, 5, 6, 7 of seed 0 with blur on select kernels 7, 7, 3, none
    arrays = synth.scenes_to_arrays([synth.sample_scene(0, f, blur=True)
                                     for f in (2, 5, 6, 7)])
    card = synth.render_clean(arrays, device=DEVICE).cpu()
    cpu = synth.render_clean(arrays, device="cpu")
    flipped = ((card - cpu).abs() > 1e-3).float().mean().item()
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, (4, 384, 512)).astype(np.float32))
    r_card = resize(x.to(DEVICE), (331, 331)).cpu()
    r_cpu = resize(x, (331, 331))
    r_rel = ((r_card - r_cpu).abs().max() / r_cpu.abs().max()).item()
    print(f"[synth] noise-free render, card vs CPU, 4 frames (blur 7, 7, 3, "
          f"none): {flipped:.2e} of the pixels differ (tol "
          f"{RENDER_FLIP_SHARE}); resize 384x512 -> 331^2 rel {r_rel:.2e} "
          f"(tol {RESIZE_RTOL})")
    if not (flipped <= RENDER_FLIP_SHARE and r_rel <= RESIZE_RTOL):
        fail(f"synth: render card vs CPU {flipped}, resize rel {r_rel}")

    n = min(32, len(train_ds.x))
    xb = _prep_x(torch.from_numpy(train_ds.x[:n]))
    rows = torch.from_numpy(train_ds.rows[:n])
    mask = torch.from_numpy(train_ds.row_mask[:n])
    params = augment.sample_geo_params(
        torch.Generator().manual_seed(seed), n)
    x_cpu, rows_cpu = augment.apply_geo_batch(xb, rows, mask, params)
    x_card, rows_card = augment.apply_geo_batch(
        xb.to(DEVICE), rows.to(DEVICE), mask.to(DEVICE),
        {k: v.to(DEVICE) for k, v in params.items()})
    w_err = (x_card.cpu() - x_cpu).abs().max().item()
    r_err = (rows_card.cpu() - rows_cpu).abs().max().item()
    y_card = encode_batch_device(rows_cpu.to(DEVICE), mask.to(DEVICE),
                                 train_ds.grid).cpu().numpy()
    m = mask.numpy()
    recs = [canonicalize_records(rows_cpu.numpy()[i][m[i]]) for i in range(n)]
    y_host = normalize(batch_ellipses_to_grid(recs, train_ds.grid,
                                              on_overflow="drop"),
                       train_ds.grid).astype(np.float32)
    lanes = np.arange(y_host.shape[1]) % 8
    angle = (lanes == 4) | (lanes == 5)
    e_err = float(np.abs(y_card - y_host).max())
    bitwise = bool(np.array_equal(y_card, y_host))
    print(f"[synth] geo warp of {n} frames, card vs CPU: image "
          f"max_abs_err {w_err:.3e} (tol {WARP_ATOL}), rows {r_err:.3e} "
          f"(tol {ROWS_ATOL}); encoder on the card vs the host codec: "
          f"bitwise {bitwise}, max_abs_err {e_err:.3e} (slot lanes exact, "
          f"angle lanes tol {ANGLE_LANE_ATOL})")
    if not (w_err <= WARP_ATOL and r_err <= ROWS_ATOL
            and np.array_equal(y_card[:, ~angle], y_host[:, ~angle])
            and e_err <= ANGLE_LANE_ATOL):
        fail(f"synth: warp {w_err}, rows {r_err}, encoder {e_err}")
    return dict(render_flipped=flipped, resize_rel=r_rel, warp_err=w_err,
                encode_bitwise=bitwise)


def _geo_step_profile(cfg, train_ds, tmp: str, smi: str) -> dict:
    """Train steps of Xception-331 bf16 at b=128 on the resident synthetic
    set: 10 geo steps and 10 without geo timed in turns to the host value
    of the last loss, then 3 geo steps under `utils.profiling.trace`,
    whose trace gives the geo stages' share of the device time."""
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_step
    from spnet_tpu_torch.utils.profiling import trace

    model = build_model(cfg.model, device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda step: 1e-5)
    feed = [torch.from_numpy(a).to(DEVICE) for a in (
        train_ds.x, train_ds.y, train_ds.rows, train_ds.row_mask)]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    idx = torch.arange(TRAIN_BATCH, device=DEVICE)
    steps = {geo: make_train_step(model, cfg.loss_weights, geo_augment=geo,
                                  grid=cfg.grid) for geo in (False, True)}

    def run(geo, n):
        args = feed if geo else feed[:2]
        for _ in range(n):
            _, met = steps[geo](state, *args, idx, gen)
        return float(met["loss"])

    run(True, 2)
    run(False, 2)
    ms = {False: [], True: []}
    for geo in (True, False, False, True):
        _, sec = _sync_s(lambda: run(geo, 10))
        ms[geo].append(1e3 * sec / 10)
    logdir = os.path.join(tmp, "geo_profile")
    with trace(logdir):
        run(True, 3)
    (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    summ = trace_summary(path)
    share = {k: v / max(summ["total_us"], 1e-9)
             for k, v in summ["stages_us"].items()}
    mc = cfg.model
    print(f"[synth] geo train step, {mc.backbone}-{mc.input_size} "
          f"{mc.compute_dtype} b={TRAIN_BATCH}: "
          f"{ms[True]} ms with geo, {ms[False]} ms without (10 steps each, "
          f"in turns); 3 profiled steps: device time {summ['total_us']:.0f} "
          f"us, geo_augment {summ['stages_us']['geo_augment']:.0f} us "
          f"({100 * share['geo_augment']:.2f} %), grid_encode "
          f"{summ['stages_us']['grid_encode']:.0f} us "
          f"({100 * share['grid_encode']:.2f} %)  [{smi}]")
    if summ["total_us"] <= 0:
        fail("synth: the profiled geo steps show no device time")
    del state, model, feed
    torch.cuda.empty_cache()
    return dict(geo_ms=ms[True], plain_ms=ms[False], share=share,
                device_us=summ["total_us"], stages_us=summ["stages_us"])


def _cli_gen_and_profile(tmp: str, smi: str) -> dict:
    """`gen-fake-espi -n GEN_FRAMES --all`, then `train --geo_augment
    --epoch_repeats GEO_REPEATS --use_tb --profile` for 1 epoch at
    b=PROFILE_BATCH on those files, both through the CLI's `main` (in this
    process, so the launch counts read), with every count set to 0 before
    the train run and checked after."""
    import glob

    from spnet_tpu_torch.cli import gen_fake_espi, train
    from spnet_tpu_torch.config import ModelConfig

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _, t_gen = _sync_s(lambda: gen_fake_espi.main(
            ["-d", "gen", "-n", str(GEN_FRAMES), "--all"]))
        n_train = len(glob.glob("gen/Train/*.png"))
        n_val = len(glob.glob("gen/Val/*.png"))
        split = sum(i / GEN_FRAMES < 0.8 for i in range(GEN_FRAMES))
        print(f"[synth] gen-fake-espi -n {GEN_FRAMES} --all: {n_train} "
              f"Train + {n_val} Val pairs in {t_gen:.2f} s "
              f"({GEN_FRAMES / t_gen:.1f} frames/s, PNG encoding "
              f"included)  [{smi}]")
        if (n_train, n_val) != (split, GEN_FRAMES - split):
            fail(f"gen-fake-espi wrote {n_train} + {n_val} frames")
        _zero_counts()
        _, t_train = _sync_s(lambda: train.main(
            ["-d", "gen", "-b", str(PROFILE_BATCH), "-e", "1", "-w", "ck",
             "--name", "prof", "--geo_augment", "--epoch_repeats",
             str(GEO_REPEATS), "--use_tb", "--profile", "--no-eval"]))
        counts = _counts()
        (log_dir,) = glob.glob("logs/prof_*")
        traces = [os.path.abspath(t) for t in
                  glob.glob(os.path.join(log_dir, "profile", "*.json"))]
        steps = n_train // PROFILE_BATCH * GEO_REPEATS
        v = n_val // PROFILE_BATCH * PROFILE_BATCH  # build_dataset's cut
        val_batches = -(-v // max(PROFILE_BATCH, min(VAL_BATCH, v)))
        want = _want_counts(ModelConfig(), predict_batches=val_batches + 1,
                            train_steps=_epoch_calls(steps))
        events = glob.glob(os.path.join(log_dir, "tb", "events.*"))
        print(f"[synth] train --geo_augment --epoch_repeats {GEO_REPEATS} "
              f"--use_tb --profile, 1 epoch at b={PROFILE_BATCH}: "
              f"{t_train:.1f} s; launches {counts}; traces "
              f"{[os.path.basename(t) for t in traces]}; tb {len(events)}")
        if counts != want:
            fail(f"synth: CLI train launches {counts} != {want}")
        if len(events) != 1:
            fail(f"synth: CLI train tb event files {events}")
        if len(traces) != 1 or os.path.getsize(traces[0]) == 0:
            fail(f"synth: profile traces {traces}")
        summ = trace_summary(traces[0])
    finally:
        os.chdir(cwd)
    ours = _ours(summ["names"])
    share = {k: v / max(summ["total_us"], 1e-9)
             for k, v in summ["stages_us"].items()}
    print(f"[synth] the CLI's trace: {len(summ['names'])} kernel names, "
          f"device time {summ['total_us']:.0f} us; the repo's kernels in "
          f"it: {ours}; geo stages {summ['stages_us']} us "
          f"({ {k: round(100 * v, 3) for k, v in share.items()} } %)")
    if summ["total_us"] <= 0:
        fail("synth: the CLI's trace holds no kernel")
    return dict(gen_fps=GEN_FRAMES / t_gen, counts=counts, ours=ours,
                share=share, trace_mb=os.path.getsize(traces[0]) / 2 ** 20)


def phase_synth(seed: int, smi: str, phase6_img_s: float) -> dict:
    """The synthetic feed on the card, the card against the CPU, geometric
    training with epoch repeats and TensorBoard through `train_network`
    (2 epochs, then resumed to 3), the geo steps' device share, and the
    gen-fake-espi -> train --profile chain through the CLI."""
    import dataclasses

    from spnet_tpu_torch.config import ExperimentConfig, TrainConfig
    from spnet_tpu_torch.data.dataset import synthetic_dataset
    from spnet_tpu_torch.io.tb import read_events

    cfg = ExperimentConfig(train=TrainConfig(
        batch_size=TRAIN_BATCH, epochs=2, save_every=1, seed=seed,
        geo_augment=True, epoch_repeats=GEO_REPEATS, use_tb=True))
    out = dict(breakdown=_synth_breakdown(seed, smi))
    (train_ds, t_train) = _sync_s(lambda: synthetic_dataset(
        SYNTH_TRAIN, cfg.grid, seed=seed, input_size=cfg.model.input_size,
        batch_size=TRAIN_BATCH, device=DEVICE))
    (val_ds, t_val) = _sync_s(lambda: synthetic_dataset(
        SYNTH_VAL, cfg.grid, seed=seed + 1, input_size=cfg.model.input_size,
        device=DEVICE))
    out["frames_per_s"] = (SYNTH_TRAIN / t_train, SYNTH_VAL / t_val)
    print(f"[synth] synthetic_dataset on the card: {SYNTH_TRAIN} train "
          f"frames in {t_train:.2f} s ({out['frames_per_s'][0]:.1f} "
          f"frames/s, first call), {SYNTH_VAL} val frames in {t_val:.2f} s "
          f"({out['frames_per_s'][1]:.1f} frames/s); uint8 at "
          f"{cfg.model.input_size}^2, labels and rows from the host codec  "
          f"[{smi}]")
    size = cfg.model.input_size
    if not (train_ds.x.shape == (SYNTH_TRAIN, size, size, 1)
            and val_ds.x.shape == (SYNTH_VAL, size, size, 1)
            and train_ds.x.dtype == np.uint8
            and np.isfinite(train_ds.y).all()
            and train_ds.row_mask.sum(1).min() >= 1
            and 10 < train_ds.x.mean() < 200):
        fail(f"synth: dataset {train_ds.x.shape} {train_ds.x.dtype}, mean "
             f"{train_ds.x.mean()}, rows {train_ds.row_mask.sum()}")
    out.update(_card_vs_cpu_synth(seed, train_ds))

    with tempfile.TemporaryDirectory() as tmp:
        state, hist, counts = _train_run(cfg, train_ds, val_ds, tmp, smi,
                                         "synth")
        del state
        (name,) = os.listdir(os.path.join(tmp, "log", "tb"))
        events = list(read_events(os.path.join(tmp, "log", "tb", name)))
        tags = {(s, t) for s, t, k, _ in events if k == "scalar"}
        if len(tags) != 7 * cfg.train.epochs:
            fail(f"synth: tb scalars {sorted(tags)}")
        cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, epochs=3))
        state, hist3, counts3 = _train_run(cfg3, train_ds, val_ds, tmp, smi,
                                           "synth")
        spe = (SYNTH_TRAIN // TRAIN_BATCH) * GEO_REPEATS
        if state.step != 3 * spe or state.opt_state.count != 3 * spe:
            fail(f"synth: resumed run ended at step {state.step}")
        del state
        torch.cuda.empty_cache()
        out["img_per_sec"] = [h["img_per_sec"] for h in hist + hist3]
        print(f"[synth] geo train images/s, b={TRAIN_BATCH}, repeats "
              f"{GEO_REPEATS}, epochs 1-3 (3 resumed): "
              f"{[round(v, 1) for v in out['img_per_sec']]}; phase 6 "
              f"(no geo, seeded noise frames) epoch 2: {phase6_img_s:.1f}  "
              f"[{smi}]")
        out["train_counts"], out["resume_counts"] = counts, counts3
        out["profile"] = _geo_step_profile(cfg, train_ds, tmp, smi)
        out["cli"] = _cli_gen_and_profile(tmp, smi)
    return out


# ---------------------------------------------------------------------------
# Phases 11-14: the chunked and host-fed feeds, remat, export, --pretrained
# ---------------------------------------------------------------------------
FEED_TRAIN, FEED_VAL, FEED_CHUNK = 2048, 256, 512
FEEDS = {"resident": True, "host-fed": False, "chunked": "chunked"}
PROFILED_STEPS = 5   # host-fed / resident steps under torch.profiler
REMAT_STEPS = 5      # per timed run, 4 runs in turns (off, on, on, off)
# float32 b=16 step, remat on vs off: the recompute runs the same kernels
# on the same inputs (cuDNN deterministic during the check), so only an
# order that varies between runs could part them
REMAT_RTOL = 1e-5
REMAT_STATS_RTOL = 1e-6
EXPORT_FRAMES = 256  # per sweep, b=16, eager and artifact in turns


def device_idle(path: str) -> dict:
    """From a torch.profiler chrome trace: the span from the first device
    event (kernel, copy, set) to the end of the last, the time covered by
    at least one of them (the union of their intervals), the copies' own
    time, and the idle share of the span, in microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")
           and "dur" in e]
    if not dev:
        fail(f"no device event in the trace {path}")
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, (lo, hi) = 0.0, iv[0]
    for a, b in iv[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    span = max(b for _, b in iv) - iv[0][0]
    return dict(span_us=span, busy_us=busy, idle=1.0 - busy / span,
                copy_us=sum(e["dur"] for e in dev
                            if e["cat"] == "gpu_memcpy"))


def _feed_batches(name, rows, train_ds, resident):
    """The (x, y, idx) of the resident feed (`resident`: its device
    tensors) or the host-fed (x, y) batches of `rows`, as `train_network`
    makes them."""
    from spnet_tpu_torch.train.chunked import Stager

    if name == "resident":
        return ((*resident, idx) for idx in torch.from_numpy(rows).to(DEVICE))
    return Stager((train_ds.x, train_ds.y), TRAIN_BATCH,
                  torch.device(DEVICE)).stream_rows(rows)


def _feed_streams_vs_host(train_ds, seed: int) -> dict:
    """The staging on the card against the host arrays: every host-fed
    batch of an epoch equals its host rows; every chunk a chunked epoch
    hands a (stand-in) step equals its host slice, and the (chunk,
    within-chunk indices) sequence of 2 epochs equals that of the same
    `run_chunked_epoch` on the CPU."""
    from spnet_tpu_torch.train.chunked import ChunkStreamer, \
        run_chunked_epoch
    from spnet_tpu_torch.train.loop import epoch_order

    order = epoch_order(FEED_TRAIN, TRAIN_BATCH, seed, 1)
    for rows, (xb, yb) in zip(order, _feed_batches(
            "host-fed", order, train_ds, None)):
        if not (np.array_equal(xb.cpu().numpy(), train_ds.x[rows])
                and np.array_equal(yb.cpu().numpy(), train_ds.y[rows])):
            fail("feeds: a host-fed batch on the card differs from its "
                 "host rows")
    n_chunks = FEED_TRAIN // FEED_CHUNK
    visits = {}
    for dev in (DEVICE, "cpu"):
        rec, seen = [], {}

        def stub(state, x, y, idx, gen):
            if id(x) not in seen:  # a new chunk: which host slice is it?
                host = x.cpu().numpy()
                hits = [c for c in range(n_chunks) if np.array_equal(
                    host, train_ds.x[c * FEED_CHUNK:(c + 1) * FEED_CHUNK])]
                if len(hits) != 1:
                    fail(f"feeds: a chunk on {dev} matches host chunks "
                         f"{hits}")
                seen[id(x)] = (hits[0], x)  # keep x: ids stay unique
            rec.append((seen[id(x)][0], idx.cpu().numpy()))
            return state, {"loss": torch.zeros((), device=x.device)}

        streamer = ChunkStreamer((train_ds.x, train_ds.y), FEED_CHUNK,
                                 n_chunks, torch.device(dev))
        for epoch in range(2):
            run_chunked_epoch(stub, None, streamer, TRAIN_BATCH, None, epoch,
                              seed)
        visits[dev] = rec
    same = len(visits[DEVICE]) == len(visits["cpu"]) == 2 * FEED_TRAIN \
        // TRAIN_BATCH and all(
            a[0] == b[0] and np.array_equal(a[1], b[1])
            for a, b in zip(visits[DEVICE], visits["cpu"]))
    chunks = [c for k, (c, _) in enumerate(visits[DEVICE])
              if k % (FEED_CHUNK // TRAIN_BATCH) == 0]
    print(f"[feeds] staging on the card: {len(order)} host-fed batches "
          f"equal their host rows; chunked visits of 2 epochs (chunks "
          f"{chunks}, {len(visits[DEVICE])} index rows) equal the CPU "
          f"streamer's: {same}")
    if not same:
        fail("feeds: the chunked visit order on the card differs from the "
             "CPU's")
    return dict(chunks=chunks)


def _feed_losses(cfg, train_ds, seed: int) -> dict:
    """Two steps from one seed, augmentation off, with the resident feed
    and with the host-fed one (the same minibatches): the losses equal,
    bitwise (cuDNN deterministic during the check)."""
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.loop import epoch_order
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_step

    rows = epoch_order(FEED_TRAIN, TRAIN_BATCH, seed, 0)[:2]
    resident = (torch.from_numpy(train_ds.x).to(DEVICE),
                torch.from_numpy(train_ds.y).to(DEVICE))
    losses, det = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("resident", "host-fed"):
            model = build_model(cfg.model, device=DEVICE,
                                generator=torch.Generator().manual_seed(seed))
            state = create_train_state(model, lambda step: 1e-5)
            step = make_train_step(model, cfg.loss_weights, augment=False,
                                   indexed="epoch" if name == "resident"
                                   else False)
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            losses[name] = [float(step(state, *b, gen)[1]["loss"]) for b in
                            _feed_batches(name, rows, train_ds, resident)]
            del state, model, step
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"[feeds] 2 steps, augmentation off, resident vs host-fed losses "
          f"{losses['resident']} vs {losses['host-fed']}: bitwise "
          f"{losses['resident'] == losses['host-fed']}")
    if losses["resident"] != losses["host-fed"]:
        fail(f"feeds: host-fed losses {losses['host-fed']} != resident "
             f"{losses['resident']}")
    torch.cuda.empty_cache()
    return losses


def _feed_profiles(cfg, train_ds, seed: int, tmp: str, smi: str) -> dict:
    """PROFILED_STEPS train steps of the resident and the host-fed feed
    under `utils.profiling.trace`, after 2 warm-up steps each, in turns
    (resident, host-fed, host-fed, resident: the first trace of a process
    pays the profiler's start-up): the device's idle share of each run
    from its trace."""
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.loop import epoch_order
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_step
    from spnet_tpu_torch.utils.profiling import trace

    model = build_model(cfg.model, device=DEVICE,
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, lambda step: 1e-5)
    resident = (torch.from_numpy(train_ds.x).to(DEVICE),
                torch.from_numpy(train_ds.y).to(DEVICE))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rows = epoch_order(FEED_TRAIN, TRAIN_BATCH, seed, 0)
    out = {"resident": [], "host-fed": []}
    for k, name in enumerate(("resident", "host-fed", "host-fed",
                              "resident")):
        step = make_train_step(model, cfg.loss_weights,
                               indexed="epoch" if name == "resident"
                               else False)

        def run(r):
            for b in _feed_batches(name, r, train_ds, resident):
                _, met = step(state, *b, gen)
            return float(met["loss"])

        run(rows[:2])
        logdir = os.path.join(tmp, f"profile_{k}")
        with trace(logdir):
            run(rows[2:2 + PROFILED_STEPS])
        (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        out[name].append(device_idle(path))
    for name, runs in out.items():
        print(f"[feeds] {name}, {PROFILED_STEPS} profiled steps, 2 runs: "
              "device span " + ", ".join(
                  f"{r['span_us'] / 1e3:.2f}" for r in runs) + " ms, busy "
              + ", ".join(f"{r['busy_us'] / 1e3:.2f}" for r in runs)
              + " ms, idle " + ", ".join(f"{100 * r['idle']:.2f}"
                                         for r in runs)
              + " %, copies " + ", ".join(f"{r['copy_us'] / 1e3:.3f}"
                                          for r in runs) + f" ms  [{smi}]")
    del state, model, resident
    torch.cuda.empty_cache()
    return out


def phase_feeds(seed: int, smi: str) -> dict:
    """The three feeds of `train_network` on Xception-331 bf16 at b=128:
    FEED_TRAIN seeded frames, 2 epochs a run (augmentation on; the chunked
    feed in 4 chunks of FEED_CHUNK), two runs of each in turns, their
    images/s and launch counts; the
    staging against the host; 2 steps resident vs host-fed; the host-fed
    steps' idle share from a trace."""
    from spnet_tpu_torch.config import ExperimentConfig, TrainConfig
    from spnet_tpu_torch.train.chunked import plan_chunks

    cfg = ExperimentConfig(train=TrainConfig(batch_size=TRAIN_BATCH,
                                             epochs=2, seed=seed))
    train_ds, val_ds = _seeded_split((FEED_TRAIN, FEED_VAL),
                                     cfg.model.input_size, cfg.grid, seed)
    item = train_ds.x[0].nbytes + train_ds.y[0].nbytes
    budget = 3 * FEED_CHUNK * item + 3  # plan_chunks keeps ~3 in flight
    plan = plan_chunks(FEED_TRAIN, item, TRAIN_BATCH, budget)
    print(f"[feeds] {FEED_TRAIN} train frames ({train_ds.x.nbytes / 1e6:.1f}"
          f" MB uint8) + {FEED_VAL} val at {cfg.model.input_size}^2; chunk "
          f"budget {budget} B -> plan_chunks (chunk_len, n_chunks) {plan}")
    if plan != (FEED_CHUNK, FEED_TRAIN // FEED_CHUNK):
        fail(f"feeds: chunk plan {plan}")
    out = {name: dict(img_per_sec=[]) for name in FEEDS}
    with tempfile.TemporaryDirectory() as tmp:
        # in turns, then in the reverse order: a later run of a process
        # can be slower (or faster) than an earlier one
        for name in list(FEEDS) + list(reversed(FEEDS)):
            with tempfile.TemporaryDirectory(dir=tmp) as run_dir:
                state, hist, counts = _train_run(
                    cfg, train_ds, val_ds, run_dir, smi, f"feeds {name}",
                    device_data=FEEDS[name], chunk_budget=budget)
                del state
            torch.cuda.empty_cache()
            out[name]["img_per_sec"].append([h["img_per_sec"]
                                             for h in hist])
            out[name]["counts"] = counts
        rates = "; ".join(
            f"{n} {[[round(v, 1) for v in run] for run in r['img_per_sec']]}"
            for n, r in out.items())
        print(f"[feeds] train images/s at b={TRAIN_BATCH}, [epoch 1, epoch "
              f"2] of each run, runs in turns and reversed: {rates}  "
              f"[{smi}]")
        out["streams"] = _feed_streams_vs_host(train_ds, seed)
        out["losses"] = _feed_losses(cfg, train_ds, seed)
        out["profile"] = _feed_profiles(cfg, train_ds, seed, tmp, smi)
    return out


def phase_remat(seed: int, smi: str) -> dict:
    """Xception-331 bf16 train steps at b=128 with remat off and on, in
    turns: step time and peak memory each; then one float32 b=16 step both
    ways: the same loss, gradients and BN running statistics."""
    import dataclasses

    from spnet_tpu_torch.config import ExperimentConfig
    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import _prep_x, forward_loss, \
        make_train_step

    cfg = ExperimentConfig()
    (ds,) = _seeded_split((TRAIN_BATCH,), cfg.model.input_size, cfg.grid,
                          seed)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in (ds.x, ds.y))
    model = build_model(cfg.model, device=DEVICE,
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, lambda step: 1e-5)
    step = make_train_step(model, cfg.loss_weights, indexed=False)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    gib = 2.0 ** 30

    def run(remat, n):
        model.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            _, met = step(state, x, y, gen)
        float(met["loss"])
        return (1e3 * (time.perf_counter() - t0) / n,
                torch.cuda.max_memory_allocated() / gib)

    run(False, 2)
    run(True, 2)
    _zero_counts()
    res = {False: [], True: []}
    for remat in (False, True, True, False):
        res[remat].append(run(remat, REMAT_STEPS))
    counts = _counts()
    if counts != _want_counts(cfg.model, train_steps=4 * REMAT_STEPS):
        fail(f"remat: launches {counts}")
    for remat, r in res.items():
        print(f"[remat] remat {remat}: step "
              f"{[round(ms, 2) for ms, _ in r]} ms, peak "
              f"{[round(g, 2) for _, g in r]} GiB (b={TRAIN_BATCH}, "
              f"{REMAT_STEPS} steps a run, runs in turns off/on/on/off)  "
              f"[{smi}]")
    del state, model, step
    torch.cuda.empty_cache()

    f32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    got, det = [], torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            m = build_model(dataclasses.replace(f32, remat=remat),
                            device=DEVICE,
                            generator=torch.Generator().manual_seed(seed))
            m.train()
            loss, _ = forward_loss(
                m, _prep_x(x[:16]), y[:16],
                torch.Generator(device=DEVICE).manual_seed(seed))
            grads = torch.autograd.grad(loss, list(m.parameters()))
            stats = [t for b in m.modules() if isinstance(b, BatchNorm)
                     for t in (b.running_mean, b.running_var)]
            got.append((float(loss.detach()), grads, stats))
            del m
    finally:
        torch.backends.cudnn.deterministic = det
    (l0, g0, s0), (l1, g1, s1) = got
    top = max(g.abs().max().item() for g in g0)
    l_rel = abs(l1 - l0) / abs(l0)
    # each leaf against its own max, floored at 1e-6 of the largest (a few
    # leaves are zero but for rounding, as in the CPU tests)
    g_rel = max(((a - b).abs().max() / max(b.abs().max().item(),
                                           1e-6 * top)).item()
                for a, b in zip(g1, g0))
    s_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                .item() for a, b in zip(s1, s0))
    bitwise = l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1)) \
        and all(torch.equal(a, b) for a, b in zip(s0, s1))
    print(f"[remat] float32 b=16 step, remat on vs off: loss rel "
          f"{l_rel:.2e}, gradients rel {g_rel:.2e} (tol {REMAT_RTOL}), BN "
          f"running statistics rel {s_rel:.2e} (tol {REMAT_STATS_RTOL}); "
          f"bitwise {bitwise}")
    if not (l_rel <= REMAT_RTOL and g_rel <= REMAT_RTOL
            and s_rel <= REMAT_STATS_RTOL):
        fail(f"remat: float32 step, loss rel {l_rel}, gradients {g_rel}, "
             f"BN statistics {s_rel}")
    torch.cuda.empty_cache()
    return dict(step_ms={k: [ms for ms, _ in v] for k, v in res.items()},
                peak_gib={k: [g for _, g in v] for k, v in res.items()},
                counts=counts)


def phase_export(seed: int, smi: str) -> dict:
    """Xception-331 bf16 port checkpoints (default and 'ss' head) exported
    on the card and loaded; EXPORT_FRAMES seeded frames at b=16 through
    `predict_in_batches`, eager and artifact in turns, and a b=7 batch:
    equal bitwise, with the launch counts; export time and frames/s."""
    from spnet_tpu_torch.cli.common import load_model_and_state
    from spnet_tpu_torch.config import ExperimentConfig, ModelConfig
    from spnet_tpu_torch.io.checkpoint import save_checkpoint
    from spnet_tpu_torch.io.export import export_predictor, load_predictor
    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.loop import predict_in_batches
    from spnet_tpu_torch.train.steps import make_predict_step

    out = {}
    for tag, mc in (("export", ModelConfig()),
                    ("export ss", ModelConfig(selective_sigmoid=True))):
        cfg = ExperimentConfig(model=mc)
        gen = torch.Generator().manual_seed(seed)
        model = build_model(mc, device="cpu", generator=gen)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.normal_(0.0, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        x, _ = _seeded_dataset(EXPORT_FRAMES, mc.input_size, cfg.grid, seed)
        with tempfile.TemporaryDirectory() as tmp:
            ck, art = os.path.join(tmp, "ck"), os.path.join(tmp, "art")
            save_checkpoint(ck, model.state_dict(), cfg)
            del model
            _, t_export = _sync_s(lambda: export_predictor(ck, art,
                                                           device=DEVICE))
            (call, meta), t_load = _sync_s(lambda: load_predictor(art))
            _, eager, _ = load_model_and_state(ck, DEVICE)
            fns = {"eager": make_predict_step(eager), "artifact": call}
            fps, ys, counts = {"eager": [], "artifact": []}, {}, {}
            want = _want_counts(mc, predict_batches=EXPORT_FRAMES // 16 + 1)
            for name in ("eager", "artifact", "artifact", "eager"):
                _zero_counts()
                ys[name], f = predict_in_batches(fns[name], x, 16, DEVICE,
                                                 verbose=False)
                counts[name] = _counts()
                if counts[name] != want:
                    fail(f"{tag}: {name} launches {counts[name]} != {want}")
                fps[name].append(f)
            x16 = torch.from_numpy(x[:16]).to(DEVICE)
            host = {name: host_us(lambda: fns[name](x16), calls=50) / 1e3
                    for name in ("eager", "artifact", "artifact", "eager")}
            x7 = torch.from_numpy(x[:7]).to(DEVICE)
            _zero_counts()
            y7 = call(x7)
            c7 = _counts()
            e7 = fns["eager"](x7)
        if c7 != _want_counts(mc, predict_batches=1):
            fail(f"{tag}: b=7 launches {c7}")
        err = max(np.abs(ys["artifact"] - ys["eager"]).max(),
                  (y7 - e7).abs().max().item())
        bitwise = np.array_equal(ys["artifact"], ys["eager"]) and \
            torch.equal(y7, e7) and y7.shape == (7, cfg.grid.num_outputs)
        print(f"[{tag}] {mc.backbone}-{mc.input_size} "
              f"{mc.compute_dtype}, selective_sigmoid "
              f"{mc.selective_sigmoid}: export {t_export:.2f} s, load "
              f"{t_load:.2f} s, batch {meta['input']['batch']}; "
              f"{EXPORT_FRAMES} frames at b=16 and 7 at b=7, artifact vs "
              f"eager bitwise {bitwise} (max_abs_err {err:.3e}); launches "
              f"per artifact sweep {counts['artifact']} (warm-up "
              f"included), b=7 {c7}")
        print(f"[{tag}] frames/s at b=16, in turns: eager "
              f"{[round(v, 1) for v in fps['eager']]}, artifact "
              f"{[round(v, 1) for v in fps['artifact']]}; ms per b=16 "
              f"batch over 50 calls with one sync (host-bound when above "
              f"the device time): eager {host['eager']:.3f}, artifact "
              f"{host['artifact']:.3f}  [{smi}]")
        if meta["input"]["batch"] != "symbolic" or not bitwise:
            fail(f"{tag}: batch {meta['input']['batch']}, bitwise "
                 f"{bitwise} (max_abs_err {err})")
        # the launches counted in the artifact's last sweep
        out[tag] = dict(export_s=t_export, fps=fps, counts=counts["artifact"],
                        batch_ms=host)
        del eager, fns, call
        torch.cuda.empty_cache()
    return out


def phase_pretrained(seed: int, smi: str) -> dict:
    """`train_network` with `pretrained` pointing at a random-weight Keras
    Xception's `.weights.h5` (written here; Keras on its torch backend):
    the backbone on the card before the first step equals the file's
    weights, then 2 steps at b=128.  Without keras, one line says so."""
    import dataclasses
    import importlib.util

    if any(importlib.util.find_spec(m) is None for m in ("keras", "h5py")):
        print("[pretrained] keras or h5py is not installed on this host: "
              "--pretrained is proven by the CPU tests "
              "(tests/test_torch_keras_import.py) only")
        return dict(keras=False)
    # Keras on its torch backend; its optional jax import (an Orbax
    # callback's, guarded by `except ImportError`) is refused, so that
    # this process holds no JAX
    os.environ.setdefault("KERAS_BACKEND", "torch")
    sys.modules.setdefault("jax", None)
    try:
        import keras
    except ImportError as e:
        print(f"[pretrained] keras does not import here without JAX "
              f"({e!r}): --pretrained is proven by the CPU tests "
              "(tests/test_torch_keras_import.py) only")
        return dict(keras=False)

    from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
        TrainConfig
    from spnet_tpu_torch.convert import flax_to_state_dict
    from spnet_tpu_torch.io.keras_import import keras_xception_to_flax
    from spnet_tpu_torch.train import loop

    km = keras.applications.Xception(include_top=False, weights=None,
                                     input_shape=(None, None, 3))
    rng = np.random.default_rng(seed)
    for layer in km.layers:  # non-trivial BN statistics
        if layer.__class__.__name__ == "BatchNormalization":
            layer.set_weights([rng.uniform(0.5, 1.5, w.shape).astype(
                np.float32) for w in layer.get_weights()])
    seen = {}
    real = loop.make_train_step

    def first_step_sees(model, *a, **k):
        step = real(model, *a, **k)

        def wrapped(state, *args):
            if not seen:
                seen.update({n: t.detach().cpu().clone() for n, t in
                             state.model.backbone.state_dict().items()})
            return step(state, *args)
        return wrapped

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "xception.weights.h5")
        km.save_weights(path)
        cfg = ExperimentConfig(
            model=ModelConfig(pretrained=path),
            train=TrainConfig(batch_size=TRAIN_BATCH, epochs=1, seed=seed))
        train_ds, val_ds = _seeded_split((2 * TRAIN_BATCH, TRAIN_BATCH),
                                         cfg.model.input_size, cfg.grid,
                                         seed)
        loop.make_train_step = first_step_sees
        try:
            state, _, counts = _train_run(cfg, train_ds, val_ds, tmp, smi,
                                          "pretrained")
        finally:
            loop.make_train_step = real
        want = flax_to_state_dict(*keras_xception_to_flax(km),
                                  state.model.backbone)
        del state
    same = set(seen) == set(want) and all(torch.equal(seen[k], want[k])
                                          for k in want)
    print(f"[pretrained] keras {keras.__version__} "
          f"({keras.backend.backend()} backend): a random-weight Xception's "
          f".weights.h5 -> train_network(pretrained=...), 2 steps at "
          f"b={TRAIN_BATCH}; the backbone on the card before the first "
          f"step equals the file's {len(want)} tensors bitwise: {same}; "
          f"launches {counts}  [{smi}]")
    if not same:
        fail("pretrained: the backbone before the first step is not the "
             "file's weights")
    torch.cuda.empty_cache()
    return dict(keras=True, counts=counts)


# ---------------------------------------------------------------------------
# phase 15: the data-preparation commands
# ---------------------------------------------------------------------------

PREP_FRAMES = 16          # gen-fake-espi's native 512x384 frames
PREP_AUGS = 4             # setup-data -a
AUG_FILES, AUG_N = 8, 42  # augment: 8 files x 42 variants (its default)
AUG_CPU_FILES = 2         # of them again on the CPU
AUG_ROWS_ATOL = 1e-4      # augmented CSV rows (tests/test_torch_cli_data.py)
AUG_PIXEL_LEVELS = 1      # card vs CPU: the truncating cast may part by 1


def _zooniverse_csv(src: str, path: str) -> dict:
    """An aggregated Zooniverse CSV (x, y, filename, fringe_count, rx, ry,
    angle) from the frames' label files: a header, every ellipse (those
    with a > b every other time as b, a, angle - 90, which
    parse-zooniverse swaps back) and the last row again.  Returns the
    rows parse-zooniverse must write, by file."""
    from spnet_tpu_torch.data.csvio import paired_file_lists, read_raw_meta

    lines, want = ["x,y,filename,fringe_count,rx,ry,angle"], {}
    imgs, metas = paired_file_lists(src + os.sep)
    for img, meta in zip(imgs, metas):
        name = os.path.basename(img)
        for i, row in enumerate(read_raw_meta(meta).tolist()):
            cx, cy, a, b, ang, rings = row
            if rings == 0:
                continue  # "no object": parse-zooniverse drops it
            want.setdefault(name, []).append(
                (cx, cy, max(a, b), min(a, b), ang + 90.0 * (b > a), rings))
            if i % 2 and a > b:
                a, b, ang = b, a, ang - 90.0
            lines.append(f"{cx!r},{cy!r},{name},{rings!r},{a!r},{b!r},"
                         f"{ang!r}")
    lines.append(lines[-1])  # an exact duplicate: dropped
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return want


def _editor_model(csv_path: str, tmp: str) -> str:
    """The editor's data model on one parsed label file (no display on
    this host): load, hit-test, handles, save and reload."""
    from spnet_tpu_torch.cli.ellipse_editor import Ellipse
    from spnet_tpu_torch.data.csvio import read_raw_meta, write_meta_file

    es = [Ellipse(*r) for r in read_raw_meta(csv_path).tolist()]
    inside = all(e.contains(e.cx, e.cy) for e in es)
    on_axes = all(abs(np.hypot(end[0] - e.cx, end[1] - e.cy) - e.a) < 1e-6
                  and abs(np.hypot(side[0] - e.cx, side[1] - e.cy) - e.b)
                  < 1e-6 for e in es for end, side in [e.handles()])
    out = os.path.join(tmp, "editor.csv")
    write_meta_file(out, [e.row() for e in es])
    same = np.allclose(read_raw_meta(out), read_raw_meta(csv_path),
                       rtol=0, atol=1e-6)
    if not (es and inside and on_axes and same):
        fail(f"ellipse-editor data model: {len(es)} ellipses, centers "
             f"inside {inside}, handles on the axes {on_axes}, reload "
             f"equal {same}")
    return (f"{len(es)} ellipses of {os.path.basename(csv_path)}: centers "
            f"inside, handles on the axes, saved and reloaded equal")


def phase_prep(seed: int, smi: str) -> dict:
    """gen-fake-espi -> an aggregated Zooniverse CSV -> parse-zooniverse ->
    gen-bboxes -> setup-data -a PREP_AUGS, each through its CLI `main`;
    then augment -n AUG_N of AUG_FILES files on the card (files/s, the
    warp's share), AUG_CPU_FILES of them on the CPU against it, and the
    editor's data model."""
    from PIL import Image

    from spnet_tpu_torch.cli import augment_preproc, gen_bboxes, \
        gen_fake_espi, parse_zooniverse, setup_data
    from spnet_tpu_torch.data.csvio import paired_file_lists, read_raw_meta

    def pngs(d):
        return sorted(f for f in os.listdir(d) if f.endswith(".png"))

    with tempfile.TemporaryDirectory() as tmp:
        raw, parsed = os.path.join(tmp, "raw"), os.path.join(tmp, "parsed")
        t0 = time.perf_counter()
        gen_fake_espi.main(["-d", raw, "-n", str(PREP_FRAMES), "--seed",
                            str(seed), "--device", DEVICE])
        src = os.path.join(raw, "Train")
        gen_s = time.perf_counter() - t0
        want = _zooniverse_csv(src, os.path.join(tmp, "agg.csv"))
        n_rows = parse_zooniverse.main(["-i", os.path.join(tmp, "agg.csv"),
                                        "-p", src, "-o", parsed])
        for name, rows in want.items():
            got = read_raw_meta(os.path.join(parsed, name[:-4] + ".csv"))
            if got.shape != (len(rows), 6) or not np.allclose(
                    got, rows, rtol=0, atol=1e-9):
                fail(f"parse-zooniverse: {name} rows {got} != {rows}")
        if pngs(parsed) != sorted(want) or n_rows != sum(
                len(r) for r in want.values()):
            fail(f"parse-zooniverse: {n_rows} rows, images {pngs(parsed)}")
        n_boxes = gen_bboxes.main(["-d", parsed, "-o",
                                   os.path.join(tmp, "boxes.csv")])
        with open(os.path.join(tmp, "boxes.csv")) as f:
            box_lines = f.read().splitlines()
        if n_boxes != n_rows or len(box_lines) != n_rows + 1:
            fail(f"gen-bboxes: {n_boxes} boxes of {n_rows} rows")
        ds = os.path.join(tmp, "ds")
        setup_data.main(["-o", parsed, "--name", ds, "-a", str(PREP_AUGS),
                         "--device", DEVICE])
        n = len(want)
        n_train = sum(r / n < 0.80 for r in range(n))
        got = (len(pngs(os.path.join(ds, "Train"))),
               len(pngs(os.path.join(ds, "Val"))))
        if got != (n_train * (1 + PREP_AUGS), n - n_train):
            fail(f"setup-data: Train/Val PNGs {got}")
        print(f"[prep] gen-fake-espi {PREP_FRAMES} native frames "
              f"({gen_s:.2f} s) -> parse-zooniverse {n_rows} rows of {n} "
              f"frames (the swapped axes and the duplicate undone) -> "
              f"gen-bboxes {n_boxes} boxes -> setup-data -a {PREP_AUGS}: "
              f"Train {got[0]} PNGs ({n_train} originals, {PREP_AUGS} variants "
              f"each), Val {got[1]}")

        imgs, metas = paired_file_lists(parsed + os.sep)
        card, cpu = os.path.join(tmp, "aug_card"), os.path.join(tmp,
                                                                "aug_cpu")
        for d, k in ((card, AUG_FILES), (cpu, AUG_CPU_FILES)):
            os.makedirs(d)
            for f in imgs[:k] + metas[:k]:
                shutil.copy(f, d)
        stats = augment_preproc.main(["-d", card, "-n", str(AUG_N),
                                      "--device", DEVICE])
        augment_preproc.main(["-d", cpu, "-n", str(AUG_N), "--device",
                              "cpu"])
        if len(pngs(card)) != AUG_FILES * (1 + AUG_N):
            fail(f"augment: {len(pngs(card))} PNGs")
        names = pngs(cpu)
        if len(names) != AUG_CPU_FILES * (1 + AUG_N) or \
                not set(names) <= set(pngs(card)):
            fail("augment: the CPU's file names are not the card's")
        worst_px = worst_row = 0.0
        differ = 0
        for f in names:
            a = np.asarray(Image.open(os.path.join(card, f)), np.int16)
            b = np.asarray(Image.open(os.path.join(cpu, f)), np.int16)
            worst_px = max(worst_px, float(np.abs(a - b).max()))
            differ += int((a != b).sum())
            ra = read_raw_meta(os.path.join(card, f[:-4] + ".csv"))
            rb = read_raw_meta(os.path.join(cpu, f[:-4] + ".csv"))
            if ra.shape != rb.shape:
                fail(f"augment: {f} rows {ra.shape} vs {rb.shape}")
            if ra.size:
                worst_row = max(worst_row, float(np.abs(ra - rb).max()))
        files_s = stats["files"] / stats["seconds"]
        variants_s = stats["variants"] / stats["seconds"]
        warp = stats["warp_seconds"] / stats["seconds"]
        print(f"[prep] augment -n {AUG_N} of {AUG_FILES} files on the card: "
              f"{stats['variants']} variants in {stats['seconds']:.3f} s, "
              f"{files_s:.3f} files/s ({variants_s:.1f} variants/s); the "
              f"warp (upload, warps, one host copy) {100 * warp:.2f} % of "
              f"the command's time, the rest PNG "
              f"and CSV writes on the host  [{smi}]")
        print(f"[prep] augment, card vs CPU on {AUG_CPU_FILES} files "
              f"({len(names)} PNGs): names identical; rows max |diff| "
              f"{worst_row:.3g} (tol {AUG_ROWS_ATOL}); pixels max |diff| "
              f"{worst_px:.0f} gray level(s) (tol {AUG_PIXEL_LEVELS}), "
              f"{differ} pixel(s) apart")
        if worst_row > AUG_ROWS_ATOL or worst_px > AUG_PIXEL_LEVELS:
            fail(f"augment: card vs CPU rows {worst_row}, pixels "
                 f"{worst_px}")
        print(f"[prep] ellipse-editor: no display on this host, its data "
              f"model only: {_editor_model(metas[0], tmp)}")
    return dict(files_per_s=files_s, warp_share=warp, **stats)


# ---------------------------------------------------------------------------
# phase 16: data-parallel training
# ---------------------------------------------------------------------------

DP_TURN_FRAMES = 1024     # train frames of each timed run (8 steps an epoch)
DP_TURNS = ("group", "none", "none", "group")
DP_CHILD_TIMEOUT = 900    # seconds a rank of phase 16(b) may take
DP_PROBE_TIMEOUT = 180    # ... the NCCL probe's
DP_PROFILE_STEPS = 5      # traced steps of each turn of `_dp_step_profile`
# DDP collects runtime statistics, syncing the host on CUDA events, in its
# first 10 iterations (and every 100th): `_dp_step_profile` times steps
# 3-10 and 13-22 apart
DDP_SAMPLED_ITERS = 10
DP_F32_BATCH = 16
DP_F32_RTOL = 1e-5        # 2 ranks vs 1 process, f32 loss and head gradient


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_group(backend: str = "nccl"):
    """A process group of one rank (this process) on the card."""
    from spnet_tpu_torch.parallel.multihost import maybe_initialize

    if not maybe_initialize(f"localhost:{_free_port()}", 1, 0,
                            backend=backend, device=DEVICE):
        fail("maybe_initialize did not start the group")


def _dp_bitwise(cfg, train_ds, seed: int) -> list:
    """Two steps from one seed, augmentation and dropout off, in a 1-rank
    NCCL group (DDP) and without a group: the losses bitwise equal (cuDNN
    deterministic during the check)."""
    import dataclasses

    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.loop import epoch_order
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_step

    rows = torch.from_numpy(epoch_order(len(train_ds.x), TRAIN_BATCH, seed,
                                        0)[:2]).to(DEVICE)
    x_all = torch.from_numpy(train_ds.x).to(DEVICE)
    y_all = torch.from_numpy(train_ds.y).to(DEVICE)
    model_cfg = dataclasses.replace(cfg.model, dropout_rate=0.0)
    losses, det = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for grouped in (True, False):
            if grouped:
                _start_group()
            try:
                model = build_model(model_cfg, device=DEVICE,
                                    generator=torch.Generator().manual_seed(
                                        seed))
                state = create_train_state(model, lambda step: 1e-5)
                step = make_train_step(model, cfg.loss_weights,
                                       augment=False)
                gen = torch.Generator(device=DEVICE).manual_seed(seed)
                losses[grouped] = [float(step(state, x_all, y_all, idx,
                                              gen)[1]["loss"])
                                   for idx in rows]
                del state, model, step
            finally:
                if grouped:
                    torch.distributed.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"[dp] 2 steps, augmentation and dropout off: 1-rank NCCL group "
          f"(DDP) {losses[True]} vs no group {losses[False]}: bitwise "
          f"{losses[True] == losses[False]}")
    if losses[True] != losses[False]:
        fail(f"dp: 1-rank group losses {losses[True]} != {losses[False]}")
    torch.cuda.empty_cache()
    return losses[True]


def _device_by_kernel(path: str) -> dict:
    """From a torch.profiler chrome trace: device microseconds by kernel,
    copy and set name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return out


def _dp_step_profile(cfg, train_ds, tmp: str, smi: str) -> dict:
    """Xception-331 bf16 train steps at b=128 (augmentation and dropout
    on) in a 1-rank NCCL group (DDP) and without a group, in turns
    DP_TURNS, each turn with its own model from one seed: after 2 warm-up
    steps, steps 3-10 (inside DDP's sampled iterations) and steps 13-22
    timed to the host value of their last loss, then DP_PROFILE_STEPS
    steps under `utils.profiling.trace`.  From each trace, a step's device
    time (all kernels, copies and sets), its NCCL kernels' and its device
    copies' time, and the idle share; and the kernels by which the group's
    traces exceed the others (DDP's bucket copies and the all-reduce)."""
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_step
    from spnet_tpu_torch.utils.profiling import trace

    feed = [torch.from_numpy(a).to(DEVICE) for a in (train_ds.x,
                                                     train_ds.y)]
    idx = torch.arange(TRAIN_BATCH, device=DEVICE)
    res = {"group": [], "none": []}
    by_name = {"group": {}, "none": {}}
    for turn, mode in enumerate(DP_TURNS):
        if mode == "group":
            _start_group()
        try:
            model = build_model(cfg.model, device=DEVICE,
                                generator=torch.Generator().manual_seed(0))
            state = create_train_state(model, lambda step: 1e-5)
            step = make_train_step(model, cfg.loss_weights)
            gen = torch.Generator(device=DEVICE).manual_seed(0)

            def run(n):
                for _ in range(n):
                    _, met = step(state, *feed, idx, gen)
                return float(met["loss"])

            run(2)
            _, early = _sync_s(lambda: run(DDP_SAMPLED_ITERS - 2))
            run(2)
            _, sec = _sync_s(lambda: run(10))
            logdir = os.path.join(tmp, f"dp_profile_{turn}")
            with trace(logdir):
                run(DP_PROFILE_STEPS)
            del state, model, step
        finally:
            if mode == "group":
                torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
        (path,) = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        kern = _device_by_kernel(path)
        for k, v in kern.items():
            by_name[mode][k] = by_name[mode].get(k, 0.0) + v
        per = 1.0 / DP_PROFILE_STEPS
        res[mode].append(dict(
            early_ms=1e3 * early / (DDP_SAMPLED_ITERS - 2),
            step_ms=1e3 * sec / 10, device_us=per * sum(kern.values()),
            nccl_us=per * sum(v for k, v in kern.items()
                              if "nccl" in k.lower()),
            copy_us=per * sum(v for k, v in kern.items()
                              if k.startswith("Memcpy")),
            idle=device_idle(path)["idle"]))
    n = {m: DP_PROFILE_STEPS * DP_TURNS.count(m) for m in res}
    extra = sorted(((by_name["group"][k] / n["group"]
                     - by_name["none"].get(k, 0.0) / n["none"], k)
                    for k in by_name["group"]), reverse=True)[:6]

    def col(mode, key, fmt):
        return "/".join(format(r[key], fmt) for r in res[mode])

    print(f"[dp] the step with and without a 1-rank NCCL group, "
          f"Xception-331 bf16 b={TRAIN_BATCH}, in turns {DP_TURNS}: ms a "
          f"step, steps 3-{DDP_SAMPLED_ITERS} group "
          f"{col('group', 'early_ms', '.2f')}, none "
          f"{col('none', 'early_ms', '.2f')}; steps 13-22 group "
          f"{col('group', 'step_ms', '.2f')}, none "
          f"{col('none', 'step_ms', '.2f')}; {DP_PROFILE_STEPS} traced "
          f"steps a turn, a step's device time group "
          f"{col('group', 'device_us', '.1f')} us, none "
          f"{col('none', 'device_us', '.1f')} us; NCCL kernels group "
          f"{col('group', 'nccl_us', '.1f')} us; device copies group "
          f"{col('group', 'copy_us', '.1f')} us, none "
          f"{col('none', 'copy_us', '.1f')} us; idle share group "
          f"{col('group', 'idle', '.4f')}, none {col('none', 'idle', '.4f')}"
          f"  [{smi}]")
    print("[dp] what the group adds a step (device us, group less none, "
          "mean over the turns): " + "; ".join(
              f"{k[:70]} {v:+.1f}" for v, k in extra))
    if any(r["device_us"] <= 0 for m in res for r in res[m]):
        fail("dp: a profiled turn shows no device time")
    return dict(turns=res, extra=[(k, v) for v, k in extra])


def _spawn_ranks(mode: str, world: int, tmp: str, seed: int,
                 timeout: float) -> list:
    """`chip_smoke.py --dp-child` ranks of one group on this card; returns
    [(returncode, output)] by rank, every process ended."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--dp-child", mode, str(r), str(world), port, tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(timed out)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _f32_dp_step(model, x16, y16, seed: int):
    """One float32 forward + backward of `model` (a DDP wrapper inside a
    group) on this rank's rows of the global batch (x16, y16): the loss
    averaged over the ranks and the head kernel's gradient (DDP's average
    over the ranks)."""
    from spnet_tpu_torch.config import LossWeights
    from spnet_tpu_torch.parallel import mesh
    from spnet_tpu_torch.train.steps import _prep_x, forward_loss

    core = getattr(model, "module", model)
    core.train()
    loss, _ = forward_loss(
        model, mesh.local_rows(_prep_x(x16)), mesh.local_rows(y16),
        torch.Generator(device=x16.device).manual_seed(seed), LossWeights())
    loss.backward()
    loss = loss.detach()
    if mesh.world_size() > 1:
        torch.distributed.all_reduce(loss)
        loss /= mesh.world_size()
    return float(loss), core.final_output.weight.grad.detach()


def _dp_data(seed: int):
    """Phase 16's seeded global datasets: TRAIN_FRAMES + VAL_FRAMES."""
    from spnet_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig()
    return _seeded_split((TRAIN_FRAMES, VAL_FRAMES), cfg.model.input_size,
                         cfg.grid, seed)


def _exchange_check(local, union, device: str, seed: int) -> list:
    """The sharded set's exchange on the card: this rank's shard (x, y) in
    `ShardedRows`, one epoch's global order (`epoch_order`, as
    `train_network` walks it); per step, whether the rows it hands this
    rank are bitwise the union's [idx_r].  Returns [steps, steps equal]."""
    from spnet_tpu_torch.parallel import mesh
    from spnet_tpu_torch.parallel.multihost import ShardedRows
    from spnet_tpu_torch.train.loop import epoch_order

    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    shard = ShardedRows([put(local.x), put(local.y)])
    order = epoch_order(shard.n_global, TRAIN_BATCH, seed, 0)
    plan = shard.plan(order)
    ux, uy = put(union.x), put(union.y)
    equal = 0
    for i, row in enumerate(order):
        idx = mesh.local_rows(torch.from_numpy(row)).to(device)
        x, y = shard.rows(plan, i)
        equal += int(torch.equal(x, ux[idx]) and torch.equal(y, uy[idx]))
    return [len(order), equal]


def dp_child(mode: str, rank: int, world: int, port: str, tmp: str,
             seed: int):
    """One rank of phase 16(b), on cuda:0.  'nccl-probe': an NCCL group and
    one all-reduce (NCCL refuses two ranks on one device).  'gloo': a gloo
    group (the backend passed explicitly), `train_network` on this rank's
    shards (b=TRAIN_BATCH global, 2 epochs; the training bytes it keeps
    on the card recorded), `_exchange_check`, then one float32 step of
    DP_F32_BATCH through DDP; writes tmp/gloo_r{rank}.npz."""
    import dataclasses

    from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
        TrainConfig
    from spnet_tpu_torch.models.layers import BatchNorm
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.parallel import mesh
    from spnet_tpu_torch.parallel.multihost import maybe_initialize
    from spnet_tpu_torch.train import loop

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda:0" if DEVICE == "cuda" else DEVICE  # both on one card
    maybe_initialize(f"localhost:{port}", world, rank,
                     backend="nccl" if mode == "nccl-probe" else "gloo",
                     device=device)
    if mode == "nccl-probe":
        t = torch.ones(1, device=device)
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {rank}: NCCL all-reduce on {device} gave {t.item()}")
        torch.distributed.destroy_process_group()
        return
    cfg = ExperimentConfig(train=TrainConfig(batch_size=TRAIN_BATCH,
                                             epochs=2, save_every=1,
                                             seed=seed))
    train_g, val_g = _dp_data(seed)

    def shard(ds):
        return dataclasses.replace(
            ds, x=mesh.local_rows(ds.x), y=mesh.local_rows(ds.y),
            file_list=list(mesh.local_rows(np.array(ds.file_list))))

    resident = []
    real = loop._to_device

    def spy(ds, val_ds, dev, geo=False):  # the training arrays it keeps
        res = real(ds, val_ds, dev, geo)
        resident.append(sum(a.numel() * a.element_size() for i, a in
                            enumerate(res) if i != 2 and a is not None))
        return res

    loop._to_device = spy
    _zero_counts()
    try:
        state, hist = loop.train_network(
            cfg, shard(train_g), shard(val_g), device,
            log_dir=os.path.join(tmp, f"log_r{rank}"),
            ckpt_dir=os.path.join(tmp, "ckpt"), render_overlays=False)
    finally:
        loop._to_device = real
    counts = _counts()
    exchange = _exchange_check(shard(train_g), train_g, device, seed)
    bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    stats = torch.cat([torch.cat([m.running_mean, m.running_var])
                       for m in bns]).cpu().numpy()
    step = state.step
    del state
    torch.cuda.empty_cache()

    model = build_model(ModelConfig(compute_dtype="float32"), device=device,
                        generator=torch.Generator().manual_seed(seed))
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[0] if device == "cuda:0" else None)
    x16 = torch.from_numpy(train_g.x[:DP_F32_BATCH]).to(device)
    y16 = torch.from_numpy(train_g.y[:DP_F32_BATCH]).to(device)
    loss, grad = _f32_dp_step(ddp, x16, y16, seed)
    np.savez(os.path.join(tmp, f"gloo_r{rank}.npz"),
             losses=np.array([h["train_loss"] for h in hist]),
             img_per_sec=np.array([h["img_per_sec"] for h in hist]),
             val=np.array([h["val_comps"]["total"] for h in hist]),
             stats=stats, step=np.array(step), f32_loss=np.array(loss),
             resident=np.array(resident),
             union_bytes=np.array(train_g.x.nbytes + train_g.y.nbytes),
             exchange=np.array(exchange),
             head_grad=grad.cpu().numpy(), counts=json.dumps(counts))
    torch.distributed.destroy_process_group()


def _dp_two_ranks(seed: int, smi: str) -> dict:
    """Phase 16(b): the NCCL probe, then 2 gloo ranks on this card against
    each other and against one process."""
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.models.spnet import build_model

    with tempfile.TemporaryDirectory() as tmp:
        probe = _spawn_ranks("nccl-probe", 2, tmp, seed, DP_PROBE_TIMEOUT)
        refused = [rc != 0 and "Duplicate GPU" in out for rc, out in probe]
        line = next((ln.strip() for _, out in probe
                     for ln in out.splitlines() if "Duplicate GPU" in ln),
                    "no 'Duplicate GPU' message")
        print(f"[dp] two NCCL ranks on one card: exit codes "
              f"{[rc for rc, _ in probe]}, refused {refused}: {line[:300]}"
              f"  -> the 2-rank run below uses gloo, passed explicitly")
        t0 = time.perf_counter()
        ranks = _spawn_ranks("gloo", 2, tmp, seed, DP_CHILD_TIMEOUT)
        seconds = time.perf_counter() - t0
        for r, (rc, out) in enumerate(ranks):
            if rc != 0:
                print(out[-6000:])
                fail(f"dp: gloo rank {r} exited {rc}")
        res = [dict(np.load(os.path.join(tmp, f"gloo_r{r}.npz")))
               for r in range(2)]
    counts = [json.loads(str(r["counts"])) for r in res]
    steps = 2 * (TRAIN_FRAMES // TRAIN_BATCH)
    val_batches = 2 * 2  # a val shard of VAL_FRAMES / 2 in one batch + warm-up
    want = _want_counts(ModelConfig(), predict_batches=val_batches,
                        train_steps=steps)
    print(f"[dp] 2 gloo ranks on one card, b={TRAIN_BATCH} global "
          f"({TRAIN_BATCH // 2} a rank), 2 epochs of "
          f"{TRAIN_FRAMES // TRAIN_BATCH} steps, {seconds:.1f} s with the "
          f"processes' start: losses {res[0]['losses'].tolist()} / "
          f"{res[1]['losses'].tolist()}, steps {int(res[0]['step'])}; "
          f"launches per rank {counts}; val (each rank's shard) "
          f"{res[0]['val'].tolist()} / {res[1]['val'].tolist()}")
    print(f"[dp] 2 gloo ranks sharing one card (two processes, host-staged "
          f"all-reduces; not a multi-GPU rate): train images/s "
          f"{res[0]['img_per_sec'].tolist()}  [{smi}]")
    union = int(res[0]["union_bytes"])
    resident = [r["resident"].tolist() for r in res]
    exchange = [r["exchange"].tolist() for r in res]
    print(f"[dp] sharded resident set: each gloo rank's training bytes on "
          f"the card {resident} (x + y of its shard), the union's {union}; "
          f"the exchange on the card, [steps, steps bitwise union[idx_r]] "
          f"a rank: {exchange}")
    if any(r != [union // 2] for r in resident) or union % 2:
        fail(f"dp: resident training bytes {resident}, not half the "
             f"union's {union} on each rank")
    if any(e[0] != TRAIN_FRAMES // TRAIN_BATCH or e[1] != e[0]
           for e in exchange):
        fail(f"dp: the exchange's rows differ from the union's: {exchange}")
    if not np.array_equal(res[0]["losses"], res[1]["losses"]) or \
            not np.isfinite(res[0]["losses"]).all():
        fail("dp: the ranks' train losses differ")
    if not np.array_equal(res[0]["stats"], res[1]["stats"]):
        fail("dp: the ranks' BatchNorm running statistics differ")
    if any(c != want for c in counts) or int(res[0]["step"]) != steps:
        fail(f"dp: launches {counts} != {want} a rank, step "
             f"{int(res[0]['step'])}")

    model = build_model(ModelConfig(compute_dtype="float32"), device=DEVICE,
                        generator=torch.Generator().manual_seed(seed))
    train_g, _ = _dp_data(seed)
    loss1, grad1 = _f32_dp_step(
        model, torch.from_numpy(train_g.x[:DP_F32_BATCH]).to(DEVICE),
        torch.from_numpy(train_g.y[:DP_F32_BATCH]).to(DEVICE), seed)
    del model
    torch.cuda.empty_cache()
    grad1 = grad1.cpu().numpy()
    l_rel = max(abs(float(r["f32_loss"]) - loss1) / abs(loss1) for r in res)
    g_rel = max(float(np.abs(r["head_grad"] - grad1).max()
                      / np.abs(grad1).max()) for r in res)
    print(f"[dp] float32 step, b={DP_F32_BATCH} (dropout on, one global "
          f"mask), 2 gloo ranks vs 1 process on the card: loss rel "
          f"{l_rel:.2e}, head-kernel gradient rel {g_rel:.2e} (worst rank; "
          f"tol {DP_F32_RTOL})")
    if not (l_rel <= DP_F32_RTOL and g_rel <= DP_F32_RTOL):
        fail(f"dp: f32 step 2 ranks vs 1 process: loss {l_rel}, gradient "
             f"{g_rel}")
    return dict(counts=counts, refused=refused, loss_rel=l_rel,
                grad_rel=g_rel, img_per_sec=res[0]["img_per_sec"].tolist(),
                resident=resident, union_bytes=union, exchange=exchange)


def phase_dp(seed: int, smi: str) -> dict:
    """Phase 16: (a) a 1-rank NCCL group through `train_network` (2 epochs,
    resumed to 3; launches), 2 steps bitwise against no group, and the
    train rate with and without the group in turns; (b) two ranks on the
    one card (`_dp_two_ranks`)."""
    import dataclasses

    from spnet_tpu_torch.config import ExperimentConfig, TrainConfig

    cfg = ExperimentConfig(train=TrainConfig(
        batch_size=TRAIN_BATCH, epochs=2, save_every=1, seed=seed))
    train_ds, val_ds = _dp_data(seed)
    _start_group()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            state, hist, counts = _train_run(cfg, train_ds, val_ds, tmp, smi,
                                             "dp nccl-1")
            del state
            cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, epochs=3))
            state, _, _ = _train_run(cfg3, train_ds, val_ds, tmp, smi,
                                     "dp nccl-1")
            if state.step != 3 * (TRAIN_FRAMES // TRAIN_BATCH):
                fail(f"dp: resumed run ended at step {state.step}")
            del state
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    bitwise = _dp_bitwise(cfg, train_ds, seed)

    turn_train, turn_val = _seeded_split((DP_TURN_FRAMES, VAL_FRAMES),
                                         cfg.model.input_size, cfg.grid,
                                         seed + 1)
    rates = {"group": [], "none": []}
    for mode in DP_TURNS:
        if mode == "group":
            _start_group()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                state, hist_t, _ = _train_run(cfg, turn_train, turn_val, tmp,
                                              smi, f"dp turns {mode}")
                del state
        finally:
            if mode == "group":
                torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
        rates[mode].append(hist_t[-1]["img_per_sec"])
    print(f"[dp] train images/s at b={TRAIN_BATCH}, epoch 2 of "
          f"{DP_TURN_FRAMES} frames, in turns {DP_TURNS}: 1-rank NCCL "
          f"group (DDP, eager steps) {[round(v, 1) for v in rates['group']]}"
          f", no group (the graphed epoch form) "
          f"{[round(v, 1) for v in rates['none']]}  [{smi}]")
    with tempfile.TemporaryDirectory() as tmp:
        profile = _dp_step_profile(cfg, turn_train, tmp, smi)
    two = _dp_two_ranks(seed, smi)
    return dict(counts=counts, bitwise=bitwise, rates=rates,
                profile=profile, two=two)


BENCH_STEPS = 16          # steps an epoch of phase 17's `bench` (160 there)
INFER_FRAMES = 4096       # bench_infer's frames
INFER_BATCHES = (INFER_BATCH, 16)  # and the reference's logged FPS batch


def phase_bench(seed: int, smi: str) -> dict:
    """Phase 17: the port's benchmarks as a user runs them, through
    `tools/bench.py::main` (Xception-331 bf16, b=128, the synthetic set,
    BENCH_STEPS steps an epoch) and `tools/bench_infer.py`'s two modes at
    each of INFER_BATCHES over INFER_FRAMES seeded frames, with the launch
    counts of each."""
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.tools import bench, bench_infer
    from spnet_tpu_torch.train.steps import make_predict_step

    t0 = time.perf_counter()
    _zero_counts()
    out = bench.main(steps_per_epoch=BENCH_STEPS)
    counts = _counts()
    # the graphed turns' warm-up and capture, the eager turns' every step
    want = _want_counts(ModelConfig(), train_steps=sum(
        _epoch_calls(2 * BENCH_STEPS) if form == "graph" else 2 * BENCH_STEPS
        for form in bench.TURNS))
    print(f"[bench] bench.main(steps_per_epoch={BENCH_STEPS}) (warm-up + "
          f"timed epoch): {json.dumps(out)}; launches {counts}  [{smi}]")
    if tuple(out) != ("metric", "value", "unit", "vs_baseline") or not (
            np.isfinite(out["value"]) and out["value"] > 0):
        fail(f"bench: {out}")
    if counts != want:
        fail(f"bench: launches {counts} != {want}")
    res = dict(train=out, train_counts=counts, infer={})

    model, x, mc = bench_infer.setup(INFER_BATCHES[0], INFER_FRAMES)
    predict = make_predict_step(model)
    for b in INFER_BATCHES:
        steps = INFER_FRAMES // b
        _zero_counts()
        y1, fps1 = bench_infer.pipelined(predict, x, b)
        c1 = _counts()
        _zero_counts()
        y2, fps2 = bench_infer.captured_sweep(predict, x, b)
        c2 = _counts()
        # pipelined: the warm-up batch and every batch; the sweep: its
        # eager warm-up batch and the graph's contents (captured once; the
        # replays do not pass through the wrapper)
        w1 = _want_counts(mc, predict_batches=-(-INFER_FRAMES // b) + 1)
        w2 = _want_counts(mc, predict_batches=1 + steps)
        same = torch.equal(y1[: steps * b], y2)
        r = bench_infer.result(b, fps1, fps2, x.device, mc)
        print(f"[bench] bench_infer b={b}, {INFER_FRAMES} frames: "
              f"{json.dumps(r)}; outputs of the two modes bitwise equal: "
              f"{same}; K1 launches pipelined {c1['sepconv_infer']}, sweep "
              f"{c2['sepconv_infer']} (warm-up batch + the graph's "
              f"{steps} x 34)  [{smi}]")
        if c1 != w1 or c2 != w2:
            fail(f"bench_infer b={b}: launches {c1} / {c2} != {w1} / {w2}")
        if not (same and torch.isfinite(y1).all()):
            fail(f"bench_infer b={b}: the two modes' outputs differ")
        res["infer"][b] = dict(result=r, pipelined=c1["sepconv_infer"],
                               sweep=c2["sepconv_infer"])
    del model, predict, x
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[bench] phase 17 took {res['seconds']:.1f} s")
    return res


NATIVE_TRAIN, NATIVE_VAL = 512, 256  # phase 18(c)'s native frames
NATIVE_SERVE_FRAMES = 256            # phase 18(b)'s predict frames, b=16


def _native_kernel(seed: int, smi: str) -> dict:
    """Phase 18(a): K1 against its plain version at NATIVE_SHAPES, b=16,
    INFER_BATCH and VAL_BATCH, float32 and bfloat16; the path each shape takes
    (`wgmma_kernel` tiles or the simple kernel), and for bf16 its median
    time, bound, % of bound and the library pair's time."""
    from spnet_tpu_torch.ops._build import load_library
    from spnet_tpu_torch.ops.sepconv import _wgmma_tiles, sepconv_infer, \
        sepconv_infer_torch

    lib = load_library()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err, paths = 0.0, {}
    sums = {b: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
            for b in (16, INFER_BATCH, VAL_BATCH)}
    for b in (16, INFER_BATCH, VAL_BATCH):
        for _, h, w, c, f, relu, relu_in, uses in NATIVE_SHAPES:
            for dtype, rtol in ((torch.float32, F32_RTOL),
                                (torch.bfloat16, BF16_RTOL)):
                args = _sepconv_inputs(b, h, w, c, f, dtype, gen)
                kw = dict(relu=relu, relu_in=relu_in)
                tm, tn, blocks = _wgmma_tiles(lib, *args)
                path = (f"wgmma_kernel TM={tm} TN={tn} ({blocks} blocks)"
                        if tm else "simple kernel")
                out = sepconv_infer(*args, **kw)
                ref = sepconv_infer_torch(*args, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                rel = err / max(ref.float().abs().max().item(), 1e-30)
                name = str(dtype).replace("torch.", "")
                line = (f"[native] K1 {name:8s} B={b} {h}x{w} {c}->{f} "
                        f"relu={relu:d} relu_in={relu_in:d}: {path}  "
                        f"max_abs_err {err:.3e} (rel {rel:.2e}, tol {rtol})")
                if dtype == torch.bfloat16:
                    paths[(b, h, w, c, f)] = path
                    t_k = cuda_median_ms(lambda: sepconv_infer(*args, **kw))
                    t_p = cuda_median_ms(
                        lambda: sepconv_infer_torch(*args, **kw))
                    t_l = cuda_median_ms(_library_pair(*args[:3]))
                    bound, kind = sepconv_bound(b, h, w, c, f)
                    line += (f"  kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                             f"library pair {t_l:.4f} ms  bound "
                             f"{bound:.4f} ms ({kind})  "
                             f"{100 * bound / t_k:.1f}% of bound  x{uses}")
                    for k, v in (("ms", t_k), ("plain_ms", t_p),
                                 ("library_ms", t_l), ("bound_ms", bound)):
                        sums[b][k] += uses * v
                print(f"{line}  [{smi}]")
                if not rel <= rtol:
                    fail(f"native sepconv {dtype} {(b, h, w, c, f)}: "
                         f"relative error {rel} > {rtol}")
                max_err = max(max_err, err)
                del args, out, ref
    for b, acc in sums.items():
        share = 100 * acc["bound_ms"] / acc["ms"]
        print(f"[native] one bf16 batch of b={b} at 384x512 (34 sepconvs): "
              f"kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
              f"library pair {acc['library_ms']:.4f} ms, bound "
              f"{acc['bound_ms']:.4f} ms ({share:.1f}% of bound)  [{smi}]")
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, paths=paths, sums=sums)


def phase_native(seed: int, smi: str) -> dict:
    """Phase 18: native resolution (`input_size=0`, uncut 512x384
    frames), Xception bf16 with f32 params: (a) K1 at its ten shapes;
    (b) the model served from a port checkpoint (NATIVE_SERVE_FRAMES at
    b=16: frames/s, 34 K1 launches a batch) and held, float32 and bf16,
    against its plain version; (c) `train_network` at b=128 on
    NATIVE_TRAIN + NATIVE_VAL seeded native frames for 2 epochs: finite
    losses, launches, the run's peak memory."""
    from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
        TrainConfig

    t0 = time.perf_counter()
    kern = _native_kernel(seed, smi)
    cfg = ExperimentConfig(model=ModelConfig(input_size=0))
    model, x, _, _, fps, serve_counts = _serve(
        cfg, seed, smi, "native", n_frames=NATIVE_SERVE_FRAMES)
    for dtype in ("float32", "bfloat16"):
        _kernels_vs_plain(cfg.model, model.state_dict(), x[:16], "native",
                          dtype)
    del model
    torch.cuda.empty_cache()
    cfg = ExperimentConfig(model=ModelConfig(input_size=0),
                           train=TrainConfig(batch_size=TRAIN_BATCH,
                                             epochs=2, save_every=1,
                                             seed=seed))
    train_ds, val_ds = _seeded_split((NATIVE_TRAIN, NATIVE_VAL), 0,
                                     cfg.grid, seed)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        state, hist, train_counts = _train_run(cfg, train_ds, val_ds, tmp,
                                               smi, tag="native")
        del state
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"[native] train b={TRAIN_BATCH} at 384x512: peak "
          f"max_memory_allocated {peak:.2f} GiB over the run (train steps, "
          f"the b={VAL_BATCH} val sweeps, {NATIVE_TRAIN + NATIVE_VAL} "
          f"resident frames); predict {fps:.1f} frames/s at b=16; phase 18 "
          f"took {seconds:.1f} s  [{smi}]")
    return dict(kern=kern, predict_fps=fps, serve_counts=serve_counts,
                train_counts=train_counts, peak_gib=peak,
                img_per_sec=hist[-1]["img_per_sec"], seconds=seconds)


VALIDATION_ARGV = ["2", "32", "1e-4", "1024", "bfloat16", "331", "Xception"]
VALIDATION_VAL = 256        # SPNET_NVAL of phase 19's dataset_a run
VALIDATION_TTA_FRAMES = 4992  # eval_tta's val set (the tool's own)
VALIDATION_MOVIE = 512      # movie_predict's frames, at MOVIE_BATCH


def _tool(name: str, fn, argv, want: dict, smi: str,
          tag: str = "validation"):
    """One validation tool's `main(argv)` with its stdout kept, and the
    launch counts set to 0 just before it and checked against `want`
    just after.  Returns (its result, its counts, its stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
    except BaseException:
        print(buf.getvalue()[-4000:])
        raise
    seconds = time.perf_counter() - t0
    counts = _counts()
    mem = [line for line in buf.getvalue().splitlines()
           if line.startswith("[memory]")]
    print(f"[{tag}] {name} {' '.join(argv)}: {seconds:.1f} s; "
          f"launches {counts}; {' | '.join(mem)}  [{smi}]")
    if counts != want:
        fail(f"{tag} {name}: launches {counts} != {want}")
    return out, counts, buf.getvalue()


def phase_validation(seed: int, smi: str) -> dict:
    """Phase 19: the accuracy-validation tools (`spnet_tpu_torch/tools/`)
    as a user runs them, in a temporary working directory (they write
    under logs/): a 2-epoch `dataset_a` at full width, then
    `eval_breakdown`, `eval_tta` and `movie_predict` on its checkpoint,
    each with its own launch counts.  `seed` is unused: the tools seed
    themselves, as their JAX counterparts do."""
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.tools import dataset_a, eval_breakdown, eval_tta, \
        movie_predict

    del seed
    t0 = time.perf_counter()
    mc = ModelConfig()
    epochs, b, n_train = (int(VALIDATION_ARGV[i]) for i in (0, 1, 3))
    val_batches = -(-VALIDATION_VAL // max(b, min(VAL_BATCH,
                                                   VALIDATION_VAL)))
    tta_batches = -(-VALIDATION_TTA_FRAMES // VAL_BATCH) + 1  # + warm-up
    env = {"SPNET_NVAL": str(VALIDATION_VAL), "SPNET_CKPT": "ck"}
    saved = {k: os.environ.get(k) for k in (*env, "SPNET_LOGDIR",
                                            "SPNET_DEVICE", "SPNET_AUGMENT",
                                            "SPNET_REMAT",
                                            "SPNET_TTA_PER_VIEW")}
    cwd = os.getcwd()
    res = {"counts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for k in saved:
                os.environ.pop(k, None)
            os.environ.update(env)
            os.chdir(tmp)
            out, res["counts"]["dataset_a"], text = _tool(
                "dataset_a", dataset_a.main, VALIDATION_ARGV,
                _want_counts(mc, predict_batches=(val_batches + 1)
                             * epochs + val_batches + 1,
                             train_steps=_epoch_calls(
                                 epochs * (n_train // b))), smi)
            with open("logs/dataset_a/metrics.jsonl") as f:
                losses = [json.loads(line)["train"] for line in f]
            line = [l for l in text.splitlines()
                    if l.startswith("DATASET_A_RESULT ")]
            final = json.loads(line[0].split(" ", 1)[1])["final_eval"] \
                if len(line) == 1 else {}
            print(f"[validation] dataset_a: train loss by epoch {losses}; "
                  f"final evaluation mAP {final.get('mAP')} ring_acc "
                  f"{final.get('ring_acc')} class_acc "
                  f"{final.get('class_acc')}  [{smi}]")
            if len(line) != 1 or not all(
                    np.isfinite(final.get(k, np.nan))
                    for k in ("mAP", "ring_acc", "class_acc")):
                fail(f"dataset_a: result line {line}")
            if not (len(losses) == epochs and losses[1] < losses[0]):
                fail(f"dataset_a: the train loss did not fall {losses}")
            res["dataset_a"] = final

            out, res["counts"]["eval_breakdown"], _ = _tool(
                "eval_breakdown", eval_breakdown.main,
                ["ck", str(VALIDATION_VAL)],
                _want_counts(mc, predict_batches=val_batches + 1), smi)
            print(f"[validation] BREAKDOWN {json.dumps(out)}")
            if out["n_true"] <= 0:
                fail(f"eval_breakdown: {out}")

            out, res["counts"]["eval_tta"], text = _tool(
                "eval_tta", eval_tta.main, ["ck"],
                _want_counts(mc, predict_batches=(1 + 3 + 4)
                             * tta_batches), smi)
            maps = [l.strip(" ()") for l in text.splitlines()
                    if "(calc_map:" in l]
            print(f"[validation] eval_tta: {'; '.join(maps)}; plain ring_acc "
                  f"{out['plain']['ring_acc']:.4f} mAP "
                  f"{out['plain']['mAP']} | per view "
                  f"{ {m: round(v['ring_acc'], 4) for m, v in out['per_view'].items()} }"
                  f" | tta ring_acc {out['tta']['ring_acc']:.4f} mAP "
                  f"{out['tta']['mAP']}  [{smi}]")
            if set(out["per_view"]) != {"h", "v", "hv"} or not all(
                    np.isfinite(out[r]["mAP"]) for r in ("plain", "tta")):
                fail(f"eval_tta: {out}")

            out, res["counts"]["movie_predict"], text = _tool(
                "movie_predict", movie_predict.main,
                [str(VALIDATION_MOVIE), str(MOVIE_BATCH)],
                _want_counts(mc, predict_batches=2), smi)
            fps = [l for l in text.splitlines() if "FPS = " in l]
            print(f"[validation] MOVIE_RESULT {json.dumps(out)}; "
                  f"{fps[-1].strip() if fps else ''}  [{smi}]")
            if out["overlays"] != 8 or out["frames"] != VALIDATION_MOVIE:
                fail(f"movie_predict: {out}")
        finally:
            os.chdir(cwd)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[validation] phase 19 took {res['seconds']:.1f} s")
    return res


EPOCH_FRAMES = 256        # phase 20's resident frames
EPOCH_BATCHES = (16, 128)
EPOCH_STEPS, EPOCH_SPLIT = 8, 4  # steps of a pair run; unfreeze after 4
EPOCH_FREEZE = 0.5        # freeze_fac of its first epoch
EPOCH_TIMED = {16: 32, 32: 32, 128: 16}  # steps of a timed epoch, by batch
EPOCH_TURNS = ("graph", "eager", "eager", "graph")
# phase 20(b): the other backbones at the 25-epoch sweep's batch
EPOCH_ZOO = ("DarkNet19", "InceptionResNetV2", "MobileNet", "NASNetMobile")
EPOCH_ZOO_BATCH = 32


def _epoch_calls(steps: int) -> int:
    """The loss wrapper's calls in `steps` steps of the epoch form after a
    (re)capture: the eager warm-up steps and the one captured step (the
    replays do not pass through the wrapper)."""
    from spnet_tpu_torch.train.steps import WARMUP_STEPS

    return min(WARMUP_STEPS, steps) + int(steps > WARMUP_STEPS)


def _states_equal(a, b) -> list:
    """Names of the leaves where two train states differ bitwise: the
    model's parameters and buffers, the Adam moments, the device count and
    the host ints."""
    bad = [k for (k, v), w in zip(a.model.state_dict().items(),
                                  b.model.state_dict().values())
           if not torch.equal(v, w)]
    for name in ("mu", "nu"):
        for i, (u, v) in enumerate(zip(getattr(a.opt_state, name),
                                       getattr(b.opt_state, name))):
            if (u is None) != (v is None) or (
                    u is not None and not torch.equal(u, v)):
                bad.append(f"{name}[{i}]")
    if not torch.equal(a.opt_state.t, b.opt_state.t):
        bad.append("t")
    if (a.step, a.opt_state.count) != (b.step, b.opt_state.count):
        bad.append("step/count")
    return bad


def _epoch_trainer(form: str, mc, data, seed: int):
    """A seeded model's train state (freeze_fac EPOCH_FREEZE, optax Adam
    under onecycle(1e-4, 100)) and epoch(rows, generator seed) -> losses:
    the graphed epoch form (form 'graph') or the eager steps ('eager'), on
    `data` ((x_all, y_all) or, geo, (x_all, y_all, rows_all, mask_all)).
    Returns (box with the 'state', epoch, the epoch form's capture
    seconds)."""
    from spnet_tpu_torch.config import GridSpec, LossWeights
    from spnet_tpu_torch.models.spnet import build_model
    from spnet_tpu_torch.train.schedule import onecycle_schedule
    from spnet_tpu_torch.train.state import create_train_state
    from spnet_tpu_torch.train.steps import make_train_epoch, make_train_step

    geo = len(data) == 4
    grid = GridSpec()
    model = build_model(mc, num_outputs=grid.num_outputs, device=DEVICE,
                        generator=torch.Generator().manual_seed(seed))
    box = {"state": create_train_state(model, onecycle_schedule(1e-4, 100),
                                       freeze_fac=EPOCH_FREEZE,
                                       adam_variant="optax")}
    step = make_train_step(model, LossWeights(), mc.loss_type,
                           l2_reg=mc.l2_reg, augment=True, geo_augment=geo,
                           grid=grid)
    train_epoch = make_train_epoch(step, geo)
    gen = torch.Generator(device=DEVICE)

    def epoch(rows, gen_seed: int):
        gen.manual_seed(gen_seed)
        if form == "graph":
            return train_epoch(box["state"], *data, rows, gen)[1]
        return torch.stack([step(box["state"], *data, r, gen)[1]["loss"]
                            for r in rows])

    return box, epoch, train_epoch.capture_seconds


def _epoch_pair(mc, b: int, data, seed: int, tag: str, smi: str) -> dict:
    """The graphed epoch form and the eager steps from the same seeded
    model and generator seeds (`_epoch_trainer`): EPOCH_STEPS steps
    (augmentation on, the model's dropout) as two epochs of EPOCH_SPLIT
    with `unfreeze` between; losses, parameters, BN statistics, Adam
    moments and counts must be bitwise equal.  The eager steps run twice
    (first, and after the graphed run), and the two runs must be bitwise
    equal: the eager path's own determinism, which the pair relies on.
    Then both train on in turns (EPOCH_TURNS, EPOCH_TIMED[b] steps an
    epoch, after one untimed graphed epoch of that length, which captures
    again for its longer buffers): images/s each way."""
    from spnet_tpu_torch.train.state import unfreeze

    rng = np.random.default_rng(seed)
    n = data[0].shape[0]
    idx = torch.from_numpy(rng.integers(0, n, (EPOCH_STEPS, b))).to(DEVICE)
    runs = {}
    for form in ("eager2", "graph", "eager"):
        box, epoch, captures = _epoch_trainer(form[:5], mc, data, seed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held0 = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the other run's state too
        _zero_counts()
        t0 = time.perf_counter()
        first = epoch(idx[:EPOCH_SPLIT], seed * 1_000_003)
        box["state"] = unfreeze(box["state"], adam_variant="optax")
        losses = torch.cat([first, epoch(idx[EPOCH_SPLIT:],
                                         seed * 1_000_003 + 1)])
        float(losses[-1])
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        # what the cache cannot give back after the run: the private pool
        # of the graph it captured
        torch.cuda.empty_cache()
        held = (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
                - held0) / 2**30
        runs[form] = dict(state=box["state"], epoch=epoch, losses=losses,
                          counts=_counts(), seconds=seconds, peak_gib=peak,
                          held_gib=held, captures=list(captures))
    e2 = runs.pop("eager2")
    bad = _states_equal(e2["state"], runs["eager"]["state"])
    same = torch.equal(e2["losses"], runs["eager"]["losses"])
    print(f"[epoch] {tag} b={b}: eager against eager, {EPOCH_STEPS} steps: "
          f"bitwise equal: losses {same}, every parameter, BN statistic, "
          f"Adam moment and count {not bad} {bad[:5]}")
    if not same or bad:
        fail(f"epoch {tag} b={b}: two eager runs differ: losses {same}, "
             f"leaves {bad[:10]}")
    del e2
    g, e = runs["graph"], runs["eager"]
    bad = _states_equal(g["state"], e["state"])
    same = torch.equal(g["losses"], e["losses"])
    want_g = _want_counts(mc, train_steps=2 * _epoch_calls(EPOCH_SPLIT))
    want_e = _want_counts(mc, train_steps=EPOCH_STEPS)
    print(f"[epoch] {tag} b={b}: {EPOCH_STEPS} steps, unfreeze after "
          f"{EPOCH_SPLIT}: graphed losses {g['losses'].tolist()}; eager "
          f"bitwise equal: losses {same}, every parameter, BN statistic, "
          f"Adam moment and count {not bad} {bad[:5]}; captures "
          f"{[round(c, 3) for c in g['captures']]} s; launches graphed "
          f"{g['counts']} (warm-ups + the graph's contents), eager "
          f"{e['counts']}; peak allocated above the memory in use before "
          f"the run, graphed {g['peak_gib']:.4f} / "
          f"eager {e['peak_gib']:.4f} GiB; reserved and free after "
          f"empty_cache, more than before the run (the graph's pool) "
          f"{g['held_gib']:.4f} / {e['held_gib']:.4f} GiB  [{smi}]")
    if not same or bad or not torch.isfinite(g["losses"]).all():
        fail(f"epoch {tag} b={b}: graphed vs eager differ: losses {same}, "
             f"leaves {bad[:10]}")
    if g["counts"] != want_g or e["counts"] != want_e:
        fail(f"epoch {tag} b={b}: launches {g['counts']} / {e['counts']} "
             f"!= {want_g} / {want_e}")
    steps = EPOCH_TIMED[b]
    timed = torch.from_numpy(rng.integers(0, n, (steps, b))).to(DEVICE)
    float(g["epoch"](timed, seed)[-1])  # the graph's longer buffers
    rates = {"graph": [], "eager": []}
    for k, form in enumerate(EPOCH_TURNS):
        t0 = time.perf_counter()
        float(runs[form]["epoch"](timed, seed + 1 + k)[-1])
        rates[form].append(b * steps / (time.perf_counter() - t0))
    print(f"[epoch] {tag} b={b}: train images/s, {steps} steps an epoch, "
          f"in turns {EPOCH_TURNS}: graphed "
          f"{[round(v, 2) for v in rates['graph']]}, eager "
          f"{[round(v, 2) for v in rates['eager']]}  [{smi}]")
    g_peak, e_peak = g["peak_gib"], e["peak_gib"]
    del runs, g, e
    torch.cuda.empty_cache()
    return dict(counts=want_g, rates=rates, bitwise=True,
                peak_gib=(g_peak, e_peak))


def phase_epoch(seed: int, smi: str) -> dict:
    """Phase 20: the epoch form (`train/steps.py::make_train_epoch`, a CUDA
    graph of the train step replayed once a minibatch) against the eager
    steps at full width, Xception-331 bf16 with f32 params, cuDNN
    deterministic: b=16 and b=128, the 'ss' head at b=16, and geometric
    augmentation at b=16 (`_epoch_pair`); (b) each of EPOCH_ZOO at 331,
    bf16 with f32 params, b=EPOCH_ZOO_BATCH."""
    import dataclasses

    from spnet_tpu_torch.config import GridSpec, ModelConfig
    from spnet_tpu_torch.data.dataset import pad_raw_rows

    t0 = time.perf_counter()
    grid = GridSpec()
    mc = ModelConfig()
    x, y, raws = _seeded_dataset(EPOCH_FRAMES, mc.input_size, grid, seed,
                                 raw=True)
    rows, mask = pad_raw_rows(raws)
    x, y, rows, mask = (torch.from_numpy(a).to(DEVICE)
                        for a in (x, y, rows, mask))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {}
    try:
        for b in EPOCH_BATCHES:
            res[f"b{b}"] = _epoch_pair(mc, b, (x, y), seed, "default", smi)
        res["ss"] = _epoch_pair(dataclasses.replace(
            mc, selective_sigmoid=True), 16, (x, y), seed, "ss", smi)
        res["geo"] = _epoch_pair(mc, 16, (x, y, rows, mask), seed, "geo",
                                 smi)
        t1 = time.perf_counter()
        for backbone in EPOCH_ZOO:
            res[backbone] = _epoch_pair(
                dataclasses.replace(mc, backbone=backbone), EPOCH_ZOO_BATCH,
                (x, y), seed, backbone, smi)
        zoo_s = time.perf_counter() - t1
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"[epoch] phase 20(b), {', '.join(EPOCH_ZOO)} at "
          f"b={EPOCH_ZOO_BATCH}, took {zoo_s:.1f} s")
    res["seconds"] = time.perf_counter() - t0
    print(f"[epoch] phase 20 took {res['seconds']:.1f} s")
    return res


DATASET_D_ARGV = ["48", "1"]  # phase 21: n_train, epochs_offline
DATASET_D_VAL = 16            # ... its N_VAL
DATASET_D_AUGS = 4            # ... its N_AUGS
BLUR_SPLIT_FRAMES = 64        # eval_blur_split's n_val on its checkpoint


def _inflated_names(train_dir: str, n_augs: int) -> set:
    """The PNG names `augment -n n_augs` leaves in a copy of train_dir:
    the originals and every variant's name from the tool's draws (one
    `default_rng(0)` for the directory, files in sorted order)."""
    from spnet_tpu_torch.cli.augment_preproc import draw_variant, \
        variant_suffix
    from spnet_tpu_torch.data.csvio import paired_file_lists

    imgs, _ = paired_file_lists(train_dir + os.sep)
    rng = np.random.default_rng(0)
    names = set()
    for im in imgs:
        stem = os.path.splitext(os.path.basename(im))[0]
        names.add(stem + ".png")
        names.update(stem + variant_suffix(*draw_variant(rng)) + ".png"
                     for _ in range(n_augs))
    return names


def _stages(text: str) -> dict:
    lines = [json.loads(l.split(" ", 1)[1]) for l in text.splitlines()
             if l.startswith("DATASET_D_STAGES ")]
    if len(lines) != 1:
        fail(f"dataset_d: {len(lines)} DATASET_D_STAGES lines")
    return lines[0]


def phase_dataset_d(seed: int, smi: str) -> dict:
    """Phase 21: the Dataset-D experiment (`tools/dataset_d.py`) as a user
    runs it, at a small depth and full width (Xception-331 bf16, b=16), in
    a temporary directory: `dataset_d 48 1 --arm offline` (gen-fake-espi's
    48 + 16 native PNG frames, the train split inflated 4x by `augment`,
    loaded back through `build_dataset`), then `--arm onthefly --rep R`
    with R the offline set's frames // 48, then `eval_blur_split` on a
    checkpoint of the offline arm's state.  Checks the inflated file
    names and count, that both arms took the resident feed and the epoch
    form, each run's K1-K3 launches, finite results; prints both arms'
    images/s and stage seconds.  `seed` is unused: the tools seed
    themselves."""
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.io.checkpoint import save_train_state
    from spnet_tpu_torch.tools import dataset_d, eval_blur_split
    import spnet_tpu_torch.train.loop as loop

    del seed
    t0 = time.perf_counter()
    mc = ModelConfig()
    if (mc.backbone, mc.input_size) != (dataset_d.BACKBONE,
                                        dataset_d.INPUT_SIZE):
        fail("dataset_d: the recipe is no longer Xception-331")
    n_train, epochs = (int(a) for a in DATASET_D_ARGV)
    b = dataset_d.BATCH
    val_batches = -(-DATASET_D_VAL // max(b, min(VAL_BATCH, DATASET_D_VAL)))
    blur_batches = -(-BLUR_SPLIT_FRAMES // max(b, min(VAL_BATCH,
                                                      BLUR_SPLIT_FRAMES)))
    consts = {"N_VAL": DATASET_D_VAL, "N_AUGS": DATASET_D_AUGS}
    saved = {k: getattr(dataset_d, k) for k in consts}
    hooks = {"pick": loop._pick_feed, "epoch": loop.make_train_epoch,
             "train": dataset_d.train_network}
    env = {"SPNET_DEVICE": os.environ.get("SPNET_DEVICE")}
    seen = {"feeds": [], "epoch_forms": [], "states": []}

    def pick(*a, **k):
        seen["feeds"].append(hooks["pick"](*a, **k))
        return seen["feeds"][-1]

    def make_epoch(*a, **k):
        seen["epoch_forms"].append(hooks["epoch"](*a, **k))
        return seen["epoch_forms"][-1]

    def train(cfg, *a, **k):
        state, history = hooks["train"](cfg, *a, **k)
        seen["states"].append((state, cfg))
        return state, history

    cwd = os.getcwd()
    res = {"counts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            os.environ["SPNET_DEVICE"] = DEVICE  # the tools' default
            for k, v in consts.items():
                setattr(dataset_d, k, v)
            loop._pick_feed, loop.make_train_epoch = pick, make_epoch
            dataset_d.train_network = train
            os.chdir(tmp)
            wd = dataset_d.workdir(DEVICE)

            # the offline arm: the frames and the inflation first, so the
            # inflated set's size (and with it the steps) is known when the
            # counts are checked; the tool reuses both through the marker
            from spnet_tpu_torch.tools import dataset_d_prep
            _zero_counts()
            t1 = time.perf_counter()
            dataset_d_prep.main([str(n_train), str(DATASET_D_VAL),
                                 str(DATASET_D_AUGS)])
            prep_s = time.perf_counter() - t1
            if _counts() != _want_counts(mc):
                fail(f"dataset_d_prep launched a kernel: {_counts()}")
            names = {f for f in os.listdir(f"{wd}/TrainAug")
                     if f.endswith(".png")}
            want_names = _inflated_names(f"{wd}/Train", DATASET_D_AUGS)
            written = n_train * (DATASET_D_AUGS + 1)
            print(f"[dataset_d] dataset_d_prep {n_train} {DATASET_D_VAL} "
                  f"{DATASET_D_AUGS}: {prep_s:.1f} s; TrainAug holds {len(names)} PNG files of"
                  f" {written} written ({written - len(names)} share a "
                  f"name)  [{smi}]")
            if names != want_names:
                fail(f"dataset_d: inflated names differ from augment's "
                     f"draws: {sorted(names ^ want_names)[:6]}")
            frames = len(names) // b * b
            steps = frames // b
            out, res["counts"]["offline"], text = _tool(
                "dataset_d", dataset_d.main, [*DATASET_D_ARGV, "--arm",
                                              "offline"],
                _want_counts(mc, predict_batches=(val_batches + 1)
                             * epochs + val_batches + 1,
                             train_steps=_epoch_calls(epochs * steps)),
                smi, tag="dataset_d")
            off = _stages(text)
            if "(reusing completed inflation:" not in text:
                fail("dataset_d: the tool did not reuse the inflation")
            if (off["inflated_files"], off["frames"]) != (len(names),
                                                          frames):
                fail(f"dataset_d: stages {off} != {len(names)} files, "
                     f"{frames} frames")
            rep = frames // n_train
            out2, res["counts"]["onthefly"], text = _tool(
                "dataset_d", dataset_d.main, [*DATASET_D_ARGV, "--arm",
                                              "onthefly", "--rep",
                                              str(rep)],
                _want_counts(mc, predict_batches=(val_batches + 1)
                             * epochs + val_batches + 1,
                             train_steps=_epoch_calls(
                                 epochs * rep * (n_train // b))),
                smi, tag="dataset_d")
            fly = _stages(text)
            if (seen["feeds"] != [True, True]
                    or len(seen["epoch_forms"]) != 2
                    or None in seen["epoch_forms"]):
                fail(f"dataset_d: feeds {seen['feeds']}, epoch forms "
                     f"{seen['epoch_forms']}: not the resident feed's "
                     f"epoch form")
            r_off, r_fly = out["offline"], out2["onthefly"]
            for r in (r_off, r_fly):
                if not all(np.isfinite(r[k]) for k in (
                        "ring_acc", "class_acc", "mAP", "pix_err")):
                    fail(f"dataset_d: result {r}")
            if (r_off["imgs_seen"], r_fly["imgs_seen"]) != (
                    epochs * frames, epochs * rep * n_train):
                fail(f"dataset_d: images seen {r_off['imgs_seen']}, "
                     f"{r_fly['imgs_seen']}")
            for arm, st in (("offline", off), ("onthefly", fly)):
                secs = {k: v for k, v in st.items()
                        if k.endswith("_s") and v is not None}
                print(f"[dataset_d] {arm}: {st['frames']} frames, images/s "
                      f"{st['img_per_sec']}; stage seconds {secs}  [{smi}]")
            res.update(offline=r_off, onthefly=r_fly,
                       img_per_sec={"offline": off["img_per_sec"],
                                    "onthefly": fly["img_per_sec"]})

            state, cfg = seen["states"][0]
            save_train_state("ck", state, cfg)
            lines, res["counts"]["blur_split"], _ = _tool(
                "eval_blur_split", eval_blur_split.main,
                ["ck", str(BLUR_SPLIT_FRAMES)],
                _want_counts(mc, predict_batches=2 * (blur_batches + 1)),
                smi, tag="dataset_d")
            print(f"[dataset_d] BLUR_SPLIT {json.dumps(lines)}  [{smi}]")
            if [l["val"] for l in lines] != ["blurred(30%)", "blur-free"] \
                    or not all(np.isfinite(l[k]) for l in lines for k in (
                        "ring_acc", "class_acc", "mean_pix_err")):
                fail(f"eval_blur_split: {lines}")
        finally:
            os.chdir(cwd)
            loop._pick_feed, loop.make_train_epoch = (hooks["pick"],
                                                      hooks["epoch"])
            dataset_d.train_network = hooks["train"]
            for k, v in saved.items():
                setattr(dataset_d, k, v)
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[dataset_d] phase 21 took {res['seconds']:.1f} s")
    return res


REFGEN_SHARD = 64             # phase 22: frames a shard, two shards
REFGEN_SIZE = 331
REFGEN_SPLIT = (96, 32)       # ... refgen_run's N_TRAIN, N_VAL
REFGEN_ARGV = ["1", "32", "1e-4", "bfloat16", str(REFGEN_SIZE)]
REFGEN_TTA_MODES = "h"


def _shard_arrays(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _refgen_frames(smi: str) -> dict:
    """Phase 22's shards, in the current directory: drawn serially into
    serial/, then through `refgen_dataset.main` over its pool into the
    tool's directory (bitwise equal), a rerun that skips both, and a shard
    of altered versions refused.  Returns the frames/s both ways and the
    worker count."""
    import contextlib
    import io

    from spnet_tpu_torch.tools import refgen_dataset as rd

    total = 2 * REFGEN_SHARD
    rd.SHARD = REFGEN_SHARD  # restored by phase_refgen
    t0 = time.perf_counter()
    rd.write_shards(total, REFGEN_SIZE, 0, None, cache_dir="serial")
    serial_s = time.perf_counter() - t0
    _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = rd.main([str(total), str(REFGEN_SIZE), "0"])
    if _counts() != _want_counts(_model_config()):
        fail(f"refgen_dataset launched a kernel: {_counts()}")
    if out["frames"] != total or "REFGEN_DONE" not in buf.getvalue():
        fail(f"refgen_dataset: {out}; {buf.getvalue()[-2000:]}")
    for s in range(2):
        a = _shard_arrays(rd.shard_path(0, REFGEN_SIZE, s, "serial"))
        b = _shard_arrays(rd.shard_path(0, REFGEN_SIZE, s))
        bad = [k for k in a if a[k].shape != b[k].shape
               or not np.array_equal(a[k], b[k])]
        if bad or set(a) != set(b) or a["x"].shape != (
                REFGEN_SHARD, REFGEN_SIZE, REFGEN_SIZE, 1):
            fail(f"refgen: shard {s} pooled != serial in {bad}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = rd.main([str(total), str(REFGEN_SIZE), "0"])
    if again["frames"] != 0 or buf.getvalue().count("exists, skip") != 2:
        fail(f"refgen: the rerun drew {again}")
    os.makedirs("altered")
    z = _shard_arrays(rd.shard_path(0, REFGEN_SIZE, 0))
    z["versions"] = np.array(["cv2=0.0.0", *z["versions"][1:]])
    np.savez(rd.shard_path(0, REFGEN_SIZE, 0, "altered"), **z)
    try:
        rd.write_shards(REFGEN_SHARD, REFGEN_SIZE, 0, None,
                        cache_dir="altered")
        fail("refgen: a shard of altered versions was not refused")
    except SystemExit as e:
        if "cv2=0.0.0" not in str(e) or \
                f"cv2={rd.cv2.__version__}" not in str(e):
            fail(f"refgen: the refusal names not both sets: {e}")
    res = {"serial_frames_per_s": total / serial_s,
           "pool_frames_per_s": out["frames_per_s"],
           "workers": out["workers"]}
    print(f"[refgen] {total} frames at {REFGEN_SIZE}: serial "
          f"{res['serial_frames_per_s']:.1f} frames/s, pooled "
          f"{res['pool_frames_per_s']} frames/s over {res['workers']} "
          f"workers (bitwise equal); rerun skipped both shards; altered "
          f"versions refused ({', '.join(rd.versions())})  [{smi}]")
    return res


def _model_config():
    from spnet_tpu_torch.config import ModelConfig

    return ModelConfig()


def phase_refgen(seed: int, smi: str) -> dict:
    """Phase 22: the reference generator's frames (`tools/refgen_dataset.py`)
    and the recipe trained on them (`tools/refgen_run.py`) as a user runs
    them, at a small depth and full width (Xception-331 bf16, b=32), in a
    temporary directory: the shards (`_refgen_frames`), then `refgen_run`
    on 96 + 32 frames with SPNET_CKPT, then `eval_breakdown <ckpt> refgen`
    and `eval_tta <ckpt> refgen h` on its checkpoint.  Checks that the run
    took the resident feed and the epoch form, each run's K1-K3 launches,
    the overflow line and finite results; prints frames/s and the stage
    seconds.  `seed` is unused: the tools seed themselves."""
    from spnet_tpu_torch.tools import eval_breakdown, eval_tta, \
        refgen_dataset, refgen_run
    import spnet_tpu_torch.train.loop as loop

    del seed
    t0 = time.perf_counter()
    mc = _model_config()
    epochs, b = int(REFGEN_ARGV[0]), int(REFGEN_ARGV[1])
    n_train, n_val = REFGEN_SPLIT
    if (mc.backbone, mc.input_size) != ("Xception", REFGEN_SIZE):
        fail("refgen: the recipe is no longer Xception-331")
    val_batches = -(-n_val // max(b, min(VAL_BATCH, n_val)))
    eval_batches = -(-n_val // VAL_BATCH) + 1  # + warm-up, at b=256
    views = len(REFGEN_TTA_MODES.split(","))
    saved = {"N_TRAIN": refgen_run.N_TRAIN, "N_VAL": refgen_run.N_VAL,
             "SHARD": refgen_dataset.SHARD}
    hooks = {"pick": loop._pick_feed, "epoch": loop.make_train_epoch}
    env = {k: os.environ.get(k) for k in (
        "SPNET_DEVICE", "SPNET_CKPT", "SPNET_LOGDIR", "SPNET_REMAT",
        "SPNET_BACKBONE_DTYPE", "SPNET_TTA_PER_VIEW")}
    seen = {"feeds": [], "epoch_forms": []}

    def pick(*a, **k):
        seen["feeds"].append(hooks["pick"](*a, **k))
        return seen["feeds"][-1]

    def make_epoch(*a, **k):
        seen["epoch_forms"].append(hooks["epoch"](*a, **k))
        return seen["epoch_forms"][-1]

    cwd = os.getcwd()
    res = {"counts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for k in env:
                os.environ.pop(k, None)
            os.environ.update(SPNET_DEVICE=DEVICE, SPNET_CKPT="ck")
            os.chdir(tmp)
            res.update(_refgen_frames(smi))
            refgen_run.N_TRAIN, refgen_run.N_VAL = n_train, n_val
            loop._pick_feed, loop.make_train_epoch = pick, make_epoch
            out, res["counts"]["refgen_run"], text = _tool(
                "refgen_run", refgen_run.main, REFGEN_ARGV,
                _want_counts(mc, predict_batches=(val_batches + 1)
                             * epochs + val_batches + 1,
                             train_steps=_epoch_calls(
                                 epochs * (n_train // b))), smi,
                tag="refgen")
            if seen["feeds"] != [True] or len(seen["epoch_forms"]) != 1 \
                    or None in seen["epoch_forms"]:
                fail(f"refgen_run: feeds {seen['feeds']}, epoch forms "
                     f"{seen['epoch_forms']}: not the resident feed's "
                     "epoch form")
            over = [l.strip() for l in text.splitlines()
                    if "grid-slot overflow frames:" in l]
            stages = [l for l in text.splitlines() if l.startswith(
                ("[stage]", "refgen data ready"))]
            final = out["final_eval"]
            print(f"[refgen] refgen_run: {'; '.join(over + stages)}; "
                  f"final evaluation ring_acc {final['ring_acc']} mAP "
                  f"{final['mAP']} total_obj {final['total_obj']}; "
                  f"images/s {out['last']['img_per_sec']:.1f}  [{smi}]")
            if len(over) != 1 or not over[0].endswith(
                    f"/{n_train + n_val} (0.00%)") or not all(
                    np.isfinite(final[k]) for k in (
                        "ring_acc", "class_acc", "mAP", "mean_pix_err")):
                fail(f"refgen_run: {over} {final}")
            res["refgen_run"] = final

            out, res["counts"]["eval_breakdown"], _ = _tool(
                "eval_breakdown", eval_breakdown.main, ["ck", "refgen"],
                _want_counts(mc, predict_batches=eval_batches), smi,
                tag="refgen")
            print(f"[refgen] BREAKDOWN {json.dumps(out)}  [{smi}]")
            if out["n_true"] != final["total_obj"]:
                fail(f"eval_breakdown refgen: {out['n_true']} true objects,"
                     f" the run's evaluation {final['total_obj']}")

            out, res["counts"]["eval_tta"], _ = _tool(
                "eval_tta", eval_tta.main, ["ck", "refgen",
                                            REFGEN_TTA_MODES],
                _want_counts(mc, predict_batches=(1 + views + views + 1)
                             * eval_batches), smi, tag="refgen")
            print(f"[refgen] eval_tta refgen: plain ring_acc "
                  f"{out['plain']['ring_acc']:.4f} mAP {out['plain']['mAP']}"
                  f" | per view { {m: round(v['ring_acc'], 4) for m, v in out['per_view'].items()} }"
                  f" | tta ring_acc {out['tta']['ring_acc']:.4f} mAP "
                  f"{out['tta']['mAP']}  [{smi}]")
            if out["source"] != "refgen" or out["plain"]["total_obj"] != \
                    final["total_obj"] or not all(
                        np.isfinite(out[r]["mAP"]) for r in ("plain", "tta")):
                fail(f"eval_tta refgen: {out}")
        finally:
            os.chdir(cwd)
            loop._pick_feed, loop.make_train_epoch = (hooks["pick"],
                                                      hooks["epoch"])
            refgen_run.N_TRAIN, refgen_run.N_VAL = (saved["N_TRAIN"],
                                                    saved["N_VAL"])
            refgen_dataset.SHARD = saved["SHARD"]
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[refgen] phase 22 took {res['seconds']:.1f} s")
    return res


PROFILE_RUNS = ((16, "epoch"), (128, "epoch"), (16, "eager"))  # phase 23
PROFILE_STEPS = 5         # traced steps of each run (the tool's default)


def phase_profile(seed: int, smi: str) -> dict:
    """Phase 23: `tools/profile_step.py` through its `main` as a user runs
    it (Xception-331 bf16), PROFILE_RUNS with PROFILE_STEPS steps each, its
    traces in a temporary directory.  Each run's tables are printed; the
    checks: the epoch form's trace shows the loss kernel once a step
    inside the replays (the tool raises otherwise; checked again here),
    the class sums add up to the kernels' total, the busy share lies in
    (0, 1], and each run's launches: the epoch form's wrappers run in the
    warm-up run only (`_epoch_calls`), the eager form's in all three runs
    (warm-up, timed, traced).  `seed` is unused: the tool seeds itself."""
    from spnet_tpu_torch.config import ModelConfig
    from spnet_tpu_torch.tools import profile_step

    del seed
    t0 = time.perf_counter()
    res = {"counts": {}, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for b, form in PROFILE_RUNS:
            tag = f"{form}_b{b}"
            steps = (_epoch_calls(PROFILE_STEPS) if form == "epoch"
                     else 3 * PROFILE_STEPS)
            out, res["counts"][tag], text = _tool(
                "profile_step", lambda argv: profile_step.main(
                    argv, logdir=tmp),
                [str(b), "--form", form, "--steps", str(PROFILE_STEPS)],
                _want_counts(ModelConfig(), train_steps=steps), smi,
                tag="profile")
            print("\n".join(line for line in text.splitlines()
                            if not line.startswith("PROFILE_STEP_RESULT")))
            total = out["device_us_per_step"]
            summed = sum(out["classes_us"].values())
            print(f"[profile] {tag}: step {out['step_ms']:.3f} ms, busy "
                  f"share {out['busy_share']:.4f}, kernels "
                  f"{total:.1f} us a step, classes "
                  f"{ {c: round(v, 1) for c, v in out['classes_us'].items()} }"
                  f", loss_kernel calls in the trace "
                  f"{out['loss_kernel_calls']}  [{smi}]")
            if form == "epoch" and out["loss_kernel_calls"] != PROFILE_STEPS:
                fail(f"profile {tag}: {out['loss_kernel_calls']} loss_kernel"
                     f" calls in {PROFILE_STEPS} replays")
            if not (abs(summed - total) <= 1e-6 * total and total > 0
                    and 0 < out["busy_share"] <= 1 + 1e-9
                    and np.isfinite(out["step_ms"])):
                fail(f"profile {tag}: classes {summed} vs total {total}, "
                     f"busy {out['busy_share']}, step {out['step_ms']}")
            res["runs"][tag] = {k: out[k] for k in (
                "step_ms", "busy_share", "device_us_per_step", "classes_us",
                "class_shares", "loss_kernel_calls",
                "bn_forward_us_per_step")}
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"[profile] phase 23 took {res['seconds']:.1f} s")
    return res


def _late_launches(name: str, feeds: dict, remat: dict, pre: dict) -> dict:
    """A loss kernel's launches on the paths of phases 11, 12 and 14."""
    return dict(feeds_launches={f: feeds[f]["counts"][name] for f in FEEDS},
                remat_launches=remat["counts"][name],
                pretrained_launches=(pre["counts"][name] if pre["keras"]
                                     else None))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp-child", nargs=5,
                   metavar=("MODE", "RANK", "WORLD", "PORT", "DIR"),
                   help="run one rank of phase 16(b) (started by phase 16)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        raise SystemExit(1)
    if args.dp_child:
        mode, rank, world, port, tmp = args.dp_child
        dp_child(mode, int(rank), int(world), port, tmp, args.seed)
        return
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
    zoo = phase_zoo(args.seed, smi)
    tta = phase_tta(args.seed, smi)
    syn = phase_synth(args.seed, smi, train["img_per_sec"])
    t1 = time.perf_counter()
    feeds = phase_feeds(args.seed, smi)
    remat = phase_remat(args.seed, smi)
    export = phase_export(args.seed, smi)
    pre = phase_pretrained(args.seed, smi)
    print(f"[done] phases 11-14 took {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    prep = phase_prep(args.seed, smi)
    dp = phase_dp(args.seed, smi)
    print(f"[done] phases 15-16 took {time.perf_counter() - t2:.1f} s")
    bench = phase_bench(args.seed, smi)
    native = phase_native(args.seed, smi)
    validation = phase_validation(args.seed, smi)
    epoch = phase_epoch(args.seed, smi)
    dsd = phase_dataset_d(args.seed, smi)
    refgen = phase_refgen(args.seed, smi)
    profile = phase_profile(args.seed, smi)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase; "
          f"train {train['img_per_sec']:.1f} images/s at b={TRAIN_BATCH}; "
          f"zoo train images/s "
          f"{ {b: round(r['img_per_sec'], 1) for b, r in zoo.items()} }; "
          f"TTA {tta['predict_fps']:.1f} frames/s; synthetic feed "
          f"{syn['frames_per_s'][1]:.1f} frames/s, geo train "
          f"{syn['img_per_sec'][1]:.1f} images/s; augment "
          f"{prep['files_per_s']:.3f} files/s; 1-rank group / no group "
          f"train images/s {[round(v, 1) for v in dp['rates']['group']]} / "
          f"{[round(v, 1) for v in dp['rates']['none']]}; bench "
          f"{bench['train']['value']} images/s, bench_infer "
          f"{ {b: r['result']['value'] for b, r in bench['infer'].items()} }"
          f" frames/s; native predict {native['predict_fps']:.1f} frames/s, "
          f"train {native['img_per_sec']:.1f} images/s, peak "
          f"{native['peak_gib']:.2f} GiB  [{smi}]")

    def bench_launches(name):
        # phase 17: bench.main's run, and bench_infer's modes per batch
        # (the sweep's: its warm-up batch and the captured graph's contents)
        res = {"bench": bench["train_counts"][name]}
        if name == "sepconv_infer":
            res["bench_infer"] = {
                b: {"pipelined": r["pipelined"], "sweep": r["sweep"]}
                for b, r in bench["infer"].items()}
        return res

    def native_launches(name):
        # phase 18: the native serve (b=16) and the native 2-epoch run
        return {"serve": native["serve_counts"][name],
                "train": native["train_counts"][name]}

    def validation_launches(name):
        # phase 19: each validation tool's run
        return {t: c[name] for t, c in validation["counts"].items()}

    def dataset_d_launches(name):
        # phase 21: each Dataset-D arm's run and the blur split
        return {t: c[name] for t, c in dsd["counts"].items()}

    def refgen_launches(name):
        # phase 22: the refgen run and the two eval tools on its checkpoint
        return {t: c[name] for t, c in refgen["counts"].items()}

    def profile_launches(name):
        # phase 23: each profile_step run (warm-up, timed and traced runs)
        return {t: c[name] for t, c in profile["counts"].items()}

    def epoch_launches(name):
        # phase 20: the graphed epoch form's 8-step runs (warm-up steps and
        # the captured graphs' contents; the replays pass no wrapper)
        return {k: r["counts"][name] for k, r in epoch.items()
                if k != "seconds"}

    def dp_launches(name):
        # phase 16: the 1-rank NCCL group's 2-epoch run, and each gloo
        # rank's run on the shared card
        return {"nccl_1rank": dp["counts"][name],
                "gloo_2rank": [c[name] for c in dp["two"]["counts"]]}
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
        # phase 9: predict_tta at b=16 and evaluate_network's TTA sweep
        "tta_launches": tta["launches"],
        "tta_eval_launches": tta["eval_launches"],
        # phase 10: the geo training run's val sweeps, the CLI's profiled
        # run, and the CLI trace's launches of the kernel
        "synth_launches": syn["train_counts"]["sepconv_infer"],
        "cli_launches": syn["cli"]["counts"]["sepconv_infer"],
        "cli_trace_launches": syn["cli"]["ours"].get("wgmma_kernel", 0)
        + syn["cli"]["ours"].get("simple_kernel", 0),
        # phases 11 and 13: each feed's 2-epoch run (its val sweeps), and
        # one sweep of the exported artifact (EXPORT_FRAMES at b=16 and a
        # warm-up batch; the 'ss' head's the same)
        "feeds_launches": {f: feeds[f]["counts"]["sepconv_infer"]
                           for f in FEEDS},
        "export_launches": export["export"]["counts"]["sepconv_infer"],
        "export_ss_launches": export["export ss"]["counts"][
            "sepconv_infer"],
        "dp_launches": dp_launches("sepconv_infer"),
        # phases 17 and 18
        "bench_launches": bench_launches("sepconv_infer"),
        "native_launches": native_launches("sepconv_infer"),
        "native_max_abs_err": native["kern"]["max_abs_err"],
        # one bf16 batch of 34 at 384x512, b=16: summed median times
        "native_ms": native["kern"]["sums"][16]["ms"],
        "native_plain_ms": native["kern"]["sums"][16]["plain_ms"],
        "native_bound_ms": native["kern"]["sums"][16]["bound_ms"],
        "native_library_ms": native["kern"]["sums"][16]["library_ms"],
        "validation_launches": validation_launches("sepconv_infer"),
        "dataset_d_launches": dataset_d_launches("sepconv_infer"),
        "refgen_launches": refgen_launches("sepconv_infer"),
        "profile_launches": profile_launches("sepconv_infer"),
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
              ss_step_composed_ms=loss_ss["ss_step_composed"]["ms"],
              zoo_launches={b: r["train_counts"]["spnet_loss_fwd"]
                            for b, r in zoo.items()},
              geo_launches=syn["train_counts"]["spnet_loss_fwd"],
              cli_trace_launches=syn["cli"]["ours"].get("loss_kernel", 0),
              dp_launches=dp_launches("spnet_loss_fwd"),
              bench_launches=bench_launches("spnet_loss_fwd"),
              native_launches=native_launches("spnet_loss_fwd"),
              validation_launches=validation_launches("spnet_loss_fwd"),
              epoch_launches=epoch_launches("spnet_loss_fwd"),
              dataset_d_launches=dataset_d_launches("spnet_loss_fwd"),
              refgen_launches=refgen_launches("spnet_loss_fwd"),
              profile_launches=profile_launches("spnet_loss_fwd"),
              profile_trace_calls={t: r["loss_kernel_calls"]
                                   for t, r in profile["runs"].items()},
              epoch_ss_launches=epoch["ss"]["counts"][SS_COUNT],
              **_late_launches("spnet_loss_fwd", feeds, remat, pre)),
        # g * dloss/dy_pred from y_true, y_pred and g; the train step's
        # backward scales the kept gradient (scale_ms, scale_bound_ms)
        small("spnet_loss_bwd", loss_src, "spnet_tpu/ops/losses.py:176",
              train["bwd_launches"], loss["bwd_err"], loss["bwd"],
              loss["bwd_plain"], 3 * n + 4, scale_ms=loss["scale"]["ms"],
              scale_bound_ms=1e3 * (2 * n + 4) / HBM_BYTES_PER_S,
              zoo_launches={b: r["train_counts"]["spnet_loss_bwd"]
                            for b, r in zoo.items()},
              geo_launches=syn["train_counts"]["spnet_loss_bwd"],
              cli_trace_launches=syn["cli"]["ours"].get(
                  "grad_scale_kernel", 0),
              dp_launches=dp_launches("spnet_loss_bwd"),
              bench_launches=bench_launches("spnet_loss_bwd"),
              native_launches=native_launches("spnet_loss_bwd"),
              validation_launches=validation_launches("spnet_loss_bwd"),
              epoch_launches=epoch_launches("spnet_loss_bwd"),
              dataset_d_launches=dataset_d_launches("spnet_loss_bwd"),
              refgen_launches=refgen_launches("spnet_loss_bwd"),
              profile_launches=profile_launches("spnet_loss_bwd"),
              **_late_launches("spnet_loss_bwd", feeds, remat, pre)),
        small("selective_sigmoid_fwd", k4_src, k4_at,
              heads["ss"]["predict_counts"]["selective_sigmoid_fwd"],
              k4["fwd_err"], k4["fwd"], k4["fwd_plain"], 2 * n,
              export_launches=export["export ss"]["counts"][
                  "selective_sigmoid_fwd"]),
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
