"""Predicting over clips of frames: the kind of the `predict_*` mixes.

The program's path is `predict_network`'s: `predict_in_batches(
make_predict_step(model), clip, batch, device)` over a clip of uint8
frames in host memory, as decoded frames sit there, returning the
predictions as numpy.  A clip is what one call predicts over: a whole
directory of frames (`predict_network` reads one and truncates it to a
multiple of the batch), or a strike's clip.  One caller in a closed loop
sends the next clip when the last one's predictions are in hand.  Clip
lengths run over every whole number in [clip_min, clip_max], each once in
a block, the blocks in orders drawn from the seed (every seed the same set
of sizes); clips are taken one after another from a pool of `pool_frames`
distinct host frames made from the seed.

Set-up: the model, the pool, and one clip of the longest and one of the
shortest length (every shape the calls use; `warmup_clips` of them).  The
window sends clips until `--seconds` have passed; it ends when the last
clip's predictions are in hand.  A traced tail runs clips for
`tail_seconds` more under the profiler (at least one), then as long again
with ranges around each separable conv layer (forward hooks on the
program's `SeparableConvBN` modules, which the tail without them does not
pay for); the ranges of a call's first batch are named apart, so that a
reader can leave out the warm-up batch that `predict_in_batches` runs
first in each call.  The check runs the reference in float32 over
`check_frames` of the window's frames, drawn from the seed.

Traffic parameters: batch, pool_frames, clip_min, clip_max,
warmup_clips, check_frames, tail_seconds, calib_frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import core, inputs, trace
from perfbench.counts import model as counts
from perfbench.reference import spnet as ref
from perfbench.reference.layers import Numerics, exact_float32
from spnet_tpu_torch.models.layers import SeparableConvBN
from spnet_tpu_torch.train import loop as program_loop
from spnet_tpu_torch.train import steps as program_steps

#: frames of one reference call
REF_BLOCK = 32


def clip_plan(t: dict, seed: int, n: int):
    """The lengths and pool offsets of the first clips, forever: blocks of
    every length in [clip_min, clip_max], each block shuffled by the seed;
    a clip that would run past the pool's end starts at its beginning."""
    lengths = np.arange(t["clip_min"], t["clip_max"] + 1)
    rng = np.random.default_rng(inputs.derive(seed, "clips"))
    at = 0
    while True:
        for length in rng.permutation(lengths):
            length = int(length)
            if at + length > n:
                at = 0
            yield at, length
            at += length


def _sepconv_ranges(model, first: list) -> list:
    """Forward hooks that open a `perfbench.sepconv` range around each
    separable conv layer of the program's model (`perfbench.sepconv_first`
    while `first[0]` is true); returns their handles."""
    stack = []

    def enter(_m, _inp):
        rf = trace.span("sepconv_first" if first[0] else "sepconv")
        rf.__enter__()
        stack.append(rf)

    def leave(_m, _inp, _out):
        stack.pop().__exit__(None, None, None)

    return [h for m in model.modules() if isinstance(m, SeparableConvBN)
            for h in (m.register_forward_pre_hook(enter),
                      m.register_forward_hook(leave))]


def run(ctx: core.Ctx):
    t, dev = ctx.traffic, ctx.device
    b = t["batch"]
    size = ctx.config["model"]["input_size"]
    pool_dev = inputs.frames(t["pool_frames"], size, ctx.seed, "pool", dev)
    model, weights = core.program_model(ctx, pool_dev[: t["calib_frames"]])
    pool = pool_dev.cpu().numpy()
    del pool_dev
    predict = program_steps.make_predict_step(model)

    def call(at, length, step=predict):
        return program_loop.predict_in_batches(
            step, pool[at: at + length], b, dev, verbose=False)[0]

    for length in (t["clip_max"], t["clip_min"])[: t["warmup_clips"]]:
        call(0, length)
    core.sync(dev)
    core.reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t0

    plan = clip_plan(t, ctx.seed, pool.shape[0])
    done, failed = [], 0
    start = time.perf_counter()
    while True:
        at, length = next(plan)
        y = call(at, length)
        t_done = time.perf_counter()
        done.append((at, length, y))
        failed += int(not np.isfinite(y).all())
        if t_done - start >= ctx.seconds:
            break
    window_s = t_done - start
    peak = core.peak_bytes(dev)

    tails = {}
    if ctx.trace:
        def tail_work(lengths, step=predict):
            def work():
                t_end = time.perf_counter() + t["tail_seconds"]
                while not lengths or time.perf_counter() < t_end:
                    at, length = next(plan)
                    with trace.span("predict_call"):
                        call(at, length, step)
                    lengths.append(length)
            return work

        plain_lengths, layer_lengths, batches = [], [], []
        first = [False]

        def counted(x):
            """The predict step, naming the ranges of a call's first
            batch apart and counting each call's batches."""
            first[0] = len(batches) == len(layer_lengths)
            if first[0]:
                batches.append(0)
            batches[-1] += 1
            return predict(x)

        tails["plain"] = trace.traced(tail_work(plain_lengths), 0, dev)
        tails["plain"].units = sum(plain_lengths)
        hooks = _sepconv_ranges(model, first)
        try:
            tails["layers"] = trace.traced(
                tail_work(layer_lengths, counted), 0, dev)
        finally:
            for h in hooks:
                h.remove()
        tails["layers"].units = sum(layer_lengths)
        tails["layers"].extra["clip_lengths"] = layer_lengths
        tails["layers"].extra["clip_batches"] = batches

    shapes = ref.param_shapes(counts.ref_config(ctx.config))
    record = dict(
        kind="predict_clips", batch=b, setup_s=setup_s, window_s=window_s,
        work={"frames": sum(d[1] for d in done)},
        attempted=len(done), failed=failed, peak_bytes=peak, tails=tails,
        counts={"forward_flops": counts.forward_flops(ctx.config, shapes),
                "sepconv_layers": counts.sepconv_layers(ctx.config, shapes)})
    # the frames compared: drawn from the seed over all the window's
    ends = np.cumsum([d[1] for d in done])
    rng = np.random.default_rng(inputs.derive(ctx.seed, "sample"))
    pick = np.sort(rng.choice(int(ends[-1]), min(t["check_frames"],
                                                 int(ends[-1])),
                              replace=False))
    clip = np.searchsorted(ends, pick, side="right")
    within = pick - np.concatenate([[0], ends[:-1]])[clip]
    sample = (np.stack([pool[done[c][0] + i] for c, i in zip(clip, within)]),
              np.stack([done[c][2][i] for c, i in zip(clip, within)]))
    del done
    held = [model, predict]

    def check():
        held.clear()
        core.free(dev)
        return compare(ctx, weights, sample)

    return record, check


def _reference(ctx, w, frames_u8, nm):
    dev = ctx.device
    rc = counts.ref_config(ctx.config)
    out = []
    with torch.no_grad(), exact_float32():
        for s in range(0, frames_u8.shape[0], REF_BLOCK):
            x = torch.from_numpy(frames_u8[s: s + REF_BLOCK]).to(dev)
            out.append(ref.forward(w, ref.normalize(x), rc, train=False,
                                   nm=nm).cpu())
    return torch.cat(out).numpy()


def frame_gaps(y: np.ndarray, r: np.ndarray) -> dict:
    """Each frame's distance from the reference (`core.frame_gaps`): of
    the worst frame and of the median one."""
    worst, median = core.frame_gaps(y, r)
    return {"pred_gap": worst, "pred_median_gap": median}


def compare(ctx, weights, sample) -> tuple[dict, dict]:
    w = {k: v.to(ctx.device) for k, v in weights.items()}
    frames_u8, y = sample
    r = _reference(ctx, w, frames_u8, Numerics("f32"))
    numbers = frame_gaps(y, r)
    readings = {}
    if ctx.calibrate:
        readings["control_fp8"] = frame_gaps(
            _reference(ctx, w, frames_u8, Numerics("fp8")), r)
        readings["witness_bf16"] = frame_gaps(
            _reference(ctx, w, frames_u8, Numerics("bf16")), r)
        readings["frames_compared"] = int(frames_u8.shape[0])
    return numbers, readings
