"""Training from a resident set: the kind of the `train_resident_*` mixes.

The program's path is the one `train_network` runs on one rank with the
resident feed: `make_train_epoch(make_train_step(..., augment=True,
indexed="epoch"))` over uint8 frames and float32 labels on the card, with
the 1-cycle schedule and optax's Adam of `create_train_state`.  The
benchmark draws the frames, labels, weights and the minibatch order from
the seed (shuffled passes without replacement) and hands the epoch form
`chunk_rows` minibatch rows a call, keeping the train state and the
captured graph across calls.

Set-up: the model, the data, then the first `check_steps` steps through
the window's own call, on rows that all differ (one row, then the rest:
the first two steps of a capture run eagerly and the last one is the
first replay of the captured graph); the loss of each, the first step's
outputs (a forward hook), the first gradient (from Adam's first moments
after one step) and each parameter's change are read; then one chunk warms up the window's shape (the epoch
form makes its buffers and captures again for a call of more rows).  The
window hands over chunks until `--seconds` have passed and ends at the
host value of the last chunk's last loss.  A traced tail runs one chunk
more.  The check follows the first steps with the reference in float32
from the same weights, rows and generator seed.  The window's own graph,
captured for the warm-up chunk, runs no step that the reference follows:
the parameters are read before and after the window, and every leaf that
the reference moves has to have moved in it.

Traffic parameters: frames, batch, chunk_rows, lr_max, total_steps,
p_object (labels), check_steps, calib_frames.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import core, inputs, trace
from perfbench.counts import model as counts
from perfbench.reference import spnet as ref
from perfbench.reference.layers import Numerics, exact_float32
from spnet_tpu_torch.config import LossWeights
from spnet_tpu_torch.train import schedule as program_schedule
from spnet_tpu_torch.train import state as program_state
from spnet_tpu_torch.train import steps as program_steps

#: leaves whose reference gradient is under this share of the median
#: leaf's are left out of the change's comparison: Adam moves them by
#: round-off alone
STILL_LEAF = 1e-3
#: host-clock steps a second no cell reaches; sizes the minibatch order
#: (a faster run goes over it again)
MAX_STEPS_PER_S = 500


def run(ctx: core.Ctx):
    t, dev = ctx.traffic, ctx.device
    b, chunk, n = t["batch"], t["chunk_rows"], t["frames"]
    n_check = t["check_steps"]
    size = ctx.config["model"]["input_size"]
    n_out = ctx.config["model"]["num_outputs"]
    rc = counts.ref_config(ctx.config)

    x_all = inputs.frames(n, size, ctx.seed, "train_frames", dev)
    y_all = inputs.labels(n, n_out, ctx.seed, "train_labels", dev,
                          t["p_object"])
    model, weights = core.program_model(ctx, x_all[: t["calib_frames"]])
    rows_needed = n_check + chunk * (2 + math.ceil(
        ctx.seconds * MAX_STEPS_PER_S / chunk))
    passes = math.ceil(rows_needed / (n // b))
    order = torch.from_numpy(inputs.epoch_rows(n, b, ctx.seed, passes)).to(dev)

    sched = program_schedule.onecycle_schedule(t["lr_max"], t["total_steps"])
    state = program_state.create_train_state(model, sched)
    step = program_steps.make_train_step(
        model, LossWeights(), ctx.config["model"]["loss_type"],
        l2_reg=ctx.config["model"]["l2_reg"], augment=True, indexed="epoch")
    train_epoch = program_steps.make_train_epoch(step)
    gen = inputs.device_generator(ctx.seed, "augment", dev)

    # ---- the first steps, read for the check --------------------------
    names, params = zip(*model.named_parameters())
    p0 = [p.detach().clone() for p in params]
    # the first step runs eagerly: a hook keeps its outputs
    out1 = []
    hook = model.register_forward_hook(
        lambda _m, _i, out: out1.append(out.detach().float().clone()))
    try:
        state, l_first = train_epoch(state, x_all, y_all, order[0:1], gen)
    finally:
        hook.remove()
    b1 = ref.ADAM_B1
    grad1 = [(m / (1.0 - b1)).cpu() for m in state.opt_state.mu]
    state, l_rest = train_epoch(state, x_all, y_all, order[1:n_check], gen)
    losses = [float(v) for v in torch.cat([l_first, l_rest]).cpu()]
    change = [(p.detach() - q).cpu() for p, q in zip(params, p0)]
    del p0
    check_rows = order[:n_check]
    batches = [(x_all[r].cpu(), y_all[r].cpu()) for r in check_rows]
    core.reset_peak(dev)

    # ---- warm-up of the window's shape, then the window ---------------
    cursor = n_check

    def chunk_rows():
        nonlocal cursor
        if cursor + chunk > order.shape[0]:  # faster than sized for
            cursor = n_check
        rows = order[cursor: cursor + chunk]
        cursor += chunk
        return rows

    state, warm = train_epoch(state, x_all, y_all, chunk_rows(), gen)
    float(warm[-1])
    before = [p.detach().to("cpu", copy=True) for p in params]
    setup_s = time.perf_counter() - ctx.t0

    bad = torch.zeros((), dtype=torch.int64, device=dev)
    chunks, pending = 0, None
    start = time.perf_counter()
    while True:
        state, cl = train_epoch(state, x_all, y_all, chunk_rows(), gen)
        bad += (~torch.isfinite(cl)).sum()
        chunks += 1
        if pending is not None:
            float(pending[-1])
        pending = cl
        if time.perf_counter() - start >= ctx.seconds:
            break
    float(pending[-1])
    window_s = time.perf_counter() - start
    peak = core.peak_bytes(dev)
    failed = int(bad)
    unmoved = {n for n, p, q in zip(names, params, before)
               if torch.equal(p.detach().cpu(), q)}
    del before

    tails = {}
    if ctx.trace:
        def tail_work():
            nonlocal state
            with trace.span("chunk_enqueue"):
                state, cl = train_epoch(state, x_all, y_all, chunk_rows(),
                                        gen)
            with trace.span("sync"):
                float(cl[-1])

        tails["plain"] = trace.traced(tail_work, chunk, dev)

    shapes = ref.param_shapes(rc)
    record = dict(
        kind="train_resident", batch=b, setup_s=setup_s, window_s=window_s,
        work={"images": chunks * chunk * b, "steps": chunks * chunk},
        attempted=chunks * chunk, failed=failed, peak_bytes=peak,
        tails=tails,
        counts={"forward_flops": counts.forward_flops(ctx.config, shapes),
                "adam_least_bytes": counts.adam_least_bytes(shapes)})
    program = dict(losses=losses, out1=out1[0].cpu(),
                   grad1=dict(zip(names, grad1)),
                   change=dict(zip(names, change)), unmoved=unmoved)
    # the program's state goes when the check starts
    held = [state, model, step, train_epoch, x_all, y_all, order, gen]

    def check():
        held.clear()
        core.free(dev)
        return compare(ctx, program, weights, batches)

    return record, check


def _reference(ctx, weights, batches, nm=None, half=False):
    dev = ctx.device
    w = {k: v.to(dev) for k, v in weights.items()}
    rb = [(x.to(dev), y.to(dev)) for x, y in batches]
    sched = ref.onecycle(ctx.traffic["lr_max"], ctx.traffic["total_steps"])
    gen = inputs.device_generator(ctx.seed, "augment", dev)
    with exact_float32():
        out = ref.train_steps(w, rb, counts.ref_config(ctx.config), sched,
                              gen, nm or Numerics("f32"), half_batch=half)
    return dict(losses=out["losses"], out1=out["out1"], grad1=out["grad1"],
                change={n: v - w[n] for n, v in out["params"].items()})


def gaps(side: dict, r: dict) -> dict:
    """The numbers of `side` against the reference `r` that a limit may
    hold (`limits/<cell>.json` names those compared), from the losses and
    from each leaf's first gradient and change (tensors by name):

      * `out1_gap`, `out1_median_gap`: the first step's outputs (train
        mode, dropout drawn alike), each frame's ‖y - r‖ over the larger
        of ‖r‖ and the median frame's, of the worst and the median frame;
      * the relative loss gap of the worst step, the root mean square of
        the steps' and the first step's;
      * `*_gap`, `*_median_gap`: the gap of norms of the worst and of the
        median leaf, |‖p‖ - ‖r‖| over the larger of ‖r‖ and the median
        leaf's ‖r‖;
      * `*_diff`, `*_median_diff`: the norm of the difference of the worst
        and of the median leaf, ‖p - r‖ over the same;
      * `*_total_diff`: ‖p - r‖ / ‖r‖ over all the leaves together;
      * `window_unmoved`: the share of leaves that the window left
        unchanged, where `side` carries it (the program's run).

    The change leaves out the leaves the reference's gradient barely
    moves; so does `window_unmoved`."""
    names = list(r["grad1"])
    if set(side["grad1"]) != set(names):
        raise ValueError("the program's parameters are not the reference's")
    r_norm = {k: dict(zip(names, core.norms([r[k][n] for n in names])))
              for k in ("grad1", "change")}
    med = float(np.median(list(r_norm["grad1"].values())))
    still = {n for n in names if r_norm["grad1"][n] < STILL_LEAF * med}
    out = {}
    for key, kept in (("grad1", names),
                      ("change", [n for n in names if n not in still])):
        dev = r[key][kept[0]].device
        p = [side[key][n].to(dev, torch.float32) for n in kept]
        q = [r[key][n].float() for n in kept]
        rn = [r_norm[key][n] for n in kept]
        norm_gap = core.leaf_gaps(core.norms(p), rn)
        diff = core.leaf_gaps(core.norms([a - b for a, b in zip(p, q)]),
                              [0.0] * len(kept), rn)
        total = core.rel_gap_total(p, q)
        out.update({f"{key}_gap": max(norm_gap),
                    f"{key}_median_gap": float(np.median(norm_gap)),
                    f"{key}_diff": max(diff),
                    f"{key}_median_diff": float(np.median(diff)),
                    f"{key}_total_diff": total})
    steps = [core.rel_gap(p, q) for p, q in zip(side["losses"], r["losses"])]
    out["out1_gap"], out["out1_median_gap"] = core.frame_gaps(
        side["out1"].cpu(), r["out1"].cpu())
    out.update({
        "loss_gap": max(steps),
        "loss_rms_gap": math.sqrt(sum(e * e for e in steps) / len(steps)),
        "loss1_gap": core.rel_gap(side["losses"][0], r["losses"][0])})
    if "unmoved" in side:
        moved = [n for n in names if n not in still]
        out["window_unmoved"] = (sum(n in side["unmoved"] for n in moved)
                                 / len(moved))
    return out


def worst_leaves(side: dict, r: dict, top: int = 4) -> list:
    """The leaves with the largest differences: [name, ‖p - r‖ over the
    larger of ‖r‖ and the median leaf's, ‖r‖]."""
    names = list(r)
    rn = core.norms([r[n] for n in names])
    dn = core.norms([side[n].to(r[n].device, torch.float32) - r[n].float()
                     for n in names])
    med = float(np.median(rn))
    rows = [[n, d / max(q, med, 1e-30), q] for n, d, q in zip(names, dn, rn)]
    return sorted(rows, key=lambda row: -row[1])[:top]


def compare(ctx, program, weights, batches) -> tuple[dict, dict]:
    r = _reference(ctx, weights, batches)
    compared = gaps(program, r)
    readings = {}
    if ctx.calibrate:
        rn = core.norms(list(r["grad1"].values()))
        med = float(np.median(rn))
        readings["still_leaves"] = [n for n, g in zip(r["grad1"], rn)
                                    if g < STILL_LEAF * med]
        for side, kw in (("control_fp8", dict(nm=Numerics("fp8"))),
                         ("witness_bf16", dict(nm=Numerics("bf16"))),
                         ("fault_half_batch", dict(half=True))):
            readings[side] = gaps(_reference(ctx, weights, batches, **kw), r)
            core.free(ctx.device)
        readings["worst_leaves"] = {
            key: worst_leaves(program[key], r[key]) for key in ("grad1",
                                                                 "change")}
        readings["losses"] = program["losses"]
        readings["ref_losses"] = r["losses"]
    return compared, readings
