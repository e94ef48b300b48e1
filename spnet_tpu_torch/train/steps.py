"""Train, eval and predict steps.

Counterpart of `spnet_tpu/train/steps.py`.  A train step gathers its
minibatch from the uint8 dataset resident on the device (or, host-fed,
takes the minibatch itself), normalizes it,
with `geo_augment` warps it by a random flip / rotation / translation and
re-encodes its labels from the remapped ellipse rows, augments it
(cutout, salt & pepper, optional blur), runs the forward pass
in train mode (batch-stat BatchNorm, dropout), the loss (the fused kernels
K2/K3, which on the 'ss' head also apply its selective sigmoid K4) plus the
L2 penalty, the backward pass, and one Adam update under the 1-cycle
schedule.  Where JAX compiles a whole epoch into one `lax.scan` program,
the port's epoch form (`make_train_epoch`, JAX's `train_epoch` /
`train_epoch_geo`) captures the step once as a CUDA graph and replays it
once per row of the epoch's index matrix; on the CPU the same step runs
once per row from Python.  `train/loop.py` trains the resident feed
through it on one rank; the host-fed and chunked feeds, remat and a
process group (where the step is data-parallel,
`DistributedDataParallel`) call the step once per minibatch.

L2 regularization: an explicit penalty over the conv and dense kernels in
scope, added to the loss, as in the JAX package.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from spnet_tpu_torch.models.layers import Kernel
from spnet_tpu_torch.ops import augment as aug_ops
from spnet_tpu_torch.ops.grid_encode import encode_batch_device
from spnet_tpu_torch.ops.losses import loss_components, spnet_loss, \
    spnet_loss_fused
from spnet_tpu_torch.config import GridSpec, LossWeights
from spnet_tpu_torch.parallel import mesh
from spnet_tpu_torch.train.schedule import schedule_table
from spnet_tpu_torch.utils.profiling import annotate


def _prep_x(x):
    """Datasets may be stored as uint8 (4x fewer bytes to the device);
    normalize on the device with the Inception scaling."""
    if x.dtype == torch.uint8:
        return (x.float() / 255.0 - 0.5) * 2.0
    return x


#: Which kernels the L2 penalty covers.  'reference' mirrors the layers the
#: reference's regularizer effectively touched: the stem, the first
#: backbone blocks and the head (`spnet_tpu/train/steps.py:74-95`).
L2_SCOPES = ("reference", "all", "none")


def kernel_names(model: nn.Module) -> list[str]:
    """Parameter names of the conv and dense kernels, the leaves flax calls
    'kernel': every `Kernel.weight` and the Dense head's weight.  BN
    parameters and the Dense bias are not kernels."""
    return [f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (Kernel, nn.Linear))]


def _l2_in_scope(name: str, scope: str) -> bool:
    """Whether the kernel parameter `name` is in the L2 scope."""
    if scope == "reference":
        parts = name.split(".")
        return (parts[0] in ("stem", "final_output", "sigmoid_output",
                             "dense_output")
                or (parts[0] == "backbone"
                    and parts[1] in ("conv1", "conv2", "block2")))
    return scope == "all"


def kernel_l2(model: nn.Module, scope: str = "reference"):
    """Sum of squared kernels in scope, float32 (0 for 'none')."""
    if scope not in L2_SCOPES:
        raise ValueError(f"l2 scope must be one of {L2_SCOPES}, got "
                         f"{scope!r}")
    params = dict(model.named_parameters())
    terms = [torch.sum(torch.square(params[n].float()))
             for n in kernel_names(model) if _l2_in_scope(n, scope)]
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return torch.stack(terms).sum()


def forward_loss(model: nn.Module, x, y, generator: torch.Generator | None,
                 loss_weights: LossWeights = LossWeights(),
                 loss_type: str = "same", l2_reg: float = 1e-4,
                 l2_scope: str = "reference", fused: bool = True):
    """Forward pass in the model's current mode, data loss (the fused
    kernels, or the plain twin with fused=False) and the L2 term.
    Returns (loss, data_loss), both 0-d float32 tensors.

    On an 'ss' head with its kernels (not `plain_kernels`), the fused loss
    applies the selective sigmoid in its own pass: the model leaves it out
    and the loss takes the pre-activation (one launch forward and one
    backward in place of four).  fused=False keeps the model's
    `SelectiveSigmoid` and the plain loss.  `model` may be a
    `DistributedDataParallel` wrapper: it runs the forward, and the L2 term
    and the head's settings come from the module inside."""
    core = model.module if isinstance(model, DistributedDataParallel) \
        else model
    ss = fused and core.selective_sigmoid and not core.plain_kernels
    out = model(x, dropout_generator=generator, selective_sigmoid=not ss)
    data_loss = (spnet_loss_fused(y, out, loss_weights, loss_type,
                                  selective_sigmoid=ss) if fused
                 else spnet_loss(y, out, loss_weights, loss_type))
    loss = data_loss
    if l2_reg and l2_scope != "none":
        loss = loss + l2_reg * kernel_l2(core, l2_scope)
    return loss, data_loss


def make_train_step(model: nn.Module,
                    loss_weights: LossWeights = LossWeights(),
                    loss_type: str = "same", l2_reg: float = 1e-4,
                    augment: bool = True, blur_prob: float = 0.0,
                    l2_scope: str = "reference",
                    indexed: str | bool = "epoch",
                    geo_augment: bool = False, grid: GridSpec | None = None):
    """Returns train_step(state, x_all, y_all, idx, generator) ->
    (state, metrics).

    x_all (N, H, W, 1) uint8 and y_all (N, M) float32 are the whole
    training set (or a chunk of it) on the device; idx (b,) int64 on the
    same device picks the minibatch, gathered there.  With indexed=False
    (the host-fed feed) the step takes the minibatch itself:
    train_step(state, x, y, generator), x (b, H, W, 1).  `generator` (on
    that device) draws the augmentation and the dropout mask.  The loss runs
    through the fused kernels (`spnet_loss_fused`).  The step updates
    `state` in place (parameters, BN statistics, optimizer state, step)
    and returns it; metrics hold 'loss' and 'data_loss' as device scalars
    (no host sync) and 'lr', the schedule at the step it ran.  The update's
    learning rate is schedule(count), evaluated on the host, or, while
    `make_train_epoch` runs an epoch, read on the device from the epoch's
    table (`TrainState.lr_feed`).

    With `geo_augment=True` (requires `grid`) the step takes the padded
    raw rows (N, S, 6) and their mask (N, S) after `y_all`:
    train_step(state, x_all, y_all, rows_all, mask_all, idx, generator).
    In this order: normalize, `geo_augment_batch` on the normalized frames
    and the native-coordinate rows (flip / rotate / translate, fill -1),
    `y = encode_batch_device(rows, mask, grid)` (the stored y_all is not
    read), then cutout / salt & pepper, the model and the loss.  Host-fed
    and geo: train_step(state, x, y, rows, mask, generator).

    Made while a process group runs (`parallel/mesh.py`), the step is
    data-parallel: idx (or the host-fed batch) is the global batch, and
    every rank gathers, augments and trains on its own rows of it
    (`mesh.local_rows`) inside `DistributedDataParallel`.  The
    augmentation and dropout draws are the global batch's, from the
    generator every rank seeds alike, so a run does not depend on the world
    size; the BatchNorm statistics are the global batch's, and the logged
    losses are averaged over the ranks.  With indexed="rows" (a sharded
    resident set, `parallel/multihost.py::ShardedRows`) the step takes
    this rank's rows of the minibatch, already gathered:
    train_step(state, x, y, generator), or with `geo_augment`
    train_step(state, x, y, rows, mask, generator) (y is not read)."""
    if indexed not in ("epoch", "rows", False):
        raise ValueError(f"indexed must be 'epoch', 'rows' or False, got "
                         f"{indexed!r}")
    if l2_scope not in L2_SCOPES:
        raise ValueError(f"l2 scope must be one of {L2_SCOPES}, got "
                         f"{l2_scope!r}")
    if geo_augment and grid is None:
        raise ValueError("geo_augment=True requires the GridSpec")
    net = model
    if mesh.active():
        # the BatchNorm running statistics are equal on every rank (their
        # all-reduced moments), so a per-forward buffer broadcast would
        # only add traffic
        dev = next(model.parameters()).device
        net = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    n_ranks = mesh.world_size()

    def step(state, x, y, generator, rows=None, mask=None):
        """One update from this rank's rows (x, y[, rows, mask]) of the
        minibatch."""
        m = state.model
        m.train()
        x = _prep_x(x)
        if geo_augment:
            with annotate("geo_augment"):
                x, rows = aug_ops.geo_augment_batch(
                    x, rows, mask, generator,
                    img_w=grid.img_width, img_h=grid.img_height)
            with annotate("grid_encode"):
                y = encode_batch_device(rows, mask, grid)
        if augment:
            x = aug_ops.augment_on_the_fly(x, generator, blur_prob=blur_prob)
        # a rank's loss is the mean over its b/W x M slots; DDP averages
        # the gradients over the ranks, and the average of equal-sized
        # means is the global mean, while the L2 term, the same on every
        # rank, averages to itself.  DDP reduces what `backward`
        # accumulates into `.grad`.
        loss, data_loss = forward_loss(net, x, y, generator, loss_weights,
                                       loss_type, l2_reg, l2_scope)
        params = list(m.parameters())
        m.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in params]
        m.zero_grad(set_to_none=True)
        lr = state.schedule(state.step)
        state.opt_state = state.optimizer.update(params, grads,
                                                 state.opt_state,
                                                 state.step_lr())
        state.step += 1
        loss, data_loss = loss.detach(), data_loss.detach()
        if n_ranks > 1:  # the logged losses: the global batch's
            logged = torch.stack([loss, data_loss])
            dist.all_reduce(logged)
            loss, data_loss = logged / n_ranks
        return state, {"loss": loss, "data_loss": data_loss, "lr": lr}

    def local(*ts):
        return [None if t is None else mesh.local_rows(t) for t in ts]

    if indexed == "rows":
        if geo_augment:
            def train_step_rows_geo(state, x, y, rows, mask, generator):
                return step(state, x, None, generator, rows, mask)

            return train_step_rows_geo

        def train_step_rows(state, x, y, generator):
            return step(state, x, y, generator)

        return train_step_rows

    if indexed is False:
        if geo_augment:
            def train_step_geo(state, x, y, rows, mask, generator):
                x, y, rows, mask = local(x, y, rows, mask)
                return step(state, x, y, generator, rows, mask)

            return train_step_geo

        def train_step_fed(state, x, y, generator):
            return step(state, *local(x, y), generator)

        return train_step_fed

    if geo_augment:
        def train_step_geo(state, x_all, y_all, rows_all, mask_all, idx,
                           generator):
            # the stored labels are not read: the step encodes its own
            (idx,) = local(idx)
            return step(state, x_all[idx], None, generator, rows_all[idx],
                        mask_all[idx])

        return train_step_geo

    def train_step(state, x_all, y_all, idx, generator):
        (idx,) = local(idx)
        return step(state, x_all[idx], y_all[idx], generator)

    return train_step


#: one side stream a device for every capture: cuBLAS keeps a workspace
#: (32 MiB + 1 MiB for cuBLASLt on an H100) for each stream that runs a
#: matmul until the process ends, so a new stream a capture would grow the
#: card's memory by 33 MiB a capture
_CAPTURE_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that CUDA graphs are captured on, one a device
    (`make_train_epoch`, `tools/bench_infer.py::captured_sweep`)."""
    key = torch.device(device).index
    if key is None:
        key = torch.cuda.current_device()
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(key)
    return _CAPTURE_STREAMS[key]


#: eager steps on the capturing stream before the step is captured: the
#: first makes what a step makes once (the loss kernel's workspace for the
#: stream, cuBLAS's, the cached device constants of the augmentation and
#: the label encoder), the second runs as every later step does
WARMUP_STEPS = 2


def make_train_epoch(train_step, geo_augment: bool = False):
    """The epoch form of a resident-feed step made by
    `make_train_step(indexed="epoch")` on one rank, JAX's `train_epoch` /
    `train_epoch_geo`:

        train_epoch(state, x_all, y_all, idx_mat, generator)
            -> (state, losses)
        train_epoch_geo(state, x_all, y_all, rows_all, mask_all, idx_mat,
                        generator) -> (state, losses)

    idx_mat (steps, b) int64 on the data's device holds one minibatch a
    row, trained in order; losses is the (steps,) float32 device tensor of
    the steps' losses (the scan's stacked losses), with no host sync.  The
    epoch's learning rates, sched(count + i), are evaluated on the host
    once (`schedule_table`) and a row counter on the device picks each
    step's minibatch row and rate (`TrainState.lr_feed`), so every step
    reads the same buffers.

    On a CUDA device the step is captured once as a CUDA graph and then
    replayed once a row: WARMUP_STEPS eager steps on the capturing stream
    (`capture_stream`) come first, in the first epoch(s), then the capture,
    with `generator` registered with the graph, so that each replay draws
    the augmentation and dropout an eager step would draw.  The graph
    serves later epochs (reseed the same generator between them) and is
    captured again when the model, the optimizer's moments (`unfreeze`),
    the data, the generator or the batch size change, or an epoch has more
    rows than the graph's buffers.  A failed capture or replay raises.  On
    the CPU the same step runs once a row from Python.  The returned
    function's `capture_seconds` lists the host seconds of each capture."""
    cache: dict = {}
    capture_seconds: list = []

    def buffers(state, data, generator, steps: int, b: int, device):
        """The epoch's buffers, made anew (dropping the graph) when the
        capture's inputs changed."""
        key = (state.model, state.opt_state.mu, generator, *data)
        old = cache.get("key", ())
        if len(old) != len(key) or any(a is not k for a, k in zip(old, key)) \
                or cache["idx"].shape[0] < steps or cache["idx"].shape[1] != b:
            cache.clear()  # the old graph's memory goes back first
            cache.update(
                key=key, graph=None, warm=0,
                idx=torch.empty((steps, b), dtype=torch.int64,
                                device=device),
                lr=torch.empty(steps, dtype=torch.float32, device=device),
                row=torch.zeros(1, dtype=torch.int64, device=device),
                loss=torch.zeros(steps, dtype=torch.float32, device=device))
        return cache

    def replay(body, steps: int, generator, device) -> None:
        row = 0
        if cache["graph"] is None:
            stream = capture_stream(device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                while cache["warm"] < WARMUP_STEPS and row < steps:
                    body()
                    row += 1
                    cache["warm"] += 1
                if row < steps:
                    t0 = time.perf_counter()
                    graph = torch.cuda.CUDAGraph()
                    if generator is not None:  # a step that draws nothing
                        graph.register_generator_state(generator)
                    with torch.cuda.graph(graph, stream=stream):
                        body()
                    cache["graph"] = graph
                    capture_seconds.append(time.perf_counter() - t0)
            current.wait_stream(stream)
        for _ in range(row, steps):
            cache["graph"].replay()

    def run(state, data, idx_mat, generator):
        steps, b = idx_mat.shape
        device = idx_mat.device
        step0, count0 = state.step, state.opt_state.count
        buf = buffers(state, data, generator, steps, b, device)
        buf["idx"][:steps].copy_(idx_mat)
        buf["lr"][:steps].copy_(torch.from_numpy(
            schedule_table(state.schedule, count0, steps)))
        buf["row"].zero_()

        def body():
            idx = buf["idx"].index_select(0, buf["row"]).view(b)
            _, metrics = train_step(state, *data, idx, generator)
            buf["loss"].index_copy_(0, buf["row"], metrics["loss"].view(1))
            buf["row"].add_(1)

        state.lr_feed = (buf["lr"], buf["row"])
        try:
            if device.type == "cuda":
                replay(body, steps, generator, device)
            else:
                for _ in range(steps):
                    body()
        finally:
            state.lr_feed = None
        # the host ints: a capture ran the step's host side once more,
        # and a replay runs none of it
        state.step, state.opt_state.count = step0 + steps, count0 + steps
        return state, buf["loss"][:steps].clone()

    if geo_augment:
        def train_epoch_geo(state, x_all, y_all, rows_all, mask_all,
                            idx_mat, generator):
            return run(state, (x_all, y_all, rows_all, mask_all), idx_mat,
                       generator)

        train_epoch_geo.capture_seconds = capture_seconds
        return train_epoch_geo

    def train_epoch(state, x_all, y_all, idx_mat, generator):
        return run(state, (x_all, y_all), idx_mat, generator)

    train_epoch.capture_seconds = capture_seconds
    return train_epoch


def make_eval_step(model: nn.Module,
                   loss_weights: LossWeights = LossWeights(),
                   loss_type: str = "same"):
    """Returns eval_step(x, y) -> (y_pred, component losses), eval mode,
    no autograd."""

    @torch.inference_mode()
    def eval_step(x, y):
        model.eval()
        out = model(_prep_x(x))
        return out, loss_components(y, out, loss_weights, loss_type)

    return eval_step


def make_predict_step(model: nn.Module):
    """Returns predict(x) -> y_pred (normalized), eval mode (set on every
    call: a train step switches the model to train mode), no autograd."""

    @torch.inference_mode()
    def predict(x):
        model.eval()
        return model(_prep_x(x))

    return predict
