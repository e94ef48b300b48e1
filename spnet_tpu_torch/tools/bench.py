"""Training benchmark of the port on one card: images/s of the train step.

    python -m spnet_tpu_torch bench

Counterpart of the JAX package's `bench.py` (which stays the JAX driver's
benchmark; this one times the port).  The same work, timed the same way:
SPNet Xception-331, bf16 compute with f32 parameters, b=128; the frames
and labels of `synthetic_dataset(2048, seed=0)` (truncated to a multiple
of the batch) held on the card as uint8; each step gathers its minibatch
there, augments it (cutout, salt & pepper), runs the forward pass, the
loss kernels K2/K3, the backward pass and Adam under
`onecycle_schedule(4e-5, 100_000)`.  The minibatches are
`np.random.default_rng(seed).integers(0, n, (steps, b))`, seed 1 for the
warm-up epoch and 2 for the timed one.  Where JAX runs an epoch as one
`lax.scan` program, the port runs its epoch form
(`train/steps.py::make_train_epoch`): the step captured once as a CUDA
graph in the warm-up epoch and replayed once a minibatch.  The eager
steps (enqueued from a Python loop, no host sync in between) are timed
beside it, in turns (graph, eager, eager, graph), each turn from a fresh
train state; the value is the graphed turns' mean, the unit names the
eager one's.  A timed epoch ends at the host value of its last loss,
which depends on every step before it.

Environment: SPNET_BENCH_BS (batch size, same images timed),
SPNET_BENCH_AUGMENT=0 (augmentation off, a diagnostic), SPNET_BENCH_DTYPE
and SPNET_BENCH_BACKBONE_DTYPE (the compute dtypes).  JAX's
SPNET_BENCH_PLANAR / _FUSED / _CARRY / _PREGATHER are TPU workarounds the
port does not have.

Returns / prints one dict: metric, value, unit, vs_baseline (the
reference's 126.6 img/s on an RTX 2080 Ti, BASELINE.md).
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from spnet_tpu_torch.cli.common import resolve_device
from spnet_tpu_torch.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import make_train_epoch, make_train_step

BASELINE_IMG_PER_SEC = 126.6  # RTX 2080 Ti, BASELINE.md
LR_MAX, SCHEDULE_STEPS = 4e-5, 100_000
WARMUP_SEED, TIMED_SEED = 1, 2
#: the order of the timed runs of the two forms
TURNS = ("graph", "eager", "eager", "graph")


def model_config(backbone: str = "Xception", input_size: int = 331):
    """The benchmark's ModelConfig: the defaults (bf16 compute, f32
    parameters) with SPNET_BENCH_DTYPE / SPNET_BENCH_BACKBONE_DTYPE."""
    over = {}
    if os.environ.get("SPNET_BENCH_DTYPE", ""):
        over["compute_dtype"] = os.environ["SPNET_BENCH_DTYPE"]
    if os.environ.get("SPNET_BENCH_BACKBONE_DTYPE", ""):
        over["backbone_dtype"] = os.environ["SPNET_BENCH_BACKBONE_DTYPE"]
    return ModelConfig(backbone=backbone, input_size=input_size, **over)


def index_matrix(seed: int, steps: int, n: int, batch_size: int
                 ) -> np.ndarray:
    """(steps, batch_size) int64 minibatch indices into n frames, drawn as
    the JAX benchmark draws them."""
    return np.random.default_rng(seed).integers(0, n, (steps, batch_size))


def _two_epochs(model, model_cfg, x_all, y_all, batch_size: int,
                steps_per_epoch: int, augment: bool, graphed: bool):
    """The warm-up and the timed epoch from a fresh train state, through
    the epoch form (graphed) or the eager steps."""
    device, n = x_all.device, x_all.shape[0]
    state = create_train_state(
        model, onecycle_schedule(LR_MAX, total_steps=SCHEDULE_STEPS))
    step = make_train_step(model, LossWeights(), model_cfg.loss_type,
                           l2_reg=model_cfg.l2_reg, augment=augment,
                           indexed="epoch")
    train_epoch = make_train_epoch(step)
    gen = torch.Generator(device=device)

    def epoch(seed):
        idx = torch.from_numpy(index_matrix(seed, steps_per_epoch, n,
                                            batch_size)).to(device)
        gen.manual_seed(seed)
        if graphed:
            return train_epoch(state, x_all, y_all, idx, gen)[1]
        return torch.stack([step(state, x_all, y_all, row, gen)[1]["loss"]
                            for row in idx])

    warm = epoch(WARMUP_SEED)
    float(warm[-1])
    t0 = time.perf_counter()
    timed = epoch(TIMED_SEED)
    float(timed[-1])
    return warm, timed, time.perf_counter() - t0


def train_epochs(model, model_cfg, x_all, y_all, batch_size: int,
                 steps_per_epoch: int, augment: bool = True):
    """The benchmark's two epochs on `model` from a fresh train state
    through the epoch form (a CUDA graph of the step on the card, captured
    in the warm-up epoch): the warm-up epoch (index seed 1, augmentation
    generator seed 1), then the timed one (seeds 2).  x_all (n, H, W, 1)
    uint8 and y_all (n, M) on the device.  Returns (warm-up losses, timed
    losses: (steps,) device tensors, seconds of the timed epoch to the
    host value of its last loss)."""
    return _two_epochs(model, model_cfg, x_all, y_all, batch_size,
                       steps_per_epoch, augment, graphed=True)


def eager_epochs(model, model_cfg, x_all, y_all, batch_size: int,
                 steps_per_epoch: int, augment: bool = True):
    """`train_epochs` through the eager steps, one call a minibatch."""
    return _two_epochs(model, model_cfg, x_all, y_all, batch_size,
                       steps_per_epoch, augment, graphed=False)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def main(batch_size: int = 128, steps_per_epoch: int = 160,
         n_data: int = 2048, warmup_steps: int = 32, *,
         device: str = "cuda", backbone: str = "Xception",
         input_size: int = 331) -> dict:
    """The benchmark's dict.  `warmup_steps` is the JAX signature's and, as
    there, unused: the warm-up epoch runs `steps_per_epoch` steps, like the
    timed one.  The keyword-only arguments let a CPU test run it small."""
    del warmup_steps
    total_imgs = batch_size * steps_per_epoch
    batch_size = int(os.environ.get("SPNET_BENCH_BS", batch_size))
    steps_per_epoch = max(1, total_imgs // batch_size)
    device = resolve_device(device)
    grid = GridSpec()
    mc = model_config(backbone, input_size)
    model = build_model(mc, num_outputs=grid.num_outputs, device=device)
    ds = synthetic_dataset(n_data, grid, seed=0, input_size=mc.input_size,
                           batch_size=batch_size, device=device)
    if ds.x.shape[0] == 0:
        raise ValueError("batch_size larger than the benchmark dataset")
    x_all = torch.from_numpy(ds.x).to(device)
    y_all = torch.from_numpy(ds.y).to(device)
    augment = os.environ.get("SPNET_BENCH_AUGMENT", "1") == "1"
    rates = {"graph": [], "eager": []}
    for form in TURNS:
        run = train_epochs if form == "graph" else eager_epochs
        _, losses, elapsed = run(model, mc, x_all, y_all, batch_size,
                                 steps_per_epoch, augment)
        final_loss = float(losses[-1])
        assert np.isfinite(final_loss), final_loss
        rates[form].append(batch_size * steps_per_epoch / elapsed)
    img_per_sec = statistics.mean(rates["graph"])
    eager = statistics.mean(rates["eager"])
    size = f"{mc.input_size}x{mc.input_size}" if mc.input_size else \
        "512x384"
    return {
        "metric": "train_images_per_sec_per_chip",
        "value": round(img_per_sec, 2),
        "unit": f"img/s per {device_name(device)} ({mc.backbone} {size} "
                f"b{batch_size} {mc.compute_dtype}, the epoch form "
                f"(one CUDA graph of the step on a card; eager steps "
                f"{round(eager, 2)} img/s) from the resident uint8 set, "
                + ("incl on-device augmentation)" if augment
                   else "augmentation off)"),
        "vs_baseline": round(img_per_sec / BASELINE_IMG_PER_SEC, 3),
    }
