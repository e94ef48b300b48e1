"""Helpers for a data-parallel process group.

Counterpart of `spnet_tpu/parallel/mesh.py`.  JAX builds one mesh with a
'data' axis, shards the batch over it, replicates the state, and lets XLA
insert the batch-statistic and gradient all-reduces.  The port runs one
process per device in a `torch.distributed` group: every rank holds the
whole state, takes its own rows of each global batch (`local_rows`, the
counterpart of `shard_batch`), and the step all-reduces what XLA would
(`models/layers.py::BatchNorm`, `DistributedDataParallel` in
`train/steps.py`).  With no group every helper is the identity of one
process.  JAX's `chunked_device_put` is a TPU transfer workaround the port
does not carry.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether a process group is running (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the group; 1 without one."""
    return dist.get_world_size() if active() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if active() else 0


def local_rows(t):
    """This rank's rows [r * b / W, (r + 1) * b / W) of a global batch `t`
    (b leading rows); raises when W does not divide b."""
    b, n_ranks = t.shape[0], world_size()
    if b % n_ranks:
        raise ValueError(f"a global batch of {b} does not split over "
                         f"{n_ranks} ranks")
    per = b // n_ranks
    return t[rank() * per:(rank() + 1) * per]


#: Variables naming this rank's card on its host; torchrun sets the first.
LOCAL_RANK_ENV = ("LOCAL_RANK", "SPNET_LOCAL_RANK")


def local_device(device: str | torch.device) -> torch.device:
    """The device this rank runs on.  A device with an index, or any
    non-CUDA device, is taken as given; a bare 'cuda' is
    `cuda:LOCAL_RANK` (or SPNET_LOCAL_RANK, for a launch by the SPNET_*
    variables), and `cuda:0` in a group of one rank.  In a group of more
    ranks with neither variable set it raises: the global rank names a
    card only when every rank shares one host, which nothing here can
    see.  A CUDA device that this host does not have raises: a rank never
    falls back to the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is None and active():
        local = next((os.environ[v] for v in LOCAL_RANK_ENV
                      if os.environ.get(v)), None)
        if local is None and world_size() > 1:
            raise RuntimeError(
                f"rank {rank()} of {world_size()}: no card named for this "
                "rank; set LOCAL_RANK or SPNET_LOCAL_RANK to its card's "
                "index on this host (one process a card: "
                "SPNET_NUM_PROCESSES counts cards, not hosts as in the JAX "
                "package), or pass a device with an index")
        device = torch.device("cuda", int(local or 0))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device.index is not None and device.index >= n:
        raise RuntimeError(f"rank {rank()}: device {device} is absent "
                           f"(this host has {n} CUDA device(s))")
    return device


def _broadcast(tensors) -> None:
    for t in tensors:
        dist.broadcast(t.detach(), 0)


def replicate_state(state):
    """Rank 0's parameters, buffers, optimizer moments, optimizer count and
    step, broadcast in place to every rank (JAX's `replicate_state` puts
    one copy on every device).  Returns `state`; the identity without a
    group."""
    if world_size() == 1:
        return state
    model, opt = state.model, state.opt_state
    _broadcast(list(model.parameters()) + list(model.buffers()))
    _broadcast([m for m in opt.mu + opt.nu if m is not None])
    dev = next(model.parameters()).device
    counts = torch.tensor([opt.count, state.step], dtype=torch.int64,
                          device=dev)
    dist.broadcast(counts, 0)
    opt.count, state.step = (int(v) for v in counts.tolist())
    return state
