"""Starting the process group and assembling host shards.

Counterpart of `spnet_tpu/parallel/multihost.py`, with its names:

  1. `maybe_initialize()` starts a `torch.distributed` process group when
     the process is part of a data-parallel job, and is a no-op otherwise,
     so the CLIs call it unconditionally;
  2. `process_shard()` is (rank, world size), handed to
     `build_dataset(shard_index=, num_shards=)`: every rank computes the
     same seeded file order and takes its strided slice;
  3. `host_to_global()` is the union of the ranks' local shards in rank
     order, the layout `jax.make_array_from_process_local_data` gives.

A job is configured by the JAX package's variables (SPNET_COORDINATOR or
JAX_COORDINATOR_ADDRESS = host:port, SPNET_NUM_PROCESSES, SPNET_PROCESS_ID,
with SPNET_LOCAL_RANK naming the card) or by torchrun's (MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK):
`torchrun --nproc_per_node=N -m spnet_tpu_torch train ...`.  A process
drives one card, so SPNET_NUM_PROCESSES counts cards, where JAX's one
process a host counts hosts.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from spnet_tpu_torch.parallel.mesh import active, local_device, rank, \
    world_size

#: Variables naming the coordinator (host:port); SPNET_* wins.
COORD_ENV = ("SPNET_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
#: Variables torchrun sets for every process it starts.
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def maybe_initialize(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: str | torch.device = "cuda") -> bool:
    """Start the process group when configured; else return False.

    Configuration, in priority order: the arguments, then SPNET_COORDINATOR
    (or JAX_COORDINATOR_ADDRESS) with SPNET_NUM_PROCESSES and
    SPNET_PROCESS_ID (or the JAX_* spellings), then torchrun's variables.
    The backend is NCCL for a CUDA `device` and gloo otherwise; `backend`
    overrides it (two ranks on one card need gloo: NCCL refuses a
    duplicate GPU).  Under NCCL the current CUDA device becomes this rank's
    (`mesh.local_device`).  A second call returns True and changes nothing.
    SPNET_DIST=1 (JAX's TPU-pod discovery) has no torch meaning: it raises
    unless one of the other configurations is present."""
    if active():
        return True
    coordinator = coordinator or _env(*COORD_ENV)
    torchrun = all(os.environ.get(n) for n in TORCHRUN_ENV)
    if not coordinator and not torchrun:
        if os.environ.get("SPNET_DIST") == "1":
            raise RuntimeError(
                "SPNET_DIST=1 asks JAX to discover a TPU pod's processes; "
                "torch has no such discovery: launch with torchrun, or set "
                "SPNET_COORDINATOR=host:port, SPNET_NUM_PROCESSES and "
                "SPNET_PROCESS_ID")
        return False
    if coordinator:
        n = num_processes if num_processes is not None else _env(
            "SPNET_NUM_PROCESSES", "JAX_NUM_PROCESSES")
        i = process_id if process_id is not None else _env(
            "SPNET_PROCESS_ID", "JAX_PROCESS_ID")
        if n is None or i is None:
            raise ValueError(f"coordinator {coordinator} given without the "
                             "number of processes and this process's id "
                             "(SPNET_NUM_PROCESSES, SPNET_PROCESS_ID)")
        kwargs = dict(init_method=f"tcp://{coordinator}",
                      world_size=int(n), rank=int(i))
    else:
        kwargs = dict(init_method="env://")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    return True


def process_shard() -> tuple[int, int]:
    """(shard_index, num_shards) for this process's file lists."""
    return rank(), world_size()


def is_multiprocess() -> bool:
    return world_size() > 1


def host_to_global(x_local) -> np.ndarray:
    """The ranks' equal local shards (leading axis), concatenated in rank
    order on every rank: one `all_gather` of each shard's bytes, on the
    current CUDA device under NCCL and on the CPU under gloo.  The identity
    without a group of more than one rank."""
    a = np.ascontiguousarray(x_local)
    if not is_multiprocess():
        return a
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    n = a.shape[0]
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(world_size())]
    dist.all_gather(sizes, torch.tensor([n], dtype=torch.int64, device=dev))
    if any(int(s) != n for s in sizes):
        raise ValueError(f"local shards of unequal length "
                         f"{[int(s) for s in sizes]}: every rank must hold "
                         "the same number of frames")
    row = int(np.prod(a.shape[1:], dtype=np.int64))
    local = torch.from_numpy(a.reshape(n, row).view(np.uint8)).to(dev)
    parts = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(parts, local)
    out = torch.cat(parts).cpu().numpy().view(a.dtype)
    return out.reshape((world_size() * n,) + a.shape[1:])
