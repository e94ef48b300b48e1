"""Starting the process group and assembling host shards.

Counterpart of `spnet_tpu/parallel/multihost.py`, with its names:

  1. `maybe_initialize()` starts a `torch.distributed` process group when
     the process is part of a data-parallel job, and is a no-op otherwise,
     so the CLIs call it unconditionally;
  2. `process_shard()` is (rank, world size), handed to
     `build_dataset(shard_index=, num_shards=)`: every rank computes the
     same seeded file order and takes its strided slice;
  3. `host_to_global()` is the union of the ranks' local shards in rank
     order, the layout `jax.make_array_from_process_local_data` gives;
  4. `ShardedRows` keeps only this rank's shard of the training arrays on
     its device, in that layout (rank s owns the global rows
     [s * n, (s + 1) * n)), and hands each rank its rows of a global
     minibatch through one `all_to_all_single` a step, where JAX's
     jitted gather reads the rows of a global array across the devices.

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


def _collective_device() -> torch.device:
    """Where the host-side collectives (`global_length`,
    `host_to_global`) put their tensors: the current CUDA device under
    NCCL, which takes no CPU tensor; the CPU under gloo."""
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def global_length(n_local: int) -> int:
    """The global set's length, W * n_local; raises unless every rank
    holds n_local rows (JAX's process-local layout needs equal shards)."""
    if not is_multiprocess():
        return n_local
    dev = _collective_device()
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(world_size())]
    dist.all_gather(sizes, torch.tensor([n_local], dtype=torch.int64,
                                        device=dev))
    if any(int(s) != n_local for s in sizes):
        raise ValueError(f"local shards of unequal length "
                         f"{[int(s) for s in sizes]}: every rank must hold "
                         "the same number of frames")
    return n_local * world_size()


def host_to_global(x_local) -> np.ndarray:
    """The ranks' equal local shards (leading axis), concatenated in rank
    order on every rank: one `all_gather` of each shard's bytes, on the
    current CUDA device under NCCL and on the CPU under gloo.  The identity
    without a group of more than one rank."""
    a = np.ascontiguousarray(x_local)
    if not is_multiprocess():
        return a
    dev = _collective_device()
    n = a.shape[0]
    global_length(n)
    row = int(np.prod(a.shape[1:], dtype=np.int64))
    local = torch.from_numpy(a.reshape(n, row).view(np.uint8)).to(dev)
    parts = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(parts, local)
    out = torch.cat(parts).cpu().numpy().view(a.dtype)
    return out.reshape((world_size() * n,) + a.shape[1:])


class ShardedRows:
    """This rank's shard of the training arrays, resident on its device,
    and the exchange that gives every rank its rows of a global minibatch.

    `arrays` are this rank's rows [rank * n, (rank + 1) * n) of each
    global array (equal n on every rank; x, y and, with geometric
    augmentation, the raw rows and their mask), on one device.  For an
    epoch's global order (steps, b) `plan(order)` works out on the host,
    once, what each step moves: rank r trains on the rows
    order[i, r * b/W:(r + 1) * b/W] (`mesh.local_rows`), and every rank
    sends r those of them it owns.  `rows(plan, i)` then makes one
    `all_to_all_single` of step i: each frame's arrays packed as one byte
    row, sent in destination order, received grouped by source and put
    back into the order of r's slice, so the result is bitwise
    union[order[i, r-slice]] for each array, where union is the
    global set (`host_to_global`).  The exchange runs on the shard's
    device under either backend (gloo takes `all_to_all_single` on CUDA
    tensors and stages them through the host itself).  `nbytes` is what
    the shard holds."""

    def __init__(self, arrays):
        self.arrays = tuple(arrays)
        self.device = self.arrays[0].device
        self.n_local = int(self.arrays[0].shape[0])
        if any(int(a.shape[0]) != self.n_local for a in self.arrays):
            raise ValueError("the shard's arrays have different lengths")
        self.n_global = global_length(self.n_local)
        # bytes of one frame's row of each array, in packing order
        self.widths = [int(np.prod(a.shape[1:])) * a.element_size()
                       for a in self.arrays]
        self.nbytes = sum(a.numel() * a.element_size() for a in self.arrays)

    def plan(self, order: np.ndarray) -> dict:
        """Step by step, this rank's sends (local rows, counts a
        destination) and receives (counts a source, the permutation into
        its slice's order), from the epoch's global order (steps, b)."""
        order = np.asarray(order, dtype=np.int64)
        steps, b = order.shape
        world, me = world_size(), rank()
        if b % world:
            raise ValueError(f"a global batch of {b} does not split over "
                             f"{world} ranks")
        if order.size and (order.min() < 0 or order.max() >= self.n_global):
            raise ValueError(f"the order indexes outside the {self.n_global}"
                             " global rows")
        per = b // world
        owner = order // self.n_local
        dest = np.arange(b) // per
        mine = owner == me
        # my positions first, in position order (so grouped by destination)
        pos = np.argsort(~mine, axis=1, kind="stable")
        n_send = mine.sum(1)
        # (past n_send a row holds other ranks' rows, never read)
        send = np.take_along_axis(order, pos, 1) - me * self.n_local
        slice_owner = owner[:, me * per:(me + 1) * per]
        # received row k is the slice's position src[k]; out[j] = recv[inv[j]]
        src = np.argsort(slice_owner, axis=1, kind="stable")
        return dict(
            send=torch.from_numpy(send).to(self.device),
            n_send=n_send.tolist(),
            send_counts=np.stack([(mine & (dest == d)).sum(1)
                                  for d in range(world)], 1).tolist(),
            recv_counts=np.stack([(slice_owner == s).sum(1)
                                  for s in range(world)], 1).tolist(),
            perm=torch.from_numpy(np.argsort(src, axis=1)).to(self.device))

    def rows(self, plan: dict, i: int) -> tuple:
        """This rank's rows of step i's global minibatch, one tensor an
        array, on the shard's device."""
        sel = plan["send"][i, :plan["n_send"][i]]
        packed = torch.cat([a.index_select(0, sel).reshape(
            len(sel), w // a.element_size()).view(torch.uint8)
            for a, w in zip(self.arrays, self.widths)], 1)
        recv_counts = plan["recv_counts"][i]
        out = torch.empty((sum(recv_counts), packed.shape[1]),
                          dtype=torch.uint8, device=self.device)
        dist.all_to_all_single(out, packed, output_split_sizes=recv_counts,
                               input_split_sizes=plan["send_counts"][i])
        out = out[plan["perm"][i]]
        res, at = [], 0
        for a, w in zip(self.arrays, self.widths):
            res.append(out[:, at:at + w].contiguous().view(a.dtype)
                       .reshape((len(out),) + tuple(a.shape[1:])))
            at += w
        return tuple(res)
