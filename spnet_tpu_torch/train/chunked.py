"""The chunked feed, for training sets larger than the card's budget, and
the host-to-device staging that it and the host-fed feed share.

Counterpart of `spnet_tpu/train/chunked.py`.  The host set stays in plain
numpy (it may be tens of GB: it is never pinned whole).  Each epoch visits
equal-length chunks in a seeded random order and shuffles within each
chunk:

  host set -> [chunk k on the card | chunk k+1 copying] -> steps of chunk k

`Stager` copies host slices to the card through two reused pinned
buffers, on a side stream: the compute stream waits on an event before it
reads a copy, and each copied tensor is marked used by the compute stream
(`record_stream`), so the caching allocator does not hand its memory out
again while a step still reads it.  Dropping the last reference frees a
chunk (JAX's `buf.delete()`); with one chunk ahead, about 3 chunks are on
the card at a time (current, next, and a step's gathered batch).  On the
CPU it hands out tensors over the numpy arrays.

`plan_chunks` and the order of `run_chunked_epoch`'s random draws are
JAX's: one `np.random.default_rng(seed + epoch)`, the permutation of the
chunks first, then for each chunk in the order visited
`permutation(chunk_len)[:steps * batch_size]`.  A chunked epoch runs
`chunk_len // batch_size * n_chunks` steps, which is fewer than the
`n // batch_size` the schedule and the resume count when chunks drop the
set's tail (ROADMAP C31, kept as in JAX).
"""

from __future__ import annotations

import numpy as np
import torch


def plan_chunks(n_items: int, item_bytes: int, batch_size: int,
                budget_bytes: int) -> tuple[int, int]:
    """Pick (chunk_len, n_chunks) so that ~3 in-flight chunks fit the
    budget.  chunk_len is a multiple of batch_size; the set's tail that
    does not fill a whole chunk is dropped (JAX keeps one compiled scan
    shape so; the port keeps its semantics)."""
    per_chunk_budget = max(budget_bytes // 3, batch_size * item_bytes)
    chunk_len = max(per_chunk_budget // max(item_bytes, 1), batch_size)
    chunk_len = (chunk_len // batch_size) * batch_size
    chunk_len = min(chunk_len, (n_items // batch_size) * batch_size)
    n_chunks = n_items // chunk_len
    return int(chunk_len), int(n_chunks)


class Stager:
    """Copies rows of host numpy `arrays` (all of one length) to `device`.

    `put(index)` (a slice or an int array of at most `rows` rows) starts
    the copy of `a[index]` of every array and returns a handle; `take`
    (handle) returns the device tensors once the current stream may read
    them.  On a CUDA device each put fills one of two pinned buffers
    (waiting, on the host, for that buffer's previous copy to finish) and
    copies it on a side stream; so at most two copies are in flight."""

    def __init__(self, arrays: tuple, rows: int, device: torch.device):
        self.arrays, self.device = arrays, torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.pinned = [[torch.empty(
                (rows,) + a.shape[1:], pin_memory=True,
                dtype=torch.from_numpy(a[:0]).dtype) for a in arrays]
                for _ in range(2)]
            self.copied = [None, None]
            self.k = 0

    def put(self, index):
        if not self.cuda:
            return tuple(torch.from_numpy(np.ascontiguousarray(a[index]))
                         for a in self.arrays)
        slot, self.k = self.k % 2, self.k + 1
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()  # the buffer's last copy left
        n = (len(range(*index.indices(len(self.arrays[0]))))
             if isinstance(index, slice) else len(index))
        bufs = [buf[:n] for buf in self.pinned[slot]]
        for a, buf in zip(self.arrays, bufs):
            if isinstance(index, slice):
                np.copyto(buf.numpy(), a[index])
            else:
                np.take(a, index, axis=0, out=buf.numpy())
        with torch.cuda.stream(self.stream):
            dev = tuple(buf.to(self.device, non_blocking=True)
                        for buf in bufs)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[slot] = done
        return dev, done

    def take(self, handle):
        if not self.cuda:
            return handle
        dev, done = handle
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        for t in dev:
            t.record_stream(cur)
        return dev

    def stream_rows(self, indices):
        """Yield the device tensors of each index in turn, the next copy
        issued before the current one is handed out (one ahead)."""
        if not len(indices):
            return
        pending = self.put(indices[0])
        for k in range(len(indices)):
            cur = self.take(pending)
            if k + 1 < len(indices):
                pending = self.put(indices[k + 1])
            yield cur


class ChunkStreamer:
    """Streams equal-length chunks of (x, y[, rows, mask]) to the device,
    one chunk ahead, through a `Stager`."""

    def __init__(self, arrays: tuple, chunk_len: int, n_chunks: int,
                 device: torch.device):
        self.chunk_len, self.n_chunks = chunk_len, n_chunks
        self.stager = Stager(arrays, chunk_len, device)

    def epoch(self, order: np.ndarray):
        """Yield (chunk_index, device tensors) following `order`."""
        slices = [slice(int(ci) * self.chunk_len,
                        (int(ci) + 1) * self.chunk_len) for ci in order]
        for ci, bufs in zip(order, self.stager.stream_rows(slices)):
            yield int(ci), bufs


def run_chunked_epoch(train_step, state, streamer: ChunkStreamer,
                      batch_size: int, generator: torch.Generator,
                      epoch: int, seed: int):
    """One pass over all chunks; returns (state, mean loss as a device
    scalar, n_batches).  `train_step` is the indexed one of
    `make_train_step` (geo or not: the chunk's tensors go to it in
    order); per step it gets one row of the chunk's (steps, batch)
    within-chunk permutation.  `generator` draws augmentation and
    dropout."""
    ep_rng = np.random.default_rng(seed + epoch)
    order = ep_rng.permutation(streamer.n_chunks)
    steps = streamer.chunk_len // batch_size
    losses = []
    for _, bufs in streamer.epoch(order):
        perm = ep_rng.permutation(streamer.chunk_len)[: steps * batch_size]
        idx_mat = torch.from_numpy(perm.reshape(steps, batch_size))
        if bufs[0].is_cuda:  # a pageable copy would wait for the stream
            idx_mat = idx_mat.pin_memory()
        idx_mat = idx_mat.to(bufs[0].device, non_blocking=True)
        for idx in idx_mat:
            state, metrics = train_step(state, *bufs, idx, generator)
            losses.append(metrics["loss"])
    return state, torch.stack(losses).mean(), steps * streamer.n_chunks
