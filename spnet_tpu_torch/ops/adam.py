"""Adam's update on the card: one pass over every trained leaf.

`train/optim.py::optax_adam_apply` and `keras_adam_apply` take
`adam_apply` for CUDA tensors; their `_foreach` passes
(`optim.foreach_update`) are its plain twin and the CPU's path.  The
kernel (`csrc/adam.cu`) reads p, g, m and v once and writes p, m and v
once, in place, with the twin's roundings, so the results are bit for bit
the twin's.  The leaves' pointers travel in the kernel's arguments, up to
`spnet_adam_max_leaves()` a launch (one launch for every model of the
port); lr (Keras: lr_t) and the bias corrections are read from device
scalars, so a CUDA graph of the step replays with the current values.
On a CUDA tensor it launches or raises; `.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spnet_tpu_torch.ops._build import load_library, on_device


@functools.lru_cache(maxsize=None)
def _max_leaves() -> int:
    return load_library().spnet_adam_max_leaves()


def _layout(t: torch.Tensor):
    """The strides of t's dimensions longer than one if t is
    non-overlapping and dense (its elements fill numel() slots), else
    None.  Tensors of one shape and one layout hold their elements in the
    same order; a dimension of one element may carry any stride (autograd
    gives a 1x1 conv weight's gradient other ones than the weight's)."""
    dims = [(st, sz) for sz, st in zip(t.shape, t.stride()) if sz != 1]
    want = 1
    for stride, size in sorted(dims):
        if stride != want:
            return None
        want *= size
    return tuple(st for st, _ in dims)


def _check_leaf(i: int, leaf, dev) -> None:
    """Raises unless the leaf's p, g, m and v are float32 on `dev`, of one
    shape, and dense in one element order (`_layout`).  Equal strides
    already mean one order; only other strides are compared by `_layout`,
    which keeps the eager step's check of hundreds of leaves short."""
    if not all(t is not None and t.dtype == torch.float32 and t.device == dev
               for t in leaf):
        got = [t if t is None else (t.dtype, t.device) for t in leaf]
        raise TypeError(f"adam_apply: leaf {i} needs float32 p, g, m and v "
                        f"on {dev}, got {got}")
    p = leaf[0]
    shape, stride = p.shape, p.stride()
    if not (all(t.shape == shape for t in leaf)
            and (p.is_contiguous() or _layout(p) is not None)
            and all(t.stride() == stride or _layout(t) == _layout(p)
                    for t in leaf)):
        raise ValueError(f"adam_apply: leaf {i} needs dense p, g, m and v "
                         f"of one shape and layout, got "
                         f"{[(tuple(t.shape), t.stride()) for t in leaf]}")


def _check(ps, gs, mus, nus, scalars) -> torch.device:
    """Raises unless every leaf's p, g, m, v are float32 on one CUDA
    device, of one shape and one dense layout (`_check_leaf`), and lr,
    bc1, bc2 one float32 each on that device."""
    if not len(ps) == len(gs) == len(mus) == len(nus):
        raise ValueError(f"adam_apply: {len(ps)} params, {len(gs)} grads, "
                         f"{len(mus)} first and {len(nus)} second moments")
    dev = ps[0].device
    if dev.type != "cuda":
        raise ValueError(f"adam_apply runs on CUDA tensors, got {dev}: "
                         f"`train/optim.py::foreach_update` is the CPU's path")
    for i, leaf in enumerate(zip(ps, gs, mus, nus)):
        _check_leaf(i, leaf, dev)
    for name, s in scalars.items():
        if s.dtype != torch.float32 or s.device != dev or s.numel() != 1:
            raise TypeError(f"adam_apply: {name} must be one float32 on "
                            f"{dev}, got {s.dtype} {tuple(s.shape)} on "
                            f"{s.device}")
    return dev


def _launches(n: int) -> list:
    """[(first, end)] leaf ranges of the launches over n leaves: at most
    `spnet_adam_max_leaves()` each."""
    m = _max_leaves()
    return [(i, min(i + m, n)) for i in range(0, n, m)]


def adam_apply(ps, gs, mus, nus, lr, bc1, bc2, b1: float, b2: float,
               eps: float, optax: bool) -> None:
    """One Adam update in place on the live leaves (params `ps`, grads
    `gs`, moments `mus`, `nus`: lists of float32 CUDA tensors, each leaf's
    four dense with one shape and layout, `_layout`).  optax: lr is the
    learning rate and the moments are bias-corrected by bc1 = 1 - b1^t and
    bc2 = 1 - b2^t; else (Keras) lr is lr_t and bc1, bc2 are not read.
    lr, bc1, bc2: one float32 each, on the leaves' device."""
    if not ps:
        return
    dev = _check(ps, gs, mus, nus, dict(lr=lr, bc1=bc1, bc2=bc2))
    leaves = [leaf for leaf in zip(ps, gs, mus, nus) if leaf[0].numel()]
    numels = [leaf[0].numel() for leaf in leaves]
    fn = load_library().spnet_adam_apply
    consts = (ctypes.c_float(b1), ctypes.c_float(1.0 - b1),
              ctypes.c_float(b2), ctypes.c_float(1.0 - b2),
              ctypes.c_float(eps))
    for first, end in _launches(len(leaves)):
        n = end - first
        ptrs = [[leaf[k].data_ptr() for leaf in leaves[first:end]]
                for k in range(4)]
        vec = all(a % 16 == 0 for ptr in ptrs for a in ptr)
        arrays = [(ctypes.c_void_p * n)(*ptr) for ptr in ptrs]
        counts = (ctypes.c_longlong * n)(*numels[first:end])
        err = on_device(dev.index, lambda stream: fn(
            *arrays, counts, n, lr.data_ptr(), bc1.data_ptr(),
            bc2.data_ptr(), *consts, int(optax), int(vec), stream))
        if err != 0:
            raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
        adam_apply.launches += 1


adam_apply.launches = 0
