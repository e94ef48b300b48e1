"""Flax variables -> the port's `state_dict`.

The port's modules carry the flax scope names, so the conversion is one
transform per leaf:

  conv kernel         (kh, kw, I, O) HWIO  -> (O, I, kh, kw) OIHW
  depthwise kernel    (k, k, 1, C)         -> (k, k, C)   (scope `depthwise`
                                              or NASNet's `sep*_dw`)
  pointwise kernel    (1, 1, C, F)         -> (C, F)      (`pointwise`,
                                              `sep*_pw`)
  Dense kernel        (in, out)            -> (out, in)
  conv / Dense bias   (out,)               -> bias
  BN scale / bias / mean / var -> weight / bias / running_mean / running_var
  (a gamma-less BN has no scale leaf, and its module no weight)

`flax_to_state_dict` checks the result against a model: every flax leaf
must land on a key of the model, with the model's shape, and every key of
the model must be filled.  `flax_tree_to_torch` applies the same
transforms to any params-shaped tree (gradients, Adam moments), keyed like
`model.named_parameters()`.  Inputs are nested dicts of numpy arrays (what
`spnet_tpu.io.checkpoint.load_checkpoint` returns); no jax is needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _convert_leaf(path: tuple, leaf: np.ndarray) -> tuple[str, np.ndarray]:
    *scope, name = path
    if name == "kernel":
        if leaf.ndim == 4 and (scope[-1] == "depthwise"
                               or scope[-1].endswith("_dw")):
            if leaf.shape[2] != 1 or leaf.shape[0] != leaf.shape[1]:
                raise ValueError(f"{'/'.join(path)}: depthwise kernel "
                                 f"{leaf.shape} is not (k, k, 1, C)")
            out = leaf[:, :, 0, :]
        elif leaf.ndim == 4 and (scope[-1] == "pointwise"
                                 or scope[-1].endswith("_pw")):
            out = leaf[0, 0]
        elif leaf.ndim == 4:
            out = leaf.transpose(3, 2, 0, 1)
        elif leaf.ndim == 2:
            out = leaf.T
        else:
            raise ValueError(f"{'/'.join(path)}: unexpected kernel rank "
                             f"{leaf.ndim}")
        return ".".join(scope + ["weight"]), out
    if name in _RENAME:
        return ".".join(scope + [_RENAME[name]]), leaf
    raise ValueError(f"{'/'.join(path)}: unknown leaf {name!r}")


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert flax `params` + `batch_stats` into `model`'s state_dict
    (float32 CPU tensors).  Raises ValueError naming every leaf left over,
    every key left empty and every shape that does not match."""
    return _convert(list(_leaves(params)) + list(_leaves(batch_stats)),
                    model.state_dict())


def flax_tree_to_torch(tree: Mapping, model: nn.Module
                       ) -> dict[str, torch.Tensor]:
    """Convert any params-shaped flax tree (parameters, gradients, Adam
    moments) leaf by leaf with the same transforms; the result is keyed
    like `model.named_parameters()` and checked against it."""
    return _convert(list(_leaves(tree)), dict(model.named_parameters()))


def _convert(leaves, target: Mapping) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    problems = []
    for path, leaf in leaves:
        key, arr = _convert_leaf(path, leaf)
        if key not in target:
            problems.append(f"flax leaf {'/'.join(path)} -> {key}: no such "
                            "key in the model")
        elif tuple(arr.shape) != tuple(target[key].shape):
            problems.append(f"{key}: converted shape {arr.shape} != model "
                            f"{tuple(target[key].shape)}")
        elif key in out:
            problems.append(f"{key}: filled twice")
        else:
            out[key] = torch.from_numpy(np.array(arr, order="C"))
    problems += [f"{k}: not filled by any flax leaf"
                 for k in target if k not in out]
    if problems:
        raise ValueError("flax -> torch conversion failed:\n  "
                         + "\n  ".join(problems))
    return out
