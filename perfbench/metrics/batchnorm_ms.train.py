"""Device ms a step of the port's train-mode BatchNorm kernels
(`spnet_tpu_torch/csrc/batchnorm.cu`: stats, finalize and normalize
forward; sums, finalize and dx backward) in the traced tail's graph
replays, matched by their own name prefix `batchnorm_`, which no frozen
class of `perfbench/trace.py` takes (they fall in `other`).  None where no
such kernel ran: a program that runs BatchNorm as torch ops."""

import re

_KERNEL = re.compile(r"\bbatchnorm_")


def read(record: dict):
    tail = record["tails"].get("plain")
    if record["kind"] != "train_resident" or tail is None \
            or not tail.device or not tail.units:
        return None
    us = sum(us for name, us in tail.by_name().items()
             if _KERNEL.search(name))
    if us <= 0:
        return None
    return us / tail.units / 1e3
