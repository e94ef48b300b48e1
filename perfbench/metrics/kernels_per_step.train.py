"""Device kernels a train step in the traced tail's graph replays: the
kernels the tail ran, copies and sets left out, over its steps.  Replays
carry no span, so kernels are told by name: the profiler names a copy
`Memcpy ...` and a set `Memset ...`, and every other device operation is
a kernel.  The launches that a step of many small layers pays a fixed
cost for."""

import re

_NOT_KERNEL = re.compile(r"^Mem(cpy|set)\b")


def read(record: dict):
    tail = record["tails"].get("plain")
    if record["kind"] != "train_resident" or tail is None \
            or not tail.device or not tail.units:
        return None
    kernels = sum(1 for name, *_ in tail.device
                  if not _NOT_KERNEL.match(name))
    return kernels / tail.units if kernels else None
