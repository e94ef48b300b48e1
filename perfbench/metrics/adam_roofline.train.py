"""Adam's share of its roofline: the update's least bytes (every trained
float32 parameter, gradient and both moments read once, the parameter
and moments written once: 28 B a parameter) over the card's bandwidth,
divided by the device time a step of the multi-tensor-apply kernels (the
`_foreach` passes of `train/optim.py`) in the traced tail's graph
replays."""


def read(record: dict):
    tail = record["tails"].get("plain")
    peaks = record.get("peaks")
    if record["kind"] != "train_resident" or tail is None or not peaks \
            or not tail.units:
        return None
    us = tail.class_us("multi_tensor_apply")
    if us <= 0:
        return None
    least_s = record["counts"]["adam_least_bytes"] / peaks["bytes_per_s"]
    return 100.0 * least_s / (us / 1e6 / tail.units)
