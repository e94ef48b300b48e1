"""The convolutions' and matrix products' share of their roofline in the
train step: the least time of a step's tensor-core work, 3 x the
forward's operations an image (`perfbench/counts/`: the forward and the
backward's two products a layer) x the batch over the card's dense bf16
peak, divided by the device time a step of the frozen `cudnn_conv` and
`gemm` classes (`perfbench/trace.py`) in the traced tail's graph replays.
Operations alone make the bound: the layers' bytes are not counted, so
the least time is a floor, and a layer that its bytes bound reads lower
than its own roofline would."""


def read(record: dict):
    tail = record["tails"].get("plain")
    peaks = record.get("peaks")
    if record["kind"] != "train_resident" or tail is None or not peaks \
            or not tail.units:
        return None
    us = tail.class_us("cudnn_conv", "gemm")
    if us <= 0:
        return None
    least_s = 3 * record["counts"]["forward_flops"] * record["batch"] \
        / peaks["flops"]
    return 100.0 * least_s / (us / 1e6 / tail.units)
