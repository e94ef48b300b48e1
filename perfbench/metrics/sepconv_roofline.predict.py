"""The separable conv layers' share of their roofline in the predict
path: per layer call, the larger of its operations over the peak rate and
its least bytes over the bandwidth (`perfbench/counts/`, for the real
frames of each batch: a clip's last batch may be padded), summed over the
traced tail's clips, over the device time of the kernels launched inside
the `perfbench.sepconv` ranges (forward hooks around each
`SeparableConvBN`; on Xception K1, on MobileNet the plain composition).
The ranges of a call's first batch are named `perfbench.sepconv_first`:
where every call ran one batch more than its frames need, that batch is
`predict_in_batches`' warm-up and is left out; where every call ran just
its frames' batches, it is counted; otherwise nothing is read.  The
padding of a partial batch is device time that the inputs did not need."""

import math

from perfbench.counts.model import sepconv_least_seconds


def read(record: dict):
    tail = record["tails"].get("layers")
    peaks = record.get("peaks")
    if record["kind"] != "predict_clips" or tail is None or not peaks:
        return None
    b, layers = record["batch"], record["counts"]["sepconv_layers"]
    lengths = tail.extra["clip_lengths"]
    ran = tail.extra.get("clip_batches", [])
    need = [math.ceil(n / b) for n in lengths]
    us = tail.device_us_in_ranges("perfbench.sepconv")
    if ran == [n + 1 for n in need]:
        pass
    elif ran == need:
        us += tail.device_us_in_ranges("perfbench.sepconv_first")
    else:
        return None
    if us <= 0:
        return None
    least = 0.0
    for length in lengths:
        for s in range(0, length, b):
            least += sepconv_least_seconds(layers, min(b, length - s), peaks)
    return 100.0 * least / (us / 1e6)
