"""The separable conv layers' share of their roofline in the predict
path, read from the program's own `spnet.sepconv` spans in the plain
tail: the least time of the layers (`counts/model.py::
sepconv_least_seconds`, at the batch, once a `spnet.predict.forward`
span) over the device time of the kernels launched inside `spnet.sepconv`
spans (`perfbench/spans.py`), those of each call's warm-up batch
(`spnet.predict.warmup`) left out.  `sepconv_roofline.predict` reads the
same from the benchmark's hooks in a second tail.  Nothing is read unless
the tail's frames fill its forwards' batches (no padding)."""

from perfbench import spans
from perfbench.counts.model import sepconv_least_seconds


def read(record: dict):
    tail = record["tails"].get("plain")
    peaks = record.get("peaks")
    if record["kind"] != "predict_clips" or tail is None or not tail.device \
            or not peaks:
        return None
    b, layers = record["batch"], record["counts"]["sepconv_layers"]
    forwards = len(spans.spans(tail, spans.PREDICT_LAUNCH))
    if not forwards or tail.units != b * forwards:
        return None
    us = sum(op[2] for op in spans.launched_in(
        tail, spans.SEPCONV, outside=("spnet.predict.warmup",)))
    if us <= 0:
        return None
    least = forwards * sepconv_least_seconds(layers, b, peaks)
    return 100.0 * least / (us / 1e6)
