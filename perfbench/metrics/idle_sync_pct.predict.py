"""The share of the traced tail in which no device operation ran while
the host was inside `spnet.predict.copy_in`, `spnet.predict.warmup` or
`spnet.predict.copy_out`, the phases of `predict_in_batches` in which the
host copies for the device or waits on it.  Idle gaps are split among the
program's spans by overlap (`perfbench/spans.py`).  With
`idle_launch_pct.predict` and the idle outside the predict path's spans
it makes `device_idle_pct.predict`."""

from perfbench import spans


def read(record: dict):
    tail = record["tails"].get("plain")
    if record["kind"] != "predict_clips" or tail is None or not tail.device \
            or not spans.spans(tail, spans.PREDICT_SYNC):
        return None
    return 100.0 * spans.idle_us(tail, spans.PREDICT_SYNC) / tail.window_us
