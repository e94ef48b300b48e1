"""The share of the traced tail in which no device operation ran while
the host was inside `spnet.predict.forward`, the phase of
`predict_in_batches` that enqueues the forward's kernels: the device
waits on launches.  Idle gaps are split among the program's spans by
overlap (`perfbench/spans.py`).  With `idle_sync_pct.predict` and the
idle outside the predict path's spans it makes `device_idle_pct.predict`."""

from perfbench import spans


def read(record: dict):
    tail = record["tails"].get("plain")
    if record["kind"] != "predict_clips" or tail is None or not tail.device \
            or not spans.spans(tail, spans.PREDICT_LAUNCH):
        return None
    return 100.0 * spans.idle_us(tail, spans.PREDICT_LAUNCH) / tail.window_us
