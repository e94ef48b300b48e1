"""The share of the traced tail in which no device operation ran: 100
less the union of the kernels', copies' and sets' intervals over the
tail's length."""


def read(record: dict):
    tail = record["tails"].get("plain")
    if record["kind"] != "predict_clips" or tail is None or not tail.device:
        return None
    return 100.0 * (1.0 - tail.busy_us() / tail.window_us)
