"""The predict path's share of the card's dense bf16 peak: the forward's
tensor-core operations a frame (`perfbench/counts/`) times the window's
frames a second, over the peak."""


def read(record: dict):
    peaks = record.get("peaks")
    if record["kind"] != "predict_clips" or not peaks:
        return None
    rate = record["work"]["frames"] / record["window_s"]
    return 100.0 * record["counts"]["forward_flops"] * rate / peaks["flops"]
