"""The train step's share of the card's dense bf16 peak: the forward's
tensor-core operations an image (`perfbench/counts/`) times 3 (forward
and backward), times the window's images a second, over the peak."""


def read(record: dict):
    peaks = record.get("peaks")
    if record["kind"] != "train_resident" or not peaks:
        return None
    rate = record["work"]["images"] / record["window_s"]
    return 100.0 * 3 * record["counts"]["forward_flops"] * rate \
        / peaks["flops"]
