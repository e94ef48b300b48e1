"""Device ms a step of the elementwise and reduction kernels (BatchNorm's
batch statistics and normalization, activations, augmentation, dropout,
the L2 term) in the traced tail, by the frozen kernel classes of
`perfbench/trace.py`."""


def read(record: dict):
    tail = record["tails"].get("plain")
    if record["kind"] != "train_resident" or tail is None \
            or not tail.device or not tail.units:
        return None
    return tail.class_us("elementwise", "reduction") / tail.units / 1e3
