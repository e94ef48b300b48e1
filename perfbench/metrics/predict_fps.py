"""Frames of the clips completed in the window over the window's seconds
(host clock, from the first clip's call to the last clip's predictions in
hand)."""


def read(record: dict):
    if "frames" not in record["work"]:
        return None
    return record["work"]["frames"] / record["window_s"]
