"""Images trained in the window over the window's seconds (host clock,
from the first chunk's call to the last chunk's last loss on the host)."""


def read(record: dict):
    if "images" not in record["work"]:
        return None
    return record["work"]["images"] / record["window_s"]
