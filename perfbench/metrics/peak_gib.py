"""The card's `max_memory_allocated` over the warm-up and the window
(after `reset_peak_memory_stats` once the set-up's check readings are
taken), in GiB; nothing off the card."""


def read(record: dict):
    if not record["peak_bytes"]:
        return None
    return record["peak_bytes"] / 1024 ** 3
