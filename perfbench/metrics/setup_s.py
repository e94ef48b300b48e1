"""Seconds from the start of `perfbench/run.py` to the window's start:
imports, the kernel library (built on a checkout's first run), the model,
the inputs, the first steps and the warm-up."""


def read(record: dict):
    return record["setup_s"]
