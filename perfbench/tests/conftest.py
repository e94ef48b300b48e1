"""Shared pieces of the benchmark's own tests.

Run them from the root of the checkout: `python -m pytest perfbench/tests`
(on the card: `python -m pytest perfbench/tests -m cuda`).  They import
the harness from the checkout's root and run cells on the CPU at small
sizes, with the widths of the configurations kept.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("xception331-train-b16", "xception331-predict-b16")
#: small sizes a CPU run holds (input 96, few frames and steps)
SMALL = {
    "train_resident": {"frames": 64, "batch": 4, "chunk_rows": 4,
                       "calib_frames": 4},
    "predict_clips": {"pool_frames": 64, "clip_min": 5, "clip_max": 9,
                      "batch": 4, "check_frames": 24, "tail_seconds": 0.3,
                      "calib_frames": 4},
}


def small(cell: str, **model) -> dict:
    """Overrides of `core.run_cell` that run `cell` at a small size."""
    from perfbench import core

    kind = core.load_cell(cell)["traffic"]["kind"]
    return {"model": {"input_size": 96, **model},
            "traffic": dict(SMALL[kind])}


@pytest.fixture
def card():
    """The card, for tests marked `cuda`; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
