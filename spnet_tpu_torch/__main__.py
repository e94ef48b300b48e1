"""Unified CLI: `python -m spnet_tpu_torch <command> [args...]`.

Commands ported so far (the training and serving paths, the synthetic
data generator and the serving export):

  train            train, then evaluate            (train_spnet.py)
  evaluate         score on a labeled dataset      (evaluate_spnet.py)
  predict          label-free batch inference      (predict_spnet.py)
  gen-fake-espi    synthetic ESPI frames + labels  (gen_fake_espi.py)
  export           checkpoint -> torch.export serving artifact (—)

train, evaluate, predict and export take a port checkpoint directory
(`-w`, see `io/checkpoint.py`; a JAX checkpoint converts with
`scripts/flax_ckpt_to_torch.py`; `train` resumes from it when present).
All take `--device` (default `cuda`).
"""

from __future__ import annotations

import importlib
import sys

_COMMANDS = {
    "train": "spnet_tpu_torch.cli.train",
    "evaluate": "spnet_tpu_torch.cli.evaluate",
    "predict": "spnet_tpu_torch.cli.predict",
    "gen-fake-espi": "spnet_tpu_torch.cli.gen_fake_espi",
    "export": "spnet_tpu_torch.cli.export",
}


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    cmd = sys.argv[1]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n")
        print(__doc__)
        raise SystemExit(2)
    importlib.import_module(_COMMANDS[cmd]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
