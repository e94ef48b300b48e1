"""Unified CLI: `python -m spnet_tpu_torch <command> [args...]`.

Commands ported so far (the serving path):

  evaluate         score on a labeled dataset      (evaluate_spnet.py)
  predict          label-free batch inference      (predict_spnet.py)

Both take a port checkpoint directory (`-w`, see `io/checkpoint.py`; a
JAX checkpoint converts with `scripts/flax_ckpt_to_torch.py`) and
`--device` (default `cuda`).
"""

from __future__ import annotations

import importlib
import sys

_COMMANDS = {
    "evaluate": "spnet_tpu_torch.cli.evaluate",
    "predict": "spnet_tpu_torch.cli.predict",
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
