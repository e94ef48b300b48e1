"""Unified CLI: `python -m spnet_tpu_torch <command> [args...]`.

Commands (the JAX package's):

  train            train, then evaluate            (train_spnet.py)
  evaluate         score on a labeled dataset      (evaluate_spnet.py)
  predict          label-free batch inference      (predict_spnet.py)
  gen-fake-espi    synthetic ESPI frames + labels  (gen_fake_espi.py)
  export           checkpoint -> torch.export serving artifact (—)
  setup-data       Train/Val split + augmentation  (setup_data.py)
  augment          offline flip/rotate/translate   (augment_preproc.py)
  parse-zooniverse crowd CSV -> per-image CSVs     (parse_zooniverse_csv.py)
  gen-bboxes       ellipse -> bounding-box CSV     (gen_bboxes_csv.py)
  ellipse-editor   Tk annotation editor            (ellipse_editor.py)
  bench            one-card training benchmark     (—)

train, evaluate, predict and export take a port checkpoint directory
(`-w`, see `io/checkpoint.py`; a JAX checkpoint converts with
`scripts/flax_ckpt_to_torch.py`; `train` resumes from it when present).
train, evaluate, predict, gen-fake-espi, export, setup-data and augment
take `--device` (default `cuda`).  Data-parallel training:
`torchrun --nproc_per_node=N -m spnet_tpu_torch train ...` (or the
SPNET_COORDINATOR / SPNET_NUM_PROCESSES / SPNET_PROCESS_ID variables).
`bench` (`tools/bench.py`, the port's counterpart of the JAX `bench.py`)
takes no arguments, runs on the card and prints one JSON line; its
inference companion is `python -m spnet_tpu_torch.tools.bench_infer`.
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
    "setup-data": "spnet_tpu_torch.cli.setup_data",
    "augment": "spnet_tpu_torch.cli.augment_preproc",
    "parse-zooniverse": "spnet_tpu_torch.cli.parse_zooniverse",
    "gen-bboxes": "spnet_tpu_torch.cli.gen_bboxes",
    "ellipse-editor": "spnet_tpu_torch.cli.ellipse_editor",
}


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    cmd = sys.argv[1]
    if cmd == "bench":
        import json

        from spnet_tpu_torch.tools import bench

        print(json.dumps(bench.main()))
        return
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n")
        print(__doc__)
        raise SystemExit(2)
    importlib.import_module(_COMMANDS[cmd]).main(sys.argv[2:])


if __name__ == "__main__":
    main()
