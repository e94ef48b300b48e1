"""Port checkpoints: `state.pt` + `experiment.json`.

Counterpart of `spnet_tpu/io/checkpoint.py`.  A checkpoint directory holds

  * `state.pt`: `torch.save` of {"state_dict": ..., "step": int}, tensors
    on the CPU;
  * `experiment.json`: the full `ExperimentConfig` (`to_json`), the same
    file the JAX checkpoints carry, so that predict/evaluate rebuild the
    architecture and the grid's normalization from the checkpoint.

Optimizer state and auto-resume come with the training slice.
"""

from __future__ import annotations

import os

import torch

from spnet_tpu.config import ExperimentConfig

STATE_FILENAME = "state.pt"
CONFIG_FILENAME = "experiment.json"


def save_checkpoint(ckpt_dir: str, state_dict: dict,
                    config: ExperimentConfig, step: int = 0) -> str:
    """Write the state dict, the step and the config JSON under ckpt_dir;
    returns the path of `state.pt`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, STATE_FILENAME)
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "step": int(step),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, CONFIG_FILENAME), "w") as f:
        f.write(config.to_json())
    return path


def load_checkpoint(ckpt_dir: str) -> tuple[dict, ExperimentConfig]:
    """(payload, config); raises FileNotFoundError if there is no
    `state.pt`.  A missing `experiment.json` gives the default config, as
    in the JAX package."""
    path = os.path.join(ckpt_dir, STATE_FILENAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint ({STATE_FILENAME}) under "
                                f"{ckpt_dir}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    cfg_path = os.path.join(ckpt_dir, CONFIG_FILENAME)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = ExperimentConfig.from_json(f.read())
    else:
        config = ExperimentConfig()
    return payload, config
