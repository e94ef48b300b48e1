"""Port checkpoints: `state.pt` + `experiment.json`.

Counterpart of `spnet_tpu/io/checkpoint.py`.  A checkpoint directory holds

  * `state.pt`: `torch.save` of {"state_dict": ..., "step": int} and, for
    a training checkpoint, "opt_state": the optimizer's variant, count,
    frozen parameter names and Adam moments keyed by parameter name
    (`train/state.py::TrainState.opt_state_dict`); tensors on the CPU;
  * `experiment.json`: the full `ExperimentConfig` (`to_json`), the same
    file the JAX checkpoints carry, so that predict/evaluate rebuild the
    architecture and the grid's normalization from the checkpoint.

`restore_if_exists` is the training loop's auto-resume.  Serving
checkpoints (no "opt_state") load everywhere; training resumes from them
with fresh optimizer moments.
"""

from __future__ import annotations

import os

import torch

from spnet_tpu_torch.config import ExperimentConfig

STATE_FILENAME = "state.pt"
CONFIG_FILENAME = "experiment.json"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(ckpt_dir: str, state_dict: dict,
                    config: ExperimentConfig, step: int = 0,
                    opt_state: dict | None = None) -> str:
    """Write the state dict, the step, the optimizer state (if any) and
    the config JSON under ckpt_dir; returns the path of `state.pt`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, STATE_FILENAME)
    payload = {"state_dict": _cpu(state_dict), "step": int(step)}
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, CONFIG_FILENAME), "w") as f:
        f.write(config.to_json())
    return path


def save_train_state(ckpt_dir: str, state, config: ExperimentConfig) -> str:
    """Checkpoint a `TrainState`: weights, statistics, step, optimizer."""
    return save_checkpoint(ckpt_dir, state.model.state_dict(), config,
                           step=state.step,
                           opt_state=state.opt_state_dict())


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


def restore_if_exists(ckpt_dir: str, state):
    """Auto-resume: load the weights, statistics and step of a checkpoint
    under ckpt_dir into the `TrainState` (in place), and its optimizer
    state when it belongs to the same optimizer; otherwise return `state`
    unchanged.  A caller that needs the checkpoint calls `load_checkpoint`,
    which raises when there is none."""
    try:
        payload, _ = load_checkpoint(ckpt_dir)
    except FileNotFoundError:
        print(f"    No checkpoint in {ckpt_dir}; starting from scratch.")
        return state
    print(f"    Checkpoint detected in {ckpt_dir}; resuming.")
    state.model.load_state_dict(payload["state_dict"])
    state.step = int(payload["step"])
    saved = payload.get("opt_state")
    if saved is not None and not state.load_opt_state_dict(saved):
        # e.g. a freeze phase boundary or another Adam variant
        print("    (optimizer state in checkpoint does not match the "
              "current optimizer; resuming weights-only)")
    return state
