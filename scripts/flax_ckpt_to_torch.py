#!/usr/bin/env python3
"""Convert a JAX (Orbax) checkpoint of spnet_tpu into a checkpoint of the
PyTorch port, so that a model trained with JAX is served by
`python -m spnet_tpu_torch predict|evaluate`.

Usage (in an environment with jax, flax and orbax):

    python scripts/flax_ckpt_to_torch.py -w ckpt -o ckpt_torch

Reads `<ckpt>/state` + `experiment.json` through
`spnet_tpu.io.checkpoint.load_checkpoint` (its config crosses to the
port's `ExperimentConfig` through `experiment.json`'s text), maps every
flax leaf onto the port's state dict
(`spnet_tpu_torch.convert.flax_to_state_dict`, which refuses leftover or
missing leaves) and writes `<out>/state.pt` + `experiment.json`.  The
config must be one the port builds: any of the six backbones (Xception,
MobileNet, MobileNetTiny, DarkNet19, InceptionResNetV2, NASNetMobile) and
the three heads; `build_model` raises for remat and the planar and fused
stems.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-w", "--weights", required=True,
                   help="spnet_tpu (Orbax) checkpoint directory")
    p.add_argument("-o", "--out", required=True,
                   help="port checkpoint directory to write")
    args = p.parse_args(argv)

    from spnet_tpu.io.checkpoint import load_checkpoint
    from spnet_tpu_torch.config import ExperimentConfig
    from spnet_tpu_torch.convert import flax_to_state_dict
    from spnet_tpu_torch.io.checkpoint import save_checkpoint
    from spnet_tpu_torch.models.spnet import build_model

    payload, jax_cfg = load_checkpoint(args.weights)
    cfg = ExperimentConfig.from_json(jax_cfg.to_json())
    model = build_model(cfg.model, num_outputs=cfg.grid.num_outputs,
                        device="cpu")
    state = flax_to_state_dict(payload["params"], payload["batch_stats"],
                               model)
    path = save_checkpoint(args.out, state, cfg,
                           step=int(payload["step"]))
    print(f"converted {len(state)} tensors, step {int(payload['step'])}: "
          f"{args.weights} -> {path}")


if __name__ == "__main__":
    main()
