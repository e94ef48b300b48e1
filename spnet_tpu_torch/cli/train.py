"""`python -m spnet_tpu_torch train` — train, then evaluate.

Flags mirror `spnet_tpu/cli/train.py` (reference `train_spnet.py:96-112`),
plus `--device` (default `cuda`).  Training runs on one device, on the
resident feed, or the chunked one when the set does not fit (JAX's
choice), with `--geo_augment`, `--epoch_repeats`, `--use_tb` (into
`<log_dir>/tb`), `--profile` (a `torch.profiler` trace of `train_network`
into `<log_dir>/profile`), `--remat` and `--pretrained` (Keras backbone
weights) as in JAX.  After
training it evaluates on Test/ (Val/ when there is no Test/), predicts over
`--predict_dir` into `<log_dir>/predict/` when that is given, and writes
the final weights into the log directory.

Data-parallel training: launched as `torchrun --nproc_per_node=N -m
spnet_tpu_torch train ...`, or with SPNET_COORDINATOR=host:port,
SPNET_NUM_PROCESSES (the number of cards, not of hosts as in JAX),
SPNET_PROCESS_ID and SPNET_LOCAL_RANK set for every process (the JAX
package's variables, and the card's index on its host), each process
starts the group (NCCL on the card, gloo with `--device cpu`), loads its
own shard of Train/ and Val/, and trains on `cuda:LOCAL_RANK` (or
SPNET_LOCAL_RANK) with `-b` the global batch; rank 0 alone
evaluates, predicts and writes the final weights, as it alone writes the
logs and the checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from spnet_tpu_torch.cli.common import (
    add_device_arg,
    add_model_args,
    config_from_args,
    parse_grid,
    resolve_device,
    timestamped_log_dir,
)
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.eval.predict import predict_network
from spnet_tpu_torch.io.checkpoint import save_train_state
from spnet_tpu_torch.data.dataset import build_dataset
from spnet_tpu_torch.parallel import mesh
from spnet_tpu_torch.parallel.multihost import maybe_initialize, \
    process_shard
from spnet_tpu_torch.train.loop import train_network


def main(argv=None):
    p = argparse.ArgumentParser(
        description="trains network on training dataset",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-d", "--datapath", default="./",
                   help="directory with Train/ and Val/ subdirs")
    p.add_argument("-e", "--epochs", type=int, default=100)
    p.add_argument("-f", "--fraction", type=float, default=1.0)
    p.add_argument("--freeze_fac", type=float, default=0.0)
    p.add_argument("--frozen_epochs", type=int, default=0)
    p.add_argument("-g", "--grid", type=parse_grid, default=(6, 6, 2),
                   help="predictor grid, e.g. 6x6x2")
    p.add_argument("-w", "--weights", default="ckpt",
                   help="checkpoint directory (auto-resume if present)")
    p.add_argument("-l", "--lrmax", type=float, default=4e-5)
    p.add_argument("-n", "--noaugment", action="store_true")
    p.add_argument("--blur_prob", type=float, default=0.0,
                   help="train-time Gaussian-blur probability (the "
                        "reference's train-time blur is a silent no-op, "
                        "so 0 matches its effective recipe)")
    p.add_argument("--geo_augment", action="store_true",
                   help="train-time geometric augmentation (random "
                        "flip/rotate/translate with on-device label "
                        "re-encode) — replaces offline augment-preproc "
                        "dataset inflation")
    p.add_argument("--epoch_repeats", type=int, default=1,
                   help="shuffled passes over the training set per epoch "
                        "program / per val sweep (>1 amortizes the "
                        "per-epoch val sweep for tiny datasets trained "
                        "many passes, e.g. with --geo_augment in place "
                        "of offline 42x inflation)")
    p.add_argument("--use_tb", action="store_true",
                   help="emit TensorBoard event files (scalars + overlay "
                        "image summaries) into <logdir>/tb")
    p.add_argument("--name", default="")
    p.add_argument("-r", "--random_seed", type=int, default=1)
    p.add_argument("--no-eval", action="store_true",
                   help="skip the post-training evaluation")
    p.add_argument("--predict_dir", default="",
                   help="after evaluation, run label-free prediction over "
                        "this directory (the reference chains predict "
                        "over Zooniverse data, train_spnet.py:141-143); "
                        "skipped when empty or missing")
    p.add_argument("--drop-overflow", action="store_true",
                   help="tolerate >preds_per_cell ellipses in a grid "
                        "cell (drop extras) instead of failing")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler host + device trace of "
                        "the run into <logdir>/profile")
    add_model_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    print("Command line ~= \n", " ".join(sys.argv))
    print("args = ", args)
    device = resolve_device(args.device)
    # a data-parallel job's process joins its group (a no-op otherwise),
    # then loads only its own disjoint file shard; the loop assembles the
    # global training set from the shards (parallel/multihost.py)
    maybe_initialize(device=device)
    shard_i, shard_n = process_shard()
    device = mesh.local_device(device)
    cfg = config_from_args(args, args.grid)
    log_dir = timestamped_log_dir(args.name)
    print("Logging to", log_dir)
    if shard_n > 1:
        print(f"data-parallel: rank {shard_i}/{shard_n} on {device}, file "
              f"shard {shard_i} of {shard_n}")

    ovf = "drop" if args.drop_overflow else "raise"
    size = cfg.model.input_size or None
    train_ds = build_dataset(
        os.path.join(args.datapath, "Train"), cfg.grid,
        load_frac=args.fraction, batch_size=args.batch_size,
        input_size=size, seed=args.random_seed, on_overflow=ovf,
        shard_index=shard_i, num_shards=shard_n)
    val_ds = build_dataset(
        os.path.join(args.datapath, "Val"), cfg.grid,
        batch_size=args.batch_size, shuffle=False, input_size=size,
        on_overflow=ovf, shard_index=shard_i, num_shards=shard_n)
    if args.profile:
        from spnet_tpu_torch.utils.profiling import trace

        with trace(os.path.join(log_dir, "profile")):
            state, _ = train_network(cfg, train_ds, val_ds, device,
                                     log_dir=log_dir, ckpt_dir=args.weights)
    else:
        state, _ = train_network(cfg, train_ds, val_ds, device,
                                 log_dir=log_dir, ckpt_dir=args.weights)
    if shard_n > 1:  # the rest runs on rank 0 alone, without the group
        torch.distributed.destroy_process_group()
        if shard_i > 0:
            return

    if not args.no_eval:
        print("\n----------------------------\nStarting model evaluation...")
        testpath = os.path.join(args.datapath, "Test")
        if not os.path.isdir(testpath):
            testpath = os.path.join(args.datapath, "Val")
        test_ds = build_dataset(testpath, cfg.grid,
                                batch_size=args.batch_size, shuffle=False,
                                input_size=size)
        evaluate_network(cfg, state.model, test_ds, device,
                         log_dir="logs/Evaluation/")

    # chain label-free prediction over real data (reference
    # `train_spnet.py:141-143` predicts over the Zooniverse set)
    if args.predict_dir:
        if os.path.isdir(args.predict_dir):
            print("\n----------------------------\n"
                  "Starting prediction...")
            predict_network(cfg, state.model, args.predict_dir, device,
                            log_dir=os.path.join(log_dir, "predict") +
                            os.sep, batch_size=args.batch_size)
        else:
            print(f"(predict skipped: {args.predict_dir} not found)")

    final_dir = os.path.join(log_dir, "final_weights")
    save_train_state(final_dir, state, cfg)
    print(f"Final weights + config saved to {final_dir}")
    print("SPNet-TPU execution completed.")


if __name__ == "__main__":
    main()
