"""The Dataset-D experiment: the reference's offline 42x inflation against
on-the-fly geometric augmentation, on the same small synthetic set.

    python -m spnet_tpu_torch.tools.dataset_d [n_train] [epochs_offline] \\
        [--arm both|offline|onthefly] [--rep N] [--device cuda]

Counterpart of the JAX package's `scripts/dataset_d_run.py`, with its argv,
defaults (1,280 train frames, 12 epochs) and errors.  The recipe: N_VAL
(640) val frames, N_AUGS (42) variants of every train frame, b=16, lr_max
4e-5, Xception at 331, augmentation on, blur off, seed 0; frames from
`gen-fake-espi` with seeds 0 (train) and 99 (val), written as PNG + CSV
pairs and loaded back through `build_dataset`.

- offline: the train split copied to TrainAug/ and inflated there by
  `augment` (the reference's workflow); the inflated set trained for
  `epochs_offline` epochs, the feed picked by `train_network`
  (`device_data=None`).
- onthefly: the 1x train split with `geo_augment`, `epoch_repeats` passes
  an epoch (`--rep`, else the offline set's frames // the train frames),
  so both arms see the same images and sweep the val set as often.

An inflation is complete only with its marker, `inflate_done.json` (its
wall seconds): a TrainAug/ without it is partial and is redone, one with
it is reused.  The data lives in `logs/dataset_d_data_torch_{cpu|cuda}`
and the logs in `logs/dataset_d_{tag}_torch_{cpu|cuda}`: never the JAX
script's directories (its frames are not the port's), and never the
other device type's.

Prints the stage seconds and memory on `[stage]` / `[memory]` lines, one
`DATASET_D_STAGES {json}` line an arm, the JAX script's `OFFLINE` /
`ONTHEFLY` lines and one `DATASET_D_RESULT {json}` line with its keys.
`dataset_d_prep` and `dataset_d_inflate` run the data stages alone.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time

import torch

from spnet_tpu_torch.cli import augment_preproc, gen_fake_espi
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import build_dataset
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.tools.runtime import add_device_arg, card, memory, \
    tool_device
from spnet_tpu_torch.train.loop import train_network

#: the recipe's fixed sizes (module constants, as the JAX script's locals;
#: the CPU tests shrink them)
N_VAL = 640
N_AUGS = 42
BATCH = 16
LR_MAX = 4e-5
INPUT_SIZE = 331
BACKBONE = "Xception"
TRAIN_SEED, VAL_SEED = 0, 99
ARMS = ("both", "offline", "onthefly")


def workdir(device) -> str:
    """The experiment's data directory for `device`'s type."""
    return f"logs/dataset_d_data_torch_{torch.device(device).type}"


def log_dir(tag: str, device) -> str:
    return f"logs/dataset_d_{tag}_torch_{torch.device(device).type}"


def stage(name: str, seconds: float, device) -> None:
    """Print a stage's seconds, the host's peak RSS and the card's
    memory after it."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[stage] {name}: {seconds:.1f} s; host max RSS {rss:.2f} GiB",
          flush=True)
    memory(f"after {name}", device)


def generate(wd: str, n_train: int, n_val: int, device) -> float:
    """gen-fake-espi's train frames (seed 0) into wd/Train and val frames
    (seed 99) into wd/Val, unless wd/Train exists; returns the seconds."""
    t0 = time.time()
    if not os.path.exists(f"{wd}/Train"):
        os.makedirs(f"{wd}/Train", exist_ok=True)
        os.makedirs(f"{wd}/Val", exist_ok=True)
        dev = ["--device", str(device)]
        gen_fake_espi.main(["-n", str(n_train), "-d", wd, "--seed",
                            str(TRAIN_SEED), *dev])  # writes Train/
        gen_fake_espi.main(["-n", str(n_val), "-d", wd + "/valtmp",
                            "--seed", str(VAL_SEED), *dev])
        for f in os.listdir(f"{wd}/valtmp/Train"):
            shutil.move(f"{wd}/valtmp/Train/{f}", f"{wd}/Val/{f}")
    return time.time() - t0


def marker_path(wd: str) -> str:
    return f"{wd}/inflate_done.json"


def inflate(wd: str, n_augs: int, device) -> float:
    """wd/Train copied to wd/TrainAug and inflated there by n_augs
    variants a frame, then the marker written; a TrainAug without the
    marker (a partial run: inflating it again would inflate the variants
    too) is removed first.  Returns the wall seconds."""
    t0 = time.time()
    inflated = f"{wd}/TrainAug"
    if os.path.exists(inflated):
        shutil.rmtree(inflated)
    shutil.copytree(f"{wd}/Train", inflated)
    augment_preproc.main(["-d", inflated + "/", "-n", str(n_augs),
                          "--device", str(device)])
    wall = round(time.time() - t0, 1)
    with open(marker_path(wd), "w") as f:
        json.dump({"wall_s": wall, "n_augs": n_augs}, f)
    return wall


def parse_args(argv=None):
    """(n_train, epochs_offline, arm, rep, device name), with the JAX
    script's errors."""
    p = argparse.ArgumentParser(add_help=False)
    add_device_arg(p)
    known, argv = p.parse_known_args(argv)
    arm, rep_pin = "both", None
    if "--arm" in argv:
        i = argv.index("--arm")
        if i + 1 >= len(argv):
            raise SystemExit("--arm needs a value: both|offline|onthefly")
        arm = argv[i + 1]
        if arm not in ARMS:
            raise SystemExit(f"unknown --arm {arm!r}: "
                             "both|offline|onthefly")
        del argv[i:i + 2]
    if "--rep" in argv:
        i = argv.index("--rep")
        if i + 1 >= len(argv):
            raise SystemExit("--rep needs an integer value")
        rep_pin = int(argv[i + 1])
        del argv[i:i + 2]
    n_train = int(argv[0]) if len(argv) > 0 else 1280
    ep_off = int(argv[1]) if len(argv) > 1 else 12
    return n_train, ep_off, arm, rep_pin, known.device


def experiment_config(epochs: int, **train) -> ExperimentConfig:
    """An arm's config, as the JAX script builds it; `train` adds the
    on-the-fly arm's geo_augment and epoch_repeats."""
    return ExperimentConfig(
        grid=GridSpec(),
        model=ModelConfig(backbone=BACKBONE, input_size=INPUT_SIZE),
        train=TrainConfig(batch_size=BATCH, epochs=epochs, lr_max=LR_MAX,
                          augment=True, blur_prob=0.0, seed=TRAIN_SEED,
                          save_every=10**9, **train),
    )


def load(path: str, device, name: str, **kw):
    """`build_dataset` of a directory, timed, with its frames/s."""
    t0 = time.time()
    ds = build_dataset(path, GridSpec(), batch_size=BATCH,
                       input_size=INPUT_SIZE, **kw)
    s = time.time() - t0
    n = ds.x.shape[0]
    print(f"  loaded {n} frames of {path} in {s:.1f} s "
          f"({n / max(s, 1e-9):.1f} frames/s)", flush=True)
    stage(f"load {name}", s, device)
    return ds, s


def run_one(cfg, train_ds, val_ds, tag: str, device, stages: dict) -> dict:
    """One arm: train, then evaluate the val set; the JAX script's keys."""
    t0 = time.time()
    # device_data=None: train_network picks the feed by the card's budget
    state, history = train_network(
        cfg, train_ds, val_ds, device, log_dir=log_dir(tag, device),
        ckpt_dir=None, render_overlays=False, device_data=None, verbose=1)
    wall = time.time() - t0
    stage(f"train {tag}", wall, device)
    t1 = time.time()
    res = evaluate_network(cfg, state.model, val_ds, device,
                           log_dir=log_dir(tag, device) + "_eval/",
                           num_draw=0, verbose=1)
    stages.update(train_s=wall, eval_s=time.time() - t1,
                  img_per_sec=[h["img_per_sec"] for h in history])
    stage(f"eval {tag}", stages["eval_s"], device)
    return {"tag": tag, "train_wall_s": round(wall, 1),
            "ring_acc": res["ring_acc"], "class_acc": res["class_acc"],
            "mAP": res.get("mAP"), "pix_err": res["mean_pix_err"],
            "epochs": cfg.train.epochs,
            "imgs_seen": cfg.train.epochs * train_ds.x.shape[0]}


def _print_stages(arm: str, stages: dict) -> None:
    print("DATASET_D_STAGES " + json.dumps({"arm": arm, **stages},
                                           default=float), flush=True)


def main(argv=None) -> dict:
    """Runs the arms asked for; returns the DATASET_D_RESULT dict."""
    n_train, ep_off, arm, rep_pin, dev_name = parse_args(
        list(sys.argv[1:] if argv is None else argv))
    device = tool_device(dev_name)
    card(device)
    wd = workdir(device)
    print(f"dataset_d: {n_train} train + {N_VAL} val frames in {wd}, "
          f"arm {arm}, on {device}", flush=True)

    t_gen = generate(wd, n_train, N_VAL, device)
    stage("generation", t_gen, device)

    inflated, marker = f"{wd}/TrainAug", marker_path(wd)
    r_off = None
    if arm == "onthefly":
        if rep_pin is None:
            raise SystemExit("--arm onthefly needs --rep N (match the "
                             "recorded offline run's images-seen)")
        t_inflate = None
    elif os.path.exists(marker):
        with open(marker) as f:
            t_inflate = json.load(f)["wall_s"]
        print(f"  (reusing completed inflation: {t_inflate:.0f}s)",
              flush=True)
    else:
        t_inflate = inflate(wd, N_AUGS, device)
        stage("inflation", t_inflate, device)

    val_ds, _ = load(f"{wd}/Val", device, "val", shuffle=False)
    if arm != "onthefly":
        files = len([f for f in os.listdir(inflated) if f.endswith(".png")])
        written = n_train * (N_AUGS + 1)
        print(f"  inflated set: {files} PNG files of {written} written "
              f"({written - files} variants shared a name)", flush=True)
        off_ds, load_s = load(inflated, device, "inflated", shuffle=True,
                              seed=TRAIN_SEED, on_overflow="drop")
        stages = {"generation_s": t_gen, "inflation_s": t_inflate,
                  "load_s": load_s, "inflated_files": files,
                  "frames": off_ds.x.shape[0]}
        r_off = run_one(experiment_config(ep_off), off_ds, val_ds,
                        "offline42x", device, stages)
        r_off["inflate_wall_s"] = round(t_inflate, 1)
        _print_stages("offline", stages)
        print("OFFLINE " + json.dumps(r_off, default=float), flush=True)
        if arm == "offline":
            out = {"gen_wall_s": round(t_gen, 1), "offline": r_off}
            print("DATASET_D_RESULT " + json.dumps(out, default=float),
                  flush=True)
            return out

    fly_ds, load_s = load(f"{wd}/Train", device, "train", shuffle=True,
                          seed=TRAIN_SEED)
    # equal images seen and equal val cadence: one epoch of rep_fly
    # freshly warped passes (and one val sweep) for each offline epoch
    rep_fly = (rep_pin if rep_pin is not None
               else off_ds.x.shape[0] // fly_ds.x.shape[0])
    stages = {"generation_s": t_gen, "load_s": load_s,
              "frames": fly_ds.x.shape[0]}
    r_fly = run_one(experiment_config(ep_off, geo_augment=True,
                                      epoch_repeats=rep_fly),
                    fly_ds, val_ds, "geo_fly", device, stages)
    r_fly["imgs_seen"] = ep_off * rep_fly * fly_ds.x.shape[0]
    r_fly["epoch_repeats"] = rep_fly
    _print_stages("onthefly", stages)
    print("ONTHEFLY " + json.dumps(r_fly, default=float), flush=True)
    out = {"gen_wall_s": round(t_gen, 1), "offline": r_off,
           "onthefly": r_fly}
    print("DATASET_D_RESULT " + json.dumps(out, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
