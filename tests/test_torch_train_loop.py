"""The port's training loop and its lifecycle on the CPU: a checkpoint
with the optimizer state round-trips and resumes, `train_network` trains
on the device-resident feed, checkpoints, and resumes at the saved step
and optimizer count, and `python -m spnet_tpu_torch train` runs end to
end on PNG + CSV frames."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.csvio import write_meta_file
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.io.checkpoint import load_checkpoint, \
    restore_if_exists, save_checkpoint, save_train_state
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops.losses import spnet_loss_bwd, spnet_loss_fwd
from spnet_tpu_torch.train.loop import train_network
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
CFG = ExperimentConfig(model=ModelConfig(input_size=SIZE,
                                         compute_dtype="float32"),
                       train=TrainConfig(batch_size=4, epochs=2,
                                         save_every=1))


def _rows(path):
    """The data rows of a losses.dat."""
    with open(path) as f:
        return [r for r in f if not r.startswith("#")]


def _raw_rows(rng, grid):
    k = int(rng.integers(1, 5))
    a = rng.uniform(12, 90, k)
    return np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                     rng.uniform(grid.cy_min, grid.cy_max, k), a,
                     a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
                     rng.uniform(1, 11, k)], axis=1)


def _dataset(n, seed, grid=CFG.grid):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)
    recs = [canonicalize_records(_raw_rows(rng, grid)) for _ in range(n)]
    y = normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                  grid).astype(np.float32)
    return Dataset(x=x, y=y, grid=grid,
                   file_list=[f"synthetic://{seed}/{i}" for i in range(n)])


def _trained_state(seed=0, steps=2):
    torch.manual_seed(seed)
    model = build_model(CFG.model, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, onecycle_schedule(1e-3, 10),
                               adam_variant="optax")
    ds = _dataset(8, seed)
    step = make_train_step(model, augment=True)
    gen = torch.Generator().manual_seed(seed)
    x, y = torch.from_numpy(ds.x), torch.from_numpy(ds.y)
    for i in range(steps):
        state, _ = step(state, x, y, torch.arange(4) + 4 * (i % 2), gen)
    return state


def test_checkpoint_round_trip_with_optimizer_state(tmp_path):
    state = _trained_state()
    save_train_state(str(tmp_path), state, CFG)
    payload, cfg = load_checkpoint(str(tmp_path))
    assert cfg == CFG and payload["step"] == 2
    assert payload["opt_state"]["count"] == 2
    assert payload["opt_state"]["variant"] == "optax"

    fresh = _trained_state(seed=1, steps=0)
    restored = restore_if_exists(str(tmp_path), fresh)
    assert restored.step == 2 and restored.opt_state.count == 2
    for (n, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    restored.opt_state.mu + restored.opt_state.nu):
        assert torch.equal(a, b)

    # another Adam variant: weights and step only, fresh moments
    other = create_train_state(build_model(CFG.model, device="cpu"),
                               onecycle_schedule(1e-3, 10),
                               adam_variant="keras")
    other = restore_if_exists(str(tmp_path), other)
    assert other.step == 2 and other.opt_state.count == 0
    assert all(float(m.abs().max()) == 0 for m in other.opt_state.mu)

    # a serving checkpoint (no optimizer state) resumes weights-only
    save_checkpoint(str(tmp_path / "serve"), state.model.state_dict(), CFG,
                    step=2)
    again = restore_if_exists(str(tmp_path / "serve"),
                              _trained_state(seed=2, steps=0))
    assert again.step == 2 and again.opt_state.count == 0
    # no checkpoint: starts from scratch, the state untouched
    before = {k: v.clone() for k, v in again.model.state_dict().items()}
    assert restore_if_exists(str(tmp_path / "none"), again) is again
    assert again.step == 2 and again.opt_state.count == 0
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_train_network_trains_checkpoints_and_resumes(tmp_path):
    """Two epochs of two steps each, then the same run asked for three
    epochs: it resumes at epoch 3 from the saved step and optimizer count
    and trains one more epoch.  On the CPU the loss kernels launch
    nothing."""
    train, val = _dataset(8, 3), _dataset(4, 4)
    log, ck = str(tmp_path / "log"), str(tmp_path / "ck")
    f0, b0 = spnet_loss_fwd.launches, spnet_loss_bwd.launches
    state, hist = train_network(CFG, train, val, "cpu", log_dir=log,
                                ckpt_dir=ck, verbose=0)
    assert state.step == 4 and state.opt_state.count == 4
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert len(_rows(os.path.join(log, "losses.dat"))) == 2
    assert load_checkpoint(ck)[0]["opt_state"]["count"] == 4
    bn = state.model.backbone.exit_sep4.bn
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))

    cfg3 = dataclasses.replace(CFG, train=dataclasses.replace(CFG.train,
                                                              epochs=3))
    state, hist = train_network(cfg3, train, val, "cpu", log_dir=log,
                                ckpt_dir=ck, verbose=0)
    assert [h["epoch"] for h in hist] == [2]
    assert state.step == 6 and state.opt_state.count == 6
    assert load_checkpoint(ck)[0]["step"] == 6
    assert (spnet_loss_fwd.launches, spnet_loss_bwd.launches) == (f0, b0)

    bad = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, geo_augment=True))
    with pytest.raises(NotImplementedError, match="geo_augment"):
        train_network(bad, train, val, "cpu", verbose=0)


def _write_frames(d, n, seed, grid=CFG.grid):
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8)
                        ).save(os.path.join(d, f"frame_{i:02d}.png"))
        write_meta_file(os.path.join(d, f"frame_{i:02d}.csv"),
                        _raw_rows(rng, grid))


def test_cli_train_end_to_end(tmp_path):
    """16 seeded frames at 64², one epoch, --device cpu: trains, writes
    losses.dat and a checkpoint with the optimizer state, evaluates, and
    imports no jax."""
    _write_frames(str(tmp_path / "data" / "Train"), 16, 5)
    _write_frames(str(tmp_path / "data" / "Val"), 8, 6)
    code = ("import sys, runpy\n"
            "sys.argv = ['spnet_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('spnet_tpu_torch', run_name='__main__')\n"
            "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, "train", "-d", "data", "-b", "8",
         "-e", "1", "-w", "ck", "--name", "t", "--input_size", str(SIZE),
         "--dtype", "float32", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mAP" in proc.stdout
    logs = glob.glob(str(tmp_path / "logs" / "t_*" / "losses.dat"))
    assert len(logs) == 1
    assert len(_rows(logs[0])) == 1
    payload, cfg = load_checkpoint(str(tmp_path / "ck"))
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 2
    assert cfg.model.input_size == SIZE
    assert os.path.exists(os.path.join(os.path.dirname(logs[0]),
                                       "final_weights", "state.pt"))
    for flag in (["--geo_augment"], ["--epoch_repeats", "2"]):
        p = subprocess.run(
            [sys.executable, "-m", "spnet_tpu_torch", "train", *flag,
             "--device", "cpu"], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and "not ported" in p.stderr, flag


def test_cli_train_predict_dir(tmp_path):
    """`train --predict_dir <dir>` predicts over <dir> after training into
    `<log_dir>/predict/` (the JAX CLI's chaining); a directory that is not
    there is skipped with a message, and the run still ends well."""
    _write_frames(str(tmp_path / "data" / "Train"), 8, 5)
    _write_frames(str(tmp_path / "data" / "Val"), 8, 6)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    for name, pdir in (("p", "data/Val"), ("q", "nowhere")):
        proc = subprocess.run(
            [sys.executable, "-m", "spnet_tpu_torch", "train", "-d", "data",
             "-b", "8", "-e", "1", "-w", f"ck_{name}", "--name", name,
             "--backbone", "MobileNetTiny", "--input_size", str(SIZE),
             "--dtype", "float32", "--no-eval", "--predict_dir", pdir,
             "--device", "cpu"],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, (proc.stdout[-3000:]
                                      + proc.stderr[-3000:])
        (log_dir,) = glob.glob(str(tmp_path / "logs" / f"{name}_*"))
        csv = os.path.join(log_dir, "predict", "hawley_spnet.csv")
        if pdir == "nowhere":
            assert "(predict skipped: nowhere not found)" in proc.stdout
            assert not os.path.exists(csv)
        else:
            assert "Starting prediction" in proc.stdout
            assert len(open(csv).read().splitlines()) > 1
        assert os.path.exists(os.path.join(log_dir, "final_weights",
                                           "state.pt"))


def test_dataset_too_large_for_the_card_raises(monkeypatch):
    """The resident feed is the only one ported: a dataset over half the
    card's memory raises and names its size, before any copy."""
    from types import SimpleNamespace

    from spnet_tpu_torch.train import loop

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(total_memory=10**5))
    train, val = _dataset(8, 7), _dataset(4, 8)
    need = (train.x.nbytes + train.y.nbytes + val.x.nbytes) / 1e9
    with pytest.raises(MemoryError, match=f"{need:.2f} GB"):
        loop._to_device(train, val, torch.device("cuda"))
