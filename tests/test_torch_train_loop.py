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

    # a pretrained backbone is read before the first step: a file that is
    # not there raises and names it
    bad = dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, pretrained="backbone.h5"))
    with pytest.raises(FileNotFoundError, match="backbone.h5"):
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
    p = subprocess.run(
        [sys.executable, "-m", "spnet_tpu_torch", "train", "-d", "data",
         "-b", "8", "--input_size", str(SIZE), "--pretrained", "bb.h5",
         "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "'bb.h5' not found" in p.stderr


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
    """The resident feed, asked for on a dataset over half the card's
    memory, raises and names its size, before any copy (left to itself,
    `train_network` picks the chunked feed for such a set)."""
    from types import SimpleNamespace

    from spnet_tpu_torch.train import loop

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(total_memory=10**5))
    train, val = _dataset(8, 7), _dataset(4, 8)
    need = (train.x.nbytes + train.y.nbytes + val.x.nbytes) / 1e9
    with pytest.raises(MemoryError, match=f"{need:.2f} GB"):
        loop._to_device(train, val, torch.device("cuda"))


GEO_CFG = ExperimentConfig(
    model=ModelConfig(backbone="MobileNetTiny", input_size=32,
                      compute_dtype="float32"),
    train=TrainConfig(batch_size=4, epochs=2, save_every=1, seed=3,
                      geo_augment=True, epoch_repeats=2))


def _geo_dataset(n, seed, size=32, grid=CFG.grid):
    ds = _dataset(n, seed, grid)
    from spnet_tpu_torch.data.dataset import pad_raw_rows

    rng = np.random.default_rng(seed + 100)
    rows, mask = pad_raw_rows([_raw_rows(rng, grid) for _ in range(n)])
    return dataclasses.replace(ds, x=ds.x[:, :size, :size], rows=rows,
                               row_mask=mask)


def _recording_step(record, side):
    """A stand-in for make_train_step: records each call's minibatch
    indices and trains nothing.  JAX's epoch program takes (..., idx_mat,
    rng, step_offset) and returns the epoch's losses; the port's step
    (..., idx, generator) and returns a metrics dict."""
    def make(*args, **kwargs):
        record.append(("geo", kwargs.get("geo_augment")))

        def step(state, *feed):
            if side == "jax":
                import jax.numpy as jnp

                record.append(np.asarray(feed[-3]))
                return state, jnp.zeros(len(record[-1]))
            record.append(np.asarray(feed[-2]))
            state.step += 1
            return state, {"loss": torch.zeros(())}
        return step
    return make


def test_epoch_order_under_repeats_matches_jax(monkeypatch, tmp_path):
    """`epoch_repeats=2`, 3 epochs of 12 frames at b=4: the minibatch
    indices the port's loop hands its steps, epoch by epoch, are those the
    JAX loop hands its epoch program (pass r of epoch e shuffled with seed
    + e * repeats + r), and both build the geo step."""
    import spnet_tpu.train.loop as jloop
    from spnet_tpu.config import ExperimentConfig as JExperimentConfig
    from spnet_tpu.data.dataset import Dataset as JDataset
    from spnet_tpu_torch.train import loop

    cfg = dataclasses.replace(GEO_CFG, train=dataclasses.replace(
        GEO_CFG.train, epochs=3))
    train, val = _geo_dataset(12, 0), _geo_dataset(4, 1)
    jcfg = JExperimentConfig.from_json(cfg.to_json())
    jtrain, jval = (JDataset(x=d.x, y=d.y, file_list=d.file_list,
                             grid=jcfg.grid, rows=d.rows,
                             row_mask=d.row_mask) for d in (train, val))
    j_rec, t_rec = [], []
    monkeypatch.setattr(jloop, "make_train_step",
                        _recording_step(j_rec, "jax"))
    monkeypatch.setattr(jloop, "predict_in_batches", lambda fn, p, s, x, bs,
                        **k: (np.zeros((len(x), 576), np.float32), 1.0))
    jloop.train_network(jcfg, jtrain, jval, log_dir=str(tmp_path / "j"),
                        render_overlays=False, verbose=0)
    monkeypatch.setattr(loop, "make_train_step",
                        _recording_step(t_rec, "torch"))
    loop.train_network(cfg, train, val, "cpu", log_dir=str(tmp_path / "t"),
                       render_overlays=False, verbose=0)
    assert j_rec[0] == t_rec[0] == ("geo", True)
    want = np.concatenate(j_rec[1:])
    got = np.stack(t_rec[1:])
    assert got.shape == (3 * 2 * 3, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:6], loop.epoch_order(12, 4, 3, 0, 2))


def test_geo_resume_equals_an_unbroken_run(monkeypatch, tmp_path):
    """Geometric augmentation with epoch_repeats=2, 2 epochs: a run cut
    after epoch 1's checkpoint and resumed ends with the weights, the BN
    statistics, the optimizer state and the epoch-2 loss of an unbroken
    run, bitwise; 4 steps an epoch; a dataset without raw rows raises."""
    from spnet_tpu_torch.train import loop

    train, val = _geo_dataset(8, 5), _geo_dataset(4, 6)
    whole, hist = train_network(GEO_CFG, train, val, "cpu",
                                log_dir=str(tmp_path / "a"),
                                ckpt_dir=str(tmp_path / "ca"), verbose=0)
    assert whole.step == 8 and [h["epoch"] for h in hist] == [0, 1]

    class Cut(Exception):
        pass

    def save_then_cut(*args, **kwargs):
        save_train_state(*args, **kwargs)
        raise Cut

    monkeypatch.setattr(loop, "save_train_state", save_then_cut)
    with pytest.raises(Cut):
        train_network(GEO_CFG, train, val, "cpu",
                      log_dir=str(tmp_path / "b"),
                      ckpt_dir=str(tmp_path / "cb"), verbose=0)
    monkeypatch.setattr(loop, "save_train_state", save_train_state)
    assert load_checkpoint(str(tmp_path / "cb"))[0]["step"] == 4
    resumed, hist_b = train_network(GEO_CFG, train, val, "cpu",
                                    log_dir=str(tmp_path / "b"),
                                    ckpt_dir=str(tmp_path / "cb"), verbose=0)
    assert resumed.step == 8 and [h["epoch"] for h in hist_b] == [1]
    assert hist_b[0]["train_loss"] == hist[1]["train_loss"]
    for (k, a), b in zip(whole.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(whole.opt_state.mu + whole.opt_state.nu,
                    resumed.opt_state.mu + resumed.opt_state.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="raw ellipse rows"):
        train_network(GEO_CFG, dataclasses.replace(train, rows=None), val,
                      "cpu", verbose=0)


def test_cli_gen_fake_espi_then_train_geo_tb_profile(tmp_path):
    """`gen-fake-espi -n 24 --all --device cpu` writes 20 Train and 4 Val
    pairs; `train --geo_augment --epoch_repeats 2 --use_tb --profile` on
    them (MobileNetTiny at 64^2, b=4, 1 epoch) trains 10 steps and writes
    losses.dat, a TensorBoard event file under tb/ and a torch.profiler
    trace under profile/, importing no jax."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    code = ("import sys, runpy\n"
            "sys.argv = ['spnet_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('spnet_tpu_torch', run_name='__main__')\n"
            "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    gen = subprocess.run(
        [sys.executable, "-c", code, "gen-fake-espi", "-d", "data", "-n",
         "24", "--all", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert gen.returncode == 0, gen.stdout[-2000:] + gen.stderr[-2000:]
    for sub, n in (("Train", 20), ("Val", 4)):
        names = sorted(os.listdir(tmp_path / "data" / sub))
        first = 0 if sub == "Train" else 20
        assert len(names) == 2 * n and names[:2] == [
            f"steelpan_{first:07d}.csv", f"steelpan_{first:07d}.png"]
    proc = subprocess.run(
        [sys.executable, "-c", code, "train", "-d", "data", "-b", "4",
         "-e", "1", "-w", "ck", "--name", "g", "--backbone", "MobileNetTiny",
         "--input_size", "64", "--dtype", "float32", "--geo_augment",
         "--epoch_repeats", "2", "--use_tb", "--profile", "--no-eval",
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (log_dir,) = glob.glob(str(tmp_path / "logs" / "g_*"))
    assert len(_rows(os.path.join(log_dir, "losses.dat"))) == 1
    assert len(os.listdir(os.path.join(log_dir, "tb"))) == 1
    traces = glob.glob(os.path.join(log_dir, "profile", "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    import json

    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert {"spnet.step.geo_augment", "spnet.step.grid_encode"} <= names
    payload, cfg = load_checkpoint(str(tmp_path / "ck"))
    assert payload["step"] == 10 and cfg.train.geo_augment
    assert cfg.train.epoch_repeats == 2 and cfg.train.use_tb
