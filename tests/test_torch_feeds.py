"""The port's host-fed feed (`train_network(device_data=False)`) and the
choice of feed on the CPU: with the same seeds the host-fed run is the
resident run, bitwise (losses, weights, BN statistics), with and without
geometric augmentation; three host-fed steps (`make_train_step(indexed=
False)`, the step taking the batch itself) against JAX's host-fed step on
the same batches; and JAX's choice of feed (resident when the set fits,
else chunked)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.config import ExperimentConfig, LossWeights, \
    ModelConfig, TrainConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.data.dataset import Dataset, pad_raw_rows
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train import loop
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import make_train_step

torch.set_num_threads(2)
SIZE = 32
CFG = ExperimentConfig(
    model=ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                      compute_dtype="float32"),
    train=TrainConfig(batch_size=4, epochs=2, save_every=1, seed=7,
                      augment=False))


def _raw_rows(rng, grid):
    k = int(rng.integers(1, 5))
    a = rng.uniform(12, 90, k)
    return np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                     rng.uniform(grid.cy_min, grid.cy_max, k), a,
                     a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
                     rng.uniform(1, 11, k)], axis=1)


def _dataset(n, seed, size=SIZE, grid=CFG.grid):
    """Seeded uint8 frames, their grid labels, and the padded raw rows the
    geometric augmentation reads."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8)
    raw = [_raw_rows(rng, grid) for _ in range(n)]
    y = normalize(batch_ellipses_to_grid(
        [canonicalize_records(r) for r in raw], grid, on_overflow="drop"),
        grid).astype(np.float32)
    rows, mask = pad_raw_rows(raw)
    return Dataset(x=x, y=y, grid=grid, rows=rows, row_mask=mask,
                   file_list=[f"synthetic://{seed}/{i}" for i in range(n)])


@pytest.mark.parametrize("geo", [False, True], ids=["plain", "geo"])
def test_host_fed_run_equals_the_resident_run(geo, tmp_path):
    """2 epochs x 2 repeats of 12 frames at b=4: the host-fed feed hands
    its steps the resident feed's minibatches in the resident order and
    draws from the same generator, so losses, weights and BN statistics
    end bitwise equal.  Augmentation off; with geo the warp and the label
    encode run (and draw) in both."""
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, epoch_repeats=2, geo_augment=geo))
    train, val = _dataset(12, 1), _dataset(4, 2)
    runs = {}
    for feed in (True, False):
        runs[feed] = loop.train_network(
            cfg, train, val, "cpu", log_dir=str(tmp_path / str(feed)),
            render_overlays=False, device_data=feed, verbose=0)
    (a, ha), (b, hb) = runs[True], runs[False]
    assert a.step == b.step == 2 * 2 * 3
    assert [h["train_loss"] for h in ha] == [h["train_loss"] for h in hb]
    assert [h["val_comps"] for h in ha] == [h["val_comps"] for h in hb]
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_host_fed_steps_match_jax():
    """Three host-fed steps on the same batches (full-width Xception at
    64², float32, dropout 0, augmentation off, optax Adam under the
    1-cycle schedule): the port's `make_train_step(indexed=False)` against
    JAX's `make_train_step(indexed=False)`; the losses within 1e-4, the
    tolerance of `test_torch_train.py::test_three_train_steps_match_jax`
    (float32 sums in another order through 34 separable convs and 40
    batch-stat BNs)."""
    size = 64
    mc = ModelConfig(input_size=size, compute_dtype="float32",
                     dropout_rate=0.0)
    ds = _dataset(8, 3, size=size)
    rows = np.array([[0, 3, 5, 6], [1, 2, 4, 7], [6, 0, 2, 5]])
    rng = np.random.default_rng(0)
    jm = jbuild(JModelConfig(**dataclasses.asdict(mc)))
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), ds.x[:1].astype(np.float32))
    params = _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng)
    stats = _perturb(jax.tree_util.tree_map(np.asarray, v["batch_stats"]),
                     rng)
    lr_max, total = 1e-3, 100
    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((4, size, size, 1)),
                             j_schedule(lr_max, total), adam_variant="optax")
    j_state = j_state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    j_step = j_make_train_step(jm, JLossWeights(), "same", l2_reg=1e-4,
                               augment=False, indexed=False)
    j_losses = []
    for r in rows:
        j_state, met = j_step(j_state, jnp.asarray(ds.x[r]),
                              jnp.asarray(ds.y[r]), jax.random.key(1))
        j_losses.append(float(met["loss"]))

    model = build_model(mc, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    state = create_train_state(model, onecycle_schedule(lr_max, total),
                               adam_variant="optax")
    step = make_train_step(model, LossWeights(), "same", l2_reg=1e-4,
                           augment=False, indexed=False)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(state, torch.from_numpy(ds.x[r]),
                         torch.from_numpy(ds.y[r]), gen)[1]["loss"])
              for r in rows]
    assert state.step == state.opt_state.count == 3
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)


def test_feed_choice_follows_jax(monkeypatch, capsys, tmp_path):
    """device_data None picks the resident feed when train + val fit the
    budget (no limit on the CPU) and the chunked feed when they do not;
    True, False and 'chunked' are taken as given; anything else raises.
    Forcing the resident feed on a set over the budget raises
    MemoryError."""
    train, val = _dataset(8, 4), _dataset(4, 5)
    dev = torch.device("cpu")
    need = train.x.nbytes + train.y.nbytes + val.x.nbytes
    for given in (True, False, "chunked"):
        assert loop._pick_feed(given, train, val, dev, False) == given
    assert loop._pick_feed(None, train, val, dev, False) is True
    with pytest.raises(ValueError, match="device_data"):
        loop._pick_feed("host", train, val, dev, False)
    monkeypatch.setattr(loop, "_budget", lambda device: need - 1)
    assert loop._pick_feed(None, train, val, dev, False) == "chunked"
    # geo counts the raw rows too
    monkeypatch.setattr(loop, "_budget", lambda device: need)
    assert loop._pick_feed(None, train, val, dev, False) is True
    assert loop._pick_feed(None, train, val, dev, True) == "chunked"
    with pytest.raises(MemoryError, match="device_data='chunked'"):
        loop._to_device(train, val, dev, True)
    monkeypatch.setattr(loop, "_budget", lambda device: need - 1)
    state, _ = loop.train_network(CFG, train, val, "cpu",
                                  log_dir=str(tmp_path), verbose=1,
                                  render_overlays=False)
    assert "chunk-streamed dataset" in capsys.readouterr().out
    assert state.step == 2 * 2


def test_make_train_step_takes_epoch_or_false():
    model = build_model(CFG.model, device="cpu")
    with pytest.raises(ValueError, match="indexed"):
        make_train_step(model, indexed=True)
