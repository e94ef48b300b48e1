"""The port's epoch form (`spnet_tpu_torch/train/steps.py::make_train_epoch`,
JAX's `train_epoch` / `train_epoch_geo`) on the CPU, where it runs the
step once a row from Python (on the card it replays a CUDA graph of the
step: `tests/test_torch_epoch_cuda.py`).

Against the JAX package: the epoch at full width (Xception, 64², float32)
against JAX's `make_train_step(indexed="epoch", pregather=False)` on the
default and the 'ss' head.  Against the port itself: the device-scalar
Adam against the host-scalar updates it replaced, across an `unfreeze`;
the epoch's learning-rate table against the schedule; the epoch bitwise
the eager steps (with augmentation, dropout and geometric augmentation);
an epoch split by a checkpoint against an unbroken one; and which feeds
`train_network` runs through the epoch form."""

import collections
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, LossWeights, \
    ModelConfig, TrainConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.data.dataset import Dataset, pad_raw_rows
from spnet_tpu_torch.io.checkpoint import restore_if_exists, save_train_state
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train import loop
from spnet_tpu_torch.train.optim import B1, B2, EPS, adam_init, lr_tensor, \
    optax_adam_apply
from spnet_tpu_torch.train.schedule import onecycle_schedule, schedule_table
from spnet_tpu_torch.train.state import create_train_state, unfreeze
from spnet_tpu_torch.train.steps import make_train_epoch, make_train_step
from test_torch_train import JW, PARAM_GROUPS, SIZE, W, _labels, _np_tree, \
    _param_group, _perturb, _rel_close

torch.set_num_threads(2)
TINY = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                   compute_dtype="float32")
ORDER = ["conv1", "block2"]


@pytest.fixture(scope="module", params=[False, True], ids=["default", "ss"])
def head_setup(request):
    """Full-width SPNet (float32, dropout 0) of the default or the 'ss'
    head with perturbed BN, and a seeded uint8 dataset of 8 frames."""
    cfg = ModelConfig(input_size=SIZE, compute_dtype="float32",
                      dropout_rate=0.0, selective_sigmoid=request.param)
    rng = np.random.default_rng(0)
    jm = jbuild(JModelConfig(**dataclasses.asdict(cfg)))
    x_all = rng.integers(0, 256, (8, SIZE, SIZE, 1), dtype=np.uint8)
    y_all = _labels(rng, 8)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), x_all[:1].astype(np.float32))
    params = _perturb(_np_tree(v["params"]), rng)
    stats = _perturb(_np_tree(v["batch_stats"]), rng)
    return cfg, jm, params, stats, x_all, y_all


def test_train_epoch_matches_jax(head_setup, monkeypatch):
    """Three steps of the epoch form on one idx_mat against JAX's epoch
    program, augmentation off, dropout 0, optax Adam under the 1-cycle
    schedule, with `test_three_train_steps_match_jax`'s tolerances: losses
    within 1e-4, BN statistics within 1e-4 of their scale, every weight
    within 2 * sum(lr) of JAX's, in each leaf the median within 0.05 and
    the 99th percentile within 0.5 of sum(lr), in each group and pooled
    the median within 0.01 and the 99th percentile within 0.1."""
    cfg, jm, params, stats, x_all, y_all = head_setup
    monkeypatch.setenv("SPNET_SCAN_UNROLL", "1")
    idx_mat = np.array([[0, 3, 5, 6], [1, 2, 4, 7], [6, 0, 2, 5]], np.int32)
    lr_max, total = 1e-3, 100
    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((4, SIZE, SIZE, 1)),
                             j_schedule(lr_max, total), adam_variant="optax")
    j_state = j_state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            params),
                              batch_stats=jax.tree_util.tree_map(
                                  jnp.asarray, stats))
    j_epoch = j_make_train_step(jm, JW, "same", l2_reg=1e-4, augment=False,
                                indexed="epoch", pregather=False)
    j_state, j_losses = j_epoch(j_state, jnp.asarray(x_all),
                                jnp.asarray(y_all), jnp.asarray(idx_mat),
                                jax.random.key(1))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    sched = onecycle_schedule(lr_max, total)
    state = create_train_state(model, sched, adam_variant="optax")
    train_epoch = make_train_epoch(make_train_step(model, W, "same",
                                                   l2_reg=1e-4,
                                                   augment=False))
    state, losses = train_epoch(state, torch.from_numpy(x_all),
                                torch.from_numpy(y_all),
                                torch.from_numpy(idx_mat).long(),
                                torch.Generator().manual_seed(0))
    assert losses.shape == (3,) and losses.dtype == torch.float32
    assert state.step == state.opt_state.count == 3
    assert float(state.opt_state.t) == 3.0 and state.lr_feed is None
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=1e-4)

    sum_lr = sum(sched(i) for i in range(3))
    want = flax_to_state_dict(_np_tree(j_state.params),
                              _np_tree(j_state.batch_stats), model)
    devs = collections.defaultdict(list)
    for k, v in model.state_dict().items():
        got, ref = v.numpy(), want[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            _rel_close(got, ref, 1e-4)
            continue
        dev = np.abs(got - ref).ravel() / sum_lr
        assert dev.max() <= 2.0, (k, dev.max())
        med, q99 = np.median(dev), np.quantile(dev, 0.99)
        assert med <= 0.05 and q99 <= 0.5, (k, med, q99)
        devs[_param_group(model, k)].append(dev)
        devs["all"].append(dev)
    assert set(devs) == {"all", *PARAM_GROUPS}
    for group, d in devs.items():
        d = np.concatenate(d)
        med, q99 = np.median(d), np.quantile(d, 0.99)
        assert med <= 0.01 and q99 <= 0.1, (group, med, q99)


class Tiny(torch.nn.Module):
    """Stem, a two-block backbone and a head, named like SPNet."""

    def __init__(self):
        super().__init__()
        self.stem = torch.nn.Linear(3, 4)
        self.backbone = torch.nn.ModuleDict({
            "conv1": torch.nn.Linear(4, 5), "block2": torch.nn.Linear(5, 4)})
        self.final_output = torch.nn.Linear(4, 2)

    def backbone_layer_order(self):
        return list(ORDER)


@torch.no_grad()
def _host_update(variant, params, grads, mus, nus, count, lr):
    """The updates as the port took them before the device count: the
    bias corrections in float64 on the host, the learning rate a Python
    float (`alpha`).  Frozen parameters have moments None."""
    keep = [i for i, m in enumerate(mus) if m is not None]
    ps, gs = [params[i] for i in keep], [grads[i] for i in keep]
    ms, vs = [mus[i] for i in keep], [nus[i] for i in keep]
    t = count + 1
    torch._foreach_mul_(ms, B1)
    torch._foreach_add_(ms, gs, alpha=1.0 - B1)
    torch._foreach_mul_(vs, B2)
    torch._foreach_addcmul_(vs, gs, gs, value=1.0 - B2)
    if variant == "optax":
        denom = torch._foreach_div(vs, 1.0 - B2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(ms, 1.0 - B1 ** t)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(ps, upd, alpha=-lr)
    else:
        lr_t = lr * math.sqrt(1.0 - B2 ** t) / (1.0 - B1 ** t)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(ms, denom)
        torch._foreach_add_(ps, upd, alpha=-lr_t)


@pytest.mark.parametrize("variant", ["optax", "keras"])
def test_device_scalar_adam_matches_the_host_updates(variant):
    """Five updates from identical gradients, three with the first
    backbone block frozen (freeze_fac 0.5), then `unfreeze` and two more:
    the device-scalar Adam (`Optimizer.update`) against the host-scalar
    updates it replaced, every weight within 1e-4 * lr_max, the bound
    `test_torch_optim.py` holds the port to JAX with (the bias corrections
    1 - b^t are float32 now, as in optax, float64 before: 1 - 0.9 is
    1.3e-5 off in float32 and 1 - 0.999 keeps four digits).  The device
    count follows the host count and restarts at `unfreeze`.  The same
    updates with the
    learning rate read from the epoch's table (`TrainState.lr_feed`, the
    epoch form's path) are bitwise the host-evaluated ones."""
    torch.manual_seed(0)
    lr_max, total = 1e-2, 10
    sched = onecycle_schedule(lr_max, total)
    rng = np.random.default_rng(1)
    models = [Tiny() for _ in range(3)]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    states = [create_train_state(m, sched, 0.5, adam_variant=variant)
              for m in models[:2]]
    ref = models[2]
    ref_names = [n for n, _ in ref.named_parameters()]
    frozen = states[0].optimizer.frozen
    mus = [None if n in frozen else torch.zeros_like(p)
           for n, p in ref.named_parameters()]
    nus = [None if m is None else torch.zeros_like(m) for m in mus]
    count = 0
    for k in range(5):
        if k == 3:
            states = [unfreeze(s, adam_variant=variant) for s in states]
            assert float(states[0].opt_state.t) == 0.0
            mus = [torch.zeros_like(p) for p in ref.parameters()]
            nus = [torch.zeros_like(p) for p in ref.parameters()]
            count = 0
        grads = [torch.from_numpy(rng.normal(0, 1, p.shape).astype(
            np.float32)) for p in ref.parameters()]
        _host_update(variant, list(ref.parameters()), grads, mus, nus,
                     count, sched(count))
        count += 1
        for i, s in enumerate(states):
            table = torch.from_numpy(schedule_table(
                sched, s.opt_state.count, 1))
            s.lr_feed = (table, torch.zeros(1, dtype=torch.int64)) \
                if i == 1 else None
            s.opt_state = s.optimizer.update(list(s.model.parameters()),
                                             grads, s.opt_state,
                                             s.step_lr())
            s.lr_feed = None
            s.step += 1
            assert s.opt_state.count == count
            assert float(s.opt_state.t) == count
        for (n, p), q in zip(models[0].named_parameters(), ref.parameters()):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=0,
                                       atol=1e-4 * lr_max, err_msg=n)
        for p, q in zip(models[0].parameters(), models[1].parameters()):
            assert torch.equal(p, q)
    assert ref_names == [n for n, _ in models[0].named_parameters()]
    assert states[0].step == 5 and states[0].opt_state.count == 2


def test_apply_takes_the_rate_as_a_device_scalar():
    """`optax_adam_apply` reads the learning rate from a 0-d tensor and
    the bias corrections from the device count, so changing the tensor's
    value (as a replayed graph does) changes the update."""
    p = [torch.ones(4)]
    outs = []
    for lr in (1e-3, 2e-3):
        q = [t.clone() for t in p]
        st = adam_init(q)
        st = optax_adam_apply(q, [torch.full((4,), 0.5)], st,
                              lr_tensor(lr, st))
        outs.append(1.0 - q[0])
        assert st.count == 1 and float(st.t) == 1.0
    # Adam's first step is lr * sign(g), up to eps and the float32 bias
    # corrections (1 - 0.9 is 1.3e-5 off in float32)
    np.testing.assert_allclose(outs[0].numpy(), 1e-3, rtol=5e-5)
    np.testing.assert_allclose(outs[1].numpy(), 2e-3, rtol=5e-5)


def test_epoch_lr_table_is_the_schedule():
    """`schedule_table` is sched(start + i) in float32 at every step, and
    the epoch form's updates apply exactly those rates: a stand-in step
    reads `TrainState.step_lr()` each row, before and after an `unfreeze`
    (whose fresh count restarts the table at schedule(0))."""
    sched = onecycle_schedule(4e-5, 50)
    table = schedule_table(sched, 7, 40)
    assert table.dtype == np.float32
    np.testing.assert_array_equal(
        table, np.array([sched(7 + i) for i in range(40)], np.float32))
    assert schedule_table(sched, 0, 0).shape == (0,)

    seen = []

    def step(state, x_all, y_all, idx, generator):
        seen.append(float(state.step_lr()))
        state.opt_state = dataclasses.replace(
            state.opt_state, count=state.opt_state.count + 1)
        state.step += 1
        return state, {"loss": torch.zeros(())}

    state = create_train_state(Tiny(), sched, 0.5)
    train_epoch = make_train_epoch(step)
    x, y = torch.zeros(4, 3), torch.zeros(4, 2)
    idx = torch.zeros(6, 2, dtype=torch.int64)
    state, _ = train_epoch(state, x, y, idx, None)
    state = unfreeze(state)
    state, _ = train_epoch(state, x, y, idx[:4], None)
    want = [sched(i) for i in range(6)] + [sched(i) for i in range(4)]
    np.testing.assert_array_equal(np.array(seen, np.float32),
                                  np.array(want, np.float32))
    assert state.step == 10 and state.opt_state.count == 4


def _frames(n, seed, geo, grid=GridSpec()):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)
    y = _labels(rng, n)
    data = [torch.from_numpy(x), torch.from_numpy(y)]
    if geo:
        raws = []
        for _ in range(n):
            k = int(rng.integers(1, 6))
            a = rng.uniform(12, 90, k)
            raws.append(np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                                  rng.uniform(grid.cy_min, grid.cy_max, k),
                                  a, a * rng.uniform(0.4, 1.0, k),
                                  rng.uniform(0, 180, k),
                                  rng.uniform(1, 11, k)], axis=1))
        data += [torch.from_numpy(v) for v in pad_raw_rows(raws)]
    return data


def _trainer(geo, seed=3):
    model = build_model(TINY, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, onecycle_schedule(1e-3, 20),
                               freeze_fac=0.5)
    step = make_train_step(model, LossWeights(), augment=True,
                           geo_augment=geo, grid=GridSpec())
    return state, step, make_train_epoch(step, geo)


def _assert_states_equal(a, b):
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for u, v in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert (u is None and v is None) or torch.equal(u, v)
    assert torch.equal(a.opt_state.t, b.opt_state.t)
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


@pytest.mark.parametrize("geo", [False, True], ids=["plain", "geo"])
def test_epoch_form_is_bitwise_the_eager_steps(geo):
    """MobileNetTiny at 64², b=4, augmentation on, dropout 0.1, with and
    without geometric augmentation: two epochs of 3 steps with an
    `unfreeze` between, through the epoch form and through the step called
    once a row, from the same weights and generator seeds: the losses,
    weights, BN statistics, moments and counts bitwise equal."""
    data = _frames(12, 1, geo)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, 12, (6, 4)))
    got = {}
    for form in ("epoch", "eager"):
        state, step, train_epoch = _trainer(geo)
        gen, losses = torch.Generator(), []
        for e, rows in enumerate((idx[:3], idx[3:])):
            if e == 1:
                state = unfreeze(state)
            gen.manual_seed(100 + e)
            if form == "epoch":
                state, ls = train_epoch(state, *data, rows, gen)
                losses.append(ls)
            else:
                losses.append(torch.stack(
                    [step(state, *data, r, gen)[1]["loss"] for r in rows]))
        got[form] = (state, torch.cat(losses))
    assert torch.equal(got["epoch"][1], got["eager"][1])
    assert len(set(got["epoch"][1].tolist())) == 6
    _assert_states_equal(got["epoch"][0], got["eager"][0])


def test_epoch_split_by_a_checkpoint_equals_an_unbroken_one(tmp_path):
    """Six rows as one epoch, and as three rows, a checkpoint, a fresh
    model and train state restored from it (weights, statistics, step,
    moments and the count, whose device mirror follows), then the other
    three with the generator's state carried over: losses and the final
    state bitwise equal (augmentation on, dropout 0.1)."""
    data = _frames(12, 4, False)
    idx = torch.from_numpy(np.random.default_rng(5).integers(0, 12, (6, 4)))
    state, _, train_epoch = _trainer(False)
    gen = torch.Generator().manual_seed(7)
    whole, losses = train_epoch(state, *data, idx, gen)

    state, _, train_epoch = _trainer(False)
    gen = torch.Generator().manual_seed(7)
    state, first = train_epoch(state, *data, idx[:3], gen)
    save_train_state(str(tmp_path), state, ExperimentConfig(model=TINY))
    resumed, _, train_epoch = _trainer(False, seed=11)
    resumed = restore_if_exists(str(tmp_path), resumed)
    assert resumed.step == resumed.opt_state.count == 3
    assert float(resumed.opt_state.t) == 3.0
    gen2 = torch.Generator()
    gen2.set_state(gen.get_state())
    resumed, second = train_epoch(resumed, *data, idx[3:], gen2)
    assert torch.equal(torch.cat([first, second]), losses)
    _assert_states_equal(resumed, whole)


@pytest.mark.parametrize("case", ["resident", "host-fed", "remat"])
def test_train_network_takes_the_epoch_form_for_the_resident_feed(
        case, monkeypatch, tmp_path):
    """On one rank the resident feed trains through `make_train_epoch`
    (one call an epoch); the host-fed feed and remat call the step once a
    minibatch."""
    made, calls = [], collections.Counter()
    real = loop.make_train_epoch

    def recording(step, geo=False):
        made.append(geo)
        epoch = real(step, geo)

        def train_epoch(*args):
            calls["epoch"] += 1
            return epoch(*args)
        return train_epoch

    monkeypatch.setattr(loop, "make_train_epoch", recording)
    mc = dataclasses.replace(TINY, remat=case == "remat")
    cfg = ExperimentConfig(model=mc, train=TrainConfig(
        batch_size=4, epochs=2, augment=False))
    rng = np.random.default_rng(6)
    train, val = (Dataset(x=rng.integers(0, 256, (n, SIZE, SIZE, 1),
                                         dtype=np.uint8),
                          y=_labels(rng, n), grid=cfg.grid,
                          file_list=[f"f{i}" for i in range(n)])
                  for n in (8, 4))
    state, hist = loop.train_network(
        cfg, train, val, "cpu", log_dir=str(tmp_path),
        render_overlays=False, device_data=case != "host-fed", verbose=0)
    assert state.step == 4 and len(hist) == 2
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    if case == "resident":
        assert made == [False] and calls["epoch"] == 2
    else:
        assert made == [] and calls["epoch"] == 0
