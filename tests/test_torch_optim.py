"""The port's optimizer, freeze masks and schedule
(`spnet_tpu_torch/train/{optim,state,schedule}.py`) against the JAX
package: both Adam variants update by update against `optax.adam(eps=
1e-7)` and `keras_adam` through a frozen phase and `unfreeze`, the restart
of the schedule the update applies after `unfreeze`, the backbone freeze
labels of the full SPNet, and the 1-cycle schedule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.schedule import onecycle_lut
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import backbone_freeze_labels as j_labels
from spnet_tpu.train.state import make_optimizer as j_make_optimizer
from spnet_tpu_torch.config import ModelConfig
from spnet_tpu_torch.convert import flax_tree_to_torch
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train.optim import adam_init, optax_adam_update
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import (
    backbone_freeze_labels,
    create_train_state,
    make_optimizer,
    unfreeze,
)

ORDER = ["conv1", "block2"]


class Tiny(nn.Module):
    """Stem, a two-block backbone and a head, named like SPNet."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Linear(3, 4)
        self.backbone = nn.ModuleDict({"conv1": nn.Linear(4, 5),
                                       "block2": nn.Linear(5, 4)})
        self.final_output = nn.Linear(4, 2)

    def backbone_layer_order(self):
        return list(ORDER)


def _flax_params(model):
    """The flax tree of `model`'s parameters (Dense kernels are (in, out))."""
    def dense(m):
        return {"kernel": m.weight.detach().numpy().T.copy(),
                "bias": m.bias.detach().numpy().copy()}
    return {"stem": dense(model.stem),
            "backbone": {k: dense(model.backbone[k]) for k in ORDER},
            "final_output": dense(model.final_output)}


@pytest.mark.parametrize("variant", ["optax", "keras"])
def test_adam_matches_jax_through_freeze_and_unfreeze(variant):
    """Five updates from identical gradients: three with the first
    backbone block frozen (freeze_fac 0.5), then `unfreeze`, then two
    more.  Frozen weights do not move; every weight agrees with JAX within
    1e-4 * lr_max: JAX takes the schedule and the bias corrections
    1 - b^t in float32 (1 - 0.999 keeps only four digits there), the port
    in float64.

    The restart (ROADMAP C10): a fresh optimizer state after `unfreeze`
    has count 0, so the 4th update applies schedule(0), not schedule(3),
    in JAX and in the port alike, while the train state's step carries
    on.  With this schedule schedule(0) = lr_max / 25, and Adam's first
    step is ~lr * sign(g), so the 4th update's largest move is about
    schedule(0)."""
    torch.manual_seed(0)
    model = Tiny()
    rng = np.random.default_rng(1)
    grads_np = [jax.tree_util.tree_map(
        lambda p: rng.normal(0, 1, p.shape).astype(np.float32),
        _flax_params(model)) for _ in range(5)]
    lr_max, total = 1e-2, 10
    sched, j_sched = onecycle_schedule(lr_max, total), j_schedule(lr_max,
                                                                  total)
    assert sched(3) == pytest.approx(lr_max)

    params = jax.tree_util.tree_map(jnp.asarray, _flax_params(model))
    tx = j_make_optimizer(j_sched, params, ORDER, 0.5, adam_variant=variant)
    opt = tx.init(params)
    state = create_train_state(model, sched, 0.5, adam_variant=variant)
    assert state.optimizer.frozen == {"backbone.conv1.weight",
                                      "backbone.conv1.bias"}
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for k, g in enumerate(grads_np):
        if k == 3:
            tx = j_make_optimizer(j_sched, params, ORDER, 0.0,
                                  adam_variant=variant)
            opt = tx.init(params)
            state = unfreeze(state, adam_variant=variant)
            assert state.step == 3 and state.opt_state.count == 0
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        tg = flax_tree_to_torch(g, model)
        state.opt_state = state.optimizer.update(
            list(model.parameters()), [tg[n] for n in names],
            state.opt_state)
        state.step += 1
        want = flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, params),
                                  model)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=0, atol=1e-4 * lr_max, err_msg=n)
            moved = not torch.equal(p.detach(), before[n])
            assert moved == (k >= 3 or not n.startswith("backbone.conv1"))
        if k == 3:
            step4 = max((p.detach() - before[n]).abs().max().item()
                        for n, p in model.named_parameters()
                        if not n.startswith("backbone.conv1"))
            assert 0.5 * sched(0) < step4 < 1.01 * sched(0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert state.step == 5 and state.opt_state.count == 2


def test_optax_update_matches_optax_without_schedule():
    """A constant learning rate and a tensor list: the bare update
    function, five steps, within 1e-3 of lr (weights near 1 round to
    6e-8 = 2e-4 lr in float32, and optax takes its bias corrections in
    float32)."""
    rng = np.random.default_rng(2)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (7,))]
    gs = [[rng.normal(0, 1e-3, p.shape).astype(np.float32) for p in p0]
          for _ in range(5)]
    tx = optax.adam(3e-4, eps=1e-7)
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ts = adam_init(tp)
    for g in gs:
        u, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        ts = optax_adam_update(tp, [torch.from_numpy(x) for x in g], ts,
                               lambda count: 3e-4)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3 * 3e-4)
    assert ts.count == 5


def test_make_optimizer_variant_plumbing(monkeypatch):
    model = Tiny()
    monkeypatch.delenv("SPNET_ADAM", raising=False)
    assert make_optimizer(lambda s: 1e-3, model, ORDER).variant == "optax"
    monkeypatch.setenv("SPNET_ADAM", "keras")
    assert make_optimizer(lambda s: 1e-3, model, ORDER).variant == "keras"
    assert make_optimizer(lambda s: 1e-3, model, ORDER,
                          adam_variant="optax").variant == "optax"
    with pytest.raises(ValueError, match="adam_variant"):
        make_optimizer(lambda s: 1e-3, model, ORDER, adam_variant="sgd")


def test_spnet_freeze_labels_match_jax():
    """The full SPNet's labels at freeze_fac 0.5, mapped leaf by leaf from
    the JAX label tree: 9 of Xception's 18 top-level blocks frozen, stem
    and head never."""
    cfg = ModelConfig(input_size=64, compute_dtype="float32")
    jm = jbuild(JModelConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(0)},
                        jnp.zeros((1, 64, 64, 1)), train=False))["params"]
    labels = j_labels(shapes, jm.backbone_layer_order(), 0.5)
    flags = jax.tree_util.tree_map(
        lambda lab, s: np.full(s.shape, lab == "frozen", np.float32),
        labels, shapes)
    model = build_model(cfg, device="cpu")
    assert model.backbone_layer_order() == list(jm.backbone_layer_order())
    want = {n: "frozen" if v.numpy().all() else "train"
            for n, v in flax_tree_to_torch(flags, model).items()}
    got = backbone_freeze_labels(model, model.backbone_layer_order(), 0.5)
    assert got == want
    blocks = {n.split(".")[1] for n, v in got.items() if v == "frozen"}
    assert blocks == set(model.backbone_layer_order()[:9])


def test_onecycle_matches_jax_and_reference_lut():
    lut = onecycle_lut(4e-5, n_data_points=800, epochs=10, batch_size=16)
    sched = onecycle_schedule(4e-5, total_steps=len(lut))
    j_sched = j_schedule(4e-5, total_steps=len(lut))
    got = np.array([sched(i) for i in range(len(lut) + 5)])
    ref = np.array([float(j_sched(i)) for i in range(len(lut) + 5)])
    # float64 here, float32 in JAX: 1e-6 of lr_max
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * 4e-5)
    np.testing.assert_allclose(got[:len(lut)], lut, rtol=2e-3)
    assert sched(len(lut) + 100) == pytest.approx(4e-5 / 25 / 1e4)
