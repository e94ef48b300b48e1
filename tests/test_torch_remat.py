"""Backbone remat in the port (`ModelConfig.remat`: the backbone under
`torch.utils.checkpoint` in train mode) on the CPU: train steps with remat
are the steps without it, bitwise, BatchNorm running statistics included
(the recompute must not update them a second time), with and without a
frozen backbone; the remat step against JAX's `remat=True` model; and the
parameter names, eval outputs and checkpoints are those of the model
without remat."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.train.steps import kernel_l2 as j_kernel_l2
from spnet_tpu_torch.config import LossWeights, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.models.layers import BatchNorm
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import forward_loss, make_predict_step, \
    make_train_step

torch.set_num_threads(2)
SIZE = 64
CFG = ModelConfig(input_size=SIZE, compute_dtype="float32")


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)
    y = rng.random((n, 576), dtype=np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _train(remat, freeze_fac, steps=2):
    """`steps` host-fed train steps of full-width Xception at 64²
    (dropout 0.1 and augmentation on, both from one seeded generator)."""
    model = build_model(dataclasses.replace(CFG, remat=remat), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    state = create_train_state(model, onecycle_schedule(1e-3, 10),
                               freeze_fac=freeze_fac, adam_variant="optax")
    step = make_train_step(model, indexed=False)
    gen = torch.Generator().manual_seed(2)
    losses = [float(step(state, *_batch(k), gen)[1]["loss"])
              for k in range(steps)]
    return state, losses


@pytest.mark.parametrize("freeze_fac", [0.0, 0.5], ids=["all", "frozen"])
def test_remat_steps_equal_the_plain_steps_bitwise(freeze_fac):
    """Two steps with remat and two without: the same losses, weights, BN
    running statistics and Adam moments, bitwise.  A second running-stat
    update in the recompute would move every backbone BN's statistics
    away from the plain run's.  With half the backbone frozen, its frozen
    weights stay where they started and its statistics still move once."""
    (a, la), (b, lb) = _train(False, freeze_fac), _train(True, freeze_fac)
    assert b.model.remat and not a.model.remat
    assert la == lb
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for m, n in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert (m is None and n is None) or torch.equal(m, n)
    start = build_model(CFG, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    params = dict(b.model.named_parameters())
    for name, p0 in start.named_parameters():
        assert torch.equal(params[name], p0) == (name in b.optimizer.frozen)
    assert bool(b.optimizer.frozen) == (freeze_fac > 0)
    bn = b.model.backbone.conv1.bn  # frozen when freeze_fac = 0.5
    assert not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))


def test_recompute_leaves_the_running_statistics_alone():
    """One remat forward + backward updates every BatchNorm's running
    statistics once: r = momentum * r0 + (1 - momentum) * batch, read off
    the model without remat after one forward; and the BNs take updates
    again after the backward."""
    x, y = _batch(3)
    gen = [torch.Generator().manual_seed(4) for _ in range(2)]
    models = [build_model(dataclasses.replace(CFG, remat=r), device="cpu",
                          generator=torch.Generator().manual_seed(1)).train()
              for r in (False, True)]
    loss0, _ = forward_loss(models[0], x.float() / 127.5 - 1, y, gen[0])
    loss1, _ = forward_loss(models[1], x.float() / 127.5 - 1, y, gen[1])
    once = {k: v.clone() for k, v in models[0].state_dict().items()}
    torch.autograd.grad(loss1, list(models[1].parameters()))
    for k, v in models[1].state_dict().items():
        assert torch.equal(v, once[k]), k
    assert all(m.update_stats for m in models[1].modules()
               if isinstance(m, BatchNorm))
    assert float(loss0.detach()) == float(loss1.detach())


def test_remat_matches_jax_remat():
    """Data loss + 'reference' L2 and its gradient of the port's remat
    model against JAX's `remat=True` model on the same weights (float32,
    dropout 0): the tolerances of
    `test_torch_train.py::test_spnet_loss_and_gradients_match_jax` (loss
    1e-5; each gradient leaf within 1e-4 of its own max, floored at 1e-6
    of the largest; running statistics 1e-5)."""
    mc = dataclasses.replace(CFG, dropout_rate=0.0, remat=True)
    rng = np.random.default_rng(0)
    jm = jbuild(JModelConfig(**dataclasses.asdict(mc)))
    xb, yb = _batch(5)
    x = (xb.numpy().astype(np.float32) / 255.0 - 0.5) * 2.0
    y = yb.numpy()
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(jax.random.key(0), x[:1])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.6, 1.4, s.shape).astype(np.float32),
        v["batch_stats"])

    def loss_fn(p):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.key(1)})
        data = j_components(y, out, JLossWeights(), "same")["total"]
        return data + 1e-4 * j_kernel_l2(p, "reference"), upd

    (j_loss, j_upd), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = build_model(mc, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    model.train()
    names, tparams = zip(*model.named_parameters())
    loss, _ = forward_loss(model, torch.from_numpy(x), yb, None,
                           LossWeights(), "same", 1e-4, "reference")
    grads = torch.autograd.grad(loss, tparams)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    want = flax_tree_to_torch(jax.tree_util.tree_map(np.asarray, j_grads),
                              model)
    floor = 1e-6 * max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in zip(names, grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= max(1e-4 * np.abs(w).max(), floor), (name, err)
    stats_want = flax_to_state_dict(
        params, jax.tree_util.tree_map(np.asarray, j_upd["batch_stats"]),
        model)
    for k, t in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            w = stats_want[k].numpy()
            assert np.abs(t.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


def test_remat_keeps_names_eval_and_checkpoints():
    """The remat model has the plain model's state_dict keys and shapes
    (checkpoints load both ways, as `nn.remat`'s do), and in eval mode,
    where nothing is recomputed, gives the plain model's output."""
    plain = build_model(CFG, device="cpu",
                        generator=torch.Generator().manual_seed(6))
    rem = build_model(dataclasses.replace(CFG, remat=True), device="cpu")
    sd = plain.state_dict()
    assert [(k, v.shape) for k, v in rem.state_dict().items()] == \
        [(k, v.shape) for k, v in sd.items()]
    rem.load_state_dict(sd)
    plain.load_state_dict(rem.state_dict())
    x, _ = _batch(7, n=2)
    assert torch.equal(make_predict_step(rem)(x), make_predict_step(plain)(x))
