"""The port's train mode against the JAX package, in float32 at full width
(every channel count of Xception) on a small frame (64², a 1x1x2048 map
into the head): BatchNorm with batch statistics and its running-stat
update, the whole SPNet loss with the 'reference' L2 term and its
gradient leaf by leaf, and three steps of `make_train_step(indexed=
'epoch')` on the same minibatch indices."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from spnet_tpu.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu.grid import batch_ellipses_to_grid, canonicalize_records, \
    normalize
from spnet_tpu.models.layers import ConvBN as JConvBN
from spnet_tpu.models.layers import SeparableConvBN as JSeparableConvBN
from spnet_tpu.models.spnet import Stem as JStem
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import kernel_l2 as j_kernel_l2
from spnet_tpu.train.steps import make_eval_step as j_make_eval_step
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.models.layers import BatchNorm, ConvBN, SeparableConvBN
from spnet_tpu_torch.models.spnet import Stem, build_model
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import forward_loss, kernel_l2, \
    make_eval_step, make_train_step

torch.set_num_threads(2)
SIZE = 64
CFG = ModelConfig(input_size=SIZE, compute_dtype="float32", dropout_rate=0.0)
W = LossWeights()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng):
    """Non-trivial BN parameters and running statistics."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def _labels(rng, n, grid=GridSpec()):
    recs = []
    for _ in range(n):
        k = int(rng.integers(1, 6))
        a = rng.uniform(12, 90, k)
        raw = np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                        rng.uniform(grid.cy_min, grid.cy_max, k), a,
                        a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
                        rng.uniform(1, 11, k)], axis=1)
        recs.append(canonicalize_records(raw))
    return normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                     grid).astype(np.float32)


#: parameter groups whose update errors are bounded each on its own, so that
#: a fault in a small group (the BN parameters are <1% of the weights) cannot
#: hide in the pooled statistics
PARAM_GROUPS = ("bn", "stem", "backbone", "head")


def _param_group(model, name):
    module = model.get_submodule(name.rsplit(".", 1)[0])
    if isinstance(module, BatchNorm):
        return "bn"
    return {"stem": "stem", "backbone": "backbone",
            "final_output": "head"}[name.split(".", 1)[0]]


def _rel_close(got, want, tol, floor=0.0):
    """max |got - want| <= max(tol * max |want|, floor)."""
    err = np.abs(got - want).max()
    assert err <= max(tol * np.abs(want).max(), floor), (
        err, np.abs(want).max())


@pytest.mark.parametrize("which", ["ConvBN", "SeparableConvBN", "Stem"])
def test_train_mode_batchnorm_matches_flax(which):
    """Output and running statistics after one train-mode call, against
    flax `mutable=['batch_stats']`: biased fast variance for both, momentum
    0.99, eps 1e-3.  float32; 1e-5 covers the summation order."""
    rng = np.random.default_rng(7)
    if which == "ConvBN":
        jm = JConvBN(16, strides=(2, 2), padding="VALID", act=nn.relu,
                     dtype=jnp.float32)
        tm = ConvBN(8, 16, 3, stride=2, padding="VALID", act="relu")
        shape = (3, 13, 11, 8)
    elif which == "SeparableConvBN":
        jm = JSeparableConvBN(24, dtype=jnp.float32)
        tm = SeparableConvBN(8, 24)
        shape = (3, 9, 10, 8)
    else:
        jm = JStem(dtype=jnp.float32, planar=False)
        tm = Stem()
        shape = (3, 18, 18, 1)
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    v = jm.init({"params": jax.random.key(0)}, x, train=False)
    params = _perturb(_np_tree(v["params"]), rng)
    stats = _perturb(_np_tree(v["batch_stats"]), rng)
    ref, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                        train=True, mutable=["batch_stats"])
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    tm.train()
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(params, _np_tree(upd["batch_stats"]), tm)
    got = tm.state_dict()
    moved = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert moved
    for k in moved:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not torch.equal(got[k], flax_to_state_dict(
            params, stats, tm)[k]), f"{k} did not move"


@pytest.fixture(scope="module")
def spnet_setup():
    """Full-width SPNet (float32, dropout 0) with perturbed BN, and a
    seeded uint8 dataset of 8 frames with labels."""
    rng = np.random.default_rng(0)
    jm = jbuild(CFG)
    x_all = rng.integers(0, 256, (8, SIZE, SIZE, 1), dtype=np.uint8)
    y_all = _labels(rng, 8)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), x_all[:1].astype(np.float32))
    params = _perturb(_np_tree(v["params"]), rng)
    stats = _perturb(_np_tree(v["batch_stats"]), rng)
    return jm, params, stats, x_all, y_all


def _torch_model(params, stats):
    model = build_model(CFG)
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return model


def test_spnet_loss_and_gradients_match_jax(spnet_setup):
    """Data loss + 1e-4 * 'reference'-scope L2 and its gradient, leaf by
    leaf (flax_tree_to_torch), in train mode with dropout 0.  Each leaf
    within 1e-4 of its own max: float32 sums in another order through 34
    separable convs and 40 batch-stat BNs.  A few leaves are zero but for
    rounding (a BN bias whose per-channel shift the next BN removes, e.g.
    stem.bn3.bias); both sides must keep those below 1e-6 of the largest
    gradient."""
    jm, params, stats, x_all, y_all = spnet_setup
    x = ((x_all[:4].astype(np.float32) / 255.0 - 0.5) * 2.0)
    y = y_all[:4]

    def loss_fn(p):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.key(1)})
        data = j_components(y, out, W, "same")["total"]
        return data + 1e-4 * j_kernel_l2(p, "reference"), (data, upd)

    (j_loss, (j_data, j_upd)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = _torch_model(params, stats).train()
    names, tparams = zip(*model.named_parameters())
    loss, data = forward_loss(model, torch.from_numpy(x), torch.from_numpy(y),
                              None, W, "same", 1e-4, "reference")
    grads = torch.autograd.grad(loss, tparams)
    assert float(data.detach()) == pytest.approx(float(j_data), rel=1e-5)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    want = flax_tree_to_torch(_np_tree(j_grads), model)
    assert set(want) == set(names)
    floor = 1e-6 * max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in zip(names, grads):
        _rel_close(g.numpy(), want[name].numpy(), 1e-4, floor)
    stats_want = flax_to_state_dict(params, _np_tree(j_upd["batch_stats"]),
                                    model)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _rel_close(v.numpy(), stats_want[k].numpy(), 1e-5)


def test_three_train_steps_match_jax(spnet_setup, monkeypatch):
    """Three steps of the resident-feed train step on the same idx_mat,
    augmentation off, dropout 0, optax Adam under the 1-cycle schedule.

    Losses per step within 1e-4 and BN statistics within 1e-4 of their
    scale.  Parameters are compared in units of the learning rate: Adam's
    step is m_hat / sqrt(v_hat) ~ +-1 times lr wherever |g| >> eps, so
    where a weight's gradient is near zero, or changes sign between steps,
    float32 rounding differences of ~1e-5 in the gradient can move that
    ratio by up to 2 (a flipped sign) per step.  Hence every weight within
    2 * sum(lr) of JAX's (measured max 1.1).  A missing or wrong update moves
    most weights of its leaf by ~1 * sum(lr), so the bulk is bounded too:
    in each leaf the median within 0.05 * sum(lr) and 99% within 0.5 *
    sum(lr) (measured, worst leaf: 0.008 and 0.15); in each group of
    PARAM_GROUPS and pooled over all weights, the median within 0.01 *
    sum(lr) and 99% within 0.1 * sum(lr) (measured, worst group: 0.005 and
    0.058)."""
    jm, params, stats, x_all, y_all = spnet_setup
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
    j_step = j_make_train_step(jm, W, "same", l2_reg=1e-4, augment=False,
                               indexed="epoch", pregather=False)
    j_state, j_losses = j_step(j_state, jnp.asarray(x_all),
                               jnp.asarray(y_all), jnp.asarray(idx_mat),
                               jax.random.key(1))
    j_losses = np.asarray(j_losses)

    model = _torch_model(params, stats)
    sched = onecycle_schedule(lr_max, total)
    state = create_train_state(model, sched, adam_variant="optax")
    step = make_train_step(model, W, "same", l2_reg=1e-4, augment=False)
    gen = torch.Generator().manual_seed(0)
    xt, yt = torch.from_numpy(x_all), torch.from_numpy(y_all)
    losses = []
    for idx in torch.from_numpy(idx_mat).long():
        state, metrics = step(state, xt, yt, idx, gen)
        losses.append(float(metrics["loss"]))
    assert state.step == 3 and state.opt_state.count == 3
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)

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


@pytest.mark.parametrize("scope", ["reference", "all", "none"])
def test_kernel_l2_scopes_match_jax(spnet_setup, scope):
    """Conv and dense kernels only (BN parameters and the Dense bias are
    not kernels); 'reference' covers the stem, backbone conv1 / conv2 /
    block2 and the head."""
    _, params, stats, _, _ = spnet_setup
    model = _torch_model(params, stats)
    want = float(j_kernel_l2(params, scope))
    assert float(kernel_l2(model, scope).detach()) == pytest.approx(
        want, rel=1e-5, abs=0.0)


def test_eval_step_matches_jax(spnet_setup):
    """Eval mode with the running statistics: predictions and component
    losses on uint8 frames, 1e-4 of the output's scale."""
    jm, params, stats, x_all, y_all = spnet_setup

    st = collections.namedtuple("State", "params batch_stats")(params, stats)
    j_out, j_comps = j_make_eval_step(jm)(st, x_all[:4], y_all[:4])
    model = _torch_model(params, stats).train()  # eval_step switches
    out, comps = make_eval_step(model)(torch.from_numpy(x_all[:4]),
                                       torch.from_numpy(y_all[:4]))
    assert not model.training
    j_out = np.asarray(j_out)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0,
                               atol=1e-4 * np.abs(j_out).max())
    for k, v in j_comps.items():
        assert float(comps[k]) == pytest.approx(float(v), rel=1e-4), k
