"""The port's loss (`spnet_tpu_torch/ops/losses.py`) against the JAX
package: the plain twin against `loss_components` / `spnet_loss`, its
gradient, the closed-form gradient `spnet_loss_grad_torch` and the fused
autograd function's CPU path against `jax.grad` of `spnet_loss_pallas`
(interpret mode on the CPU, as tests/test_losses.py runs it), what the
fused function keeps for its backward, the kernel's block count, and what
the wrappers refuse; and the fused function's 'ss' route
(selective_sigmoid=True: the loss of the selective sigmoid of y_pred, the
gradient with respect to y_pred) against the JAX package's Pallas and jnp
compositions.  The kernels themselves run only on the card
(tests/test_torch_losses_cuda.py)."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.ops.activations import selective_sigmoid_jnp, \
    selective_sigmoid_pallas
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.ops.losses import spnet_loss as j_loss
from spnet_tpu.ops.losses import spnet_loss_pallas
from spnet_tpu_torch.config import GridSpec, LossWeights
from spnet_tpu_torch.grid import normalize
from spnet_tpu_torch.ops import losses
from spnet_tpu_torch.ops.activations import SelectiveSigmoid
from spnet_tpu_torch.ops.losses import (
    loss_components,
    loss_blocks,
    spnet_loss,
    spnet_loss_bwd,
    spnet_loss_fused,
    spnet_loss_fwd,
    spnet_loss_grad_torch,
)

W, JW = LossWeights(), JLossWeights()
LOSS_TYPES = ["same", "hybrid"]


def _rand_batch(seed=0, b=4):
    """Normalized targets of plausible grids (objects and empty slots) and
    predictions scattered around them."""
    g = GridSpec()
    rng = np.random.default_rng(seed)
    yt = np.tile(g.defaults.reshape(-1), (b, 1)).astype(np.float32)
    t3 = yt.reshape(b, -1, 8)
    obj = rng.random(t3.shape[:2]) < 0.15
    t3[..., 6] = np.where(obj, 0.0, 1.0)
    t3[..., 7] = np.where(obj, rng.uniform(1, 11, t3.shape[:2]), 0.0)
    t3[..., 0] += rng.normal(0, 20, t3.shape[:2])
    t3[..., 2] = rng.uniform(20, 100, t3.shape[:2])
    t3[..., 3] = rng.uniform(10, 60, t3.shape[:2])
    ytn = normalize(yt.reshape(b, -1), g).astype(np.float32)
    ypn = (ytn + rng.normal(0, 0.3, ytn.shape)).astype(np.float32)
    return ytn, ypn


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_components_match_jax(loss_type):
    """Each component and the total, rel 1e-5 (float32, other summation
    order)."""
    yt, yp = _rand_batch(1)
    ref = jax.jit(lambda a, b: j_components(a, b, JW, loss_type))(yt, yp)
    got = loss_components(torch.from_numpy(yt), torch.from_numpy(yp), W,
                          loss_type)
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5), k
    total = float(jax.jit(lambda a, b: j_loss(a, b, JW, loss_type))(yt, yp))
    assert float(spnet_loss(torch.from_numpy(yt), torch.from_numpy(yp), W,
                            loss_type)) == pytest.approx(total, rel=1e-5)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_gradients_match_jax_pallas(loss_type):
    """The twin's autograd gradient and the fused function's CPU path
    (forward twin, backward `spnet_loss_bwd`) against jax.grad of the
    Pallas loss (custom VJP, interpret mode); rtol 1e-4, atol 1e-6 as in
    tests/test_losses.py."""
    yt, yp = _rand_batch(4, b=5)
    g_ref = np.asarray(jax.jit(jax.grad(
        lambda p, t: spnet_loss_pallas(t, p, JW, loss_type)))(yp, yt))
    v_ref = float(jax.jit(
        lambda t, p: spnet_loss_pallas(t, p, JW, loss_type))(yt, yp))
    t = torch.from_numpy(yt)
    for fn in (spnet_loss, spnet_loss_fused):
        p = torch.from_numpy(yp).requires_grad_(True)
        loss = fn(t, p, W, loss_type)
        assert float(loss.detach()) == pytest.approx(v_ref, rel=1e-5)
        loss.backward()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=1e-4,
                                   atol=1e-6)
    # the upstream gradient scales the backward
    p = torch.from_numpy(yp).requires_grad_(True)
    (3.0 * spnet_loss_fused(t, p, W, loss_type)).backward()
    np.testing.assert_allclose(p.grad.numpy(), 3.0 * g_ref, rtol=1e-4,
                               atol=3e-6)


def test_wrappers_refuse_bad_inputs():
    yt, yp = (torch.from_numpy(a) for a in _rand_batch(2, b=2))
    g = torch.ones(())
    cases = [
        ((yt.double(), yp.double()), TypeError),   # not float32
        ((yt, yp[:, :-8]), ValueError),            # shapes differ
        ((yt[:, :-4], yp[:, :-4]), ValueError),    # M not a multiple of 8
        ((yt[0], yp[0]), ValueError),              # not (B, M)
        ((yt[:0], yp[:0]), ValueError),            # empty batch
        ((yt.t(), yp.t()), ValueError),            # not contiguous
        ((yt.to("meta"), yp), ValueError),         # mixed devices
    ]
    for args, err in cases:
        with pytest.raises(err):
            spnet_loss_fwd(*args)
        with pytest.raises(err):
            spnet_loss_bwd(*args, g)
    with pytest.raises(ValueError, match="loss_type"):
        spnet_loss_fwd(yt, yp, W, "mse")
    with pytest.raises(ValueError, match="g must be"):
        spnet_loss_bwd(yt, yp, torch.ones(2))
    with pytest.raises(ValueError, match="no loss kernel"):
        spnet_loss_fwd(yt.to("meta"), yp.to("meta"))


def test_cpu_calls_launch_nothing():
    yt, yp = (torch.from_numpy(a) for a in _rand_batch(3, b=2))
    f0, b0 = spnet_loss_fwd.launches, spnet_loss_bwd.launches
    p = yp.clone().requires_grad_(True)
    spnet_loss_fused(yt, p).backward()
    spnet_loss_fwd(yt, yp)
    spnet_loss_bwd(yt, yp, torch.ones(()))
    assert (spnet_loss_fwd.launches, spnet_loss_bwd.launches) == (f0, b0)
    assert p.grad is not None and torch.isfinite(p.grad).all()


def _rand_any(seed, b, m):
    """Any (B, M): normal targets with a 0/1 noobj flag on every slot (80 %
    empty) and predictions scattered around them, float32."""
    rng = np.random.default_rng(seed)
    yt = rng.normal(0, 1, (b, m)).astype(np.float32)
    yt.reshape(b, -1, 8)[..., 6] = rng.random((b, m // 8)) < 0.8
    yp = (yt + rng.normal(0, 0.3, (b, m))).astype(np.float32)
    return yt, yp


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("shape", [(5, 576), (3, 8 * 37), (2, 8 * 250)])
def test_grad_torch_matches_jax_pallas(shape, loss_type):
    """The closed-form gradient against jax.grad of the Pallas loss
    (custom VJP, interpret mode), rtol 1e-4 / atol 1e-6 as in
    tests/test_losses.py, at the train width and two ragged ones."""
    yt, yp = _rand_any(sum(shape), *shape)
    g_ref = np.asarray(jax.jit(jax.grad(
        lambda p, t: spnet_loss_pallas(t, p, JW, loss_type)))(yp, yt))
    got = spnet_loss_grad_torch(torch.from_numpy(yt), torch.from_numpy(yp),
                                W, loss_type)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), g_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_fused_cpu_forward_is_the_twin(loss_type):
    t, p = (torch.from_numpy(a) for a in _rand_any(5, 3, 8 * 37))
    p.requires_grad_(True)
    loss = spnet_loss_fused(t, p, W, loss_type)
    assert torch.equal(loss.detach(), spnet_loss(t, p.detach(), W,
                                                 loss_type))


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_fused_backward_scales_the_kept_gradient(loss_type):
    """The forward keeps the closed-form gradient; the backward is that
    times g, exactly."""
    t, p = (torch.from_numpy(a) for a in _rand_any(6, 4, 576))
    p.requires_grad_(True)
    loss = spnet_loss_fused(t, p, W, loss_type)
    kept = spnet_loss_grad_torch(t, p.detach(), W, loss_type)
    assert torch.equal(loss.grad_fn.saved_tensors[0], kept)
    (grad,) = torch.autograd.grad(loss, p, torch.tensor(3.0))
    assert torch.equal(grad, kept * 3.0)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_fused_retain_graph_gives_the_same_gradient_twice(loss_type):
    t, p = (torch.from_numpy(a) for a in _rand_any(7, 2, 8 * 250))
    p.requires_grad_(True)
    loss = 2.0 * spnet_loss_fused(t, p, W, loss_type)
    (first,) = torch.autograd.grad(loss, p, retain_graph=True)
    (second,) = torch.autograd.grad(loss, p)
    assert torch.equal(first, second)
    np.testing.assert_allclose(
        first.numpy(), 2.0 * spnet_loss_grad_torch(t, p.detach(), W,
                                                   loss_type).numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_requires_grad", "requires_grad"])
def test_fused_keeps_a_gradient_only_when_one_is_needed(mode, monkeypatch):
    """The forward computes (and keeps) the gradient only when y_pred
    needs one and autograd records."""
    calls = []
    grad_torch = losses.spnet_loss_grad_torch
    monkeypatch.setattr(losses, "spnet_loss_grad_torch",
                        lambda *a: calls.append(1) or grad_torch(*a))
    t, p = (torch.from_numpy(a) for a in _rand_any(8, 2, 576))
    p.requires_grad_(mode != "no_requires_grad")
    ctx = {"no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}.get(mode)
    if ctx is None:
        loss = spnet_loss_fused(t, p)
    else:
        with ctx():
            loss = spnet_loss_fused(t, p)
    assert len(calls) == (mode == "requires_grad")
    assert (loss.grad_fn is not None) == (mode == "requires_grad")
    assert float(loss.detach()) == float(spnet_loss(t, p.detach()))


@pytest.mark.parametrize("n_slots", [1, 255, 256, 257, 37 * 3, 250 * 5,
                                     72 * 128])
def test_block_count_is_the_kernels_rule(n_slots):
    """The wrapper sizes the loss's partials as the kernel launches its
    blocks: ceil(n_slots / THREADS), THREADS read from csrc/loss.cu."""
    src = (Path(losses.__file__).parent.parent / "csrc" / "loss.cu") \
        .read_text()
    (threads,) = re.findall(r"constexpr int THREADS = (\d+);", src)
    assert losses.LOSS_THREADS == int(threads)
    assert loss_blocks(n_slots) == (n_slots + int(threads) - 1) \
        // int(threads)


# the selective sigmoid's test shapes (tests/test_torch_activations.py)
SS_SHAPES = [(4, 576), (128, 576), (3, 296)]


def _ss_inputs(seed, b, m):
    """Targets as `_rand_any` gives them and head pre-activations z of both
    signs, far enough out that the sigmoid's tails are reached."""
    yt, _ = _rand_any(seed, b, m)
    z = (4.0 * np.random.default_rng(seed + 1).normal(0, 1, (b, m))) \
        .astype(np.float32)
    return yt, z


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("shape", SS_SHAPES)
def test_fused_ss_matches_jax(shape, loss_type):
    """spnet_loss_fused(..., selective_sigmoid=True) on the CPU against the
    JAX package's 'ss' head followed by its loss, twice:
      * Pallas, in interpret mode: spnet_loss_pallas(t,
        selective_sigmoid_pallas(z)); its gradient is the Pallas loss's
        custom VJP taken through the VJP of `selective_sigmoid_jnp` (the
        Pallas sigmoid has no autodiff rule: the JAX model differentiates
        its jnp twin);
      * jnp: jax.value_and_grad of spnet_loss(t, selective_sigmoid_jnp(z)).
    Loss rel 1e-5; gradient rtol 1e-4, atol 1e-6, as
    tests/test_losses.py holds the Pallas loss."""
    yt, z = _ss_inputs(sum(shape), *shape)

    def pallas(z):
        s = selective_sigmoid_pallas(z)
        v, g_s = jax.value_and_grad(
            lambda p: spnet_loss_pallas(yt, p, JW, loss_type))(s)
        return v, jax.vjp(selective_sigmoid_jnp, z)[1](g_s)[0]

    refs = [jax.jit(pallas)(z), jax.jit(jax.value_and_grad(
        lambda z: j_loss(yt, selective_sigmoid_jnp(z), JW, loss_type)))(z)]
    p = torch.from_numpy(z).requires_grad_(True)
    loss = spnet_loss_fused(torch.from_numpy(yt), p, W, loss_type,
                            selective_sigmoid=True)
    (grad,) = torch.autograd.grad(loss, p)
    assert grad.shape == shape and grad.dtype == torch.float32
    for v_ref, g_ref in refs:
        assert float(loss.detach()) == pytest.approx(float(v_ref), rel=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-6)
    # the noobj lane's gradient carries the sigmoid's factor; under
    # 'hybrid' BCE-with-logits reads the sigmoided value (a second sigmoid)
    s = 1.0 / (1.0 + np.exp(-z.astype(np.float64)))
    t6 = yt.reshape(-1, 8)[:, 6]
    s6 = s.reshape(-1, 8)[:, 6]
    d6 = (1.0 / (1.0 + np.exp(-s6)) - t6 if loss_type == "hybrid"
          else 2.0 * (s6 - t6))
    want6 = W.noobj * d6 / yt.size * s6 * (1.0 - s6)
    np.testing.assert_allclose(grad.numpy().reshape(-1, 8)[:, 6], want6,
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_fused_ss_is_the_composition(loss_type):
    """On the CPU the 'ss' route is the parent's composition,
    `SelectiveSigmoid` then the fused loss: the loss bit for bit, the
    gradient bit for bit at g = 1 and within rel 1e-6 at g = 3 (g
    multiplies before the sigmoid's factor there, after it here)."""
    yt, z = (torch.from_numpy(a) for a in _ss_inputs(11, 3, 8 * 37))
    p, q = (z.clone().requires_grad_(True) for _ in range(2))
    fused = spnet_loss_fused(yt, p, W, loss_type, selective_sigmoid=True)
    composed = spnet_loss_fused(yt, SelectiveSigmoid.apply(q), W, loss_type)
    assert torch.equal(fused.detach(), composed.detach())
    for g in (1.0, 3.0):
        (a,) = torch.autograd.grad(fused, p, torch.tensor(g),
                                   retain_graph=True)
        (b,) = torch.autograd.grad(composed, q, torch.tensor(g),
                                   retain_graph=True)
        if g == 1.0:
            assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["no_grad", "requires_grad"])
def test_fused_ss_keeps_a_gradient_only_when_one_is_needed(mode):
    yt, z = (torch.from_numpy(a) for a in _ss_inputs(12, 2, 576))
    p = z.clone().requires_grad_(True)
    if mode == "no_grad":
        with torch.no_grad():
            loss = spnet_loss_fused(yt, p, selective_sigmoid=True)
        assert loss.grad_fn is None
    else:
        loss = spnet_loss_fused(yt, p, selective_sigmoid=True)
        (kept,) = loss.grad_fn.saved_tensors
        assert kept.shape == z.shape
    assert float(loss.detach()) == float(
        spnet_loss(yt, torch.where(torch.arange(576) % 8 == 6,
                                   torch.sigmoid(z), z)))
