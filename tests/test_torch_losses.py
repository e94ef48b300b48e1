"""The port's loss (`spnet_tpu_torch/ops/losses.py`) against the JAX
package: the plain twin against `loss_components` / `spnet_loss`, its
gradient, the closed-form gradient `spnet_loss_grad_torch` and the fused
autograd function's CPU path against `jax.grad` of `spnet_loss_pallas`
(interpret mode on the CPU, as tests/test_losses.py runs it), what the
fused function keeps for its backward, the kernel's block count, and what
the wrappers refuse.  The kernels themselves run only on the card
(tests/test_torch_losses_cuda.py)."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.ops.losses import spnet_loss as j_loss
from spnet_tpu.ops.losses import spnet_loss_pallas
from spnet_tpu_torch.config import GridSpec, LossWeights
from spnet_tpu_torch.grid import normalize
from spnet_tpu_torch.ops import losses
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
