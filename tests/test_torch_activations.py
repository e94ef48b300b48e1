"""The port's selective sigmoid (`spnet_tpu_torch/ops/activations.py`)
against the JAX package: the plain twin against `selective_sigmoid_jnp`
and against `selective_sigmoid_pallas` (interpret mode on the CPU, as
tests/test_losses.py runs the Pallas loss), the autograd function's
gradient against `jax.grad` of the jnp twin, and what the wrappers
refuse.  The kernels themselves run only on the card
(tests/test_torch_activations_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.ops.activations import selective_sigmoid_jnp, \
    selective_sigmoid_pallas
from spnet_tpu_torch.ops.activations import (
    SelectiveSigmoid,
    selective_sigmoid_bwd,
    selective_sigmoid_fwd,
    selective_sigmoid_grad_torch,
    selective_sigmoid_torch,
)

SHAPES = [(4, 576), (128, 576), (3, 296)]


def _x(shape, seed=0):
    """Head outputs of both signs, some far into the sigmoid's tails."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, shape) * (1 + 4 * (rng.random(shape) < 0.05))
            ).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jnp_and_pallas(shape):
    """rtol 1e-6: the sigmoid of XLA and of torch on the CPU may differ in
    the last ulp; the seven linear lanes are copied exactly."""
    x = _x(shape)
    ref = np.asarray(jax.jit(selective_sigmoid_jnp)(x))
    ref_pallas = np.asarray(jax.jit(selective_sigmoid_pallas)(x))
    np.testing.assert_array_equal(ref_pallas, ref)
    for fn in (selective_sigmoid_torch, selective_sigmoid_fwd):
        out = fn(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
        lin = np.arange(shape[1]) % 8 != 6
        np.testing.assert_array_equal(out[:, lin], x[:, lin])
        noobj = out[:, 6::8]
        assert ((noobj >= 0) & (noobj <= 1)).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax_grad(shape):
    """SelectiveSigmoid's backward (the twin on the CPU) against jax.grad of
    sum(w * selective_sigmoid_jnp(x)) for a seeded w; rtol 1e-6, atol 1e-7
    (the sigmoid's last ulp again)."""
    x = _x(shape, 1)
    w = np.random.default_rng(2).normal(0, 1, shape).astype(np.float32)
    ref = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(w * selective_sigmoid_jnp(x))))(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = SelectiveSigmoid.apply(xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-6, atol=1e-7)
    direct = selective_sigmoid_bwd(y.detach(), torch.from_numpy(w))
    np.testing.assert_array_equal(direct.numpy(), xt.grad.numpy())
    twin = selective_sigmoid_grad_torch(y.detach(), torch.from_numpy(w))
    np.testing.assert_array_equal(twin.numpy(), xt.grad.numpy())


def test_wrappers_refuse_bad_inputs():
    x = torch.from_numpy(_x((2, 64)))
    cases = [
        (x.double(), TypeError),          # not float32
        (x[:, :-4].contiguous(), ValueError),  # M not a multiple of 8
        (x[0], ValueError),               # not (B, M)
        (x[:0], ValueError),              # empty batch
        (x.t(), ValueError),              # not contiguous
        (x.to("meta"), ValueError),       # no kernel for this device
    ]
    for bad, err in cases:
        with pytest.raises(err):
            selective_sigmoid_fwd(bad)
        with pytest.raises(err):
            selective_sigmoid_bwd(bad, bad)
    with pytest.raises(ValueError, match="same"):
        selective_sigmoid_bwd(x, x[:, :-8].contiguous())
    with pytest.raises(ValueError, match="meta"):
        selective_sigmoid_bwd(x, x.to("meta"))
    with pytest.raises(TypeError):
        selective_sigmoid_bwd(x, x.double())


def test_cpu_calls_launch_nothing():
    f0, b0 = selective_sigmoid_fwd.launches, selective_sigmoid_bwd.launches
    x = torch.from_numpy(_x((2, 64))).requires_grad_(True)
    SelectiveSigmoid.apply(x).sum().backward()
    selective_sigmoid_fwd(x.detach())
    selective_sigmoid_bwd(x.detach(), x.detach())
    assert (selective_sigmoid_fwd.launches,
            selective_sigmoid_bwd.launches) == (f0, b0)
    assert x.grad is not None and torch.isfinite(x.grad).all()
