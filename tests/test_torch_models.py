"""Port of the model (`spnet_tpu_torch/models`, `convert.py`) against the
JAX package: full-width SPNet Xception with converted weights, the stem,
the SAME max-pool, the head's flatten order, the Keras initializer's fans,
train-mode dropout and separable convs, and what `build_model` refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from spnet_tpu.config import ModelConfig
from spnet_tpu.models.spnet import Stem as JStem, build_model as jbuild
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.models.layers import Dropout, SeparableConvBN, \
    init_keras_, max_pool_same
from spnet_tpu_torch.models.spnet import SPNet, Stem, build_model

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng):
    """Non-trivial BN parameters and running stats, so no fold is the
    identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        elif k == "bias":
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def _jax_variables(module, x, rng):
    v = jax.jit(lambda k, x: module.init({"params": k, "dropout": k}, x,
                                         train=False))(jax.random.key(0), x)
    return (_perturb(_np_tree(v["params"]), rng),
            _perturb(_np_tree(v["batch_stats"]), rng))


def test_spnet_xception_full_width_matches_jax():
    """Converted weights, float32, eval: 34 separable convs plus the stem,
    shortcuts and head; 1e-4 of the output's scale covers the different
    summation orders (measured ~5e-7)."""
    cfg = ModelConfig(input_size=144, compute_dtype="float32")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 144, 144, 1)).astype(np.float32)
    jm = jbuild(cfg)
    params, stats = _jax_variables(jm, x, rng)
    y_jax = np.asarray(jax.jit(
        lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x,
                                 train=False))(params, stats, x))

    tm = build_model(cfg)
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    with torch.inference_mode():
        y = tm(torch.from_numpy(x)).numpy()
    assert y.shape == y_jax.shape == (2, 576)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("size", [33, 32])
def test_stem_matches_jax_nhwc_stem(size):
    """Colorizer conv, 2x2 avg-pool (an odd row/column is cropped), BN +
    leaky ReLU, and the pooled 1-channel skip broadcast to 3 channels."""
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, 1)).astype(np.float32)
    js = JStem(dtype=jnp.float32, planar=False)
    params, stats = _jax_variables(js, x, rng)
    ref = np.asarray(js.apply({"params": params, "batch_stats": stats}, x))
    stem = Stem().eval()
    stem.load_state_dict(flax_to_state_dict(params, stats, stem))
    with torch.inference_mode():
        out = stem(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, size // 2, size // 2, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [10, 9, 5, 2])
def test_max_pool_same_matches_flax(size):
    """TF SAME pads an even size by (0, 1) with -inf, so
    MaxPool2d(padding=1) would be wrong there."""
    rng = np.random.default_rng(size)
    x = rng.normal(-1, 1, (2, size, size + 1, 4)).astype(np.float32)
    ref = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                 padding="SAME"))
    out = max_pool_same(torch.from_numpy(x), 3, 2).numpy()
    np.testing.assert_array_equal(out, ref)
    if size % 2 == 0 and size > 2:  # at 2 the window covers everything
        sym = torch.nn.functional.max_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1,
        ).permute(0, 2, 3, 1).numpy()
        assert sym.shape != ref.shape or not np.array_equal(sym, ref)


def test_head_flattens_nhwc():
    """The head reads the backbone's (B, h, w, 2048) map in NHWC order,
    so a flax (h*w*2048, 576) kernel converts by a transpose alone."""
    rng = np.random.default_rng(1)
    model = SPNet(input_hw=(96, 96), dtype=torch.float32).eval()
    feat = rng.normal(0, 1, (2, 2, 2, 2048)).astype(np.float32)
    kernel = rng.normal(0, 0.01, (2 * 2 * 2048, 576)).astype(np.float32)
    bias = rng.normal(0, 0.1, 576).astype(np.float32)

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return torch.from_numpy(feat)

    model.backbone = Fixed()
    with torch.no_grad():
        model.final_output.weight.copy_(torch.from_numpy(kernel.T))
        model.final_output.bias.copy_(torch.from_numpy(bias))
        out = model(torch.zeros(2, 96, 96, 1)).numpy()
    want = feat.reshape(2, -1) @ kernel + bias
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    nchw = feat.transpose(0, 3, 1, 2).reshape(2, -1) @ kernel + bias
    assert np.abs(out - nchw).max() > 1e-2


def test_keras_init_uses_flax_fans():
    """glorot_uniform on the FLAX shapes: a depthwise (3, 3, 1, C) kernel
    has fan_in 9 and fan_out 9*C (torch's own fans for (C, 1, 3, 3)
    differ); pointwise (1, 1, C, F) has C and F."""
    model = build_model(ModelConfig(input_size=96),
                        generator=torch.Generator().manual_seed(3))
    sep = model.backbone.block2.sep1
    c, f = 64, 128
    for w, lim in ((sep.depthwise.weight, np.sqrt(6 / (9 + 9 * c))),
                   (sep.pointwise.weight, np.sqrt(6 / (c + f))),
                   (model.backbone.conv1.conv.weight,
                    np.sqrt(6 / (3 * 9 + 32 * 9)))):
        w = w.detach().numpy()
        assert np.abs(w).max() <= lim
        assert np.abs(w).max() > 0.95 * lim
        # uniform(-l, l) has std l / sqrt(3)
        assert abs(w.std() - lim / np.sqrt(3)) < 0.1 * lim
    g1 = build_model(ModelConfig(input_size=96),
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(g1.final_output.weight, model.final_output.weight)


@pytest.mark.parametrize("field,value", [
    ("backbone", "InceptionResNetV2"), ("backbone", "NASNetMobile"),
    ("backbone", "DarkNet19"), ("stem_planar", True),
    ("stem_fused", True), ("remat", True),
])
def test_build_model_refuses_unported_options(field, value):
    with pytest.raises(NotImplementedError, match=field):
        build_model(ModelConfig(input_size=96, **{field: value}))


def test_train_mode_dropout_draws_from_the_generator():
    """flax Dropout in train mode: kept values scaled by 1 / (1 - rate),
    the rest zero, the mask from the generator passed in (the same seed,
    the same mask; none at all is an error); the identity in eval mode."""
    drop = Dropout(0.25).train()
    x = torch.rand(4, 16, 16, 3) + 0.5
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    a = drop(x, torch.Generator().manual_seed(1))
    b = drop(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.75)
    assert abs(1 - kept.float().mean().item() - 0.25) < 0.03
    assert torch.equal(drop.eval()(x), x)
    model = SPNet(input_hw=(64, 64), dtype=torch.float32)
    assert model.stem_dropout.rate == 0.1
    assert model.backbone_layer_order()[:2] == ["conv1", "conv2"]


def test_separable_conv_train_mode_composition():
    """Train mode runs depthwise -> pointwise -> batch-stat BN -> ReLU
    through autograd and gives gradients to both kernels; eval mode after
    it uses the updated running statistics."""
    layer = init_keras_(SeparableConvBN(8, 8, act="relu"),
                        torch.Generator().manual_seed(1)).train()
    x = torch.randn(2, 5, 5, 8, generator=torch.Generator().manual_seed(0))
    y = layer(x)
    assert (y >= 0).all()
    # batch statistics: the pre-ReLU output is normalized per channel
    z = layer.bn(torch.matmul(torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2),
        layer.depthwise.weight.permute(2, 0, 1).unsqueeze(1), padding=1,
        groups=8).permute(0, 2, 3, 1), layer.pointwise.weight))
    torch.testing.assert_close(y, torch.relu(z))
    y.sum().backward()
    assert layer.depthwise.weight.grad.abs().sum() > 0
    assert layer.pointwise.weight.grad.abs().sum() > 0
    assert not torch.equal(layer.bn.running_var, torch.ones(8))
    with torch.no_grad():
        layer.eval()(x)


def test_convert_reports_leftover_and_missing_leaves():
    stem = Stem()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, 8, 8, 1)).astype(np.float32)
    params, stats = _jax_variables(JStem(dtype=jnp.float32, planar=False),
                                   x, rng)
    extra = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        flax_to_state_dict(extra, stats, stem)
    missing = {k: v for k, v in params.items() if k != "bn3"}
    with pytest.raises(ValueError, match="bn3.weight"):
        flax_to_state_dict(missing, stats, stem)
