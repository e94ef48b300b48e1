"""The port's other backbones (`spnet_tpu_torch/models/darknet.py`,
`inception_resnet_v2.py`, `nasnet.py`) against the JAX package: SPNet of
each at full width in eval mode, the head's width at 331, the backbone's
size, the Keras init's fans, the freeze labels and the L2 scope, and one
test per layer a straightforward port gets wrong (the pools, strided 5x5
and 7x7 SAME sepconvs, DarkNet's space-to-depth order, NASNet's
factorized reduction, ConvBN with and without gamma).  The train step and
the CLI are in `test_torch_backbones_train.py`.

Weights: the JAX model's variable shapes (`jax.eval_shape`, no init
program) filled from numpy seeds, kernels with the Keras glorot limits of
their flax fans, BN parameters and running statistics away from the
identity; converted with `flax_to_state_dict`."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models import nasnet as jnasnet
from spnet_tpu.models.darknet import _space_to_depth_2 as j_s2d
from spnet_tpu.models.layers import ConvBN as JConvBN
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.state import backbone_freeze_labels as j_labels
from spnet_tpu.train.steps import _l2_in_scope as j_l2_in_scope
from spnet_tpu_torch.config import ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.models import layers
from spnet_tpu_torch.models.darknet import DarkNet19, space_to_depth_2
from spnet_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
from spnet_tpu_torch.models.layers import BatchNorm, ConvBN
from spnet_tpu_torch.models.nasnet import Adjust, NASNetMobile, SepBlock
from spnet_tpu_torch.models.spnet import SPNet, build_model
from spnet_tpu_torch.train.state import backbone_freeze_labels
from spnet_tpu_torch.train.steps import _l2_in_scope, kernel_names

torch.set_num_threads(2)
BACKBONES = ["DarkNet19", "InceptionResNetV2", "NASNetMobile"]
#: the smallest inputs of the JAX package's own tests (tests/test_models.py):
#: DarkNet19 4x4x1280 into the head, InceptionResNetV2 (backbone input 80,
#: the least is 75) 1x1x1536, NASNetMobile 3x3x1056
SIZES = {"DarkNet19": 128, "InceptionResNetV2": 160, "NASNetMobile": 96}


def _cfg(backbone, config=ModelConfig, size=None, **kw):
    """The port's ModelConfig (config=JModelConfig: the JAX package's)."""
    return config(backbone=backbone, input_size=size or SIZES[backbone],
                  compute_dtype="float32", dropout_rate=0.0, **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fans(shape):
    """flax `variance_scaling`'s fans of a kernel (in_axis -2, out_axis
    -1, the rest the receptive field)."""
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def fill(tree, rng):
    """numpy values for a tree of shapes: kernels U(-l, l) with the Keras
    glorot limit of their flax fans, biases N(0, 0.1), BN scales U(0.8,
    1.2), running means N(0, 0.1) and variances U(0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = fill(v, rng)
        elif k == "kernel":
            lim = math.sqrt(6.0 / sum(_fans(v.shape)))
            out[k] = rng.uniform(-lim, lim, v.shape)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, v.shape)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, v.shape)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape)
        else:
            raise KeyError(k)
        if not isinstance(v, dict):
            out[k] = out[k].astype(np.float32)
    return out


def variables(module, x_shape, rng, **kw):
    """(params, batch_stats) of a flax module for inputs of x_shape."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.key(0),
                             "dropout": jax.random.key(0)},
                            jnp.zeros(x_shape), **kw))
    return (fill(shapes["params"], rng),
            fill(shapes.get("batch_stats", {}), rng))


@functools.lru_cache(maxsize=None)
def jax_shapes(backbone, size=None):
    """The JAX SPNet of `backbone` at `size` (default SIZES) and its
    variables' shapes."""
    size = size or SIZES[backbone]
    jm = jbuild(_cfg(backbone, JModelConfig, size=size))
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(0)},
                        jnp.zeros((1, size, size, 1)), train=False))
    return jm, shapes


@functools.lru_cache(maxsize=None)
def setup(backbone):
    """The JAX SPNet of `backbone`, its variables and 2 seeded frames."""
    rng = np.random.default_rng(BACKBONES.index(backbone))
    size = SIZES[backbone]
    jm, shapes = jax_shapes(backbone)
    params, stats = fill(shapes["params"], rng), fill(shapes["batch_stats"],
                                                      rng)
    x = rng.normal(0, 1, (2, size, size, 1)).astype(np.float32)
    return jm, params, stats, x


def torch_model(backbone, params, stats, **kw):
    model = build_model(_cfg(backbone, **kw), device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return model


@pytest.mark.parametrize("backbone", BACKBONES)
def test_eval_matches_jax(backbone):
    """SPNet at full width, float32, eval, b=2: 1e-4 of the output's
    scale, as for Xception (tests/test_torch_models.py).  Every flax leaf
    lands on the port's state dict: NASNet's (k, k, 1, C) `sep*_dw`
    kernels, Inception-ResNet-v2's `up` biases and its BNs without a
    scale."""
    jm, params, stats, x = setup(backbone)
    y_jax = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                x, train=False))
    model = torch_model(backbone, params, stats)
    with torch.inference_mode():
        y = model(torch.from_numpy(x)).numpy()
    assert y.shape == y_jax.shape == (2, 576)
    scale = np.abs(y_jax).max()
    assert np.isfinite(y).all() and scale > 0.1
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("backbone,n_in", [
    ("DarkNet19", 5 * 5 * 1280), ("InceptionResNetV2", 3 * 3 * 1536),
    ("NASNetMobile", 6 * 6 * 1056)])
def test_head_width_at_331_matches_jax(backbone, n_in):
    """At 331 (165² into the backbone) the head reads DarkNet's 5x5x1280
    (165 -> 82 -> 41 -> 20 -> 10 -> 5, the passthrough's 10² through
    space-to-depth), Inception-ResNet-v2's 3x3x1536 (-> 82 -> 80 -> 39 ->
    37 -> 18 -> 8 -> 3) and NASNet's 6x6x1056 (stem 82 -> 41 -> 21 -> 11
    -> 6): JAX's head kernel, read through `jax.eval_shape`."""
    _, shapes = jax_shapes(backbone, 331)
    assert shapes["params"]["final_output"]["kernel"].shape == (n_in, 576)
    with torch.device("meta"):
        model = SPNet(backbone=backbone)
        split = SPNet(backbone=backbone, compound_head=True)
    assert model.final_output.in_features == n_in
    assert split.sigmoid_output.in_features == n_in


#: parameters + BN statistics at a 160 input (Keras's counts for the two
#: Keras applications, tests/test_models.py)
COUNTS = {"DarkNet19": 38_747_360, "InceptionResNetV2": 54_336_736,
          "NASNetMobile": 4_269_716}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_backbone_size_matches_jax(backbone):
    """The backbone's variables, parameters and running statistics, number
    JAX's at a backbone input of 160."""
    from spnet_tpu.models.spnet import _backbone_ctor

    cls, kw, _ = _backbone_ctor(backbone, dtype=jnp.float32)
    v = jax.eval_shape(lambda: cls(**kw).init(
        jax.random.key(0), jnp.zeros((1, 160, 160, 3)), train=False))
    n_jax = sum(math.prod(a.shape) for a in jax.tree_util.tree_leaves(v))
    port = {"DarkNet19": DarkNet19, "InceptionResNetV2": InceptionResNetV2,
            "NASNetMobile": functools.partial(NASNetMobile,
                                              input_hw=(160, 160))}
    with torch.device("meta"):
        n = sum(t.numel() for t in port[backbone]().state_dict().values())
    assert n == n_jax == COUNTS[backbone]


@pytest.mark.parametrize("backbone", BACKBONES)
def test_keras_init_uses_flax_fans(backbone):
    """`init_keras_` draws every kernel from U(-l, l) with l from the fans
    of its FLAX-shaped leaf (a depthwise (k, k, 1, C) kernel: k² and k²·C),
    zeroes every bias (Inception-ResNet-v2's `up`), and starts each BN at
    the identity; leaf by leaf against the JAX model's shapes."""
    _, shapes = jax_shapes(backbone)
    limits = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, math.sqrt(6.0 / sum(_fans(s.shape)))
                             if p[-1].key == "kernel" else np.nan,
                             np.float32), shapes["params"])
    model = build_model(_cfg(backbone), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    params = dict(model.named_parameters())
    want = flax_tree_to_torch(limits, model)
    kernels = set(kernel_names(model))
    n_bias = 0
    for name, lim in want.items():
        w = params[name].detach()
        if name in kernels:
            lim = lim.flatten()[0].item()
            assert w.abs().max() <= lim and w.abs().max() > 0.5 * lim, name
        elif name.endswith(".weight"):  # BN scale
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            n_bias += name.endswith("up.bias")
            assert torch.equal(w, torch.zeros_like(w)), name
    assert n_bias == (40 if backbone == "InceptionResNetV2" else 0)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert (m.running_var == 1).all() and (m.running_mean == 0).all()


@pytest.mark.parametrize("backbone", BACKBONES)
def test_freeze_labels_match_jax(backbone):
    """freeze_fac 0.5, leaf by leaf from JAX's label tree, with the
    backbone's own order.  NASNet's `LAYER_ORDER` names `stem_conv` and
    not `stem_bn`, so its stem BN trains in both packages."""
    jm, shapes = jax_shapes(backbone)
    labels = j_labels(shapes["params"], jm.backbone_layer_order(), 0.5)
    flags = jax.tree_util.tree_map(
        lambda lab, s: np.full(s.shape, lab == "frozen", np.float32),
        labels, shapes["params"])
    model = build_model(_cfg(backbone), device="cpu")
    assert model.backbone_layer_order() == list(jm.backbone_layer_order())
    want = {n: "frozen" if v.numpy().all() else "train"
            for n, v in flax_tree_to_torch(flags, model).items()}
    got = backbone_freeze_labels(model, model.backbone_layer_order(), 0.5)
    assert got == want
    frozen = {n.split(".")[1] for n, v in got.items() if v == "frozen"}
    order = model.backbone_layer_order()
    assert frozen == set(order[:len(order) // 2])
    if backbone == "NASNetMobile":
        assert got["backbone.stem_bn.weight"] == "train"
        assert got["backbone.stem_conv.weight"] == "frozen"


@pytest.mark.parametrize("backbone", BACKBONES)
def test_l2_scope_matches_jax(backbone):
    """The kernels in the 'reference' L2 scope are JAX's `_l2_in_scope`
    set: the stem and the head, and DarkNet's `conv1` and `conv2`; the
    other two backbones add nothing (NASNet's cell `conv1`s sit a level
    deeper)."""
    _, shapes = jax_shapes(backbone)
    flags = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, j_l2_in_scope(p, "reference"),
                             np.float32), shapes["params"])
    model = build_model(_cfg(backbone), device="cpu")
    want = {n for n, v in flax_tree_to_torch(flags, model).items()
            if v.numpy().all()}
    got = {n for n in kernel_names(model) if _l2_in_scope(n, "reference")}
    assert got == want
    in_backbone = {n for n in got if n.startswith("backbone.")}
    assert in_backbone == ({"backbone.conv1.conv.weight",
                            "backbone.conv2.conv.weight"}
                           if backbone == "DarkNet19" else set())


# ---- layers ----------------------------------------------------------------

def _nhwc(rng, shape):
    return rng.normal(0.2, 1.0, shape).astype(np.float32)


POOLS = {
    # name: (port, flax)
    "max2_valid": (lambda x: layers.max_pool_valid(x, 2, 2),
                   lambda x: nn.max_pool(x, (2, 2), strides=(2, 2))),
    "max3_valid": (lambda x: layers.max_pool_valid(x, 3, 2),
                   lambda x: nn.max_pool(x, (3, 3), strides=(2, 2))),
    "avg3_same": (layers.avg_pool3_same, jnasnet._avg3),
    "max3_padded": (layers.max_pool3_padded, jnasnet._max3_padded),
    "avg3_padded": (layers.avg_pool3_padded, jnasnet._avg3_padded),
}


@pytest.mark.parametrize("size", [11, 12])
@pytest.mark.parametrize("pool", list(POOLS))
def test_pools_match_flax(pool, size):
    """DarkNet's and Inception-ResNet-v2's VALID max pools (flax's default
    padding), the stride-1 SAME average that divides an edge window by its
    real cells (C16), and NASNet's zero pad + VALID 3x3/2 pools whose zeros
    count (C17), at an odd and an even size; float32, within 1e-6.  The
    inputs are mostly negative, so a -inf pad or a pad left out of the
    average would show."""
    port, ref = POOLS[pool]
    x = np.random.default_rng(size).normal(-1.0, 1.0, (2, size, size, 5)
                                           ).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _state_matches(tm, params, upd, atol=1e-6):
    want = flax_to_state_dict(params, _np_tree(upd["batch_stats"]), tm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("size", [11, 12])
@pytest.mark.parametrize("kernel", [5, 7])
def test_strided_sepblock_matches_flax(kernel, size):
    """NASNet's separable block at stride 2 (relu -> depthwise k/2 -> 1x1
    -> BN -> relu -> depthwise k -> 1x1 -> BN): TF SAME pads an even size
    by (k//2 - 1, k//2), not symmetrically (C13), an odd one by k//2.  Eval
    and train mode (output, and the running statistics moved with momentum
    0.9997, C18), float32, within 1e-5."""
    rng = np.random.default_rng(kernel * size)
    jm = jnasnet.SepBlock(12, kernel, 2)
    tm = SepBlock(8, 12, kernel, 2)
    x = _nhwc(rng, (3, size, size, 8))
    params, stats = variables(jm, x.shape, rng)
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x))
    assert ref.shape == (3, 6, 6, 12)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    ref, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                        train=True, mutable=["batch_stats"])
    out = tm.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    _state_matches(tm, params, upd)
    assert tm.bn1.momentum == 0.9997
    moved = (tm.bn1.running_mean - torch.from_numpy(
        stats["bn1"]["mean"])).abs().max().item()
    assert 0 < moved < 1e-3  # 0.0003 of the batch mean


def test_space_to_depth_matches_jax_order():
    """DarkNet's passthrough: output channel (dy * 2 + dx) * C + c, JAX's
    order, bitwise; `F.pixel_unshuffle` orders c * 4 + dy * 2 + dx, which
    would scramble the converted conv20 -> head kernel."""
    x = np.random.default_rng(0).normal(size=(2, 6, 4, 3)).astype(
        np.float32)
    want = np.asarray(j_s2d(jnp.asarray(x)))
    got = space_to_depth_2(torch.from_numpy(x))
    assert got.shape == (2, 3, 2, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 1, 0, 3 * 3 + 2].item(),
                                  x[0, 3, 1, 2])  # dy=1, dx=1, c=2
    unshuffled = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not torch.equal(unshuffled, got)


@pytest.mark.parametrize("mode,p_size", [("reduce", 11), ("reduce", 12),
                                         ("project", 6)])
def test_adjust_matches_flax(mode, p_size):
    """NASNet's `Adjust`: on a spatial mismatch the factorized reduction
    (relu; p[::2, ::2] and the (0, 1)-padded p[1::2, 1::2], each through a
    1x1 conv of filters // 2; BN), at an odd size too, where the padded
    branch reads the pad; on a channel mismatch the 1x1 projection; in
    eval and train mode, float32, within 1e-5."""
    rng = np.random.default_rng(p_size)
    p = _nhwc(rng, (3, p_size, p_size, 10))
    ip = _nhwc(rng, (3, 6, 6, 7))
    jm = jnasnet.Adjust(16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), p, ip))
    params, stats = fill(shapes["params"], rng), fill(
        shapes["batch_stats"], rng)
    assert Adjust.plan((p_size, 10), (6, 7), 16) == (mode, 16)
    tm = Adjust(mode, 10, 16)
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    v = {"params": params, "batch_stats": stats}
    ref = np.asarray(jm.apply(v, p, ip))
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(p), torch.from_numpy(ip)).numpy()
    assert out.shape == ref.shape == (3, 6, 6, 16)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ref, upd = jm.apply(v, p, ip, train=True, mutable=["batch_stats"])
    out = tm.train()(torch.from_numpy(p), torch.from_numpy(ip))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    _state_matches(tm, params, upd)
    assert Adjust.plan(None, (6, 7), 16) == ("none", 7)
    assert Adjust.plan((6, 16), (6, 7), 16) == ("pass", 16)


@pytest.mark.parametrize("kernel,padding,bn_scale", [
    ((1, 7), "SAME", False), ((7, 1), "SAME", False),
    ((3, 3), "VALID", False), ((3, 1), "VALID", True)])
def test_conv_bn_variants_match_flax(kernel, padding, bn_scale):
    """ConvBN with Inception-ResNet-v2's non-square and VALID kernels and
    gamma-less BN (no `weight` at all, so no leaf is missing), and with a
    gamma; eval and train mode with the running statistics, float32,
    within 1e-5."""
    rng = np.random.default_rng(kernel[0] * 10 + kernel[1])
    jm = JConvBN(12, kernel, padding=padding, act=nn.relu,
                 bn_scale=bn_scale, dtype=jnp.float32)
    tm = ConvBN(6, 12, kernel, padding=padding, act="relu",
                bn_scale=bn_scale)
    x = _nhwc(rng, (2, 9, 8, 6))
    params, stats = variables(jm, x.shape, rng)
    assert ("scale" in params["bn"]) == bn_scale == (tm.bn.weight
                                                     is not None)
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    v = {"params": params, "batch_stats": stats}
    ref = np.asarray(jm.apply(v, x))
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ref, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    out = tm.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    _state_matches(tm, params, upd)

