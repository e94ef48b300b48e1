"""The port's MobileNet backbone family (`spnet_tpu_torch/models/
mobilenet.py`) against the JAX package: full-width MobileNet in eval, the
strided TF-SAME separable and plain convs, the backbone's size, the head's
width and the freeze order taken from the backbone, a MobileNetTiny train
step, the L2 scope and freeze labels, and the CLI end to end."""

import collections
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from PIL import Image

from spnet_tpu.config import GridSpec, LossWeights, ModelConfig
from spnet_tpu.data.csvio import write_meta_file
from spnet_tpu.grid import batch_ellipses_to_grid, canonicalize_records, \
    normalize
from spnet_tpu.models.layers import ConvBN as JConvBN
from spnet_tpu.models.layers import SeparableConvBN as JSeparableConvBN
from spnet_tpu.models.mobilenet import relu6
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import backbone_freeze_labels as j_labels
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import _l2_in_scope as j_l2_in_scope
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.io.checkpoint import load_checkpoint
from spnet_tpu_torch.models.layers import ConvBN, SeparableConvBN
from spnet_tpu_torch.models.mobilenet import MobileNet
from spnet_tpu_torch.models.spnet import SPNet, build_model
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import backbone_freeze_labels, \
    create_train_state
from spnet_tpu_torch.train.steps import _l2_in_scope, kernel_names, \
    make_train_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = LossWeights()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng, kernel_gain=1.0):
    """Non-trivial BN parameters and running statistics; kernels scaled by
    kernel_gain, so that activations keep their size through MobileNet's
    14 layers in eval mode."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, kernel_gain)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        else:
            out[k] = (kernel_gain * v).astype(np.float32)
    return out


def _variables(module, x, rng, kernel_gain=1.0, **init_kw):
    v = jax.jit(lambda k, x: module.init({"params": k, "dropout": k}, x,
                                         train=False, **init_kw))(
        jax.random.key(0), x)
    return (_perturb(_np_tree(v["params"]), rng, kernel_gain),
            _perturb(_np_tree(v["batch_stats"]), rng))


def test_mobilenet_full_width_matches_jax():
    """SPNet MobileNet (width_mult 1.0), float32, eval, input 96 (48² after
    the stem, a 2x2x1024 map into the head): 1e-4 of the output's scale, as
    for Xception (tests/test_torch_models.py)."""
    cfg = ModelConfig(backbone="MobileNet", input_size=96,
                      compute_dtype="float32")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 96, 96, 1)).astype(np.float32)
    jm = jbuild(cfg)
    params, stats = _variables(jm, x, rng, kernel_gain=2.0)
    y_jax = np.asarray(jax.jit(
        lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x,
                                 train=False))(params, stats, x))
    tm = build_model(cfg)
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    with torch.inference_mode():
        y = tm(torch.from_numpy(x)).numpy()
    assert y.shape == y_jax.shape == (2, 576)
    scale = np.abs(y_jax).max()
    assert scale > 1.0
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("layer", ["separable", "conv"])
@pytest.mark.parametrize("size", [12, 11])
def test_strided_same_layers_match_flax(layer, size):
    """Stride 2 under TF SAME pads an even size by (0, 1) (12 -> 6), not by
    (1, 1), and an odd one by (1, 1) (11 -> 6).  MobileNet's separable block
    (depthwise /2 -> BN 'bn_dw' -> ReLU6 -> pointwise -> BN -> ReLU6) and
    its stem conv, in eval and in train mode (output and running stats),
    float32: within 1e-5 (measured ~2e-6)."""
    rng = np.random.default_rng(size)
    if layer == "separable":
        jm = JSeparableConvBN(16, strides=(2, 2), act=relu6, bn_between=True,
                              dtype=jnp.float32)
        tm = SeparableConvBN(8, 16, stride=2, act="relu6", bn_between=True)
    else:
        jm = JConvBN(16, strides=(2, 2), act=relu6, dtype=jnp.float32)
        tm = ConvBN(8, 16, 3, stride=2, act="relu6")
    x = rng.normal(0.3, 1.2, (3, size, size, 8)).astype(np.float32)
    params, stats = _variables(jm, x, rng, kernel_gain=3.0)
    tm.load_state_dict(flax_to_state_dict(params, stats, tm))
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x))
    assert ref.shape == (3, 6, 6, 16) and ref.max() == 6.0  # ReLU6 clips
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    ref, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                        train=True, mutable=["batch_stats"])
    out = tm.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(params, _np_tree(upd["batch_stats"]), tm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if layer == "separable" and size % 2 == 0:  # symmetric pads differ
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            tm.depthwise.weight.detach().permute(2, 0, 1).unsqueeze(1),
            stride=2, padding=1, groups=8).permute(0, 2, 3, 1)
        dw = nn.Conv(8, (3, 3), strides=(2, 2), padding="SAME",
                     feature_group_count=8, use_bias=False,
                     dtype=jnp.float32).apply(
            {"params": {"kernel": params["depthwise"]["kernel"]}}, x)
        assert np.abs(sym.numpy() - np.asarray(dw)).max() > 1e-2


def test_backbone_size_and_head_width():
    """The backbone's variables (parameters + BN statistics) number the JAX
    package's pinned 3,228,864 (= Keras's count, tests/test_models.py), and
    at 331 the head reads a 6x6 map: 165 -> 83 -> 42 -> 21 -> 11 -> 6."""
    assert sum(v.numel() for v in MobileNet().state_dict().values()) \
        == 3_228_864
    assert MobileNet.output_hw(165, 165) == (6, 6)
    assert MobileNet(width_mult=0.125).FEATURES == 128
    with torch.device("meta"):
        for backbone, n_in in (("Xception", 5 * 5 * 2048),
                               ("MobileNet", 6 * 6 * 1024),
                               ("MobileNetTiny", 6 * 6 * 128)):
            model = SPNet(backbone=backbone)
            assert model.final_output.in_features == n_in, backbone
            split = SPNet(backbone=backbone, compound_head=True)
            assert (split.sigmoid_output.in_features,
                    split.sigmoid_output.out_features,
                    split.dense_output.out_features) == (n_in, 72, 504)


def _shapes(cfg, size):
    jm = jbuild(cfg)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0),
                         "dropout": jax.random.key(0)},
                        jnp.zeros((1, size, size, 1)), train=False))["params"]
    return jm, shapes


@pytest.mark.parametrize("backbone", ["MobileNet", "MobileNetTiny"])
def test_freeze_labels_match_jax(backbone):
    """freeze_fac 0.5: 7 of MobileNet's 14 top-level blocks (conv1,
    block1..6) frozen, stem and head never, mapped leaf by leaf from the
    JAX label tree; the order is the backbone's own, not Xception's."""
    cfg = ModelConfig(backbone=backbone, input_size=64,
                      compute_dtype="float32")
    jm, shapes = _shapes(cfg, 64)
    labels = j_labels(shapes, jm.backbone_layer_order(), 0.5)
    flags = jax.tree_util.tree_map(
        lambda lab, s: np.full(s.shape, lab == "frozen", np.float32),
        labels, shapes)
    model = build_model(cfg)
    assert model.backbone_layer_order() == list(jm.backbone_layer_order())
    assert model.backbone_layer_order()[:2] == ["conv1", "block1"]
    want = {n: "frozen" if v.numpy().all() else "train"
            for n, v in flax_tree_to_torch(flags, model).items()}
    got = backbone_freeze_labels(model, model.backbone_layer_order(), 0.5)
    assert got == want
    blocks = {n.split(".")[1] for n, v in got.items() if v == "frozen"}
    assert blocks == {"conv1"} | {f"block{i}" for i in range(1, 7)}


@pytest.mark.parametrize("head", ["default", "selective_sigmoid",
                                  "compound_head"])
def test_l2_scope_matches_jax(head):
    """The kernels in the 'reference' L2 scope are JAX's `_l2_in_scope`
    set, mapped leaf by leaf: the stem, backbone conv1 and block2, and the
    head's kernel(s) (MobileNet has no conv2)."""
    cfg = ModelConfig(backbone="MobileNetTiny", input_size=64,
                      compute_dtype="float32",
                      **({} if head == "default" else {head: True}))
    _, shapes = _shapes(cfg, 64)
    flags = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, j_l2_in_scope(p, "reference"),
                             np.float32), shapes)
    model = build_model(cfg)
    want = {n for n, v in flax_tree_to_torch(flags, model).items()
            if v.numpy().all()}
    got = {n for n in kernel_names(model) if _l2_in_scope(n, "reference")}
    assert got == want
    heads = {"default": {"final_output.weight"},
             "selective_sigmoid": {"final_output.weight"},
             "compound_head": {"sigmoid_output.weight",
                               "dense_output.weight"}}[head]
    assert heads < got
    assert {"backbone.conv1.conv.weight", "backbone.block2.depthwise.weight",
            "backbone.block2.pointwise.weight"} < got
    assert not any(n.startswith(("backbone.block1.", "backbone.block3."))
                   for n in got)


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


def test_mobilenet_tiny_train_steps_match_jax(monkeypatch):
    """Two steps of the resident-feed train step, augmentation off, dropout
    0, optax Adam under the 1-cycle schedule, MobileNetTiny at 96².
    Losses within rel 1e-4 and BN statistics within 1e-4 of their scale
    (MobileNetTiny's float32 train mode is ill-conditioned:
    tests/test_torch_heads.py).  Parameters in units of the learning rate
    (Adam moves a weight by ~lr per step wherever |g| >> eps): every weight
    within 2 * sum(lr) of JAX's, and the median over all weights within
    0.01 * sum(lr); a missing or wrong update moves most weights of its
    leaf by ~1 * sum(lr)."""
    size = 96
    cfg = ModelConfig(backbone="MobileNetTiny", input_size=size,
                      compute_dtype="float32", dropout_rate=0.0)
    rng = np.random.default_rng(3)
    x_all = rng.integers(0, 256, (8, size, size, 1), dtype=np.uint8)
    y_all = _labels(rng, 8)
    jm = jbuild(cfg)
    params, stats = _variables(jm, x_all[:1].astype(np.float32), rng)
    monkeypatch.setenv("SPNET_SCAN_UNROLL", "1")
    idx_mat = np.array([[0, 3, 5, 6], [1, 2, 4, 7]], np.int32)
    lr_max, total = 1e-3, 100
    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((4, size, size, 1)),
                             j_schedule(lr_max, total), adam_variant="optax")
    j_state = j_state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    j_step = j_make_train_step(jm, W, "same", l2_reg=1e-4, augment=False,
                               indexed="epoch", pregather=False)
    j_state, j_losses = j_step(j_state, jnp.asarray(x_all),
                               jnp.asarray(y_all), jnp.asarray(idx_mat),
                               jax.random.key(1))

    model = build_model(cfg)
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    sched = onecycle_schedule(lr_max, total)
    state = create_train_state(model, sched, adam_variant="optax")
    step = make_train_step(model, W, "same", l2_reg=1e-4, augment=False)
    xt, yt = torch.from_numpy(x_all), torch.from_numpy(y_all)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(state, xt, yt, idx, gen)[1]["loss"])
              for idx in torch.from_numpy(idx_mat).long()]
    assert state.step == 2 and state.opt_state.count == 2
    np.testing.assert_allclose(losses, np.asarray(j_losses), rtol=1e-4)

    sum_lr = sum(sched(i) for i in range(2))
    want = flax_to_state_dict(_np_tree(j_state.params),
                              _np_tree(j_state.batch_stats), model)
    devs = collections.defaultdict(list)
    for k, v in model.state_dict().items():
        got, ref = v.numpy(), want[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), k
            assert not np.array_equal(ref, flax_to_state_dict(
                params, stats, model)[k].numpy()), f"{k} did not move"
            continue
        dev = np.abs(got - ref).ravel() / sum_lr
        assert dev.max() <= 2.0, (k, dev.max())
        devs[k].append(dev)
    assert np.median(np.concatenate([d for v in devs.values() for d in v])) \
        <= 0.01


def _write_frames(d, n, seed, size, grid=GridSpec()):
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8)
                        ).save(os.path.join(d, f"frame_{i:02d}.png"))
        k = int(rng.integers(1, 5))
        a = rng.uniform(12, 90, k)
        write_meta_file(os.path.join(d, f"frame_{i:02d}.csv"), np.stack(
            [rng.uniform(grid.cx_min, grid.cx_max, k),
             rng.uniform(grid.cy_min, grid.cy_max, k), a,
             a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
             rng.uniform(1, 11, k)], axis=1))


def test_cli_train_then_evaluate_mobilenet_tiny(tmp_path):
    """`python -m spnet_tpu_torch train --backbone MobileNetTiny
    --input_size 96 --device cpu` trains one epoch and writes a checkpoint
    whose config names the backbone; `evaluate` rebuilds the model from it
    and scores Val/."""
    size = 96
    _write_frames(str(tmp_path / "data" / "Train"), 16, 5, size)
    _write_frames(str(tmp_path / "data" / "Val"), 8, 6, size)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "spnet_tpu_torch", "train", "-d", "data",
         "-b", "8", "-e", "1", "-w", "ck", "--name", "m",
         "--backbone", "MobileNetTiny", "--input_size", str(size),
         "--device", "cpu", "--no-eval"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload, cfg = load_checkpoint(str(tmp_path / "ck"))
    assert payload["step"] == 2 and cfg.model.backbone == "MobileNetTiny"
    assert any(k.endswith("bn_dw.running_var") for k in payload["state_dict"])
    assert len(glob.glob(str(tmp_path / "logs" / "m_*" / "losses.dat"))) == 1
    proc = subprocess.run(
        [sys.executable, "-m", "spnet_tpu_torch", "evaluate", "-w", "ck",
         "-d", "data/Val", "-b", "4", "-l", "eval", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mAP" in proc.stdout
    assert len((tmp_path / "eval" / "hawley_spnet.csv").read_text()
               .splitlines()) > 0
