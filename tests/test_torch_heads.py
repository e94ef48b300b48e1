"""The port's other heads against the JAX package on `MobileNetTiny`:
the selective-sigmoid head (reference model_type 'ss', kernel K4 on the
card, its twin here), the compound head (reference 'compound') and both at
once, from flax weights converted with `flax_to_state_dict`.  Eval outputs,
the train-mode loss gradient leaf by leaf, and the 'hybrid' decode that
puts a second sigmoid on top of the 'ss' head's, as the JAX package
does."""

import collections
import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spnet_tpu.config import ExperimentConfig as JExperimentConfig
from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.eval.predict import predict_network as j_predict_network
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.ops.losses import loss_components as j_components
from spnet_tpu.train.steps import kernel_l2 as j_kernel_l2
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, LossWeights, \
    ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict, flax_tree_to_torch
from spnet_tpu_torch.data.dataset import build_x
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.eval.predict import predict_network
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops.activations import SelectiveSigmoid
from spnet_tpu_torch.train import steps
from spnet_tpu_torch.train.steps import forward_loss, make_eval_step, \
    make_predict_step

torch.set_num_threads(2)
SIZE = 64  # MobileNetTiny: 32² after the stem, 1x1x128 into the head
W, JW = LossWeights(), JLossWeights()
# head -> (selective_sigmoid, compound_head)
HEADS = {"ss": (True, False), "compound": (False, True), "both": (True, True)}


def _cfg(head, loss_type="same", config=ModelConfig):
    """The port's ModelConfig; `config=JModelConfig` gives the JAX
    package's for its oracle."""
    ss, comp = HEADS[head]
    return config(backbone="MobileNetTiny", input_size=SIZE,
                       compute_dtype="float32", dropout_rate=0.0,
                       selective_sigmoid=ss, compound_head=comp,
                       loss_type=loss_type)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng):
    """Non-trivial BN parameters and running statistics, kernels scaled up
    so that activations keep their size through 14 layers in eval mode."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.6, v.shape).astype(np.float32)
        else:
            out[k] = (2.0 * v).astype(np.float32)
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


@functools.lru_cache(maxsize=None)
def _setup(head):
    """The flax model of `head`, perturbed variables and 4 seeded frames
    (normalized floats) with labels."""
    rng = np.random.default_rng(list(HEADS).index(head))
    jm = jbuild(_cfg(head, config=JModelConfig))
    x = rng.normal(0, 1, (4, SIZE, SIZE, 1)).astype(np.float32)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(jax.random.key(0), x)
    params = _perturb(_np_tree(v["params"]), rng)
    stats = _perturb(_np_tree(v["batch_stats"]), rng)
    return jm, params, stats, x, _labels(rng, 4)


def _torch_model(head, params, stats, loss_type="same"):
    model = build_model(_cfg(head, loss_type), device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    return model


@pytest.mark.parametrize("head", list(HEADS))
def test_eval_matches_jax(head):
    """float32, eval: 1e-4 of the output's scale, as for Xception
    (tests/test_torch_models.py).  The noobj lanes lie in (0, 1); with both
    heads they went through two sigmoids, into (0.5, 0.732)."""
    jm, params, stats, x, _ = _setup(head)
    y_jax = np.asarray(jax.jit(
        lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x,
                                 train=False))(params, stats, x))
    model = _torch_model(head, params, stats)
    assert (model.selective_sigmoid, model.compound_head) == HEADS[head]
    with torch.inference_mode():
        y = model(torch.from_numpy(x)).numpy()
    assert y.shape == y_jax.shape == (4, 576)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-4 * scale)
    noobj = y[:, 6::8]
    lin = np.delete(y.reshape(4, -1, 8), 6, axis=-1)
    assert np.abs(lin).max() > 1.0  # the linear lanes are not squashed
    if head == "both":
        assert ((noobj > 0.5) & (noobj < 0.732)).all()
    else:
        assert ((noobj > 0) & (noobj < 1)).all()
        assert noobj.min() < 0.4 and noobj.max() > 0.6


@pytest.mark.parametrize("head,loss_type", [("ss", "same"), ("ss", "hybrid"),
                                            ("compound", "hybrid")])
def test_train_gradient_matches_jax(head, loss_type):
    """Data loss + 1e-4 * 'reference' L2 (which covers the split head's
    two kernels) and its gradient leaf by leaf, train mode, dropout 0, no
    augmentation.  The 'ss' head trains through the fused loss's 'ss' route
    (the loss applies the selective sigmoid); under 'hybrid' its BCE reads
    the sigmoided noobj value, as the JAX package's does.  MobileNetTiny in
    train mode is ill-conditioned in
    float32 (14 batch-stat BNs over 8 to 128 channels, the last ones over
    a 1x1 map of 4 frames): JAX's own float32 forward differs from its
    float64 one by 2.4e-4 of the output's scale.  Hence the loss within
    rel 1e-4 (measured 3.2e-5), the head kernels' gradients within 1e-3 of
    their max, and every other leaf within 1e-2 of its own max (measured
    worst 3.6e-3, a stem BN bias) or, for leaves that are zero but for
    rounding, 1e-6 of the largest gradient.  A wrong formula
    is off by O(1) of the leaf's scale."""
    jm, params, stats, x, y = _setup(head)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.key(1)})
        data = j_components(y, out, JW, loss_type)["total"]
        return data + 1e-4 * j_kernel_l2(p, "reference"), data

    (j_loss, j_data), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _torch_model(head, params, stats, loss_type).train()
    names, tparams = zip(*model.named_parameters())
    loss, data = forward_loss(model, torch.from_numpy(x), torch.from_numpy(y),
                              None, W, loss_type, 1e-4, "reference")
    grads = torch.autograd.grad(loss, tparams)
    assert float(data.detach()) == pytest.approx(float(j_data), rel=1e-4)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-4)
    want = flax_tree_to_torch(_np_tree(j_grads), model)
    assert set(want) == set(names)
    head_keys = {"ss": {"final_output.weight"},
                 "compound": {"sigmoid_output.weight",
                              "dense_output.weight"}}[head]
    assert head_keys <= set(names)
    floor = 1e-6 * max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in zip(names, grads):
        ref = np.abs(want[name].numpy()).max()
        err = np.abs(g.numpy() - want[name].numpy()).max()
        bound = 1e-3 * ref if name in head_keys else max(1e-2 * ref, floor)
        assert err <= bound, (name, err, ref)


def test_both_heads_train_through_the_fused_route():
    """Both heads at once: the compound head's sigmoid and then, in the
    fused loss's 'ss' route, the selective sigmoid, two on the noobj lane
    as the JAX package has them.  The data loss within rel 1e-4 of JAX's
    and the head kernels' gradients within 1e-3 of their max, as in
    `test_train_gradient_matches_jax`; every leaf within 1e-5 of its max
    (or 1e-6 of the largest gradient) of the composition's (`fused=False`:
    `SelectiveSigmoid` and the plain loss).  The deeper leaves are not held
    to JAX here: with these weights MobileNetTiny's float32 train mode puts
    the stem's gradients tens of percent from JAX's on either route."""
    jm, params, stats, x, y = _setup("both")

    def data_loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.key(1)})
        return j_components(y, out, JW, "same")["total"]

    j_data, j_grads = jax.jit(jax.value_and_grad(data_loss))(params)
    grads = {}
    for fused in (True, False):
        model = _torch_model("both", params, stats).train()
        names, tparams = zip(*model.named_parameters())
        _, data = forward_loss(model, torch.from_numpy(x),
                               torch.from_numpy(y), None, W, "same", 0.0,
                               fused=fused)
        assert float(data.detach()) == pytest.approx(float(j_data),
                                                     rel=1e-4)
        grads[fused] = dict(zip(names, torch.autograd.grad(data, tparams)))
    want = flax_tree_to_torch(_np_tree(j_grads), model)
    for name in ("sigmoid_output.weight", "dense_output.weight"):
        ref = np.abs(want[name].numpy()).max()
        err = np.abs(grads[True][name].numpy() - want[name].numpy()).max()
        assert err <= 1e-3 * ref, (name, err, ref)
    floor = 1e-6 * max(g.abs().max().item() for g in grads[False].values())
    for name, g in grads[True].items():
        ref = grads[False][name]
        err = (g - ref).abs().max().item()
        assert err <= max(1e-5 * ref.abs().max().item(), floor), (name, err)


def test_ss_head_runs_through_the_autograd_function(monkeypatch):
    """The 'ss' head applies `SelectiveSigmoid` (K4 on the card); with
    plain_kernels it applies the twin and never the function."""
    calls = []
    orig = SelectiveSigmoid.apply
    monkeypatch.setattr(SelectiveSigmoid, "apply",
                        lambda x: calls.append(x.shape) or orig(x))
    x = torch.zeros(2, SIZE, SIZE, 1)
    with torch.inference_mode():
        build_model(_cfg("ss"), device="cpu")(x)
        assert calls == [(2, 576)]
        build_model(_cfg("ss"), device="cpu", plain_kernels=True)(x)
        assert calls == [(2, 576)]


@pytest.mark.parametrize("loss_type", ["same", "hybrid"])
def test_ss_train_loss_takes_the_fused_route(loss_type, monkeypatch):
    """A train-mode `forward_loss` on an 'ss' model with its kernels applies
    no `SelectiveSigmoid` and hands the fused loss the head's
    pre-activation with selective_sigmoid=True, for the same loss as the
    composition (`fused=False`: `SelectiveSigmoid`, then the plain twin),
    rel 1e-6.  The eval and predict steps still apply `SelectiveSigmoid`;
    a `plain_kernels` model applies the twin and calls the fused loss
    without the flag."""
    sig_calls, loss_calls = [], []
    orig_sig, orig_loss = SelectiveSigmoid.apply, steps.spnet_loss_fused
    monkeypatch.setattr(SelectiveSigmoid, "apply",
                        lambda x: sig_calls.append(x.shape) or orig_sig(x))
    monkeypatch.setattr(
        steps, "spnet_loss_fused", lambda *a, **k: loss_calls.append(
            k.get("selective_sigmoid", False)) or orig_loss(*a, **k))
    _, params, stats, x, y = _setup("ss")
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    model = _torch_model("ss", params, stats, loss_type).train()
    fused, _ = forward_loss(model, x, y, None, W, loss_type)
    assert (sig_calls, loss_calls) == ([], [True])
    plain, _ = forward_loss(model, x, y, None, W, loss_type, fused=False)
    assert (sig_calls, loss_calls) == ([(4, 576)], [True])
    assert float(fused.detach()) == pytest.approx(float(plain.detach()),
                                                  rel=1e-6)
    make_eval_step(model, W, loss_type)(x, y)
    make_predict_step(model)(x)
    assert sig_calls == [(4, 576)] * 3 and loss_calls == [True]
    twin = build_model(_cfg("ss", loss_type), device="cpu",
                       plain_kernels=True)
    twin.load_state_dict(model.state_dict())
    forward_loss(twin.train(), x, y, None, W, loss_type)
    assert sig_calls == [(4, 576)] * 3 and loss_calls == [True, False]


def _write_frames(d, x_uint8):
    d.mkdir()
    for i, f in enumerate(x_uint8):
        Image.fromarray(f[..., 0]).save(d / f"frame_{i}.png")


def test_hybrid_decode_applies_a_second_sigmoid(tmp_path):
    """'ss' head + loss_type 'hybrid': the head already sigmoids the noobj
    lanes, and predict's decode applies a second sigmoid, as the JAX
    package's `eval/predict.py` does.  Both predict_network runs on the same
    PNG frames and weights agree to 1e-4 of the output's scale, and the
    decoded noobj values lie in (sigmoid(0), sigmoid(1))."""
    _, params, stats, _, _ = _setup("ss")
    cfg = ExperimentConfig(model=_cfg("ss", "hybrid"))
    jcfg = JExperimentConfig(model=_cfg("ss", "hybrid", JModelConfig))
    rng = np.random.default_rng(9)
    _write_frames(tmp_path / "frames",
                  rng.integers(0, 256, (4, SIZE, SIZE, 1), dtype=np.uint8))
    jm = jbuild(jcfg.model)
    state = collections.namedtuple("State", "params batch_stats")(params,
                                                                  stats)
    yp_jax, files_jax = j_predict_network(
        jcfg, state, jm, str(tmp_path / "frames"),
        log_dir=str(tmp_path / "jax"), batch_size=2, num_draw=0, verbose=0)
    model = _torch_model("ss", params, stats, "hybrid")
    yp, files = predict_network(cfg, model, str(tmp_path / "frames"), "cpu",
                                log_dir=str(tmp_path / "pt"), batch_size=2,
                                num_draw=0, verbose=0)
    assert files == files_jax and yp.shape == yp_jax.shape == (4, 576)
    scale = np.abs(yp_jax).max()
    np.testing.assert_allclose(yp, yp_jax, rtol=0, atol=1e-4 * scale)
    noobj = normalize(yp, cfg.grid)[:, 6::8]
    assert ((noobj > 0.5 - 1e-6) & (noobj < 0.7311 + 1e-6)).all()
    # the raw head output is one sigmoid deep: a second one is the decode
    raw = make_predict_step(model)(torch.from_numpy(
        build_x(files, size=SIZE))).numpy()
    np.testing.assert_allclose(noobj, 1 / (1 + np.exp(-raw[:, 6::8])),
                               rtol=0, atol=1e-5)


def test_flax_checkpoint_converts_and_serves(tmp_path):
    """scripts/flax_ckpt_to_torch.py on an Orbax checkpoint of MobileNetTiny
    with both heads: no leaf left over or key left empty, the config travels
    along, and the CLI loader serves the JAX model's predictions (1e-4 of
    the output's scale)."""
    import importlib.util
    import os

    from spnet_tpu.cli.common import InferenceState
    from spnet_tpu.io.checkpoint import save_checkpoint as j_save
    from spnet_tpu_torch.cli.common import load_model_and_state

    head = "both"
    jm, params, stats, x, _ = _setup(head)
    cfg = ExperimentConfig(model=_cfg(head))
    j_save(str(tmp_path / "jax"), InferenceState(params, stats, 5),
           JExperimentConfig(model=_cfg(head, config=JModelConfig)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "flax_ckpt_to_torch", os.path.join(root, "scripts",
                                           "flax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(["-w", str(tmp_path / "jax"), "-o", str(tmp_path / "pt")])
    cfg2, model, step = load_model_and_state(str(tmp_path / "pt"), "cpu")
    assert cfg2 == cfg and step == 5
    assert (model.selective_sigmoid, model.compound_head) == HEADS[head]
    y_jax = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x))
    with torch.inference_mode():
        y = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_jax, rtol=0,
                               atol=1e-4 * np.abs(y_jax).max())
