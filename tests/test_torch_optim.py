"""The port's optimizer, freeze masks and schedule
(`spnet_tpu_torch/train/{optim,state,schedule}.py`) against the JAX
package: both Adam variants update by update against `optax.adam(eps=
1e-7)` and `keras_adam` through a frozen phase and `unfreeze`, the restart
of the schedule the update applies after `unfreeze`, the backbone freeze
labels of the full SPNet, and the 1-cycle schedule.  On CPU tensors the
updates take the `_foreach` twin, never the card's kernel
(`ops/adam.py`), whose name the benchmark's trace classes as a
multi-tensor apply."""

import dataclasses
import re
from pathlib import Path

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
from perfbench.trace import kernel_class
from spnet_tpu_torch.ops import adam as adam_ops
from spnet_tpu_torch.ops._build import CSRC
from spnet_tpu_torch.train import optim
from spnet_tpu_torch.train.optim import ADAM_APPLIES, adam_init, \
    lr_tensor, optax_adam_update
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


@pytest.mark.parametrize("variant", ["optax", "keras"])
def test_cpu_tensors_take_the_foreach_twin(variant, monkeypatch):
    """Two updates on CPU tensors, a frozen leaf among them: the wrapper is
    never called (`adam_apply.launches` stays 0) and the result is the
    twin's, applied by hand to the live leaves, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    gen = torch.Generator().manual_seed(5)
    shapes = [(3, 4), (7,), (1,), (2, 5, 3)]
    p0 = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 1e-3 for s in shapes]
             for _ in range(2)]
    trainable = [True, False, True, True]
    n0 = adam_ops.adam_apply.launches
    monkeypatch.setattr(optim, "adam_apply", refuse)
    ps = [p.clone() for p in p0]
    state = adam_init(ps, trainable)
    for gs in grads:
        state = ADAM_APPLIES[variant](ps, gs, state, lr_tensor(1e-2, state))
    assert adam_ops.adam_apply.launches == n0 == 0
    live = [i for i, t in enumerate(trainable) if t]
    want = [p.clone() for p in p0]
    mus = [torch.zeros_like(want[i]) for i in live]
    nus = [torch.zeros_like(want[i]) for i in live]
    t = torch.zeros(())
    for gs in grads:
        t += 1
        bc1, bc2 = 1.0 - torch.pow(0.9, t), 1.0 - torch.pow(0.999, t)
        lr = lr_tensor(1e-2, state)
        if variant == "keras":
            lr = lr * torch.sqrt(bc2) / bc1
        optim.foreach_update([want[i] for i in live], [gs[i] for i in live],
                             mus, nus, lr, bc1, bc2, 0.9, 0.999, 1e-7,
                             variant == "optax")
    for a, b in zip(ps, want):
        assert torch.equal(a, b)
    assert torch.equal(ps[1], p0[1])
    for k, i in enumerate(live):
        assert torch.equal(state.mu[i], mus[k])
        assert torch.equal(state.nu[i], nus[k])


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the wrapper raises before it loads any library; the
    twin (`optim.foreach_update`) is the CPU's path."""
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA tensors"):
        adam_ops.adam_apply([torch.zeros(3)], [torch.zeros(3)],
                            [torch.zeros(3)], [torch.zeros(3)], one, one,
                            one, 0.9, 0.999, 1e-7, True)
    assert adam_ops.adam_apply.launches == 0


def _adam_kernel_names() -> list:
    """The kernel's full names as the profiler shows them, read from the
    entry point in `csrc/adam.cu`: a kernel of the anonymous namespace,
    templated on one bool and taking its argument struct by value."""
    src = (CSRC / "adam.cu").read_text()
    m = re.search(r"namespace \{.*?template <bool \w+>\s*__global__ void"
                  r"(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\("
                  r"const (\w+) \w+\).*?\}  // namespace", src, re.S)
    assert m, "no templated __global__ entry point in an anonymous namespace"
    kernel, table = m.groups()
    ns = "(anonymous namespace)::"
    return [f"void {ns}{kernel}<{b}>({ns}{table})"
            for b in ("true", "false")]


def test_kernel_name_is_classed_as_a_multi_tensor_apply():
    """`adam_roofline.train` reads the device time of the kernels that
    `perfbench/trace.py` classes as `multi_tensor_apply`: the kernel's
    name must land there and in no earlier class."""
    names = _adam_kernel_names()
    assert "adam_multi_tensor_apply_kernel" in names[0]
    for name in names:
        assert kernel_class(name) == "multi_tensor_apply", name


def test_launch_groups_respect_the_table_size(monkeypatch):
    """Leaves split into launches of at most the kernel's table size, in
    order, none empty."""
    monkeypatch.setattr(adam_ops, "_max_leaves", lambda: 3)
    assert adam_ops._launches(0) == []
    assert adam_ops._launches(3) == [(0, 3)]
    assert adam_ops._launches(7) == [(0, 3), (3, 6), (6, 7)]


def test_leaf_layout_ignores_dimensions_of_one_element():
    """A 1x1 conv weight and its gradient as autograd lays it out (other
    strides on the unit dimensions) share a layout; a permuted dense
    tensor has its own; a strided view has none."""
    w = torch.empty(256, 128, 1, 1)
    g = torch.empty_strided((256, 128, 1, 1), (128, 1, 128, 128))
    assert adam_ops._layout(w) == adam_ops._layout(g) == (128, 1)
    perm = torch.empty(6, 5, 4, 3).permute(0, 2, 3, 1)
    assert adam_ops._layout(perm) == (60, 3, 1, 12)
    assert adam_ops._layout(perm) != adam_ops._layout(perm.contiguous())
    assert adam_ops._layout(torch.empty(4, 6)[:, :3]) is None
    assert adam_ops._layout(torch.empty(4, 6)[:, ::2]) is None
