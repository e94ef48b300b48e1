"""The multi-tensor Adam kernel (`csrc/adam.cu` through
`ops/adam.py::adam_apply`) against its plain twin, the `_foreach` passes
of `train/optim.py::foreach_update`, on the card.  No jax here; run this
file on the card without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_adam_cuda.py -q

Elsewhere every case skips.

Both variants take three steps from the same leaves and gradients through
`optax_adam_apply` / `keras_adam_apply` on each side: p, m and v bitwise
equal, on Xception-331's and InceptionResNetV2-331's trained-leaf shapes
with frozen leaves, one-element and odd-length leaves and a dense
non-contiguous leaf mixed in, and gradients whose dimensions of one
element carry other strides; a CUDA graph of the update replayed with the
learning rate changed between replays gives the eager updates' bits; a
table longer than one launch takes; no live leaf launches nothing; the
wrapper refuses float64 and strided leaves.
"""

import dataclasses
import functools

import pytest
import torch

from spnet_tpu_torch.config import GridSpec, ModelConfig
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.ops.adam import adam_apply
from spnet_tpu_torch.train import optim
from spnet_tpu_torch.train.optim import ADAM_APPLIES, adam_init, lr_tensor

ODD = [(1,), (3,), (5,), (7, 1), (4097,), (2, 3, 5, 7), (1023,)]
LRS = (1e-3, 4e-4, 2.5e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _shapes(backbone: str) -> list:
    model = build_model(ModelConfig(backbone=backbone),
                        num_outputs=GridSpec().num_outputs, device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def _leaves(shapes, device, seed: int):
    """Seeded float32 parameters of `shapes` and the ODD leaves, one dense
    non-contiguous (permuted) leaf, and every fifth leaf frozen; returns
    (params, trainable)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ps = [torch.randn(s, generator=g, device=device) * 0.05
          for s in list(shapes) + ODD]
    ps.append(torch.randn((6, 5, 4, 3), generator=g, device=device)
              .permute(0, 2, 3, 1))
    return ps, [i % 5 != 2 for i in range(len(ps))]


def _grads(ps, device, seed: int):
    """Gradients over ten decades of magnitude, some exactly zero, some
    whose squares are subnormal, laid out as their parameters but with
    other strides on dimensions of one element (as autograd gives a 1x1
    conv weight's gradient)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for p in ps:
        scale = 10.0 ** torch.empty(p.shape, device=device).uniform_(
            -22, 1, generator=g)
        d = torch.randn(p.shape, generator=g, device=device) * scale
        d[torch.rand(p.shape, generator=g, device=device) < 0.01] = 0.0
        strides = [st if sz != 1 else p.numel() + 1
                   for sz, st in zip(p.shape, p.stride())]
        out.append(torch.empty_strided(p.shape, strides,
                                       device=device).copy_(d))
    return out


@torch.no_grad()
def _twin_apply(variant: str, params, grads, state, lr):
    """`ADAM_APPLIES[variant]` with the `_foreach` passes
    (`optim.foreach_update`) where it calls the kernel."""
    ps, gs, mus, nus = optim._live(params, grads, state)
    bc1, bc2 = optim._advance(state, optim.B1, optim.B2)
    if variant == "keras":
        lr = lr * torch.sqrt(bc2) / bc1
    if ps:
        optim.foreach_update(ps, gs, mus, nus, lr, bc1, bc2, optim.B1,
                             optim.B2, optim.EPS, variant == "optax")
    return dataclasses.replace(state, count=state.count + 1)


def _run(variant: str, ps, trainable, grads, twin: bool):
    """Three updates of copies of ps; the `_foreach` twin when `twin`.
    Returns (params, state)."""
    ps = [p.clone() for p in ps]
    state = adam_init(ps, trainable)
    apply = (functools.partial(_twin_apply, variant) if twin
             else ADAM_APPLIES[variant])
    for lr, gs in zip(LRS, grads):
        state = apply(ps, gs, state, lr_tensor(lr, state))
    return ps, state


def _diff(a, b) -> str:
    bad = a != b
    if not bad.any():
        return ""
    ia = a[bad].view(torch.int32).long()
    ib = b[bad].view(torch.int32).long()
    return (f"{int(bad.sum())} of {a.numel()} differ, at most "
            f"{int((ia - ib).abs().max())} ulp")


def _assert_bitwise(run_a, run_b):
    (pa, sa), (pb, sb) = run_a, run_b
    bad = []
    for i, (x, y) in enumerate(zip(pa, pb)):
        for name, u, w in (("p", x, y), ("m", sa.mu[i], sb.mu[i]),
                           ("v", sa.nu[i], sb.nu[i])):
            if u is None and w is None:
                continue
            d = _diff(u, w)
            if d:
                bad.append(f"{name}[{i}] {tuple(u.shape)}: {d}")
    assert not bad, f"{len(bad)} tensors differ: {bad[:8]}"
    assert torch.equal(sa.t, sb.t) and sa.count == sb.count


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["optax", "keras"])
@pytest.mark.parametrize("backbone", ["Xception", "InceptionResNetV2"])
def test_kernel_is_bitwise_the_foreach_twin(cuda, backbone, variant):
    ps, trainable = _leaves(_shapes(backbone), cuda, 1)
    grads = [_grads(ps, cuda, 10 + k) for k in range(len(LRS))]
    n0 = adam_apply.launches
    kernel = _run(variant, ps, trainable, grads, False)
    assert adam_apply.launches - n0 == len(LRS)  # one launch an update
    twin = _run(variant, ps, trainable, grads, True)
    assert adam_apply.launches - n0 == len(LRS)
    _assert_bitwise(kernel, twin)
    moved = [not torch.equal(p, q) for p, q in zip(kernel[0], ps)]
    assert moved == trainable


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["optax", "keras"])
def test_more_leaves_than_a_launch_holds(cuda, variant):
    """2,000 leaves of 1 to 37 elements: three launches an update, the
    twin's bits."""
    shapes = [(1 + (7 * i) % 37,) for i in range(2000)]
    ps, trainable = _leaves(shapes, cuda, 2)
    grads = [_grads(ps, cuda, 20 + k) for k in range(len(LRS))]
    n0 = adam_apply.launches
    kernel = _run(variant, ps, trainable, grads, False)
    assert adam_apply.launches - n0 == 3 * len(LRS)
    _assert_bitwise(kernel, _run(variant, ps, trainable, grads, True))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["optax", "keras"])
def test_graph_replays_are_bitwise_the_eager_updates(cuda, variant):
    """The update captured once in a CUDA graph and replayed three times,
    the learning rate tensor refilled between replays: the eager kernel's
    three updates' bits, the count's device mirror included."""
    ps0, trainable = _leaves(_shapes("Xception")[:40], cuda, 3)
    grads = _grads(ps0, cuda, 30)
    apply = ADAM_APPLIES[variant]
    eager = [p.clone() for p in ps0]
    se = adam_init(eager, trainable)
    for lr in LRS:
        se = apply(eager, grads, se, lr_tensor(lr, se))
    graphed = [p.clone() for p in ps0]
    sg = adam_init(graphed, trainable)
    lr = lr_tensor(0.0, sg)
    torch.cuda.synchronize()
    n0 = adam_apply.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        apply(graphed, grads, sg, lr)
    assert adam_apply.launches - n0 == 1
    for value in LRS:
        lr.fill_(value)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(sg.t, se.t)
    for i, (a, b) in enumerate(zip(graphed, eager)):
        assert torch.equal(a, b), i
        if trainable[i]:
            assert torch.equal(sg.mu[i], se.mu[i]), i
            assert torch.equal(sg.nu[i], se.nu[i]), i


@pytest.mark.cuda
def test_no_live_leaf_launches_nothing(cuda):
    ps, _ = _leaves([(8, 8)], cuda, 4)
    state = adam_init(ps, [False] * len(ps))
    before = [p.clone() for p in ps]
    n0 = adam_apply.launches
    for variant, apply in ADAM_APPLIES.items():
        state = apply(ps, _grads(ps, cuda, 40), state, lr_tensor(1e-3, state))
    assert adam_apply.launches == n0
    assert all(torch.equal(p, q) for p, q in zip(ps, before))
    assert state.count == 2 and float(state.t) == 2.0


@pytest.mark.cuda
def test_wrapper_refuses_float64_and_strided_leaves(cuda):
    def leaf(*shape, dtype=torch.float32):
        return torch.randn(shape, device=cuda, dtype=dtype)

    one = lr_tensor(1e-3, optim.AdamState(0, [], [], torch.zeros(
        (), device=cuda)))
    ok = [leaf(4, 6) for _ in range(4)]
    adam_apply([ok[0]], [ok[1]], [ok[2]], [ok[3]], one, one, one, 0.9,
               0.999, 1e-7, True)
    n0 = adam_apply.launches
    with pytest.raises(TypeError, match="float32"):
        adam_apply([leaf(4, 6, dtype=torch.float64)], [ok[1]], [ok[2]],
                   [ok[3]], one, one, one, 0.9, 0.999, 1e-7, True)
    with pytest.raises(ValueError, match="dense"):
        adam_apply([ok[0][:, :3]], [ok[1][:, ::2]], [ok[2][:, :3]],
                   [ok[3][:, :3]], one, one, one, 0.9, 0.999, 1e-7, True)
    with pytest.raises(ValueError, match="layout"):
        adam_apply([ok[0]], [leaf(6, 4).t()], [ok[2]], [ok[3]], one, one,
                   one, 0.9, 0.999, 1e-7, True)
    assert adam_apply.launches == n0
