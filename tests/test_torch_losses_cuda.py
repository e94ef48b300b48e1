"""The loss kernel (K2 and K3 in one pass) and the backward's scale kernel
against the plain PyTorch twin, on the card, eagerly and replayed from a
CUDA graph.  No jax here; run this file on the card without
the suite's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_losses_cuda.py -q

Elsewhere every case skips."""

import pytest
import torch

from spnet_tpu_torch.config import LossWeights
from spnet_tpu_torch.ops.losses import (
    spnet_loss,
    spnet_loss_bwd,
    spnet_loss_fused,
    spnet_loss_fwd,
    spnet_loss_grad_torch,
)

W = LossWeights()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _args(b, m, device, offset=0):
    """Targets with a noobj flag of 0 or 1 on every slot, predictions
    around them; `offset` makes views whose data pointers are not 16-byte
    aligned."""
    g = torch.Generator().manual_seed(b * 1000 + m)
    yt = torch.randn(b, m, generator=g)
    yt.view(b, -1, 8)[..., 6] = (torch.rand(b, m // 8, generator=g)
                                 < 0.8).float()
    yp = yt + 0.3 * torch.randn(b, m, generator=g)
    out = []
    for v in (yt, yp):
        buf = torch.empty(v.numel() + offset, device=device)
        out.append(buf[offset:].view(b, m).copy_(v))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("loss_type", ["same", "hybrid"])
@pytest.mark.parametrize("shape,offset", [
    ((128, 576), 0),     # the training batch
    ((3, 8 * 37), 0),    # ragged last block
    ((5, 8 * 250), 1),   # ragged and misaligned
])
def test_kernels_match_twin(cuda, shape, offset, loss_type):
    """Loss rel 1e-5 and gradient max-abs error <= 1e-5 * max|grad|: only
    the summation order differs.  Two forward calls agree bitwise."""
    yt, yp = _args(*shape, cuda, offset)
    f0, b0 = spnet_loss_fwd.launches, spnet_loss_bwd.launches
    loss = spnet_loss_fwd(yt, yp, W, loss_type)
    again = spnet_loss_fwd(yt, yp, W, loss_type)
    g = torch.full((), 0.5, device=cuda)
    dyp = spnet_loss_bwd(yt, yp, g, W, loss_type)
    torch.cuda.synchronize()
    assert (spnet_loss_fwd.launches, spnet_loss_bwd.launches) == \
        (f0 + 2, b0 + 1)
    assert torch.equal(loss, again)
    p = yp.detach().clone().requires_grad_(True)
    ref = spnet_loss(yt, p, W, loss_type)
    (ref_grad,) = torch.autograd.grad(ref * 0.5, p)
    ref = float(ref.detach())
    assert abs(float(loss) - ref) <= 1e-5 * abs(ref)
    err = (dyp - ref_grad).abs().max()
    assert err <= 1e-5 * ref_grad.abs().max()


@pytest.mark.cuda
def test_fused_function_launches_both_kernels(cuda):
    yt, yp = _args(16, 576, cuda)
    p = yp.clone().requires_grad_(True)
    f0, b0 = spnet_loss_fwd.launches, spnet_loss_bwd.launches
    spnet_loss_fused(yt, p).backward()
    torch.cuda.synchronize()
    assert (spnet_loss_fwd.launches, spnet_loss_bwd.launches) == \
        (f0 + 1, b0 + 1)
    assert torch.isfinite(p.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("loss_type", ["same", "hybrid"])
@pytest.mark.parametrize("shape,offset", [
    ((128, 576), 0),     # the training batch
    ((3, 8 * 37), 0),    # ragged last block
    ((5, 8 * 250), 1),   # ragged, and misaligned: the scalar path
])
def test_fused_function_matches_twin(cuda, shape, offset, loss_type):
    """One launch forward (loss and gradient), one backward (the scale):
    the loss rel 1e-5 of the twin's, the gradient within 1e-5 max|grad| of
    the twin's autograd gradient and rel 1e-6 of `spnet_loss_bwd`."""
    yt, yp = _args(*shape, cuda, offset)
    p = yp.detach().clone().requires_grad_(True)
    g = torch.full((), 0.5, device=cuda)
    f0, b0 = spnet_loss_fwd.launches, spnet_loss_bwd.launches
    loss = spnet_loss_fused(yt, p, W, loss_type)
    (grad,) = torch.autograd.grad(loss, p, g)
    torch.cuda.synchronize()
    assert (spnet_loss_fwd.launches, spnet_loss_bwd.launches) == \
        (f0 + 1, b0 + 1)
    q = yp.detach().clone().requires_grad_(True)
    ref = spnet_loss(yt, q, W, loss_type)
    (ref_grad,) = torch.autograd.grad(ref, q, g)
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    assert (grad - ref_grad).abs().max() <= 1e-5 * ref_grad.abs().max()
    alone = spnet_loss_bwd(yt, yp, g, W, loss_type)
    assert (grad - alone).abs().max() <= 1e-6 * alone.abs().max()
    closed = spnet_loss_grad_torch(yt, yp, W, loss_type) * g
    assert (grad - closed).abs().max() <= 1e-5 * closed.abs().max()


@pytest.mark.cuda
def test_graph_replays_are_bitwise_eager(cuda):
    """The forward (loss and gradient) and the backward captured into one
    CUDA graph after an eager call on the capturing stream; three replays
    give the eager loss and gradient bit for bit, and an eager call after
    them is still right (the kernel left its counter at 0)."""
    yt, yp = _args(128, 576, cuda)
    p = yp.detach().clone().requires_grad_(True)

    def step():
        loss = spnet_loss_fused(yt, p)
        return loss, torch.autograd.grad(loss, p)[0]

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        eager = step()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        static = step()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static[0], eager[0])
        assert torch.equal(static[1], eager[1])
    assert torch.equal(step()[0], eager[0])
    assert torch.equal(spnet_loss_fwd(yt, yp), eager[0])


@pytest.mark.cuda
def test_first_call_under_capture_raises(cuda):
    """The loss's workspace is made at a stream's first call, never inside
    a capture: a first call on a fresh stream under capture raises."""
    yt, yp = _args(16, 576, cuda)
    s = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="eagerly"):
        with torch.cuda.graph(graph, stream=s):
            spnet_loss_fwd(yt, yp)
