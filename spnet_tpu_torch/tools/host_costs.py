"""Host time of the parts of a kernel wrapper's call, on a CUDA host.

    python -m spnet_tpu_torch.tools.host_costs [--calls 20000]

Times each step a wrapper of this package takes per call (its checks, an
output allocation, the stream lookup, the ctypes call with and without a
launch) and, for scale, one PyTorch launch and the whole wrappers, at the
train step's loss shape (128, 576) float32: `calls` calls of each, then one
synchronize, on the host's clock; prints microseconds per call.  It needs a
CUDA card; the kernels build at first use.
"""

from __future__ import annotations

import argparse
import time

import torch


def per_call_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_costs: no CUDA device")
    from spnet_tpu_torch.config import LossWeights
    from spnet_tpu_torch.ops import losses
    from spnet_tpu_torch.ops._build import load_library
    from spnet_tpu_torch.ops.activations import selective_sigmoid_fwd

    lib = load_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    yt = torch.randn(128, 576, device="cuda", generator=gen)
    yp = yt + 0.3 * torch.randn(128, 576, device="cuda", generator=gen)
    g = torch.full((), 0.5, device="cuda")
    kept = losses.spnet_loss_grad_torch(yt, yp)
    out = torch.empty((), device="cuda")
    p = yp.clone().requires_grad_(True)
    one = torch.zeros(1, device="cuda")
    w = LossWeights()
    stream = torch._C._cuda_getCurrentRawStream(0)
    steps = {
        "_check (the loss wrappers' validation)":
            lambda: losses._check(yt, yp, "same"),
        "torch.empty((), device=...)":
            lambda: torch.empty((), dtype=torch.float32, device=yp.device),
        "torch.empty_like (128 x 576)": lambda: torch.empty_like(yp),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: (
            torch._C._cuda_getCurrentRawStream(0)),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "tensor.data_ptr()": yp.data_ptr,
        "ctypes, 17 arguments, no launch (n_slots = 0)": lambda: (
            lib.spnet_loss(None, None, None, None, None, None, 0, None, 0,
                           1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0, stream)),
        "ctypes, 5 arguments, with a launch (the scale kernel)": lambda: (
            lib.spnet_loss_grad_scale(g.data_ptr(), kept.data_ptr(),
                                      yt.data_ptr(), 9216, stream)),
        "one-element add_ (one PyTorch launch)": lambda: one.add_(1.0),
        "_launch (the loss kernel, no check, no allocation)": lambda: (
            losses._launch(yt, yp, None, None, out, w, "same")),
        "spnet_loss_fwd": lambda: losses.spnet_loss_fwd(yt, yp),
        "spnet_loss_bwd": lambda: losses.spnet_loss_bwd(yt, yp, g),
        "spnet_loss_grad_scale": lambda: losses.spnet_loss_grad_scale(kept,
                                                                      g),
        "spnet_loss_fused (y_pred needs a gradient)": lambda: (
            losses.spnet_loss_fused(yt, p)),
        "selective_sigmoid_fwd": lambda: selective_sigmoid_fwd(yp),
    }
    print(f"{torch.cuda.get_device_name(0)}; host us per call over "
          f"{args.calls} calls")
    for name, fn in steps.items():
        print(f"{name:56s} {per_call_us(fn, args.calls):8.2f}")


if __name__ == "__main__":
    main()
