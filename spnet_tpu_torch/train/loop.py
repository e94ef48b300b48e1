"""Batched inference with FPS timing (counterpart of
`spnet_tpu/train/loop.py:predict_in_batches`); the training loop comes
with the training slice."""

from __future__ import annotations

import time

import numpy as np
import torch


def predict_in_batches(predict_fn, x, batch_size: int,
                       device: str | torch.device,
                       verbose: bool = True) -> tuple[np.ndarray, float]:
    """Run predict_fn over x (numpy or a tensor) in batches on `device`.

    The last partial batch is padded with zeros and its padding trimmed.
    A warm-up batch (kernel build, cuDNN autotuning, allocator growth)
    runs outside the timed window, as in JAX where the first dispatch
    compiles.  All batches are enqueued before any result is copied back,
    and the window ends with the last host copy (`.cpu()`), so FPS counts
    the device work, not launches.  Returns (y (N, num_outputs) float32
    numpy, frames per second)."""
    device = torch.device(device)
    m = x.shape[0]
    xt = torch.as_tensor(x)
    wb = torch.zeros((batch_size,) + tuple(xt.shape[1:]), dtype=xt.dtype,
                     device=device)
    predict_fn(wb).cpu()
    start = time.perf_counter()
    outs, trims = [], []
    for s in range(0, m, batch_size):
        xb = xt[s : s + batch_size].to(device, non_blocking=True)
        trim = xb.shape[0]
        if trim < batch_size:  # pad the final partial batch
            xb = torch.cat([xb, xb.new_zeros((batch_size - trim,)
                                             + tuple(xb.shape[1:]))])
        outs.append(predict_fn(xb))
        trims.append(trim)
    y = np.concatenate([o.cpu().float().numpy()[:t]
                        for o, t in zip(outs, trims)])
    elapsed = time.perf_counter() - start
    fps = m / max(elapsed, 1e-9)
    if verbose:
        print(f"    predict: {m} frames in {elapsed:.2f}s  FPS = {fps:.1f}")
    return y, fps
