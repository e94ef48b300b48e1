"""SPNet in plain float32: colorizer stem, backbone, dense grid head; its
'same' loss, its L2 term, augmentation, the 1-cycle schedule and Adam
(optax's update, eps 1e-7), as the benchmark's reference.

    grayscale (B, S, S, 1) uint8 -> (x / 255 - 0.5) * 2
      -> conv 3x3 SAME (1 -> 3) 'colorizer' -> avg pool 2x2
      -> [BN -> LeakyReLU(0.1) -> conv 3x3 (3 -> 3)] x2 -> BN
      -> + avg pool 2x2 of the input (1 channel broadcast to 3)
      -> dropout 0.1 (train mode)
      -> backbone (`reference/<name>.py`) -> NHWC flatten -> dense

The published architectures are Chollet (arXiv:1610.02357), Howard et al.
(arXiv:1704.04861) and SPNet (Hawley and Morrison, arXiv:2102.00632).
Train mode normalizes with batch statistics; eval mode with the running
ones.  Random draws (cutout, salt and pepper, the dropout mask) are made
from a `torch.Generator` in a fixed order of calls and shapes, so that a
generator seeded alike draws alike in the reference and in the program.
"""

from __future__ import annotations

import importlib
import math

import torch

from perfbench.reference.layers import F32, Ctx, Numerics, avg_pool2, \
    bn_shapes, conv, dense

#: slot layout of the normalized label and prediction vectors
VARS_PER_PRED = 8
IND_CX, IND_CY, IND_A, IND_B, IND_ANGLE1, IND_ANGLE2, IND_NOOBJ, \
    IND_RINGS = range(8)
#: the loss's weights (SPNet's models.py: center 2, size 1, angle 3, no-object
#: 0.3, rings 5)
LOSS_WEIGHTS = dict(center=2.0, size=1.0, angle=3.0, noobj=0.3, rings=5.0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7
BUFFER_SUFFIXES = (".running_mean", ".running_var")

CUTOUT_MAX_REGIONS, CUTOUT_MIN, CUTOUT_MAX = 6, 11, 75
SALT_AMOUNT, SALT_VS_PEPPER = 0.004, 0.2


def backbone(name: str):
    """The backbone module `perfbench/reference/<name>.py`."""
    return importlib.import_module(f"perfbench.reference.{name}")


def is_param(name: str) -> bool:
    """A trained leaf (not a BatchNorm running statistic)."""
    return not name.endswith(BUFFER_SUFFIXES)


def normalize(x_u8):
    return (x_u8.float() / 255.0 - 0.5) * 2.0


def param_shapes(cfg: dict) -> dict:
    """Every parameter and BatchNorm statistic of the configuration, by
    name (the program's state-dict names), with its shape."""
    bb = backbone(cfg["reference"])
    s = {"stem.colorizer.weight": (3, 1, 3, 3), **bn_shapes("stem.bn1", 3),
         "stem.conv2.weight": (3, 3, 3, 3), **bn_shapes("stem.bn2", 3),
         "stem.conv3.weight": (3, 3, 3, 3), **bn_shapes("stem.bn3", 3),
         **bb.param_shapes()}
    half = cfg["input_size"] // 2
    fh, fw = bb.output_hw(half, half)
    s["final_output.weight"] = (cfg["num_outputs"], fh * fw * bb.FEATURES)
    s["final_output.bias"] = (cfg["num_outputs"],)
    return s


def stem(c: Ctx, x):
    inputs = x
    x = avg_pool2(conv(x, c.p["stem.colorizer.weight"], c.nm))
    x = torch.nn.functional.leaky_relu(c.bn(x, "stem.bn1"), 0.1)
    x = torch.nn.functional.leaky_relu(
        c.bn(conv(x, c.p["stem.conv2.weight"], c.nm), "stem.bn2"), 0.1)
    x = c.bn(conv(x, c.p["stem.conv3.weight"], c.nm), "stem.bn3")
    return x + avg_pool2(inputs)


def dropout(x, rate: float, generator: torch.Generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def forward(params: dict, x, cfg: dict, train: bool,
            generator: torch.Generator | None = None, nm: Numerics = F32,
            stats: dict | None = None):
    """x (B, S, S, 1) float32, normalized -> (B, num_outputs) float32."""
    c = Ctx(params, train, nm, stats)
    x = stem(c, x)
    if train and cfg["dropout_rate"] > 0:
        x = dropout(x, cfg["dropout_rate"], generator)
    x = backbone(cfg["reference"]).forward(c, x)
    x = x.reshape(x.shape[0], -1)
    # the head is float32 in the configurations: no numerics rounds it
    return dense(x, params["final_output.weight"],
                 params["final_output.bias"], nm if nm.kind == "f32" else F32)


def same_loss(y_true, y_pred):
    """SPNet's loss, loss type 'same': per slot the gated squared errors
    of center, size, angle (times (a - b)^2) and rings, plus the squared
    error of the no-object lane; summed over slots, divided by the vector
    length, averaged over the batch."""
    w = LOSS_WEIGHTS
    b, m = y_pred.shape
    t = y_true.reshape(b, -1, VARS_PER_PRED)
    p = y_pred.reshape(b, -1, VARS_PER_PRED)
    sq = torch.square(t - p)
    pobj = 1.0 - t[..., IND_NOOBJ]
    abdiff2 = torch.square(t[..., IND_A] - t[..., IND_B])
    per = (w["center"] * pobj * (sq[..., IND_CX] + sq[..., IND_CY])
           + w["size"] * pobj * (sq[..., IND_A] + sq[..., IND_B])
           + w["angle"] * pobj * (sq[..., IND_ANGLE1] + sq[..., IND_ANGLE2])
           * abdiff2
           + w["rings"] * pobj * sq[..., IND_RINGS]
           + w["noobj"] * sq[..., IND_NOOBJ])
    return torch.mean(torch.sum(per, dim=-1)) / m


def in_l2_scope(name: str) -> bool:
    """The kernels SPNet's L2 term covers: the stem's, the head's and
    those of the backbone's first blocks (conv1, conv2, block2)."""
    if not name.endswith(".weight"):
        return False
    parts = name.split(".")
    return parts[0] in ("stem", "final_output") or (
        parts[0] == "backbone" and parts[1] in ("conv1", "conv2", "block2"))


def l2_term(params: dict):
    """Sum of squares of the kernels in scope (ndim >= 2: convs, depthwise,
    pointwise, dense; no BatchNorm vector)."""
    return sum(torch.sum(torch.square(v)) for n, v in params.items()
               if v.dim() >= 2 and in_l2_scope(n))


def _randint(low, high, size, generator, device):
    return torch.randint(low, high, size, generator=generator, device=device)


def augment(images, generator: torch.Generator):
    """Cutout (up to 6 rectangles an image, each filled with a level drawn
    from the image's own range), then salt and pepper on about half the
    images; the draws in SPNet's order."""
    b, h, w, _ = images.shape
    dev = images.device
    r_max = CUTOUT_MAX_REGIONS
    nreg = _randint(0, r_max + 1, (b,), generator, dev)
    y0 = _randint(0, h - CUTOUT_MIN, (b, r_max), generator, dev)
    x0 = _randint(0, w - CUTOUT_MIN, (b, r_max), generator, dev)
    rh = _randint(CUTOUT_MIN, CUTOUT_MAX, (b, r_max), generator, dev)
    rw = _randint(CUTOUT_MIN, CUTOUT_MAX, (b, r_max), generator, dev)
    lo = images.amin(dim=(1, 2, 3))
    hi = images.amax(dim=(1, 2, 3))
    u = torch.rand((b, r_max), generator=generator, device=dev)
    vals = lo[:, None] + u * (hi - lo)[:, None]
    y1 = torch.clamp_max(y0 + rh, h - 1)
    x1 = torch.clamp_max(x0 + rw, w - 1)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    for r in range(r_max):
        inside = ((ys >= y0[:, r, None, None]) & (ys < y1[:, r, None, None])
                  & (xs >= x0[:, r, None, None]) & (xs < x1[:, r, None, None])
                  & (r < nreg)[:, None, None])
        images = torch.where(inside[..., None], vals[:, r, None, None, None],
                             images)
    active = torch.rand((b,), generator=generator, device=dev) < 0.5
    rr = torch.rand(images.shape, generator=generator, device=dev)
    p_salt = SALT_AMOUNT * SALT_VS_PEPPER
    p_pepper = SALT_AMOUNT * (1.0 - SALT_VS_PEPPER)
    lo = images.amin(dim=(1, 2, 3), keepdim=True)
    hi = images.amax(dim=(1, 2, 3), keepdim=True)
    out = torch.where(rr < p_salt, hi, images)
    out = torch.where((rr >= p_salt) & (rr < p_salt + p_pepper), lo, out)
    return torch.where(active[:, None, None, None], out, images)


def onecycle(lr_max: float, total_steps: int, pct_start: float = 0.3,
             div_factor: float = 25.0, final_div: float = 1e4):
    """The 1-cycle rate of update `count`: a linear ramp from lr_max / 25
    to lr_max over the first 30 % of the updates, then a cosine down to
    lr_max / 25 / 1e4, held after the last update."""
    lr_start = lr_max / div_factor
    lr_end = lr_start / final_div
    a1 = int(total_steps * pct_start)
    a2 = total_steps - a1

    def sched(count: int) -> float:
        count = float(count)
        if count >= total_steps:
            return lr_end
        if count < a1:
            return lr_start + (lr_max - lr_start) * count / max(a1 - 1, 1)
        t = (count - a1) / max(a2 - 1, 1)
        return (lr_max - lr_end) * (1.0 + math.cos(math.pi * t)) / 2.0 \
            + lr_end

    return sched


@torch.no_grad()
def adam_update(params: list, grads: list, mu: list, nu: list,
                t: torch.Tensor, lr: float):
    """optax.adam's update in place: moments, bias corrections from the
    float32 count t (advanced here), p -= lr * m_hat / (sqrt(v_hat) +
    eps)."""
    t.add_(1.0)
    bc1, bc2 = 1.0 - torch.pow(ADAM_B1, t), 1.0 - torch.pow(ADAM_B2, t)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=t.device)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        p.sub_((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS) * lr_t)


def train_steps(params0: dict, batches, cfg: dict, lr_of, generator,
                nm: Numerics = F32, augment_on: bool = True,
                half_batch: bool = False) -> dict:
    """Follow len(batches) train steps from params0 (name -> float32
    tensor; not changed): each gathers its rows (x uint8, y float32),
    normalizes, augments, runs the train-mode forward with dropout, the
    'same' loss plus l2 * the L2 term, the gradient, and Adam at
    lr_of(count).  half_batch keeps the first half of each batch (a
    fault).  Returns the losses, the first step's outputs and gradient
    (by name) and the parameters after the last step (by name)."""
    names = [n for n in params0 if is_param(n)]
    p = {n: v.detach().clone() for n, v in params0.items()}
    leaves = [p[n] for n in names]
    mu = [torch.zeros_like(v) for v in leaves]
    nu = [torch.zeros_like(v) for v in leaves]
    t = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    losses, grad1, out1 = [], None, None
    for count, (xb, yb) in enumerate(batches):
        if half_batch:
            xb, yb = xb[: xb.shape[0] // 2], yb[: yb.shape[0] // 2]
        x = normalize(xb)
        if augment_on:
            x = augment(x, generator)
        for v in leaves:
            v.requires_grad_(True)
        out = forward(p, x, cfg, True, generator, nm)
        loss = same_loss(yb, out) + cfg["l2_reg"] * l2_term(p)
        grads = torch.autograd.grad(loss, leaves)
        for v in leaves:
            v.requires_grad_(False)
        if grad1 is None:
            grad1 = dict(zip(names, [g.detach() for g in grads]))
            out1 = out.detach()
        adam_update(leaves, grads, mu, nu, t, lr_of(count))
        losses.append(float(loss.detach()))
    return dict(losses=losses, grad1=grad1, out1=out1,
                params={n: p[n] for n in names})
