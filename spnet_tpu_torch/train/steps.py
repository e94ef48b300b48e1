"""Train, eval and predict steps.

Counterpart of `spnet_tpu/train/steps.py`.  A train step gathers its
minibatch from the uint8 dataset resident on the device (or, host-fed,
takes the minibatch itself), normalizes it,
with `geo_augment` warps it by a random flip / rotation / translation and
re-encodes its labels from the remapped ellipse rows, augments it
(cutout, salt & pepper, optional blur), runs the forward pass
in train mode (batch-stat BatchNorm, dropout), the loss (the fused kernels
K2/K3, which on the 'ss' head also apply its selective sigmoid K4) plus the
L2 penalty, the backward pass, and one Adam update under the 1-cycle
schedule.  PyTorch runs eagerly, so where JAX
compiles a whole epoch into one program, the port runs one step per
minibatch from a Python loop (`train/loop.py`).

L2 regularization: an explicit penalty over the conv and dense kernels in
scope, added to the loss, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from spnet_tpu_torch.models.layers import Kernel
from spnet_tpu_torch.ops import augment as aug_ops
from spnet_tpu_torch.ops.grid_encode import encode_batch_device
from spnet_tpu_torch.ops.losses import loss_components, spnet_loss, \
    spnet_loss_fused
from spnet_tpu_torch.config import GridSpec, LossWeights
from spnet_tpu_torch.utils.profiling import annotate


def _prep_x(x):
    """Datasets may be stored as uint8 (4x fewer bytes to the device);
    normalize on the device with the Inception scaling."""
    if x.dtype == torch.uint8:
        return (x.float() / 255.0 - 0.5) * 2.0
    return x


#: Which kernels the L2 penalty covers.  'reference' mirrors the layers the
#: reference's regularizer effectively touched: the stem, the first
#: backbone blocks and the head (`spnet_tpu/train/steps.py:74-95`).
L2_SCOPES = ("reference", "all", "none")


def kernel_names(model: nn.Module) -> list[str]:
    """Parameter names of the conv and dense kernels, the leaves flax calls
    'kernel': every `Kernel.weight` and the Dense head's weight.  BN
    parameters and the Dense bias are not kernels."""
    return [f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (Kernel, nn.Linear))]


def _l2_in_scope(name: str, scope: str) -> bool:
    """Whether the kernel parameter `name` is in the L2 scope."""
    if scope == "reference":
        parts = name.split(".")
        return (parts[0] in ("stem", "final_output", "sigmoid_output",
                             "dense_output")
                or (parts[0] == "backbone"
                    and parts[1] in ("conv1", "conv2", "block2")))
    return scope == "all"


def kernel_l2(model: nn.Module, scope: str = "reference"):
    """Sum of squared kernels in scope, float32 (0 for 'none')."""
    if scope not in L2_SCOPES:
        raise ValueError(f"l2 scope must be one of {L2_SCOPES}, got "
                         f"{scope!r}")
    params = dict(model.named_parameters())
    terms = [torch.sum(torch.square(params[n].float()))
             for n in kernel_names(model) if _l2_in_scope(n, scope)]
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return torch.stack(terms).sum()


def forward_loss(model: nn.Module, x, y, generator: torch.Generator | None,
                 loss_weights: LossWeights = LossWeights(),
                 loss_type: str = "same", l2_reg: float = 1e-4,
                 l2_scope: str = "reference", fused: bool = True):
    """Forward pass in the model's current mode, data loss (the fused
    kernels, or the plain twin with fused=False) and the L2 term.
    Returns (loss, data_loss), both 0-d float32 tensors.

    On an 'ss' head with its kernels (not `plain_kernels`), the fused loss
    applies the selective sigmoid in its own pass: the model leaves it out
    and the loss takes the pre-activation (one launch forward and one
    backward in place of four).  fused=False keeps the model's
    `SelectiveSigmoid` and the plain loss."""
    ss = fused and model.selective_sigmoid and not model.plain_kernels
    out = model(x, dropout_generator=generator, selective_sigmoid=not ss)
    data_loss = (spnet_loss_fused(y, out, loss_weights, loss_type,
                                  selective_sigmoid=ss) if fused
                 else spnet_loss(y, out, loss_weights, loss_type))
    loss = data_loss
    if l2_reg and l2_scope != "none":
        loss = loss + l2_reg * kernel_l2(model, l2_scope)
    return loss, data_loss


def make_train_step(model: nn.Module,
                    loss_weights: LossWeights = LossWeights(),
                    loss_type: str = "same", l2_reg: float = 1e-4,
                    augment: bool = True, blur_prob: float = 0.0,
                    l2_scope: str = "reference",
                    indexed: str | bool = "epoch",
                    geo_augment: bool = False, grid: GridSpec | None = None):
    """Returns train_step(state, x_all, y_all, idx, generator) ->
    (state, metrics).

    x_all (N, H, W, 1) uint8 and y_all (N, M) float32 are the whole
    training set (or a chunk of it) on the device; idx (b,) int64 on the
    same device picks the minibatch, gathered there.  With indexed=False
    (the host-fed feed) the step takes the minibatch itself:
    train_step(state, x, y, generator), x (b, H, W, 1).  `generator` (on
    that device) draws the augmentation and the dropout mask.  The loss runs
    through the fused kernels (`spnet_loss_fused`).  The step updates
    `state` in place (parameters, BN statistics, optimizer state, step)
    and returns it; metrics hold 'loss' and 'data_loss' as device scalars
    (no host sync) and 'lr', the schedule at the step it ran.

    With `geo_augment=True` (requires `grid`) the step takes the padded
    raw rows (N, S, 6) and their mask (N, S) after `y_all`:
    train_step(state, x_all, y_all, rows_all, mask_all, idx, generator).
    In this order: normalize, `geo_augment_batch` on the normalized frames
    and the native-coordinate rows (flip / rotate / translate, fill -1),
    `y = encode_batch_device(rows, mask, grid)` (the stored y_all is not
    read), then cutout / salt & pepper, the model and the loss.  Host-fed
    and geo: train_step(state, x, y, rows, mask, generator)."""
    if indexed not in ("epoch", False):
        raise ValueError(f"indexed must be 'epoch' or False, got "
                         f"{indexed!r}")
    if l2_scope not in L2_SCOPES:
        raise ValueError(f"l2 scope must be one of {L2_SCOPES}, got "
                         f"{l2_scope!r}")
    if geo_augment and grid is None:
        raise ValueError("geo_augment=True requires the GridSpec")

    def step(state, x, y, generator, rows=None, mask=None):
        """One update from the minibatch (x, y[, rows, mask])."""
        m = state.model
        m.train()
        x = _prep_x(x)
        if geo_augment:
            with annotate("geo_augment"):
                x, rows = aug_ops.geo_augment_batch(
                    x, rows, mask, generator,
                    img_w=grid.img_width, img_h=grid.img_height)
            with annotate("grid_encode"):
                y = encode_batch_device(rows, mask, grid)
        if augment:
            x = aug_ops.augment_on_the_fly(x, generator, blur_prob=blur_prob)
        params = list(m.parameters())
        loss, data_loss = forward_loss(
            m, x, y, generator, loss_weights, loss_type, l2_reg, l2_scope)
        grads = torch.autograd.grad(loss, params)
        lr = state.schedule(state.step)
        state.opt_state = state.optimizer.update(params, grads,
                                                 state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "data_loss": data_loss.detach(),
                       "lr": lr}

    if indexed is False:
        if geo_augment:
            def train_step_geo(state, x, y, rows, mask, generator):
                return step(state, x, y, generator, rows, mask)

            return train_step_geo
        return step

    if geo_augment:
        def train_step_geo(state, x_all, y_all, rows_all, mask_all, idx,
                           generator):
            # the stored labels are not read: the step encodes its own
            return step(state, x_all[idx], None, generator, rows_all[idx],
                        mask_all[idx])

        return train_step_geo

    def train_step(state, x_all, y_all, idx, generator):
        return step(state, x_all[idx], y_all[idx], generator)

    return train_step


def make_eval_step(model: nn.Module,
                   loss_weights: LossWeights = LossWeights(),
                   loss_type: str = "same"):
    """Returns eval_step(x, y) -> (y_pred, component losses), eval mode,
    no autograd."""

    @torch.inference_mode()
    def eval_step(x, y):
        model.eval()
        out = model(_prep_x(x))
        return out, loss_components(y, out, loss_weights, loss_type)

    return eval_step


def make_predict_step(model: nn.Module):
    """Returns predict(x) -> y_pred (normalized), eval mode (set on every
    call: a train step switches the model to train mode), no autograd."""

    @torch.inference_mode()
    def predict(x):
        model.eval()
        return model(_prep_x(x))

    return predict
