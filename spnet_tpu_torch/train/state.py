"""Train state and optimizer construction, including freeze / unfreeze.

Counterpart of `spnet_tpu/train/state.py`.  Freezing is an optimizer
property: the first `freeze_fac` fraction of the backbone's top-level
blocks get a zero update and hold no Adam moments (optax's
`multi_transform` + `set_to_zero`).  `unfreeze` swaps in an optimizer over
every parameter with fresh moments and a fresh `count`, and keeps the
weights, the BatchNorm statistics and the global `step`.  As in the JAX
package, the fresh count restarts the learning rate the update applies at
schedule(0), while the logged rate, schedule(step), carries on.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from torch import nn

from spnet_tpu_torch.train.optim import ADAM_UPDATES, AdamState, adam_init


def backbone_freeze_labels(model: nn.Module, layer_order, freeze_fac: float
                           ) -> dict[str, str]:
    """'frozen' for the parameters of the first int(n * freeze_fac)
    backbone top-level blocks, 'train' elsewhere (stem and head always
    train); keyed like `model.named_parameters()`."""
    n_frozen = int(len(layer_order) * freeze_fac)
    frozen = set(layer_order[:n_frozen])

    def label(name: str) -> str:
        parts = name.split(".")
        return ("frozen" if len(parts) >= 2 and parts[0] == "backbone"
                and parts[1] in frozen else "train")

    return {name: label(name) for name, _ in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam of one variant ('optax' or 'keras') under `schedule`, with the
    named parameters in `frozen` held fixed."""

    schedule: Callable[[int], float]
    variant: str
    frozen: frozenset = frozenset()

    def init(self, model: nn.Module) -> AdamState:
        names, params = zip(*model.named_parameters())
        return adam_init(list(params), [n not in self.frozen for n in names])

    def update(self, params, grads, state: AdamState) -> AdamState:
        """Apply one update in place; params and grads in
        `model.parameters()` order."""
        return ADAM_UPDATES[self.variant](params, grads, state,
                                          self.schedule)


def make_optimizer(schedule: Callable[[int], float], model: nn.Module,
                   layer_order, freeze_fac: float = 0.0,
                   adam_variant: str | None = None) -> Optimizer:
    """adam_variant None reads SPNET_ADAM, default 'optax' (optax.adam
    with eps 1e-7, the JAX package's default); 'keras' is tf.keras Adam."""
    if adam_variant is None:
        adam_variant = os.environ.get("SPNET_ADAM", "optax")
    if adam_variant not in ADAM_UPDATES:
        raise ValueError(f"adam_variant must be one of "
                         f"{sorted(ADAM_UPDATES)}, got {adam_variant!r}")
    frozen = frozenset()
    if freeze_fac > 0.0:
        labels = backbone_freeze_labels(model, layer_order, freeze_fac)
        frozen = frozenset(n for n, v in labels.items() if v == "frozen")
    return Optimizer(schedule, adam_variant, frozen)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer and
    its state, and the global step (updates applied, across phases)."""

    model: nn.Module
    optimizer: Optimizer
    opt_state: AdamState
    step: int = 0

    @property
    def schedule(self) -> Callable[[int], float]:
        return self.optimizer.schedule

    def opt_state_dict(self) -> dict:
        """The optimizer state for a checkpoint: variant, count, frozen
        names and the moments keyed by parameter name."""
        names = [n for n, _ in self.model.named_parameters()]
        return {
            "variant": self.optimizer.variant,
            "count": self.opt_state.count,
            "frozen": sorted(self.optimizer.frozen),
            "mu": {n: m for n, m in zip(names, self.opt_state.mu)
                   if m is not None},
            "nu": {n: v for n, v in zip(names, self.opt_state.nu)
                   if v is not None},
        }

    def load_opt_state_dict(self, saved: dict) -> bool:
        """Load a saved optimizer state in place if it belongs to the same
        optimizer (variant, frozen set, names and shapes); returns whether
        it did."""
        if saved.get("variant") != self.optimizer.variant or \
                frozenset(saved.get("frozen", ())) != self.optimizer.frozen:
            return False
        named = list(self.model.named_parameters())
        live = [n for n, _ in named if n not in self.optimizer.frozen]
        for key in ("mu", "nu"):
            if set(saved[key]) != set(live) or any(
                    saved[key][n].shape != p.shape for n, p in named
                    if n in saved[key]):
                return False
        for i, (n, p) in enumerate(named):
            if n in saved["mu"]:
                self.opt_state.mu[i].copy_(saved["mu"][n])
                self.opt_state.nu[i].copy_(saved["nu"][n])
        self.opt_state.count = int(saved["count"])
        return True


def create_train_state(model: nn.Module, schedule: Callable[[int], float],
                       freeze_fac: float = 0.0,
                       adam_variant: str | None = None) -> TrainState:
    tx = make_optimizer(schedule, model, model.backbone_layer_order(),
                        freeze_fac, adam_variant)
    return TrainState(model, tx, tx.init(model), step=0)


def unfreeze(state: TrainState, adam_variant: str | None = None
             ) -> TrainState:
    """Phase switch: every parameter trainable, fresh optimizer state
    (count 0), same weights, statistics and step."""
    model = state.model
    tx = make_optimizer(state.schedule, model, model.backbone_layer_order(),
                        freeze_fac=0.0, adam_variant=adam_variant)
    return TrainState(model, tx, tx.init(model), step=state.step)
