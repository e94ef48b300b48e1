"""Explicit, serializable configuration (the port's copy of
`spnet_tpu/config.py`, kept whole so that both packages read and write
the same `experiment.json` and the port imports nothing of the JAX
package; fields that only the JAX package acts on are carried as they are).

Replaces the reference's module-global configuration and hidden mutable
normalization state (`spnet/config.py`,
`spnet/utils.py:140-176`) with frozen dataclasses.  The
`GridSpec` in particular owns the YOLO predictor-grid geometry *and* the
normalization means/ranges, so that evaluate/predict can never silently
denormalize with the wrong statistics (a latent hazard in the reference:
`predict_spnet.py:91-93` reconstructs them from a hardcoded shape).
"""

from __future__ import annotations

import dataclasses
import json
from functools import cached_property
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Output-vector layout.
#
# Each predictor slot emits 8 variables, laid out exactly as the reference
# (`spnet/config.py:30-38`):
#   [cx, cy, a, b, cos(2*theta), sin(2*theta), noobj, rings]
# `noobj` is an anti-existence flag (0 = object present), `rings` is a float
# ring-count regression target.
# ---------------------------------------------------------------------------
VARS_PER_PRED = 8
IND_CX = 0
IND_CY = 1
IND_A = 2
IND_B = 3
IND_ANGLE1 = 4  # cos(2*theta)
IND_ANGLE2 = 5  # sin(2*theta)
IND_NOOBJ = 6
IND_RINGS = 7

#: Native resolution of ESPI frames (width, height), as produced by the data
#: generator and assumed by the metric rasterizer
#: (`gen_fake_espi.py:31-32`, `spnet/utils.py:140`).
ORIG_IMG_WIDTH = 512
ORIG_IMG_HEIGHT = 384


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Geometry + normalization statistics of the YOLO predictor grid.

    Mirrors the behavior of `setup_means_and_ranges`
    (`spnet/utils.py:144-176`): a `nx` x `ny` grid of cells
    covering the active region [cx_min, cx_max] x [cy_min, cy_max], with
    `preds_per_cell` predictor slots per cell.  Empty slots take per-cell
    default values; normalization is (Y - means) / ranges with per-slot
    means/ranges derived from the cell geometry.
    """

    nx: int = 6
    ny: int = 6
    preds_per_cell: int = 2
    cx_min: float = 40.0
    cy_min: float = 40.0
    cx_max: float = 470.0
    cy_max: float = 350.0
    img_width: int = ORIG_IMG_WIDTH
    img_height: int = ORIG_IMG_HEIGHT

    # ----- derived geometry ------------------------------------------------
    @property
    def xbinsize(self) -> int:
        # int() truncation matches the reference (`utils.py:153`).
        return int((self.cx_max - self.cx_min) / self.nx)

    @property
    def ybinsize(self) -> int:
        return int((self.cy_max - self.cy_min) / self.ny)

    @property
    def pred_shape(self) -> tuple[int, int, int, int]:
        return (self.nx, self.ny, self.preds_per_cell, VARS_PER_PRED)

    @property
    def num_outputs(self) -> int:
        return self.nx * self.ny * self.preds_per_cell * VARS_PER_PRED

    # ----- per-slot statistics --------------------------------------------
    def _grid_centers(self) -> tuple[np.ndarray, np.ndarray]:
        """Cell-center coordinates, shape (nx, ny) each."""
        i = np.arange(self.nx, dtype=np.float32)
        j = np.arange(self.ny, dtype=np.float32)
        gx = i * self.xbinsize + self.cx_min + self.xbinsize / 2.0
        gy = j * self.ybinsize + self.cy_min + self.ybinsize / 2.0
        return np.meshgrid(gx, gy, indexing="ij")

    @cached_property
    def defaults(self) -> np.ndarray:
        """Default values for empty predictor slots, shape pred_shape.

        Per reference `utils.py:165`: [cx_cell, cy_cell, xbin/2, ybin/2,
        cos2t=-1 (i.e. 90 deg), sin2t=0, noobj=1, rings=0].
        """
        gcx, gcy = self._grid_centers()
        d = np.zeros(self.pred_shape, dtype=np.float32)
        d[..., IND_CX] = gcx[:, :, None]
        d[..., IND_CY] = gcy[:, :, None]
        d[..., IND_A] = self.xbinsize / 2.0
        d[..., IND_B] = self.ybinsize / 2.0
        d[..., IND_ANGLE1] = -1.0
        d[..., IND_ANGLE2] = 0.0
        d[..., IND_NOOBJ] = 1.0
        d[..., IND_RINGS] = 0.0
        return d

    @cached_property
    def means(self) -> np.ndarray:
        """Normalization offsets, flattened to (num_outputs,).

        Per reference `utils.py:166`: noobj mean kept at 0 (not 0.5) so the
        normalized value stays in [0, 1] and retains its probabilistic
        interpretation.
        """
        gcx, gcy = self._grid_centers()
        m = np.zeros(self.pred_shape, dtype=np.float32)
        m[..., IND_CX] = gcx[:, :, None]
        m[..., IND_CY] = gcy[:, :, None]
        m[..., IND_A] = self.xbinsize / 2.0
        m[..., IND_B] = self.ybinsize / 2.0
        m[..., IND_ANGLE1] = 0.0
        m[..., IND_ANGLE2] = 0.0
        m[..., IND_NOOBJ] = 0.0
        m[..., IND_RINGS] = 5.0
        return m.reshape(-1)

    @cached_property
    def ranges(self) -> np.ndarray:
        """Normalization scales, flattened to (num_outputs,)
        (reference `utils.py:169`)."""
        r = np.zeros(self.pred_shape, dtype=np.float32)
        r[..., IND_CX] = self.xbinsize
        r[..., IND_CY] = self.ybinsize
        r[..., IND_A] = self.xbinsize
        r[..., IND_B] = self.ybinsize
        r[..., IND_ANGLE1] = 2.0
        r[..., IND_ANGLE2] = 2.0
        r[..., IND_NOOBJ] = 1.0
        r[..., IND_RINGS] = 10.0
        return r.reshape(-1)

    # ----- (de)serialization ----------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "GridSpec":
        return cls(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Multi-task loss weights (reference `spnet/models.py:557-561`)."""

    center: float = 2.0
    size: float = 1.0
    angle: float = 3.0
    noobj: float = 0.3
    rings: float = 5.0  # "class" weight in the reference


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model architecture selection.

    backbone: 'Xception' | 'MobileNet' | 'InceptionResNetV2'
        (reference `spnet/config.py:50-52`).
    loss_type: 'same' (MSE existence term) or 'hybrid'
        (BCE-with-logits existence term)  (reference `spnet/config.py:40`).
    """

    backbone: str = "Xception"
    #: Square input resolution; 0 = no resize (native 512x384 frames, the
    #: reference's 'big' model_type — `spnet/config.py:47`).
    input_size: int = 331
    grayscale: bool = True
    loss_type: str = "same"
    dropout_rate: float = 0.1
    stem_filters: int = 3
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    #: Mixed-precision split: when set (e.g. "bfloat16" with
    #: compute_dtype="float32"), the BACKBONE computes in this dtype
    #: while the stem + head keep compute_dtype.  The ring-count
    #: regression is precision-sensitive in the stem/head; the backbone
    #: tolerates bf16 — this buys most of bf16's throughput at
    #: near-f32 accuracy (VALIDATION.md §2).  Empty = compute_dtype
    #: everywhere.
    backbone_dtype: str = ""
    l2_reg: float = 1e-4  # reference `models.py:47`
    selective_sigmoid: bool = False  # reference model_type 'ss'
    #: Compound head: separate sigmoid existence branch interleaved with
    #: the linear branch (reference model_type 'compound',
    #: `models.py:379-386`).
    compound_head: bool = False
    #: Stem layout: True = channel-planes (B,C,H,W) shifted-MAD stem,
    #: False = NHWC nn.Conv stem.  Numerical twins (same param tree,
    #: outputs to 1e-5); the default is whichever measured faster on the
    #: real chip (see VALIDATION.md §1).
    stem_planar: bool = False
    #: Space-to-depth fused entry: conv1 + avgpool folded into one 4x4
    #: stride-2 patch-einsum (models/spnet.py:_fused) — removes the
    #: 331^2x3 conv1 intermediate that made the NHWC stem copy-bound at
    #: C in {1,3} (round-1 profile).  Numerical twin of the NHWC stem
    #: (same param tree; exact in f32).  Default set by the measured
    #: A/B on real TPU (VALIDATION.md §1).
    stem_fused: bool = False
    #: Optional path to Keras pretrained backbone weights (.h5/.keras);
    #: currently supported for MobileNet (the reference's imagenet path,
    #: `models.py:349-355`).  Empty = train from scratch, which is what
    #: the reference's Xception headline runs actually do (`models.py:359`).
    pretrained: str = ""
    #: Rematerialize backbone activations in the backward pass
    #: (jax.checkpoint / nn.remat): trades recompute FLOPs for HBM —
    #: for larger batches or the native-resolution 'big' mode.
    remat: bool = False

    #: Largest inference batch known safe for the fused space-to-depth
    #: stem: b=512 eval reproducibly kernel-faults the TPU worker on
    #: this toolchain (NOTES.md round-3 log); b<=256 is clean in eval
    #: and b=128 in training.
    STEM_FUSED_MAX_INFER_BATCH = 256

    def clamp_infer_batch(self, batch_size: int) -> int:
        """Clamp an inference batch size to what this model variant can
        safely execute.  Every batched-predict path routes through this
        so a user-settable flag can never take down the device."""
        cap = self.STEM_FUSED_MAX_INFER_BATCH
        if self.stem_fused and batch_size > cap:
            print(f"    (stem_fused: clamping inference batch "
                  f"{batch_size} -> {cap}; larger eval batches "
                  f"kernel-fault this stem variant on TPU)")
            return cap
        return batch_size


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run parameters (reference `train_spnet.py:96-112` argparse surface)."""

    batch_size: int = 16
    epochs: int = 100
    lr_max: float = 4e-5
    adam_lr: float = 1e-5  # used only if one-cycle disabled
    freeze_fac: float = 0.0
    frozen_epochs: int = 0
    fraction: float = 1.0
    seed: int = 1
    augment: bool = True
    #: Train-time Gaussian-blur probability.  Default 0 matches the
    #: reference's EFFECTIVE recipe: its `blur_inplace` discards the cv2
    #: result (`augmentation.py:66-70`), so reference training never
    #: actually blurred.  Set >0 to opt in to real blur.
    blur_prob: float = 0.0
    #: Train-time GEOMETRIC augmentation (random flip/rotate/translate
    #: with on-device label re-encode) — the TPU-first replacement for
    #: the reference's offline 42x dataset inflation (augment_preproc.py).
    geo_augment: bool = False
    #: Shuffled passes over the training set per "epoch" (per epoch
    #: device program / per val sweep).  >1 amortizes the per-epoch val
    #: sweep + host metrics over R passes — for tiny datasets trained
    #: many passes (the Dataset-D shape: 1,280 frames x 42 warps,
    #: `augment_preproc.py:103`), where a per-pass val sweep would
    #: dominate wall-clock.  Each pass gets a fresh shuffle (and, with
    #: geo_augment, fresh warps); repeats=1 is the reference protocol.
    epoch_repeats: int = 1
    #: Emit TensorBoard event files (scalar curves + per-epoch overlay
    #: image summaries) into <log_dir>/tb — reference `use_tb`
    #: (`callbacks.py:88-90,239-248`); default off like the reference.
    use_tb: bool = False
    #: Adam update semantics: "optax" (optax.adam, eps on corrected
    #: sqrt(v_hat)) or "keras" (tf.keras Adam: eps on UNcorrected
    #: sqrt(v), bias correction folded into lr_t — the reference's
    #: actual optimizer, see train/optim.py).  None -> SPNET_ADAM env
    #: var, default "optax".
    adam_variant: str | None = None
    save_every: int = 5  # epochs between checkpoints (`callbacks.py:37`)
    # 1-cycle shape parameters (reference `callbacks.py:366`)
    onecycle_pct_start: float = 0.3
    onecycle_div_factor: float = 25.0
    onecycle_final_div: float = 1e4


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Top-level bundle saved alongside checkpoints so that eval/predict
    always reconstruct identical normalization + architecture."""

    grid: GridSpec = dataclasses.field(default_factory=GridSpec)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    loss_weights: LossWeights = dataclasses.field(default_factory=LossWeights)

    def to_json(self) -> str:
        return json.dumps(_to_jsonable(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        d = json.loads(s)
        return cls(
            grid=GridSpec(**d["grid"]),
            model=ModelConfig(**d["model"]),
            train=TrainConfig(**d["train"]),
            loss_weights=LossWeights(**d["loss_weights"]),
        )
