"""SPNet assembly: colorizer stem -> backbone -> dense grid head.

Counterpart of `spnet_tpu/models/spnet.py`:

  grayscale (B, S, S, 1)
    -> Conv(3ch, 3x3 SAME) 'colorizer' -> AvgPool 2x2
    -> [BN -> LeakyReLU(0.1) -> Conv(3ch)] x2 -> BN
    -> + AvgPool(input)  (residual, broadcast 1 -> 3 channels)
    -> Dropout(0.1)      (identity in eval; in train mode its mask comes
                          from the generator passed to forward)
    -> Xception | MobileNet | MobileNetTiny | DarkNet19 | InceptionResNetV2
       | NASNetMobile
    -> NHWC flatten -> float32 head:
         default        Dense(num_outputs) 'final_output'
         compound_head  Dense(S) 'sigmoid_output' -> sigmoid, and
                        Dense(num_outputs - S) 'dense_output', interleaved
                        so that slot k's noobj lane holds sigmoid k
                        (reference model_type 'compound')
    [-> selective sigmoid on every noobj lane]  (reference model_type 'ss';
         kernel K4, `ops/activations.py::SelectiveSigmoid`; the fused
         training loss applies it itself, and the train step then asks
         the model to leave it out: forward(..., selective_sigmoid=False))

The flatten is NHWC, as in JAX, so a converted head kernel needs no
permutation, and the compound interleave is JAX's, so neither does the
split head.  With both heads set, the noobj lanes go through two sigmoids,
as in JAX.

`remat` (JAX's `nn.remat` over the backbone) runs the backbone under
`torch.utils.checkpoint` in train mode: its activations are recomputed in
the backward pass instead of kept.  It is one region over the whole
backbone, as in JAX, so the backward rebuilds every backbone activation at
once and the peak memory barely falls.  The recompute leaves the BatchNorm
running statistics alone (flax keeps the first pass's update only), and
the parameter names do not change, so checkpoints are interchangeable.
`build_model` raises ValueError for an unknown backbone, as JAX does, and
NotImplementedError for the planar and fused stems (TPU workarounds the
port does not carry).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from spnet_tpu_torch.models.layers import (
    BatchNorm,
    Dropout,
    Kernel,
    avg_pool2_nhwc,
    conv2d_nhwc,
    init_keras_,
)
from spnet_tpu_torch.models.darknet import DarkNet19
from spnet_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
from spnet_tpu_torch.models.mobilenet import MobileNet
from spnet_tpu_torch.models.nasnet import NASNetMobile
from spnet_tpu_torch.models.xception import Xception
# aliased: forward's `selective_sigmoid` argument would shadow it
from spnet_tpu_torch.ops.activations import selective_sigmoid as \
    selective_sigmoid_op, selective_sigmoid_torch
from spnet_tpu_torch.config import (
    IND_NOOBJ, ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH, VARS_PER_PRED, ModelConfig,
)

#: The backbones, each a constructor of (plain_kernels, the backbone's
#: input (h, w)) -> module; each module has LAYER_ORDER, FEATURES and
#: output_hw.  Only NASNet's structure depends on the input size.
BACKBONES = {
    "Xception": lambda plain, hw: Xception(in_ch=3, plain=plain),
    "MobileNet": lambda plain, hw: MobileNet(in_ch=3, width_mult=1.0),
    "MobileNetTiny": lambda plain, hw: MobileNet(in_ch=3, width_mult=0.125),
    "DarkNet19": lambda plain, hw: DarkNet19(in_ch=3),
    "InceptionResNetV2": lambda plain, hw: InceptionResNetV2(in_ch=3),
    "NASNetMobile": lambda plain, hw: NASNetMobile(in_ch=3, input_hw=hw),
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Stem(nn.Module):
    """The 'colorizer' front end, NHWC (the JAX `Stem._nhwc` path)."""

    def __init__(self, in_ch: int = 1, filters: int = 3):
        super().__init__()

        def conv(cin):
            return Kernel((filters, cin, 3, 3), fan_in=cin * 9,
                          fan_out=filters * 9)

        self.colorizer = conv(in_ch)
        self.bn1 = BatchNorm(filters)
        self.conv2 = conv(filters)
        self.bn2 = BatchNorm(filters)
        self.conv3 = conv(filters)
        self.bn3 = BatchNorm(filters)

    def forward(self, x):
        inputs = x
        x = avg_pool2_nhwc(conv2d_nhwc(x, self.colorizer.weight))
        x = self.bn1(x, "leaky")
        x = self.bn2(conv2d_nhwc(x, self.conv2.weight), "leaky")
        x = self.bn3(conv2d_nhwc(x, self.conv3.weight))
        # residual: 2x2-average-pooled input, broadcast 1ch -> filters
        return x + avg_pool2_nhwc(inputs)


@contextlib.contextmanager
def _stats_frozen(bns):
    """The BatchNorms in `bns` skip their running-statistic update."""
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class SPNet(nn.Module):
    """Stem + backbone + flat float32 grid head.

    input_hw fixes the head's width (flax infers it at init).  dtype is
    the stem's compute dtype, backbone_dtype the backbone's (None = dtype);
    params stay float32.  plain_kernels routes every separable conv and the
    selective sigmoid through their plain PyTorch versions (tests and the
    chip check only).  remat recomputes the backbone's activations in the
    backward pass of a train-mode step."""

    def __init__(self, num_outputs: int = 576,
                 input_hw: tuple[int, int] = (331, 331),
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 backbone_dtype: torch.dtype | None = None,
                 backbone: str = "Xception",
                 selective_sigmoid: bool = False,
                 compound_head: bool = False,
                 plain_kernels: bool = False,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone_dtype = backbone_dtype or dtype
        self.selective_sigmoid, self.compound_head = (selective_sigmoid,
                                                      compound_head)
        self.plain_kernels = plain_kernels
        self.stem = Stem()
        self.stem_dropout = Dropout(dropout_rate)
        if backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r} (one of "
                             f"{', '.join(BACKBONES)})")
        # the stem's 2x2 average pool halves the input, rounding down
        hw = (input_hw[0] // 2, input_hw[1] // 2)
        self.backbone = BACKBONES[backbone](plain_kernels, hw)
        self.remat = remat
        # a tuple, not a ModuleList: no second name for these parameters
        self._backbone_bns = tuple(m for m in self.backbone.modules()
                                   if isinstance(m, BatchNorm))
        fh, fw = self.backbone.output_hw(*hw)
        n_in = fh * fw * self.backbone.FEATURES
        if compound_head:
            n_preds = num_outputs // VARS_PER_PRED
            self.sigmoid_output = nn.Linear(n_in, n_preds)
            self.dense_output = nn.Linear(n_in, num_outputs - n_preds)
        else:
            self.final_output = nn.Linear(n_in, num_outputs)

    def forward(self, x, dropout_generator: torch.Generator | None = None,
                *, selective_sigmoid: bool = True):
        """x (B, H, W, 1) -> (B, num_outputs) float32.  In train mode with
        a dropout rate above 0, `dropout_generator` (on x's device) draws
        the dropout mask.  selective_sigmoid=False leaves the 'ss' head's
        selective sigmoid out (its pre-activation, for a loss that applies
        it); it changes nothing for the other heads."""
        x = self.stem(x.to(self.dtype))
        x = self.stem_dropout(x, dropout_generator)
        x = x.to(self.backbone_dtype)
        if self.remat and self.training and torch.is_grad_enabled():
            # the backbone draws no random numbers (dropout is in the stem,
            # outside), so no RNG state needs keeping for the recompute
            x = checkpoint(self.backbone, x, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=lambda: (contextlib.nullcontext(),
                                               _stats_frozen(
                                                   self._backbone_bns)))
        else:
            x = self.backbone(x)
        # NHWC flatten (models/spnet.py:349 in JAX), float32 head
        x = x.reshape(x.shape[0], -1).float()
        if self.compound_head:
            sig = torch.sigmoid(self.sigmoid_output(x))
            d3 = self.dense_output(x).reshape(x.shape[0], sig.shape[1],
                                              VARS_PER_PRED - 1)
            x = torch.cat([d3[..., :IND_NOOBJ], sig[..., None],
                           d3[..., IND_NOOBJ:]], dim=-1)
            x = x.reshape(x.shape[0], -1)
        else:
            x = self.final_output(x)
        if self.selective_sigmoid and selective_sigmoid:
            if self.plain_kernels:
                x = selective_sigmoid_torch(x)
            else:
                x = selective_sigmoid_op(x)
        return x

    def backbone_layer_order(self) -> list[str]:
        """The backbone's top-level blocks in order (freeze masks)."""
        return list(self.backbone.LAYER_ORDER)


def build_model(cfg: ModelConfig, num_outputs: int = 576, *,
                device: str | torch.device,
                generator: torch.Generator | None = None,
                plain_kernels: bool = False) -> SPNet:
    """SPNet for `cfg`, Keras-initialized from `generator` (a CPU
    generator; seed 0 when None), on `device`, in eval mode (a train step
    switches modes itself).  `device` has no default: the caller names the
    card or the CPU."""
    unported = {
        "stem_planar": cfg.stem_planar,
        "stem_fused": cfg.stem_fused,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported to spnet_tpu_torch: {bad} (TPU workarounds; the "
            "port has the NHWC stem)")
    size = cfg.input_size
    hw = (size, size) if size else (ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH)
    model = SPNet(
        num_outputs=num_outputs,
        input_hw=hw,
        dropout_rate=cfg.dropout_rate,
        dtype=_DTYPES[cfg.compute_dtype],
        backbone_dtype=(_DTYPES[cfg.backbone_dtype]
                        if getattr(cfg, "backbone_dtype", "") else None),
        backbone=cfg.backbone,
        selective_sigmoid=cfg.selective_sigmoid,
        compound_head=cfg.compound_head,
        plain_kernels=plain_kernels,
        remat=cfg.remat,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_keras_(model, generator)
    return model.to(device).eval()
