"""SPNet assembly: colorizer stem -> Xception -> dense grid head.

Counterpart of `spnet_tpu/models/spnet.py` on its default path:

  grayscale (B, S, S, 1)
    -> Conv(3ch, 3x3 SAME) 'colorizer' -> AvgPool 2x2
    -> [BN -> LeakyReLU(0.1) -> Conv(3ch)] x2 -> BN
    -> + AvgPool(input)  (residual, broadcast 1 -> 3 channels)
    -> Dropout(0.1)      (identity in eval)
    -> Xception
    -> NHWC flatten -> float32 Dense(num_outputs) 'final_output'

The flatten is NHWC, as in JAX, so a converted 51200-row head kernel needs
no permutation.  `build_model` raises for what is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from spnet_tpu.config import ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH, ModelConfig
from spnet_tpu_torch.models.layers import (
    BatchNorm,
    Kernel,
    avg_pool2_nhwc,
    conv2d_nhwc,
    init_keras_,
    leaky_relu_01,
)
from spnet_tpu_torch.models.xception import Xception

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
        x = leaky_relu_01(self.bn1(x))
        x = leaky_relu_01(self.bn2(conv2d_nhwc(x, self.conv2.weight)))
        x = self.bn3(conv2d_nhwc(x, self.conv3.weight))
        # residual: 2x2-average-pooled input, broadcast 1ch -> filters
        return x + avg_pool2_nhwc(inputs)


class SPNet(nn.Module):
    """Stem + Xception + flat float32 grid head.

    input_hw fixes the head's width (flax infers it at init).  dtype is
    the stem's compute dtype, backbone_dtype the backbone's (None = dtype);
    params stay float32.  plain_sepconv routes every separable conv
    through its plain PyTorch version (tests and the chip check only)."""

    def __init__(self, num_outputs: int = 576,
                 input_hw: tuple[int, int] = (331, 331),
                 dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 backbone_dtype: torch.dtype | None = None,
                 plain_sepconv: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone_dtype = backbone_dtype or dtype
        self.stem = Stem()
        self.stem_dropout = nn.Dropout(dropout_rate)
        self.backbone = Xception(in_ch=3, plain=plain_sepconv)
        fh, fw = Xception.output_hw(input_hw[0] // 2, input_hw[1] // 2)
        self.final_output = nn.Linear(fh * fw * Xception.FEATURES,
                                      num_outputs)

    def forward(self, x):
        x = self.stem(x.to(self.dtype))
        x = self.stem_dropout(x)
        x = self.backbone(x.to(self.backbone_dtype))
        # NHWC flatten (models/spnet.py:349 in JAX), float32 head
        x = x.reshape(x.shape[0], -1).float()
        return self.final_output(x)


def build_model(cfg: ModelConfig, num_outputs: int = 576,
                device: str | torch.device = "cpu",
                generator: torch.Generator | None = None,
                plain_sepconv: bool = False) -> SPNet:
    """SPNet for `cfg`, Keras-initialized from `generator` (seed 0 when
    None), on `device`, in eval mode."""
    unported = {
        "backbone": cfg.backbone != "Xception",
        "compound_head": getattr(cfg, "compound_head", False),
        "selective_sigmoid": cfg.selective_sigmoid,
        "stem_planar": cfg.stem_planar,
        "stem_fused": cfg.stem_fused,
        "remat": cfg.remat,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported to spnet_tpu_torch yet: {bad} (the port has the "
            "Xception model with the default head and NHWC stem)")
    size = cfg.input_size
    hw = (size, size) if size else (ORIG_IMG_HEIGHT, ORIG_IMG_WIDTH)
    model = SPNet(
        num_outputs=num_outputs,
        input_hw=hw,
        dropout_rate=cfg.dropout_rate,
        dtype=_DTYPES[cfg.compute_dtype],
        backbone_dtype=(_DTYPES[cfg.backbone_dtype]
                        if getattr(cfg, "backbone_dtype", "") else None),
        plain_sepconv=plain_sepconv,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_keras_(model, generator)
    return model.to(device).eval()
