"""MobileNet-V2 embedding backbone. Port of face_recognition_models_tpu/
models/mobilenet.py.

torchvision's mobilenet_v2 with the classifier's Linear swapped for an
`embed_dim` one, in torchvision's parameter names (`features.0` the stem,
`features.1-17` the inverted residuals' `.conv` sequences, `features.18`
the head, `classifier.1` the Linear), so `train --pretrained` reads a
torchvision file as it is. Numerics follow the flax model: convolutions
and the Linear in `dtype`, BatchNorm in fp32 (eps 1e-5, torchvision's) with
its output in `bn_dtype`. The classifier's dropout (rate 0.2) draws its
mask from the generator the forward is given (models/dropout.py): a
train-mode forward needs `rng`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from face_recognition_models_tpu_torch.models.dropout import dropout
from face_recognition_models_tpu_torch.models.resnet import (
    AUTOCAST_DTYPES,
    BatchNorm,
    Conv2d,
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (expand_ratio, out_channels, num_blocks, first_stride)
_MBV2_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def conv_bn(cin: int, cout: int, k: int, stride: int, groups: int,
            bn_dtype: torch.dtype, act: Optional[nn.Module]
            ) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: conv (no bias, padding k // 2),
    BatchNorm, then `act` when given."""
    layers = [Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False),
              BatchNorm(cout, dtype=bn_dtype)]
    if act is not None:
        layers.append(act)
    return nn.Sequential(*layers)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 bn_dtype: torch.dtype):
        super().__init__()
        hidden = cin * expand
        self.use_skip = stride == 1 and cin == cout
        layers = []
        if expand != 1:
            layers.append(conv_bn(cin, hidden, 1, 1, 1, bn_dtype,
                                  nn.ReLU6()))
        layers += [conv_bn(hidden, hidden, 3, stride, hidden, bn_dtype,
                           nn.ReLU6()),
                   Conv2d(hidden, cout, 1, bias=False),
                   BatchNorm(cout, dtype=bn_dtype)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_skip else y


class Dropout(nn.Module):
    """The classifier's dropout: its rate, in torchvision's place
    (`classifier.0`); the forward of the trunk applies it with its
    generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng=None):
        return dropout(x, self.rate, rng, self.training)


class MobileNetV2(nn.Module):
    """forward(x, rng=None) takes NHWC images [N, H, W, 3] and returns
    [N, embed_dim] in `dtype`."""

    takes_rng = True

    def __init__(self, embed_dim: int = 512, dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.embed_dim = dtype, embed_dim
        c = _make_divisible(32)
        layers = [conv_bn(3, c, 3, 2, 1, bn_dtype, nn.ReLU6())]
        for t, ch, n, s in _MBV2_SETTINGS:
            out_c = _make_divisible(ch)
            for j in range(n):
                layers.append(InvertedResidual(c, out_c, s if j == 0 else 1,
                                               t, bn_dtype))
                c = out_c
        last_c = _make_divisible(1280)
        layers.append(conv_bn(c, last_c, 1, 1, 1, bn_dtype, nn.ReLU6()))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(Dropout(dropout_rate),
                                        nn.Linear(last_c, embed_dim))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}. "
                "(PyTorch-style NCHW must be transposed.)")
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = x.to(self.dtype)
            for layer in self.features:
                x = layer(x).to(self.dtype)
            x = self.classifier[0](x.mean(dim=(2, 3)), rng)
            return self.classifier[1](x)


def mobilenet_v2(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32,
                 image_size: int = 112) -> MobileNetV2:
    return MobileNetV2(embed_dim=embed_dim, dtype=dtype, bn_dtype=bn_dtype)
