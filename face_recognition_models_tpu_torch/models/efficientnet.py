"""EfficientNet-B0 embedding backbone. Port of face_recognition_models_tpu/
models/efficientnet.py.

torchvision's efficientnet_b0 (MBConv with squeeze-excite, SiLU and
stochastic depth) with the classifier's Linear swapped for an `embed_dim`
one, in torchvision's parameter names (`features.0` the stem,
`features.1-7` the stages of MBConv `.block` sequences with `fc1` / `fc2`
in the squeeze-excite, `features.8` the head, `classifier.1` the Linear),
so `train --pretrained` reads a torchvision file as it is. Numerics follow
the flax model: convolutions and the Linear in `dtype`, BatchNorm in fp32
(eps 1e-5, torchvision's) with its output in `bn_dtype`. The classifier's
dropout (0.2) and each residual block's stochastic depth (0.2 x block / 16)
draw from the generator the forward is given (models/dropout.py): a
train-mode forward needs `rng`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from face_recognition_models_tpu_torch.models.dropout import drop_path
from face_recognition_models_tpu_torch.models.mobilenet import (
    Dropout,
    conv_bn,
)
from face_recognition_models_tpu_torch.models.resnet import AUTOCAST_DTYPES

# (expand_ratio, out_channels, repeats, first_stride, kernel)
_B0_SETTINGS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class SqueezeExcitation(nn.Module):
    """x * sigmoid(fc2(silu(fc1(mean(x))))), torchvision's names."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.nn.functional.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 kernel: int, drop_path_rate: float, bn_dtype: torch.dtype):
        super().__init__()
        hidden = cin * expand
        self.use_skip = stride == 1 and cin == cout
        self.drop_path_rate = drop_path_rate
        layers = []
        if expand != 1:
            layers.append(conv_bn(cin, hidden, 1, 1, 1, bn_dtype, nn.SiLU()))
        layers += [conv_bn(hidden, hidden, kernel, stride, hidden, bn_dtype,
                           nn.SiLU()),
                   SqueezeExcitation(hidden, max(1, cin // 4)),
                   conv_bn(hidden, cout, 1, 1, 1, bn_dtype, None)]
        self.block = nn.Sequential(*layers)

    def forward(self, x, rng=None):
        y = self.block(x)
        if not self.use_skip:
            return y
        return x + drop_path(y, self.drop_path_rate, rng, self.training)


class EfficientNetB0(nn.Module):
    """forward(x, rng=None) takes NHWC images [N, H, W, 3] and returns
    [N, embed_dim] in `dtype`."""

    takes_rng = True

    def __init__(self, embed_dim: int = 512, dropout_rate: float = 0.2,
                 stochastic_depth: float = 0.2,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.embed_dim = dtype, embed_dim
        stages = [conv_bn(3, 32, 3, 2, 1, bn_dtype, nn.SiLU())]
        total = sum(s[2] for s in _B0_SETTINGS)
        c, idx = 32, 0
        for t, ch, n, s, k in _B0_SETTINGS:
            blocks = []
            for j in range(n):
                blocks.append(MBConv(c, ch, s if j == 0 else 1, t, k,
                                     stochastic_depth * idx / total,
                                     bn_dtype))
                c, idx = ch, idx + 1
            stages.append(nn.Sequential(*blocks))
        stages.append(conv_bn(c, 1280, 1, 1, 1, bn_dtype, nn.SiLU()))
        self.features = nn.Sequential(*stages)
        self.classifier = nn.Sequential(Dropout(dropout_rate),
                                        nn.Linear(1280, embed_dim))

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}. "
                "(PyTorch-style NCHW must be transposed.)")
        x = x.permute(0, 3, 1, 2)
        stages = list(self.features)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = stages[0](x.to(self.dtype)).to(self.dtype)
            for stage in stages[1:-1]:
                for block in stage:
                    x = block(x, rng).to(self.dtype)
            x = stages[-1](x).to(self.dtype)
            x = self.classifier[0](x.mean(dim=(2, 3)), rng)
            return self.classifier[1](x)


def efficientnet_b0(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
                    bn_dtype: torch.dtype = torch.float32,
                    image_size: int = 112) -> EfficientNetB0:
    return EfficientNetB0(embed_dim=embed_dim, dtype=dtype,
                          bn_dtype=bn_dtype)
