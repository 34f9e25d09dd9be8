"""iResNet (insightface's improved ResNet) embedding backbones. Port of
face_recognition_models_tpu/models/iresnet.py.

The ArcFace production trunk: a 3x3 stride-1 stem with no max pool (every
stage halves the map, 112 -> 7), BN-first basic blocks (BN -> conv3x3 ->
BN -> PReLU -> conv3x3(stride) -> BN, the residual added with no ReLU
after it), per-channel PReLU, and the head BN2d -> flatten -> Dense(embed)
-> a feature BatchNorm1d whose scale is frozen at 1, fp32 out.

The parameter names are arcface_torch's (`conv1/bn1/prelu`,
`layerL.B.{bn1,conv1,bn2,prelu,conv2,bn3,downsample}`, `bn2/fc/features`)
and the map is flattened in torch's (C, H, W) order, so the state_dict is
an arcface_torch iresnet's as it is. The JAX model flattens (H, W, C):
utils/weights.from_jax permutes its fc. Numerics follow the flax model:
convolutions and the Dense layer in `dtype`, BatchNorm in fp32 with the
output in `bn_dtype`, PReLU in its input's dtype. The fc's width depends
on the map it flattens, so the model is built for one `image_size` (a
multiple of 16).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from face_recognition_models_tpu_torch.models.resnet import (
    AUTOCAST_DTYPES,
    BatchNorm,
    Conv2d,
)


class PReLU(nn.Module):
    """Per-channel PReLU (torch nn.PReLU(C)'s parameter `weight`): an fp32
    slope, the math in the input's dtype, max(x, 0) + a * min(x, 0). Works
    on NCHW maps and on [N, C] batches."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_features,), 0.25))

    def reset_flax_(self, generator: torch.Generator) -> None:
        self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype)
        if x.dim() == 4:
            a = a.view(1, -1, 1, 1)
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class IBasicBlock(nn.Module):
    """BN -> conv3x3 -> BN -> PReLU -> conv3x3(stride) -> BN + shortcut."""

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, bn_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.bn1 = BatchNorm(cin, dtype=bn_dtype)
        self.conv1 = _conv3x3(cin, filters)
        self.bn2 = BatchNorm(filters, dtype=bn_dtype)
        self.prelu = PReLU(filters)
        self.conv2 = _conv3x3(filters, filters, stride)
        self.bn3 = BatchNorm(filters, dtype=bn_dtype)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride=stride, bias=False),
                BatchNorm(filters, dtype=bn_dtype))

    def forward(self, x):
        y = self.conv1(self.bn1(x).to(self.dtype))
        y = self.prelu(self.bn2(y)).to(self.dtype)
        y = self.bn3(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return (y + residual).to(self.dtype)


class IResNet(nn.Module):
    """iResNet trunk -> BN -> flatten -> Dense(embed) -> feature BN.
    forward takes NHWC images [N, S, S, 3] (S = image_size) and returns
    fp32 [N, embed_dim]."""

    def __init__(self, stage_sizes: Sequence[int], embed_dim: int = 512,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32,
                 image_size: int = 112):
        super().__init__()
        if image_size % 16:
            raise ValueError(f"iresnet needs an image size divisible by 16 "
                             f"(four stride-2 stages); got {image_size}")
        self.dtype, self.embed_dim, self.image_size = (dtype, embed_dim,
                                                       image_size)
        self.conv1 = _conv3x3(3, num_filters)
        self.bn1 = BatchNorm(num_filters, dtype=bn_dtype)
        self.prelu = PReLU(num_filters)
        cin = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            blocks = []
            for j in range(n_blocks):
                blocks.append(IBasicBlock(cin, filters, 2 if j == 0 else 1,
                                          dtype, bn_dtype))
                cin = filters
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.bn2 = BatchNorm(cin, dtype=bn_dtype)
        side = image_size // 2 ** len(stage_sizes)
        self.fc = nn.Linear(cin * side * side, embed_dim)
        self.features = BatchNorm(embed_dim, use_scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}. "
                "(PyTorch-style NCHW must be transposed.)")
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            raise ValueError(f"this iresnet is built for {self.image_size} "
                             f"px, got {tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = self.conv1(x.to(self.dtype))
            x = self.prelu(self.bn1(x)).to(self.dtype)
            for i in range(self.num_stages):
                x = getattr(self, f"layer{i + 1}")(x)
            x = self.bn2(x).flatten(1)     # (C, H, W): arcface_torch's fc
            x = self.fc(x.to(self.dtype))
        return self.features(x.to(torch.float32))


def iresnet18(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
              bn_dtype: torch.dtype = torch.float32,
              image_size: int = 112) -> IResNet:
    return IResNet((2, 2, 2, 2), embed_dim=embed_dim, dtype=dtype,
                   bn_dtype=bn_dtype, image_size=image_size)


def iresnet50(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
              bn_dtype: torch.dtype = torch.float32,
              image_size: int = 112) -> IResNet:
    return IResNet((3, 4, 14, 3), embed_dim=embed_dim, dtype=dtype,
                   bn_dtype=bn_dtype, image_size=image_size)


def iresnet100(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
               bn_dtype: torch.dtype = torch.float32,
               image_size: int = 112) -> IResNet:
    return IResNet((3, 13, 30, 5), embed_dim=embed_dim, dtype=dtype,
                   bn_dtype=bn_dtype, image_size=image_size)
