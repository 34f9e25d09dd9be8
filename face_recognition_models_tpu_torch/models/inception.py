"""Inception-v3 embedding backbone. Port of face_recognition_models_tpu/
models/inception.py.

torchvision's Inception-v3 graph without the aux classifier, global
average pooling, dropout 0.5 and Dense(embed). The parameter names are
torchvision's (`Conv2d_1a_3x3.conv`, `Mixed_5b.branch1x1.bn`, ...), which
the flax module names already are. BatchNorm has torchvision's eps 1e-3
and runs in fp32 with its output in `bn_dtype`; convolutions and the Dense
layer run in `dtype`. The max pools are VALID and the 3x3 stride-1 average
pool counts the padding (torch's count_include_pad=True). Inputs are at
least 75 px.

The JAX package cannot train this trunk through `fit`: its dropout gets no
generator there (face_recognition_models_tpu/train/loop.py:169), and the
port's `fit` refuses it the same way (train/loop.py). It embeds, exports
and serves; a train-mode forward with dropout needs `rng`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from face_recognition_models_tpu_torch.models.dropout import dropout
from face_recognition_models_tpu_torch.models.resnet import (
    AUTOCAST_DTYPES,
    BatchNorm,
    Conv2d,
)


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3) + relu, output in `dtype`."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0,
                 dtype=torch.bfloat16, bn_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                           bias=False)
        self.bn = BatchNorm(cout, eps=1e-3, dtype=bn_dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x))).to(self.dtype)


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features, **kw):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1, **kw)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, **kw)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, **kw)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **kw)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, **kw)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, **kw)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin, **kw):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, **kw)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **kw)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, **kw)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7, **kw):
        super().__init__()
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = BasicConv2d(cin, 192, 1, **kw)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, **kw)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=p17, **kw)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=p71, **kw)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, **kw)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=p71, **kw)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=p17, **kw)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=p71, **kw)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=p17,
                                          **kw)
        self.branch_pool = BasicConv2d(cin, 192, 1, **kw)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin, **kw):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, **kw)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, **kw)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, **kw)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3),
                                         **kw)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0),
                                         **kw)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, **kw)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin, **kw):
        super().__init__()
        p13, p31 = (0, 1), (1, 0)
        self.branch1x1 = BasicConv2d(cin, 320, 1, **kw)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, **kw)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=p13, **kw)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=p31, **kw)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, **kw)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, **kw)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=p13,
                                           **kw)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=p31,
                                           **kw)
        self.branch_pool = BasicConv2d(cin, 192, 1, **kw)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """forward(x, rng=None) takes NHWC images [N, H, W, 3] (H, W >= 75)
    and returns [N, embed_dim] in `dtype`."""

    takes_rng = True

    def __init__(self, embed_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dtype, self.embed_dim = dtype, embed_dim
        self.dropout_rate = dropout_rate
        kw = dict(dtype=dtype, bn_dtype=bn_dtype)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, **kw)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, **kw)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, **kw)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, **kw)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, **kw)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        self.Mixed_7a = InceptionD(768, **kw)
        self.Mixed_7b = InceptionE(1280, **kw)
        self.Mixed_7c = InceptionE(2048, **kw)
        self.fc = nn.Linear(2048, embed_dim)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}.")
        if x.shape[1] < 75 or x.shape[2] < 75:
            raise ValueError(
                f"Inception-v3 needs inputs >= 75 px, got {tuple(x.shape)}.")
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(
                x.to(self.dtype))))
            x = _max_pool(x)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = _max_pool(x)
            for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e",
                         "7a", "7b", "7c"):
                x = getattr(self, f"Mixed_{name}")(x)
            x = dropout(x.mean(dim=(2, 3)), self.dropout_rate, rng,
                        self.training)
            return self.fc(x)


def inception_v3(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32,
                 image_size: int = 112) -> InceptionV3:
    return InceptionV3(embed_dim=embed_dim, dtype=dtype, bn_dtype=bn_dtype)
