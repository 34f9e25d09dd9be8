"""MobileFaceNet embedding backbone. Port of face_recognition_models_tpu/
models/mobilefacenet.py.

The edge face trunk (Chen et al. 2018, arXiv:1804.07573): MobileNetV2
inverted residuals with per-channel PReLU, and GDConv (a depthwise conv
over the whole last map, 7x7 at 112 px) in place of global average
pooling, then a linear 1x1 conv and a BatchNorm with no scale on the
embedding. The parameter names are the flax module names (`stem`,
`block{i}_{j}.expand`, `gdconv`, `fc`, `feature_bn`, ...); the depthwise
convs are ops/depthwise.py's, with [C, 1, k, k] weights. Convolutions run
in `dtype`, BatchNorm in fp32 with its output in `bn_dtype` (the embedding
BatchNorm's too, as in the flax model). GDConv's kernel is the size of the
stride-16 map, so the model is built for one `image_size` (a multiple of
16).
"""

from __future__ import annotations

import torch
from torch import nn

from face_recognition_models_tpu_torch.models.iresnet import PReLU
from face_recognition_models_tpu_torch.models.resnet import (
    AUTOCAST_DTYPES,
    BatchNorm,
    Conv2d,
)
from face_recognition_models_tpu_torch.ops.depthwise import (
    depthwise_conv3x3,
    global_depthwise,
)

# (expand t, out channels c, blocks n, first stride s): the paper's table 1
_MFN_SETTINGS = (
    (2, 64, 5, 2),
    (4, 128, 1, 2),
    (2, 128, 6, 1),
    (4, 128, 1, 2),
    (2, 128, 2, 1),
)


class DepthwiseConv3x3(nn.Conv2d):
    """ops/depthwise.depthwise_conv3x3 with its [C, 1, 3, 3] weight (a
    Conv2d's parameter, so the initialiser sees fan-in 9)."""

    def __init__(self, channels: int, stride: int = 1):
        super().__init__(channels, channels, 3, stride=stride, padding=1,
                         groups=channels, bias=False)

    def forward(self, x):
        return depthwise_conv3x3(x, self.weight, self.stride[0])


class GDConv(nn.Conv2d):
    """ops/depthwise.global_depthwise with its [C, 1, H, W] weight."""

    def __init__(self, channels: int, side: int):
        super().__init__(channels, channels, side, groups=channels,
                         bias=False)

    def forward(self, x):
        return global_depthwise(x, self.weight)


def _conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return Conv2d(cin, cout, 1, bias=False)


class Bottleneck(nn.Module):
    """MobileNetV2 inverted residual with PReLU (paper section 3.3)."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 dtype: torch.dtype, bn_dtype: torch.dtype):
        super().__init__()
        hidden = cin * expand
        self.dtype = dtype
        self.use_skip = stride == 1 and cin == cout
        self.expand = _conv1x1(cin, hidden)
        self.expand_bn = BatchNorm(hidden, dtype=bn_dtype)
        self.expand_prelu = PReLU(hidden)
        self.depthwise = DepthwiseConv3x3(hidden, stride)
        self.depthwise_bn = BatchNorm(hidden, dtype=bn_dtype)
        self.depthwise_prelu = PReLU(hidden)
        self.project = _conv1x1(hidden, cout)
        self.project_bn = BatchNorm(cout, dtype=bn_dtype)

    def forward(self, x):
        y = self.expand_bn(self.expand(x))
        y = self.expand_prelu(y.to(self.dtype))
        y = self.depthwise_bn(self.depthwise(y))
        y = self.depthwise_prelu(y.to(self.dtype))
        y = self.project_bn(self.project(y)).to(self.dtype)
        return x + y if self.use_skip else y


class MobileFaceNet(nn.Module):
    """forward takes NHWC images [N, S, S, 3] (S = image_size) and returns
    [N, embed_dim] in `bn_dtype`."""

    def __init__(self, embed_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32,
                 image_size: int = 112):
        super().__init__()
        if image_size % 16:
            raise ValueError(
                f"MobileFaceNet needs an image size divisible by 16 (GDConv "
                f"runs over the stride-16 map); got {image_size}")
        self.dtype, self.embed_dim, self.image_size = (dtype, embed_dim,
                                                       image_size)
        self.stem = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.stem_bn = BatchNorm(64, dtype=bn_dtype)
        self.stem_prelu = PReLU(64)
        self.stem_dw = DepthwiseConv3x3(64)
        self.stem_dw_bn = BatchNorm(64, dtype=bn_dtype)
        self.stem_dw_prelu = PReLU(64)
        self.block_names = []
        cin = 64
        for i, (t, ch, n, s) in enumerate(_MFN_SETTINGS):
            for j in range(n):
                name = f"block{i}_{j}"
                self.add_module(name, Bottleneck(cin, ch, s if j == 0 else 1,
                                                 t, dtype, bn_dtype))
                self.block_names.append(name)
                cin = ch
        self.head = _conv1x1(cin, 512)
        self.head_bn = BatchNorm(512, dtype=bn_dtype)
        self.head_prelu = PReLU(512)
        self.gdconv = GDConv(512, image_size // 16)
        self.gdconv_bn = BatchNorm(512, dtype=bn_dtype)
        self.fc = _conv1x1(512, embed_dim)
        self.feature_bn = BatchNorm(embed_dim, dtype=bn_dtype,
                                    use_scale=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(
                f"Expected NHWC input [N, H, W, 3], got {tuple(x.shape)}. "
                "(PyTorch-style NCHW must be transposed.)")
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            raise ValueError(f"this MobileFaceNet is built for "
                             f"{self.image_size} px, got {tuple(x.shape)}")
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in AUTOCAST_DTYPES):
            x = self.stem_bn(self.stem(x.to(self.dtype)))
            x = self.stem_prelu(x.to(self.dtype))
            x = self.stem_dw_bn(self.stem_dw(x))
            x = self.stem_dw_prelu(x.to(self.dtype))
            for name in self.block_names:
                x = getattr(self, name)(x)
            x = self.head_bn(self.head(x))
            x = self.head_prelu(x.to(self.dtype))
            x = self.gdconv_bn(self.gdconv(x))
            x = self.fc(x.to(self.dtype))
        return self.feature_bn(x.flatten(1))


def mobilefacenet(embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16,
                  bn_dtype: torch.dtype = torch.float32,
                  image_size: int = 112) -> MobileFaceNet:
    return MobileFaceNet(embed_dim=embed_dim, dtype=dtype,
                         bn_dtype=bn_dtype, image_size=image_size)
