"""Backbone registry. Port of face_recognition_models_tpu/models/
backbones.py: the twelve trunks of the JAX registry, in its order."""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.models.efficientnet import (
    efficientnet_b0,
)
from face_recognition_models_tpu_torch.models.inception import inception_v3
from face_recognition_models_tpu_torch.models.iresnet import (
    iresnet18,
    iresnet50,
    iresnet100,
)
from face_recognition_models_tpu_torch.models.mobilefacenet import (
    mobilefacenet,
)
from face_recognition_models_tpu_torch.models.mobilenet import mobilenet_v2
from face_recognition_models_tpu_torch.models.resnet import resnet18, resnet50
from face_recognition_models_tpu_torch.models.vit import vit_b, vit_s, vit_t

BACKBONES = {
    "resnet18": resnet18,
    "resnet50": resnet50,
    "efficientnet_b0": efficientnet_b0,
    "mobilenet_v2": mobilenet_v2,
    "mobilefacenet": mobilefacenet,
    "inception_v3": inception_v3,
    "iresnet18": iresnet18,
    "iresnet50": iresnet50,
    "iresnet100": iresnet100,
    "vit_t": vit_t,
    "vit_s": vit_s,
    "vit_b": vit_b,
}


def get_backbone(name: str = "resnet18", embed_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32,
                 image_size: int = 112):
    """Build a backbone module mapping NHWC images to [N, embed_dim].
    iresnet, mobilefacenet and the ViTs are built for one `image_size`
    (their fc, GDConv kernel or position embedding has its shape); the
    others pool globally and take any size."""
    key = name.lower()
    if key not in BACKBONES:
        raise ValueError(
            f"Unsupported backbone: {name}. Available: {sorted(BACKBONES)}")
    return BACKBONES[key](embed_dim=embed_dim, dtype=dtype, bn_dtype=bn_dtype,
                          image_size=image_size)


def to_device(backbone: torch.nn.Module, device: torch.device
              ) -> torch.nn.Module:
    """Move `backbone` to `device`; on the card also to channels-last:
    NHWC batches arrive as channels-last NCHW views, and cuDNN's bf16
    convolutions are fastest with weights in the same layout. Training and
    evaluation place a backbone the same way, so a restored one computes
    what the live one did."""
    backbone = backbone.to(device)
    if device.type == "cuda":
        backbone = backbone.to(memory_format=torch.channels_last)
    return backbone
