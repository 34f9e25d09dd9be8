"""Backbone registry. Port of face_recognition_models_tpu/models/backbones.py
(the ResNet entries so far)."""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.models.resnet import resnet18, resnet50

BACKBONES = {"resnet18": resnet18, "resnet50": resnet50}


def get_backbone(name: str = "resnet18", embed_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_dtype: torch.dtype = torch.float32):
    """Build a backbone module mapping NHWC images to [N, embed_dim]."""
    key = name.lower()
    if key not in BACKBONES:
        raise ValueError(
            f"Unsupported backbone: {name}. Available: {sorted(BACKBONES)}")
    return BACKBONES[key](embed_dim=embed_dim, dtype=dtype, bn_dtype=bn_dtype)


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
