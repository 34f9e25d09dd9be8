"""Backbone registry. Port of face_recognition_models_tpu/models/backbones.py
(the ResNet entries so far)."""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.models.resnet import resnet18, resnet50

BACKBONES = {"resnet18": resnet18, "resnet50": resnet50}


def get_backbone(name: str = "resnet18", embed_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
    """Build a backbone module mapping NHWC images to [N, embed_dim]."""
    key = name.lower()
    if key not in BACKBONES:
        raise ValueError(
            f"Unsupported backbone: {name}. Available: {sorted(BACKBONES)}")
    return BACKBONES[key](embed_dim=embed_dim, dtype=dtype)
