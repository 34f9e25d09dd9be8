"""Backbones of the port."""

from face_recognition_models_tpu_torch.models.backbones import (  # noqa: F401
    BACKBONES,
    get_backbone,
)
