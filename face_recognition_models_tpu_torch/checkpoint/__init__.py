"""Checkpoints of the port."""

from face_recognition_models_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    restore_backbone,
)

__all__ = ["CheckpointManager", "restore_backbone"]
