"""Classification loss of the eager head. Port of
face_recognition_models_tpu/train/losses.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mean_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over valid (label != ignore_index) samples, in fp32."""
    return F.cross_entropy(logits.to(torch.float32), labels.long(),
                           ignore_index=ignore_index)
