"""Standalone FaceNet-side losses. Port of
face_recognition_models_tpu/triplet/losses.py: the explicit TripletLoss
(euclidean margins, FaceNet/utils/criterions.py:5-14) and the simple
CE-returning CosFace / ArcFace losses (:16-56) the reference keeps beside
its main heads. Each is fp32; the products are IEEE fp32 (callers on the
card keep TF32 off).
"""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.heads.base import one_hot
from face_recognition_models_tpu_torch.ops.normalize import l2_normalize
from face_recognition_models_tpu_torch.train.losses import (
    cross_entropy_with_integer_labels,
)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, margin: float = 0.2
                 ) -> torch.Tensor:
    """mean relu(||a-p|| - ||a-n|| + margin) (criterions.py:10-14)."""
    d_ap = torch.linalg.vector_norm(anchor - positive, dim=-1)
    d_an = torch.linalg.vector_norm(anchor - negative, dim=-1)
    return torch.clamp_min(d_ap - d_an + margin, 0.0).mean()


def _cosines(feats: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    xn = l2_normalize(feats, dim=1)
    wn = l2_normalize(weight, dim=0)
    return torch.clamp(xn @ wn, -1.0, 1.0)


def cosface_loss(feats: torch.Tensor, weight: torch.Tensor,
                 labels: torch.Tensor, m: float = 0.35,
                 s: float = 64.0) -> torch.Tensor:
    """Simple CosFace CE (criterions.py:16-36); weight [D, C]."""
    cos = _cosines(feats, weight)
    logits = s * (cos - one_hot(labels, cos.shape[1]) * m)
    return cross_entropy_with_integer_labels(logits, labels).mean()


def arcface_loss(feats: torch.Tensor, weight: torch.Tensor,
                 labels: torch.Tensor, m: float = 0.5,
                 s: float = 64.0) -> torch.Tensor:
    """Simple acos-based ArcFace CE (criterions.py:38-56); weight [D, C]."""
    cos = _cosines(feats, weight)
    cos_m = torch.cos(torch.acos(cos) + m)
    oh = one_hot(labels, cos.shape[1])
    logits = s * (oh * cos_m + (1.0 - oh) * cos)
    return cross_entropy_with_integer_labels(logits, labels).mean()
