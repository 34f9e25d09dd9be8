"""Classification loss of the eager head. Port of
face_recognition_models_tpu/train/losses.py: the target logit is taken
through a one-hot, so an ignore label (-1) scores nothing and is masked out
of the mean."""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.heads.base import one_hot


def cross_entropy_with_integer_labels(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE [N] in fp32: logsumexp minus the one-hot target logit
    (a -1 row gives the whole logsumexp; callers mask it)."""
    logits = logits.to(torch.float32)
    target = (logits * one_hot(labels, logits.shape[1])).sum(1)
    return torch.logsumexp(logits, 1) - target


def mean_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over valid (label != ignore_index) samples; 0, with a zero
    gradient, when no sample is valid."""
    per = cross_entropy_with_integer_labels(logits, labels)
    valid = (labels != ignore_index).to(torch.float32)
    return (per * valid).sum() / valid.sum().clamp_min(1.0)
