"""Training metrics. Port of face_recognition_models_tpu/train/metrics.py:
top-k accuracy in percent on the pre-margin logits."""

from __future__ import annotations

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)):
    """Rank-count top-k accuracy: a sample is right at k when fewer than k
    classes score strictly higher than its target."""
    target = logits.gather(1, labels.long()[:, None])
    higher = (logits > target).sum(1)
    return tuple(100.0 * (higher < k).to(torch.float32).mean() for k in topk)
