"""Training metrics. Port of face_recognition_models_tpu/train/metrics.py:
top-k accuracy in percent on the pre-margin logits."""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.heads.base import shard_one_hot
from face_recognition_models_tpu_torch.parallel import collectives as coll


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)):
    """Rank-count top-k accuracy: a sample is right at k when fewer than k
    classes score strictly higher than its target. The target score is
    taken through a one-hot, so an ignore label (-1) scores 0 and counts the
    logits above 0, as in the JAX package. Under an active model axis the
    logits are the rank's class shard: the target is the owning shard's and
    the counts add over the model group."""
    target = coll.reduce_from_model((logits * shard_one_hot(
        labels, logits.shape[1], logits.dtype)).sum(1, keepdim=True).detach())
    higher = coll.reduce_from_model((logits > target).sum(1))
    return tuple(100.0 * (higher < k).to(torch.float32).mean() for k in topk)
