"""Classification loss of the eager head. Port of
face_recognition_models_tpu/train/losses.py: the target logit is taken
through a one-hot, so an ignore label (-1) scores nothing and is masked out
of the mean.

Under an active model axis (parallel/collectives.using) the logits are the
rank's class shard [N, C/m], as GSPMD shards them in the JAX step: the
logsumexp combines the shards' (max, sum-exp) over the model group, as
train/partial_fc_sharded.py does, and the target logit is the owning
shard's, summed over the group."""

from __future__ import annotations

import torch

from face_recognition_models_tpu_torch.heads.base import shard_one_hot
from face_recognition_models_tpu_torch.parallel import collectives as coll


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """The logsumexp [N] of every class's logit, over the model group's
    shards: log(sum of exp(lse_local - mx)) + mx, mx the shards' largest
    local lse without gradient."""
    lse = torch.logsumexp(logits, 1)
    if coll.model_size() == 1:
        return lse
    mx = coll.max_over_model(lse.detach())
    return torch.log(coll.reduce_from_model(torch.exp(lse - mx))) + mx


def cross_entropy_with_integer_labels(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE [N] in fp32: logsumexp minus the one-hot target logit
    (a -1 row gives the whole logsumexp; callers mask it)."""
    logits = logits.to(torch.float32)
    target = coll.reduce_from_model(
        (logits * shard_one_hot(labels, logits.shape[1])).sum(1))
    return _logsumexp(logits) - target


def mean_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over valid (label != ignore_index) samples; 0, with a zero
    gradient, when no sample is valid. Under an active data axis the
    divisor is the global batch's valid count, and the rank's loss `data`
    times its rows' share of the global mean (the gradient convention of
    parallel/collectives.py): the ranks' mean is the global batch's mean
    however its ignore labels fall among the ranks."""
    per = cross_entropy_with_integer_labels(logits, labels)
    valid = (labels != ignore_index).to(torch.float32)
    count = coll.data_sum(valid.sum())
    return ((per * valid).sum() * coll.data_size()
            / count.clamp_min(1.0))
