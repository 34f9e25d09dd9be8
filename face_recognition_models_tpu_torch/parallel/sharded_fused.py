"""Class-sharded fused margin + CE. Port of face_recognition_models_tpu/
parallel/sharded_fused.py.

Each rank of a model group holds the columns [offset, offset + C/mp) of the
normalised classifier and runs the fused kernels of ops/fused_head.py (K1
forward, K2 backward; K4, the memory-blended bodies, for VPL-ArcFace and
QAFace) on that local [D, C/mp] slice for its rows of the batch. The shards'
statistics combine over the model group:

- logsumexp: the log of the sum of exp(lse_local - mx), plus mx, where mx is
  the max over the shards of the local lse without gradient (the shift only
  keeps the sum finite);
- target logit: only the shard that owns a row's label column adds
  scale * t; a non-owner's kernel gets the out-of-range label C/mp + 1 and
  has no target column at all;
- the top-k rank counts: a plain sum.

The row inputs (xn, t, tcos, scale, ab) enter the sharded region through
`copy_to_model`, so the feature gradient (and that of t and scale) is the
sum of every shard's share; the statistics leave it through
`reduce_from_model`, so each shard's backward gets exactly its own share of
the loss every peer holds (parallel/collectives.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from face_recognition_models_tpu_torch.heads.base import take_columns
from face_recognition_models_tpu_torch.ops.fused_head import (
    FusedHeadOut,
    fused_margin_ce,
    fused_margin_ce_mem,
)
from face_recognition_models_tpu_torch.parallel import collectives as coll


def local_labels(labels: torch.Tensor, c_local: int, mesh):
    """(owner [N] bool, the labels in the shard's columns): a label outside
    the shard becomes c_local + 1, which no column matches."""
    offset, _ = coll.class_range(c_local, mesh)
    lab = labels.long() - offset
    owner = (lab >= 0) & (lab < c_local)
    return owner, torch.where(owner, lab, c_local + 1)


def take_target_columns(w_local: torch.Tensor, labels: torch.Tensor,
                        mesh) -> torch.Tensor:
    """Rows [N, D] of the whole [D, C] classifier's columns at `labels`
    from the rank's shard: the owning shard's gather (the fixed-order
    gather of heads/base.take_columns), summed over the model group. The
    gradient reaches only the owner's columns."""
    if coll.model_size(mesh) == 1:
        return take_columns(w_local, labels).T
    owner, lab = local_labels(labels, w_local.shape[1], mesh)
    rows = take_columns(w_local, torch.where(owner, lab, 0)).T
    return coll.reduce_from_model(rows * owner[:, None].to(rows.dtype), mesh)


def take_class_values(v_local: torch.Tensor, labels: torch.Tensor,
                      mesh) -> torch.Tensor:
    """v[labels] of a per-class vector v [C] from the rank's shard, without
    gradient."""
    if coll.model_size(mesh) == 1:
        return v_local.index_select(0, labels.long())
    owner, lab = local_labels(labels, v_local.shape[0], mesh)
    vals = v_local.index_select(0, torch.where(owner, lab, 0))
    return coll.reduce_from_model(torch.where(owner, vals, 0.0), mesh)


def sharded_fused_margin_ce(mesh, xn, wn, labels, t, tcos, scale, ab,
                            mode: int, clamp_eps: Optional[float] = None,
                            memn=None, lam=None,
                            mm_dtype=torch.float32) -> FusedHeadOut:
    """Global-semantics fused margin + CE over the model group of `mesh`.

    xn [N, D] and every row vector are the rank's rows; wn [D, C/mp] (and
    memn [D, C/mp], lam [C/mp] for the memory-blended heads) the rank's
    class shard; labels are global class ids. Returns the global
    (lse, target_logit, higher) of the rank's rows.
    """
    c_local = wn.shape[1]
    owner, lab = local_labels(labels, c_local, mesh)
    xn, t, tcos, scale, ab = (coll.copy_to_model(v, mesh)
                              for v in (xn, t, tcos, scale, ab))
    if memn is not None:
        out = fused_margin_ce_mem(xn, wn, memn, lam, lab, t, tcos, scale, ab,
                                  mode, clamp_eps, mm_dtype)
    else:
        out = fused_margin_ce(xn, wn, lab, t, tcos, scale, ab, mode,
                              clamp_eps, mm_dtype)
    mx = coll.max_over_model(out.lse.detach(), mesh)
    lse = torch.log(coll.reduce_from_model(torch.exp(out.lse - mx),
                                           mesh)) + mx
    target = coll.reduce_from_model(
        torch.where(owner, scale.float() * t.float(), 0.0), mesh)
    higher = coll.reduce_from_model(out.higher, mesh)
    return FusedHeadOut(lse, target, higher)
