"""The 10-fold verification protocol as one vectorised [K, P] computation
on the device. Port of face_recognition_models_tpu/evaluation/
device_protocol.py.

It gives the host path's numbers (evaluation/verification.kfold_verification)
exactly: the same thresholds, the same accuracies, and the AUC to rounding.
The JAX version computes in float32, where rank sums of a few thousand pairs
pass 2^23 and round; here everything is float64, on the card by default.

Protocol semantics:
- fold assignment: StratifiedKFold(k, shuffle=True, random_state) folds
  from verification.stratified_kfold_test_folds (host index math over P
  integers);
- threshold per fold: roc_curve's points are the distinct scores of the
  HELD-OUT fold in descending order, less the collinear interior points
  that drop_intermediate removes (kept here too: in floating point the
  first maximiser could otherwise fall on one), with Youden's
  argmax(tpr - fpr) picking the first maximiser, and roc_curve's leading
  (inf, J = 0) point winning when no point has J > 0 or the fold holds one
  class only;
- accuracy: 100 * mean over the other nine folds of (sim > threshold) ==
  label;
- AUC on the other nine folds: Mann-Whitney with average ranks for ties.
"""

from __future__ import annotations

import numpy as np
import torch

from face_recognition_models_tpu_torch.evaluation.verification import (
    VerificationResult,
    stratified_kfold_test_folds,
)
from face_recognition_models_tpu_torch.utils.device import resolve_device


def fold_assignments(labels: np.ndarray, k_fold: int = 10,
                     seed: int = 42) -> np.ndarray:
    """Fold id per pair: StratifiedKFold(k, shuffle=True, seed)'s (host)."""
    return stratified_kfold_test_folds(labels, k_fold, seed)


def _neighbour(mask: torch.Tensor, after: bool) -> torch.Tensor:
    """[K, P] position of the next (after=True) or previous True of `mask`
    along each row strictly beyond each position; P (after) or -1
    (before) where there is none."""
    k, p = mask.shape
    pos = torch.arange(p, device=mask.device).expand(k, p)
    if after:
        at = torch.where(mask, pos, p).flip(1).cummin(1).values.flip(1)
        return torch.cat([at[:, 1:], at.new_full((k, 1), p)], 1)
    at = torch.where(mask, pos, -1).cummax(1).values
    return torch.cat([at.new_full((k, 1), -1), at[:, :-1]], 1)


def _protocol(sims: torch.Tensor, labels: torch.Tensor,
              fold_of: torch.Tensor, k_fold: int):
    """(thresholds [K], accuracies [K], aucs [K]), float64."""
    p = sims.shape[0]
    f64 = torch.float64
    order = torch.argsort(sims, descending=True, stable=True)
    s = sims[order]                                  # [P] descending
    y = labels[order].to(f64)
    f = fold_of[order]
    folds = torch.arange(k_fold, device=sims.device)
    val = f[None, :] == folds[:, None]               # [K, P] held-out masks
    valf = val.to(f64)

    # --- roc_curve points: the last position of each distinct score in the
    # fold's descending subsequence --------------------------------------
    nxt = _neighbour(val, after=True)
    s_ext = torch.cat([s, s.new_full((1,), float("nan"))])
    is_point = val & ((nxt >= p) | (s_ext[nxt.clamp(max=p)] != s[None, :]))
    cum_tp = torch.cumsum(valf * y[None, :], 1)
    cum_fp = torch.cumsum(valf * (1.0 - y)[None, :], 1)
    # drop_intermediate: a point between two others whose fps and tps both
    # step by the same amount on each side is dropped
    nxt_pt = _neighbour(is_point, after=True)
    prv_pt = _neighbour(is_point, after=False)
    interior = is_point & (nxt_pt < p) & (prv_pt >= 0)

    def second_diff(c):
        return ((c.gather(1, nxt_pt.clamp(max=p - 1)) - c)
                - (c - c.gather(1, prv_pt.clamp(min=0))))

    collinear = interior & (second_diff(cum_tp) == 0) & (
        second_diff(cum_fp) == 0)
    kept = is_point & ~collinear

    tot_tp, tot_fp = cum_tp[:, -1:], cum_fp[:, -1:]
    j_stat = torch.where(kept, cum_tp / tot_tp.clamp(min=1.0)
                         - cum_fp / tot_fp.clamp(min=1.0),
                         torch.tensor(-float("inf"), dtype=f64,
                                      device=sims.device))
    best = torch.argmax(j_stat, 1)                   # first maximiser
    one_class = (tot_tp[:, 0] == 0) | (tot_fp[:, 0] == 0)
    real = (j_stat.max(1).values > 0) & ~one_class
    thresholds = torch.where(real, s[best],
                             torch.full_like(s[best], float("inf")))

    # --- accuracy on the other nine folds ----------------------------------
    train = ~val
    preds = (s[None, :] > thresholds[:, None]).to(f64)
    correct = (preds == y[None, :]) & train
    n_train = train.sum(1).to(f64)
    acc = 100.0 * (correct.sum(1).to(f64) / n_train)

    # --- AUC on the other nine folds: average ranks among the selected ----
    key = torch.where(train, s[None, :], torch.tensor(float("inf"), dtype=f64,
                                                      device=sims.device))
    ord2 = torch.argsort(key, dim=1, stable=True)    # ascending, others last
    s2 = key.gather(1, ord2)
    y2 = y[ord2]
    rank = torch.arange(1, p + 1, dtype=f64, device=sims.device).expand(
        k_fold, p)
    in_range = rank <= n_train[:, None]
    new = torch.cat([torch.ones_like(s2[:, :1], dtype=torch.bool),
                     s2[:, 1:] != s2[:, :-1]], 1)
    gid = torch.cumsum(new.to(torch.int64), 1) - 1
    zero = torch.zeros_like(s2)
    grp_sum = zero.scatter_add(1, gid, torch.where(in_range, rank, zero))
    grp_cnt = zero.scatter_add(1, gid, in_range.to(f64))
    avg_rank = (grp_sum / grp_cnt.clamp(min=1.0)).gather(1, gid)
    pos = in_range & (y2 > 0.5)
    pos_ranks = torch.where(pos, avg_rank, zero).sum(1)
    n_pos = pos.sum(1).to(f64)
    n_neg = n_train - n_pos
    u = pos_ranks - n_pos * (n_pos + 1.0) / 2.0
    aucs = torch.where((n_pos > 0) & (n_neg > 0),
                       u / (n_pos * n_neg).clamp(min=1.0), zero[:, 0])
    return thresholds, acc, aucs


def kfold_verification_device(similarities, labels, k_fold: int = 10,
                              seed: int = 42, device=None
                              ) -> VerificationResult:
    """Drop-in device-vectorised version of kfold_verification. Runs on the
    card unless device='cpu' is passed."""
    device = resolve_device(device)
    labs = np.asarray(labels, np.int64)
    sims = torch.as_tensor(np.asarray(similarities, np.float64),
                           device=device)
    fold_of = torch.as_tensor(fold_assignments(labs, k_fold, seed),
                              device=device)
    thresholds, acc, aucs = _protocol(sims, torch.as_tensor(labs,
                                                            device=device),
                                      fold_of, k_fold)
    return VerificationResult.from_folds(acc.cpu().numpy(),
                                         aucs.cpu().numpy(),
                                         thresholds.cpu().numpy())
