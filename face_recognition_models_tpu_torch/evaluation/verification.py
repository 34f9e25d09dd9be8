"""Verification evaluation: embed-once + 10-fold protocol. Port of
face_recognition_models_tpu/evaluation/verification.py.

Protocol parity with the reference (model_utils.py:320-474):
- StratifiedKFold(n_splits=10, shuffle=True, random_state=42) over the pair
  list (:438);
- per fold: tune a threshold on the HELD-OUT fold via roc_curve + Youden's J
  (argmax tpr-fpr, :406-408), then measure accuracy (cos > threshold) and
  AUC on the OTHER NINE folds (:456-463). This inverts the classic LFW
  protocol (tunes on 1, tests on 9); it is replicated for number parity.
- accuracy compares strictly `cos > threshold` (:411) in percent; AUC is
  roc_auc_score's.

The JAX package takes the folds, the ROC curve and the AUC from sklearn,
which the card's machine does not have. Here they are numpy functions that
give sklearn's results: `stratified_kfold_test_folds` sklearn 1.x's
StratifiedKFold(k, shuffle=True, random_state=seed) folds, `roc_curve` its
roc_curve(drop_intermediate=True) (an `inf` threshold first), and
`roc_auc_score` the Mann-Whitney statistic with average ranks for ties
(equal to the trapezoidal area).

Every unique image is embedded once (bf16 backbone on the card, fp32
L2-normalize on the host) and the fold protocol runs on cached cosines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class VerificationResult:
    mean_accuracy: float
    std_accuracy: float
    mean_auc: float
    std_auc: float
    fold_accuracies: List[float]
    fold_aucs: List[float]
    fold_thresholds: List[float]

    def __str__(self):
        return (f"acc {self.mean_accuracy:.3f}% ± {self.std_accuracy:.3f}%  "
                f"auc {self.mean_auc:.4f} ± {self.std_auc:.4f}")

    @classmethod
    def from_folds(cls, accs, aucs, thresholds) -> "VerificationResult":
        return cls(mean_accuracy=float(np.mean(accs)),
                   std_accuracy=float(np.std(accs)),
                   mean_auc=float(np.mean(aucs)),
                   std_auc=float(np.std(aucs)),
                   fold_accuracies=[float(a) for a in accs],
                   fold_aucs=[float(a) for a in aucs],
                   fold_thresholds=[float(t) for t in thresholds])


# --- sklearn's folds, ROC curve and AUC in numpy ---------------------------

def stratified_kfold_test_folds(labels: np.ndarray, k: int = 10,
                                seed: int = 42) -> np.ndarray:
    """Test-fold id of each sample, as sklearn's
    StratifiedKFold(k, shuffle=True, random_state=seed) assigns them.

    Classes are encoded in order of first appearance; the per-fold count of
    each class comes from a round robin over the sorted codes
    (`y_order[i::k]`); each class's fold ids, in blocks, are shuffled by one
    RandomState(seed) in class order."""
    y = np.asarray(labels).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    if np.all(k > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={k} cannot be greater than the number "
                         "of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::k], minlength=n_classes)
                             for i in range(k)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(y), dtype=np.int64)
    for c in range(n_classes):
        folds_for_class = np.arange(k).repeat(allocation[:, c])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == c] = folds_for_class
    return test_folds


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) as sklearn.metrics.roc_curve gives them with
    drop_intermediate=True, label 1 positive: thresholds are the distinct
    scores in descending order with collinear interior points dropped,
    after a first `inf` point at (0, 0). A curve with no negatives
    (positives) has an all-NaN fpr (tpr)."""
    y = np.asarray(labels).reshape(-1) == 1
    scores = np.asarray(scores).reshape(-1)
    desc = np.argsort(scores, kind="mergesort")[::-1]
    s, yt = scores[desc], y[desc]
    last = np.r_[np.where(np.diff(s))[0], yt.size - 1]
    tps = np.cumsum(yt, dtype=np.float64)[last]
    fps = 1 + last - tps
    thresholds = s[last].astype(np.float64)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def _average_ranks(scores: np.ndarray) -> np.ndarray:
    """1-based ranks of `scores` in ascending order, ties given the mean of
    the ranks they span."""
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    new = np.r_[True, s[1:] != s[:-1]]
    starts = np.flatnonzero(new)
    ends = np.r_[starts[1:], len(s)]
    ranks = np.empty(len(s), np.float64)
    ranks[order] = ((starts + 1 + ends) / 2.0)[np.cumsum(new) - 1]
    return ranks


def roc_auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve (label 1 positive) as the Mann-Whitney
    statistic with average ranks for ties; raises with one class only, as
    sklearn does."""
    y = np.asarray(labels).reshape(-1) == 1
    scores = np.asarray(scores, np.float64).reshape(-1)
    n_pos = float(y.sum())
    n_neg = float(len(y)) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    u = _average_ranks(scores)[y].sum() - n_pos * (n_pos + 1.0) / 2.0
    return float(u / (n_pos * n_neg))


# --- embedding -------------------------------------------------------------

def embed_unique_images(embed_fn: Callable, images: np.ndarray,
                        batch_size: int = 256,
                        flip: bool = False) -> np.ndarray:
    """Embed uint8 images [N,H,W,3] -> L2-normalized fp32 [N,D].

    `embed_fn(uint8 images) -> raw embeddings` (a torch tensor, on the
    card or the CPU) is the eval step; the last batch is padded to keep
    every batch one shape. The raw embeddings stay on the embed_fn's
    device until all batches are queued.

    flip=True applies the insightface/facenet test-time convention: each
    image's raw embedding is SUMMED with its horizontal flip's before
    normalization (2x embed cost). Published insightface .bin numbers
    assume this fusion.
    """
    n = len(images)
    out: List[torch.Tensor] = []
    for s in range(0, n, batch_size):
        chunk = images[s:s + batch_size]
        valid = len(chunk)
        pad = batch_size - valid
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        feats = embed_fn(chunk)
        if flip:
            # NHWC: axis 2 is width; ascontiguousarray keeps the
            # host->device transfer a plain memcpy
            feats = feats + embed_fn(np.ascontiguousarray(chunk[:, :, ::-1]))
        out.append(feats[:valid])
    emb = torch.cat(out).cpu().numpy().astype(np.float32)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def pair_cosine_similarities(embeddings: np.ndarray,
                             pairs: np.ndarray,
                             id_to_row: Optional[Dict[int, int]] = None
                             ) -> np.ndarray:
    """Cosine per pair from cached normalized embeddings.

    pairs: [P, 3] int (idA, idB, label); id_to_row maps image ids to
    embedding rows (identity if None).
    """
    a, b = pairs[:, 0], pairs[:, 1]
    if id_to_row is not None:
        a = np.asarray([id_to_row[int(i)] for i in a])
        b = np.asarray([id_to_row[int(i)] for i in b])
    return np.sum(embeddings[a] * embeddings[b], axis=1)


# --- protocols ---------------------------------------------------------------

def _youden_threshold(labels: np.ndarray, scores: np.ndarray) -> float:
    """roc_curve + argmax(tpr - fpr), the first maximiser
    (model_utils.py:406-408)."""
    fpr, tpr, thresholds = roc_curve(labels, scores)
    return float(thresholds[np.argmax(tpr - fpr)])


def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
    if len(np.unique(labels)) < 2:
        return 0.0  # reference convention (model_utils.py:349-350)
    return roc_auc_score(labels, scores)


def kfold_verification(similarities: np.ndarray, labels: np.ndarray,
                       k_fold: int = 10, seed: int = 42,
                       verbose: bool = False) -> VerificationResult:
    """The reference's cross_validate_kfold over precomputed cosines."""
    similarities = np.asarray(similarities, np.float64)
    labels = np.asarray(labels, np.int64)
    fold_of = stratified_kfold_test_folds(labels, k_fold, seed)

    accs, aucs, thresholds = [], [], []
    for fold in range(k_fold):
        val = fold_of == fold
        # tune on the held-out fold (model_utils.py:452)
        thresh = _youden_threshold(labels[val], similarities[val])
        # accuracy on the other nine folds (:456)
        preds = (similarities[~val] > thresh).astype(np.int64)
        acc = 100.0 * np.mean(preds == labels[~val])
        auc = _auc(labels[~val], similarities[~val])
        accs.append(acc)
        aucs.append(auc)
        thresholds.append(thresh)
        if verbose:
            print(f"fold {fold + 1}/{k_fold}: thresh={thresh:.4f} "
                  f"acc={acc:.3f}% auc={auc:.4f}")
    return VerificationResult.from_folds(accs, aucs, thresholds)


def standard_kfold_verification(similarities: np.ndarray,
                                labels: np.ndarray, k_fold: int = 10,
                                verbose: bool = False
                                ) -> VerificationResult:
    """The CLASSIC LFW 10-fold protocol (insightface/facenet semantics),
    for comparing against published numbers.

    Differs from the reference's protocol (kfold_verification) in all three
    choices the reference inverts:
      - sequential un-shuffled KFold over the pair list (insightface
        verification.py uses sklearn KFold(shuffle=False)), not
        StratifiedKFold(shuffle, seed 42);
      - threshold tuned by ACCURACY maximization over a fixed grid —
        insightface's `np.arange(0, 4, 0.01)` on the squared L2 distance
        of unit embeddings, i.e. d = 2 - 2*cos, mapped here to cosine
        thresholds 1 - d/2 — not Youden's J on an ROC;
      - tuned on the OTHER k-1 folds, tested on the held-out fold.
    AUC is computed on the held-out fold for the result's auc fields.
    """
    similarities = np.asarray(similarities, np.float64)
    labels = np.asarray(labels, np.int64)
    n = len(similarities)
    if len(labels) != n:
        raise ValueError("similarities/labels length mismatch")
    # insightface grid: squared-L2 thresholds 0..4 step 0.01 -> cosine
    grid = 1.0 - np.arange(0.0, 4.0, 0.01) / 2.0        # [400] descending
    # folds: sequential contiguous blocks (KFold(shuffle=False) semantics)
    fold_sizes = np.full(k_fold, n // k_fold, np.int64)
    fold_sizes[: n % k_fold] += 1
    stops = np.cumsum(fold_sizes)
    starts = stops - fold_sizes

    # [P, T] correctness table once; folds slice it
    correct = ((similarities[:, None] > grid[None, :]).astype(np.int64)
               == labels[:, None])

    accs, aucs, thresholds = [], [], []
    for fold in range(k_fold):
        lo, hi = int(starts[fold]), int(stops[fold])
        test = np.zeros(n, bool)
        test[lo:hi] = True
        train_acc = correct[~test].mean(axis=0)
        best = int(np.argmax(train_acc))  # first max
        thresh = float(grid[best])
        acc = 100.0 * float(correct[test, best].mean())
        auc = _auc(labels[test], similarities[test])
        accs.append(acc)
        aucs.append(auc)
        thresholds.append(thresh)
        if verbose:
            print(f"fold {fold + 1}/{k_fold}: thresh={thresh:.4f} "
                  f"acc={acc:.3f}% auc={auc:.4f}")
    return VerificationResult.from_folds(accs, aucs, thresholds)


def evaluate_benchmark(embed_fn: Callable, pairs: np.ndarray,
                       images_by_id: Dict[int, np.ndarray],
                       batch_size: int = 256,
                       k_fold: int = 10, seed: int = 42,
                       verbose: bool = False) -> VerificationResult:
    """Full benchmark path: unique-image embed -> pair cosines -> protocol.
    `embed_fn(uint8 images) -> raw embeddings` normalises on its device."""
    unique_ids = sorted(images_by_id)
    id_to_row = {img_id: row for row, img_id in enumerate(unique_ids)}
    stack = np.stack([images_by_id[i] for i in unique_ids])
    emb = embed_unique_images(embed_fn, stack, batch_size)
    sims = pair_cosine_similarities(emb, pairs, id_to_row)
    return kfold_verification(sims, pairs[:, 2], k_fold, seed, verbose)
