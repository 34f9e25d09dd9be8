"""Open-set and at-scale recognition metrics: TPR@FAR and 1:N
identification. Port of face_recognition_models_tpu/evaluation/openset.py
(one device; the JAX package's sharded gallery waits for the multi-GPU
port).

- **TPR@FAR** (1:1 verification at fixed false-accept rates, e.g. 1e-3):
  the operating point a deployed system runs at, where one accuracy number
  hides the far tail of the impostor distribution.
- **Closed-set 1:N identification** (CMC rank-k): a probe against a
  gallery, correct if its identity ranks in the top k.
- **Open-set 1:N identification** (TPIR@FPIR): probes may be absent from
  the gallery; the accept threshold lets only a given fraction of
  non-mated probes false-alarm.

All run on cached L2-normalised embeddings; scores are cosines in [-1, 1].
The [P, G] probe-gallery scores are computed in chunks on the card
(`pooled_scores_device`), so a gallery of millions of images never makes a
[P, G] matrix; device='cpu' runs the same chunks on the CPU.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_recognition_models_tpu_torch.utils.device import resolve_device

Device = Optional[Union[str, torch.device]]   # None: the card


def tpr_at_far(scores: np.ndarray, labels: np.ndarray,
               fars: Sequence[float] = (1e-1, 1e-2, 1e-3, 1e-4),
               ) -> Dict[float, Tuple[float, float]]:
    """TPR at fixed FAR operating points for 1:1 verification.

    scores: pair cosine similarities; labels: 1 genuine / 0 impostor.
    For each target FAR, the threshold is the tightest one whose measured
    FAR does not exceed the target (the conservative convention — no
    interpolation past measured points); returns {far: (tpr, threshold)}.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    genuine = np.sort(scores[labels])
    impostor = np.sort(scores[~labels])[::-1]  # descending
    n_imp = len(impostor)
    if n_imp == 0 or len(genuine) == 0:
        raise ValueError("need both genuine and impostor pairs")

    out: Dict[float, Tuple[float, float]] = {}
    for far in fars:
        k = int(np.floor(far * n_imp))  # impostors allowed above threshold
        if k >= n_imp:
            thresh = -1.0
        else:
            # accept the k highest impostors: threshold just above the
            # (k+1)-th highest (k = 0: just above the top impostor)
            thresh = float(np.nextafter(impostor[k], np.inf))
        tpr = float(np.mean(genuine >= thresh))
        out[far] = (tpr, thresh)
    return out


def _best_per_identity(scores: np.ndarray, gallery_ids: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse [P, G_images] scores to [P, G_identities] by the max over
    each identity's gallery images; returns (pooled, unique_ids). One pass
    (sort + maximum.reduceat), no loop over identities. The host reference
    that pooled_scores_device is held against."""
    order = np.argsort(gallery_ids, kind="stable")
    uniq, starts = np.unique(gallery_ids[order], return_index=True)
    pooled = np.maximum.reduceat(scores[:, order], starts, axis=1)
    return pooled, uniq


@contextlib.contextmanager
def _true_fp32_matmul():
    """fp32 products without TF32 inside the block (the JAX package's
    Precision.HIGHEST): identification ranks on cosine gaps that a
    reduced-precision product would blur."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def pooled_scores_device(gallery_emb: np.ndarray, gallery_ids: np.ndarray,
                         probe_emb: np.ndarray, chunk: int = 256,
                         device: Device = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """[P, U] identity-pooled probe-gallery cosines computed on `device`
    (the card unless 'cpu'). The gallery, sorted by identity, goes to the
    device once; probes go in fixed chunks of `chunk` rows (the last one
    padded), each a [chunk, G] fp32 product with TF32 off and a max over
    each identity's columns (scatter_reduce amax from -inf), copied to the
    host before the next chunk, so a million-image gallery never
    materialises a [P, G] matrix. Returns (pooled [P, U] on the host,
    unique_ids)."""
    device = resolve_device(device)
    gallery_ids = np.asarray(gallery_ids)
    order = np.argsort(gallery_ids, kind="stable")
    uniq = np.unique(gallery_ids)
    seg = torch.from_numpy(np.searchsorted(uniq, gallery_ids[order])).to(
        device)
    gal = torch.from_numpy(np.ascontiguousarray(
        np.asarray(gallery_emb, np.float32)[order])).to(device)
    p = np.asarray(probe_emb, np.float32)
    n = p.shape[0]
    out = np.empty((n, len(uniq)), np.float32)
    block = torch.zeros((chunk, p.shape[1]), dtype=torch.float32,
                        device=device)
    index = seg.expand(chunk, -1)
    with torch.no_grad(), _true_fp32_matmul():
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            block.zero_()
            block[:hi - lo].copy_(torch.from_numpy(p[lo:hi]))
            scores = block @ gal.T                              # [chunk, G]
            pooled = torch.full((chunk, len(uniq)), float("-inf"),
                                device=device)
            pooled.scatter_reduce_(1, index, scores, "amax")
            del scores
            out[lo:hi] = pooled[:hi - lo].cpu().numpy()
    return out, uniq


@dataclass
class IdentificationResult:
    cmc: Dict[int, float]                    # rank -> accuracy %
    tpir_at_fpir: Dict[float, float] = field(default_factory=dict)
    thresholds: Dict[float, float] = field(default_factory=dict)

    def __str__(self):
        parts = [f"rank-{k} {v:.3f}%" for k, v in sorted(self.cmc.items())]
        parts += [f"TPIR@FPIR={f:g} {v:.3f}%"
                  for f, v in sorted(self.tpir_at_fpir.items())]
        return "  ".join(parts)


def closed_set_identification(gallery_emb: np.ndarray,
                              gallery_ids: np.ndarray,
                              probe_emb: np.ndarray,
                              probe_ids: np.ndarray,
                              ranks: Sequence[int] = (1, 5),
                              device: Device = None,
                              ) -> IdentificationResult:
    """CMC rank-k accuracy. Embeddings must be L2-normalised; every probe
    identity must appear in the gallery. The scores are pooled by
    pooled_scores_device on `device` (the card unless 'cpu')."""
    gallery_ids = np.asarray(gallery_ids)
    probe_ids = np.asarray(probe_ids)
    missing = set(probe_ids.tolist()) - set(gallery_ids.tolist())
    if missing:
        raise ValueError(
            f"{len(missing)} probe identities missing from the gallery "
            "(use open_set_identification for non-mated probes)")
    pooled, uniq = pooled_scores_device(gallery_emb, gallery_ids, probe_emb,
                                        device=device)
    true_col = np.searchsorted(uniq, probe_ids)
    true_score = pooled[np.arange(len(probe_ids)), true_col]
    # rank = number of identities scoring strictly higher, ties favor us
    rank = (pooled > true_score[:, None]).sum(axis=1)
    cmc = {k: float(100.0 * np.mean(rank < k)) for k in ranks}
    return IdentificationResult(cmc=cmc)


def open_set_identification(gallery_emb: np.ndarray,
                            gallery_ids: np.ndarray,
                            probe_emb: np.ndarray,
                            probe_ids: np.ndarray,
                            fpirs: Sequence[float] = (1e-1, 1e-2),
                            ranks: Sequence[int] = (1,),
                            device: Device = None,
                            ) -> IdentificationResult:
    """Open-set 1:N (IJB-C style): probes whose identity is not in the
    gallery are non-mated; the accept threshold at each target FPIR is set
    on the non-mated top-score distribution, and TPIR is the fraction of
    mated probes identified at rank 1 with a top score above it. device as
    for closed_set_identification."""
    gallery_ids = np.asarray(gallery_ids)
    probe_ids = np.asarray(probe_ids)
    pooled, uniq = pooled_scores_device(gallery_emb, gallery_ids, probe_emb,
                                        device=device)
    top_score = pooled.max(axis=1)

    mated = np.isin(probe_ids, uniq)
    if not mated.any() or mated.all():
        raise ValueError("open-set protocol needs both mated and "
                         "non-mated probes")
    nonmated_top = np.sort(top_score[~mated])[::-1]
    n_nm = len(nonmated_top)

    top1_correct = np.zeros(len(probe_ids), bool)
    m_idx = np.where(mated)[0]
    true_col = np.searchsorted(uniq, probe_ids[m_idx])
    # the CMC's tie convention (rank = count of STRICTLY greater
    # identities): an exact tie counts as rank 1, whichever column argmax
    # would prefer
    top1_correct[m_idx] = (pooled[m_idx, true_col] >= top_score[m_idx])

    cmc = {k: float(100.0 * np.mean(
        (pooled[m_idx] > pooled[m_idx, true_col][:, None]).sum(axis=1) < k))
        for k in ranks}

    tpir, thresholds = {}, {}
    for fpir in fpirs:
        k = int(np.floor(fpir * n_nm))
        if k == 0:
            thresh = float(np.nextafter(nonmated_top[0], np.inf))
        elif k >= n_nm:
            thresh = -1.0
        else:
            thresh = float(np.nextafter(nonmated_top[k], np.inf))
        accept = top_score[m_idx] >= thresh
        tpir[fpir] = float(100.0 * np.mean(top1_correct[m_idx] & accept))
        thresholds[fpir] = thresh
    return IdentificationResult(cmc=cmc, tpir_at_fpir=tpir,
                                thresholds=thresholds)


def pool_templates(emb: np.ndarray, ids: np.ndarray,
                   weights: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """IJB-style template pooling: every image of an identity collapses to
    one L2-normalised embedding, the (weighted) sum of its images'
    normalised embeddings, renormalised. `weights` (e.g. the quality
    scores `embed` stores) emphasise good faces. One pass (sort +
    add.reduceat). Returns (pooled [U, D], unique_ids [U])."""
    ids = np.asarray(ids)
    order = np.argsort(ids, kind="stable")
    uniq, starts = np.unique(ids[order], return_index=True)
    e = np.asarray(emb, np.float32)[order]
    if weights is not None:
        e = e * np.asarray(weights, np.float32)[order][:, None]
    summed = np.add.reduceat(e, starts, axis=0)
    norms = np.linalg.norm(summed, axis=1, keepdims=True)
    return summed / np.maximum(norms, 1e-12), uniq


def _ids_from_paths(paths: np.ndarray) -> np.ndarray:
    """Identity label = the parent directory's name (the identity-folder
    layout of the training trees)."""
    return np.asarray([os.path.basename(os.path.dirname(str(p)))
                       for p in paths])


def _quality_gate(npz, min_quality: float, which: str) -> np.ndarray:
    """Keep-mask of the rows whose quality (`embed`'s `quality` field,
    serving/embed.norm_quality) is >= min_quality."""
    if "quality" not in npz:
        raise ValueError(
            f"--min-quality given but {which} npz has no 'quality' field; "
            "re-run `embed` (older outputs lack per-image quality)")
    keep = np.asarray(npz["quality"]) >= min_quality
    if not keep.any():
        raise ValueError(
            f"min_quality={min_quality} removes every {which} image")
    return keep


def identify_from_npz(gallery_npz: str, probes_npz: str,
                      ranks: Sequence[int] = (1, 5),
                      fpirs: Sequence[float] = (1e-1, 1e-2),
                      device: Device = None,
                      min_quality: float = 0.0,
                      pool: str = "none",
                      pool_weight: str = "none",
                      ) -> IdentificationResult:
    """1:N identification over two `embed` outputs (.npz with `embeddings`
    [N, D] L2-normalised and `paths`). Identities come from each path's
    parent directory. The closed-set protocol runs when every probe
    identity is in the gallery, the open-set one otherwise. device: as
    for closed_set_identification. min_quality > 0 gates both sides on the
    stored quality score. pool in {none, probes, gallery, both} collapses
    each identity's images to one template (pool_templates);
    pool_weight='quality' weights that mean by the stored quality."""
    g = np.load(gallery_npz, allow_pickle=False)
    p = np.load(probes_npz, allow_pickle=False)
    g_emb, g_ids = g["embeddings"], _ids_from_paths(g["paths"])
    p_emb, p_ids = p["embeddings"], _ids_from_paths(p["paths"])
    g_q = g["quality"] if "quality" in g else None
    p_q = p["quality"] if "quality" in p else None
    if min_quality > 0.0:
        g_keep = _quality_gate(g, min_quality, "gallery")
        p_keep = _quality_gate(p, min_quality, "probes")
        g_emb, g_ids, g_q = g_emb[g_keep], g_ids[g_keep], g_q[g_keep]
        p_emb, p_ids, p_q = p_emb[p_keep], p_ids[p_keep], p_q[p_keep]

    if pool not in ("none", "probes", "gallery", "both"):
        raise ValueError(f"pool must be none/probes/gallery/both: {pool!r}")
    if pool_weight not in ("none", "quality"):
        raise ValueError(f"pool_weight must be none/quality: {pool_weight!r}")
    if pool != "none":
        def weights(q, which):
            if pool_weight != "quality":
                return None
            if q is None:
                raise ValueError(
                    f"pool_weight='quality' but {which} npz has no "
                    "'quality' field; re-run `embed`")
            return q
        if pool in ("gallery", "both"):
            g_emb, g_ids = pool_templates(g_emb, g_ids,
                                          weights(g_q, "gallery"))
        if pool in ("probes", "both"):
            p_emb, p_ids = pool_templates(p_emb, p_ids,
                                          weights(p_q, "probes"))
    if set(p_ids.tolist()) <= set(g_ids.tolist()):
        return closed_set_identification(g_emb, g_ids, p_emb, p_ids, ranks,
                                         device=device)
    return open_set_identification(g_emb, g_ids, p_emb, p_ids, fpirs, ranks,
                                   device=device)
