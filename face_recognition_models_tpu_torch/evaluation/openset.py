"""Open-set verification metrics. Port of `tpr_at_far` from
face_recognition_models_tpu/evaluation/openset.py (the identification
functions are not ported yet).

TPR@FAR is 1:1 verification at fixed false-accept rates (e.g. 1e-3): the
operating point a deployed system runs at, where one accuracy number hides
the far tail of the impostor distribution. Scores are cosines in [-1, 1].
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


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
