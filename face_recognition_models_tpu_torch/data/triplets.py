"""LFW triplet-file parsing for the FaceNet path. Port of
face_recognition_models_tpu/data/triplets.py (the reference's
FaceNet/utils/dataset.py:10-92): pair files under the identity directory
hold 4-line blocks (anchor, positive, negative1, negative2); each block
yields two (anchor, positive, negative) triplets. Every referenced image
must exist, as in the reference.
"""

from __future__ import annotations

import os
from typing import List, Tuple


def load_triplet_file(identity_dir: str, triplet_file: str
                      ) -> List[Tuple[str, str, str]]:
    with open(triplet_file, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) % 4 != 0:
        raise ValueError(
            f"{triplet_file}: expected 4-line blocks, got {len(lines)} lines")
    triplets: List[Tuple[str, str, str]] = []
    for i in range(0, len(lines), 4):
        block = lines[i:i + 4]
        for name in block:
            if not os.path.exists(os.path.join(identity_dir, name)):
                raise FileNotFoundError(f"{name} does not exist")
        anchor, positive, neg1, neg2 = block
        triplets.append((anchor, positive, neg1))
        triplets.append((anchor, positive, neg2))
    return triplets


def load_lfw_triplets(root_dir: str,
                      identity_subdir: str = "lfw_funneled"
                      ) -> List[Tuple[str, str, str]]:
    """Scan all pair files (except pairs.txt) in the identity dir and build
    the combined triplet list (FaceNet/utils/dataset.py:44-70)."""
    identity_dir = os.path.join(root_dir, identity_subdir)
    if not os.path.isdir(identity_dir):
        raise FileNotFoundError(f"Directory {identity_dir} does not exist")
    pair_files = sorted(
        os.path.join(identity_dir, x) for x in os.listdir(identity_dir)
        if os.path.isfile(os.path.join(identity_dir, x)) and x != "pairs.txt")
    triplets: List[Tuple[str, str, str]] = []
    for pf in pair_files:
        triplets.extend(load_triplet_file(identity_dir, pf))
    return triplets
