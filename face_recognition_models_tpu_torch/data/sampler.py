"""PK batch sampling for triplet training. Port of
face_recognition_models_tpu/data/sampler.py (the reference's PKSampler,
FaceNet/main.py:48-77): each batch holds P identities x K images;
identities with fewer than K images are sampled with replacement.

The draws come from Python's `random.Random(seed * 7919 + epoch)` in the
JAX package's order, so the port's batches are the JAX package's, index
for index.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Iterator, List, Sequence

import numpy as np


class PKBatchSampler:
    def __init__(self, labels: Sequence[int], p: int, k: int, seed: int = 0):
        self.labels = np.asarray(labels)
        self.p = p
        self.k = k
        self.seed = seed
        self.label_to_indices = defaultdict(list)
        for idx, lab in enumerate(self.labels):
            self.label_to_indices[int(lab)].append(idx)
        self.unique_labels = sorted(self.label_to_indices)
        if len(self.unique_labels) < p:
            raise ValueError(
                f"PK sampling needs >= {p} identities, got "
                f"{len(self.unique_labels)}")

    def __len__(self) -> int:
        return len(self.unique_labels) // self.p

    def epoch(self, epoch: int = 0) -> Iterator[np.ndarray]:
        """Yield index arrays of size P*K."""
        rng = random.Random(self.seed * 7919 + epoch)
        labels = list(self.unique_labels)
        rng.shuffle(labels)
        for _ in range(len(labels) // self.p):
            chosen = rng.sample(labels, self.p)
            batch: List[int] = []
            for lab in chosen:
                inds = self.label_to_indices[lab]
                if len(inds) >= self.k:
                    batch.extend(rng.sample(inds, self.k))
                else:
                    batch.extend(rng.choices(inds, k=self.k))
            yield np.asarray(batch)
