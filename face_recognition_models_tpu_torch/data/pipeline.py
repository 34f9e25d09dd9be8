"""Batch loaders. Port of `ArrayLoader` from
face_recognition_models_tpu/data/pipeline.py: the loop's
`steps_per_epoch()` / `epoch(i)` contract over in-memory uint8 arrays."""

from __future__ import annotations

import numpy as np


class ArrayLoader:
    """Yields (uint8 images [B, H, W, 3], int32 labels [B]) batches, shuffled
    per epoch from `seed + epoch`."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be uint8 [N, H, W, 3]")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder

    def steps_per_epoch(self) -> int:
        n = len(self.images)
        return (n // self.batch_size if self.drop_remainder
                else -(-n // self.batch_size))

    def epoch(self, epoch: int = 0):
        order = np.arange(len(self.images))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        bs = self.batch_size
        for s in range(self.steps_per_epoch()):
            idxs = order[s * bs:(s + 1) * bs]
            yield self.images[idxs], self.labels[idxs]
