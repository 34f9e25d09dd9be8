"""Synthetic identity data for tests and dry runs. Port of
`synthetic_identities` from face_recognition_models_tpu/data/synthetic.py:
each identity has a prototype image and its samples are noisy copies."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_identities(num_classes: int, per_class: int,
                         image_size: int = 112, seed: int = 0,
                         noise: float = 20.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 images [N, H, W, 3], int32 labels [N])."""
    rs = np.random.RandomState(seed)
    protos = rs.randint(0, 256, (num_classes, image_size, image_size, 3))
    images, labels = [], []
    for c in range(num_classes):
        jitter = rs.randn(per_class, image_size, image_size, 3) * noise
        imgs = np.clip(protos[c][None] + jitter, 0, 255).astype(np.uint8)
        images.append(imgs)
        labels.extend([c] * per_class)
    return np.concatenate(images), np.asarray(labels, np.int32)
