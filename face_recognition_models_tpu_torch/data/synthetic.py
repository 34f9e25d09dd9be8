"""Synthetic identity data for tests and dry runs. Port of
face_recognition_models_tpu/data/synthetic.py: each identity has a
prototype image and its samples are noisy copies, in memory
(`synthetic_identities`) or on disk as an identity-folder tree
(`write_identity_tree`) and a pair.list benchmark (`write_pair_benchmark`).
For the same arguments and seed the files are byte for byte the JAX
package's (the same numpy draws, the same PIL JPEG encoder at quality 95).
"""

from __future__ import annotations

import os
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


def write_identity_tree(root: str, images: np.ndarray, labels: np.ndarray,
                        split: str = "train") -> None:
    """Write root/<split>/id_<identity>/<i>.jpg (the reference's CASIA
    layout, dataset.py:93)."""
    from PIL import Image

    for c in np.unique(labels):
        d = os.path.join(root, split, f"id_{c:05d}")
        os.makedirs(d, exist_ok=True)
        for i, img in enumerate(images[labels == c]):
            Image.fromarray(img).save(os.path.join(d, f"{i:04d}.jpg"),
                                      quality=95)


def write_pair_benchmark(root: str, num_classes: int = 8,
                         pairs_per_kind: int = 60, image_size: int = 112,
                         seed: int = 0) -> str:
    """Write <root>/{pair.list,imgs/} in the reference's evaluation layout
    (evaluate_models.py:69-71) and return root: alternating genuine pairs
    (two noisy copies of one prototype) and impostor pairs (two prototypes),
    noise 15."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    imgs_dir = os.path.join(root, "imgs")
    os.makedirs(imgs_dir, exist_ok=True)
    protos = rs.randint(0, 256, (num_classes, image_size, image_size, 3))

    def save(img_id: int, cls: int):
        noise = rs.randn(image_size, image_size, 3) * 15
        arr = np.clip(protos[cls] + noise, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(imgs_dir, f"{img_id}.jpg"),
                                  quality=95)

    lines = []
    img_id = 0
    for _ in range(pairs_per_kind):
        c = rs.randint(num_classes)
        save(img_id, c)
        save(img_id + 1, c)
        lines.append(f"{img_id} {img_id + 1} 1")
        img_id += 2
        c1, c2 = rs.choice(num_classes, 2, replace=False)
        save(img_id, c1)
        save(img_id + 1, c2)
        lines.append(f"{img_id} {img_id + 1} 0")
        img_id += 2
    with open(os.path.join(root, "pair.list"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root
