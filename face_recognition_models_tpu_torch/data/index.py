"""Identity-folder dataset indexer. Port of
face_recognition_models_tpu/data/index.py.

Scans `root/<split>/<identity>/*.{jpg,jpeg,png}`, gives each identity
folder an integer label (identities and files sorted) and shuffles the
samples once with `random.Random(shuffle_seed)`, the same stdlib call as the
JAX package, so both give the same order. Decoding is the Loader's job; the
index is (paths, labels) plus the class maps.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


@dataclass
class ImageFolderIndex:
    root: str
    samples: List[Tuple[str, int]]        # (relative path, label)
    identities: List[str]
    class_to_idx: Dict[str, int]

    @property
    def idx_to_class(self) -> Dict[int, str]:
        return {i: name for name, i in self.class_to_idx.items()}

    @property
    def num_identities(self) -> int:
        return len(self.identities)

    def __len__(self) -> int:
        return len(self.samples)

    @classmethod
    def build(cls, root: str, split: Optional[str] = None,
              shuffle_seed: Optional[int] = 0) -> "ImageFolderIndex":
        """Index root[/split]/<identity>/<image>."""
        base = os.path.join(root, split) if split else root
        if not os.path.isdir(base):
            raise FileNotFoundError(f"Directory {base} does not exist")
        identities = sorted(
            d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d)))
        class_to_idx = {name: i for i, name in enumerate(identities)}
        samples: List[Tuple[str, int]] = []
        for identity in identities:
            label = class_to_idx[identity]
            ident_dir = os.path.join(base, identity)
            for image in sorted(os.listdir(ident_dir)):
                if image.lower().endswith(_IMAGE_EXTS):
                    samples.append((os.path.join(identity, image), label))
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(samples)
        return cls(root=base, samples=samples, identities=identities,
                   class_to_idx=class_to_idx)

    @classmethod
    def concat(cls, indexes: Sequence["ImageFolderIndex"]
               ) -> "ImageFolderIndex":
        """train + valid as one index. Labels must come from the same
        identity universe (the same class_to_idx) in all parts."""
        if not indexes:
            raise ValueError("concat of zero indexes")
        first = indexes[0]
        samples = []
        for idx in indexes:
            if idx.class_to_idx != first.class_to_idx:
                raise ValueError(
                    "concat requires identical identity->label maps; "
                    "got differing class_to_idx")
            samples.extend(
                (os.path.join(idx.root, rel), lab) for rel, lab in idx.samples)
        return cls(root="", samples=samples, identities=first.identities,
                   class_to_idx=dict(first.class_to_idx))

    def absolute_paths(self) -> List[str]:
        return [os.path.join(self.root, rel) for rel, _ in self.samples]

    def labels(self) -> List[int]:
        return [lab for _, lab in self.samples]


def index_tree(path: str) -> ImageFolderIndex:
    """The training index of an identity tree, as `train` and `pack` read
    it: `<path>/CASIA-WebFace` when that directory exists (its train and
    valid splits as one index, or the directory itself when it has
    neither), else `<path>` itself."""
    root = os.path.join(path, "CASIA-WebFace")
    if not os.path.isdir(root):
        root = path
    parts = []
    for split in ("train", "valid"):
        try:
            parts.append(ImageFolderIndex.build(root, split=split))
        except FileNotFoundError:
            pass
    if not parts:
        parts = [ImageFolderIndex.build(root)]
    return parts[0] if len(parts) == 1 else ImageFolderIndex.concat(parts)
