"""Packed pre-decoded dataset: decode once, then train with no decode on the
host. Port of face_recognition_models_tpu/data/packed.py, the format byte
for byte, so a pack written by either package opens in the other:

    python -m face_recognition_models_tpu_torch.cli pack \
        --dataset-path <tree or .rec> --output casia.pack/

decodes the dataset once into

    images.u8    uint8 memmap [N, H, W, 3]   (37.6 KB an image at 112 px)
    labels.npy   int32 [N]
    meta.json    {format_version: 1, num_samples, image_size, identities,
                  decode_backend, skipped_images}

and `PackedLoader` serves shuffled batches by memmap gathers in a prefetch
thread. Batches stay uint8, as from the JPEG Loader, so the step cannot tell
the two apart. A pack needs no decoder to read, so it is the input path that
runs wherever the port does.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from face_recognition_models_tpu_torch.data.index import ImageFolderIndex
from face_recognition_models_tpu_torch.data.pipeline import (
    Batch,
    Loader,
    check_shard,
    epoch_order,
    prefetched,
    steps_per_epoch,
)

_FORMAT_VERSION = 1
_META = "meta.json"
_IMAGES = "images.u8"
_LABELS = "labels.npy"


def is_packed_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _META))


def pack_dataset(index: ImageFolderIndex, out_dir: str,
                 image_size: int = 112, num_workers: int = 8,
                 backend: str = "auto", progress_every: int = 0) -> dict:
    """Decode every image in `index` into a packed dir. Returns meta.

    Corrupt images are resampled by the Loader's static-shape policy, so
    the pack always holds exactly len(index) valid samples.
    """
    n = len(index)
    if n == 0:
        raise ValueError("empty index")
    loader = Loader(index, batch_size=min(1024, n), image_size=image_size,
                    shuffle=False, num_workers=num_workers,
                    drop_remainder=False, backend=backend)
    return pack_from_loader(loader, index.identities, out_dir,
                            image_size, decode_backend=loader.backend,
                            progress_every=progress_every)


def pack_from_loader(loader, identities, out_dir: str, image_size: int,
                     decode_backend: str = "pil",
                     progress_every: int = 0) -> dict:
    """Write a packed dir from any loader with the Loader contract (the
    folder Loader, RecLoader, ...): its epoch(0) must be an unshuffled full
    pass with drop_remainder=False, its length `len(loader.dataset)` or
    `len(loader.index)`, and it counts `loader.skipped_images`."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(loader.dataset) if hasattr(loader, "dataset") \
        else len(loader.index)
    mm = np.memmap(os.path.join(out_dir, _IMAGES), dtype=np.uint8,
                   mode="w+", shape=(n, image_size, image_size, 3))
    labels = np.empty((n,), np.int32)
    pos = 0
    for imgs, labs in loader.epoch(0):
        mm[pos:pos + len(imgs)] = imgs
        labels[pos:pos + len(labs)] = labs
        pos += len(imgs)
        if progress_every and pos % progress_every < len(imgs):
            print(f"packed {pos}/{n}")
    if pos != n:
        raise RuntimeError(f"packed {pos} of {n}: the loader's epoch(0) is "
                           "not one full pass")
    mm.flush()
    del mm
    np.save(os.path.join(out_dir, _LABELS), labels)
    meta = {
        "format_version": _FORMAT_VERSION,
        "num_samples": n,
        "image_size": image_size,
        "identities": list(identities),
        "decode_backend": decode_backend,
        "skipped_images": loader.skipped_images,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f)
    return meta


@dataclass
class PackedDataset:
    """Read side of a packed dir: a zero-copy memmap over images.u8."""

    root: str
    images: np.memmap          # uint8 [N, H, W, 3]
    labels: np.ndarray         # int32 [N]
    image_size: int
    identities: List[str]

    @property
    def num_identities(self) -> int:
        return len(self.identities)

    def __len__(self) -> int:
        return len(self.labels)

    @classmethod
    def open(cls, root: str) -> "PackedDataset":
        meta_path = os.path.join(root, _META)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(f"not a packed dataset: {root}")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"packed format v{meta.get('format_version')} "
                f"!= reader v{_FORMAT_VERSION}")
        n, s = meta["num_samples"], meta["image_size"]
        img_path = os.path.join(root, _IMAGES)
        expect = n * s * s * 3
        actual = os.path.getsize(img_path)
        if actual != expect:
            raise ValueError(
                f"{img_path}: {actual} bytes, expected {expect} "
                f"({n} x {s}x{s}x3) — truncated or corrupt pack")
        images = np.memmap(img_path, dtype=np.uint8, mode="r",
                           shape=(n, s, s, 3))
        labels = np.load(os.path.join(root, _LABELS))
        if len(labels) != n:
            raise ValueError("labels/meta length mismatch")
        return cls(root=root, images=images, labels=labels.astype(np.int32),
                   image_size=s, identities=list(meta["identities"]))


class PackedLoader:
    """The Loader's epoch API over a PackedDataset.

    Batches are memmap gathers made in a prefetch thread. The shuffle order
    and `shard=(rank, count)` follow Loader's law, so a pack gives the same
    batches as the tree it was packed from.
    """

    def __init__(self, dataset: PackedDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True, prefetch: int = 2,
                 shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        check_shard(shard)
        self.shard = shard
        self.image_size = dataset.image_size
        self.skipped_images = 0  # as Loader's; a pack has no corrupt image

    def steps_per_epoch(self) -> int:
        return steps_per_epoch(len(self.dataset), self.batch_size,
                               self.drop_remainder, self.shard)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return epoch_order(len(self.dataset), self.shuffle, self.seed, epoch,
                           self.shard)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = self._epoch_order(epoch)
        bs = self.batch_size
        images, labels = self.dataset.images, self.dataset.labels

        def produce():
            for s in range(self.steps_per_epoch()):
                idxs = order[s * bs:(s + 1) * bs]
                # a sorted gather reads a cold memmap in file order; the
                # scatter restores the shuffled order within the batch
                sort = np.argsort(idxs, kind="stable")
                batch = np.empty((len(idxs),) + images.shape[1:], np.uint8)
                batch[sort] = images[idxs[sort]]
                yield batch, labels[idxs]

        return prefetched(produce, self.prefetch)
