"""Host-side batch loaders. Port of `Loader`, `PKLoader` and `ArrayLoader`
from face_recognition_models_tpu/data/pipeline.py: the loop's
`steps_per_epoch()` / `epoch(i)` contract, yielding (uint8 images
[B, H, W, 3], int32 labels [B]).

- `Loader` decodes an identity tree (data/index.py) on a thread pool, with
  the native libjpeg decoder (native/fastdecode) or PIL, into uint8
  batches; normalisation happens on the device in the train step.
- Static batch shapes: a corrupt image is replaced by another index drawn
  from `random.Random(seed * 1000003 + epoch)`, never dropped; 9 failures
  in a row raise, rather than train a label on a black image.
- The next batches are made in a background thread (`prefetched`) while
  the device runs; an exception there reaches the consumer.
- The shuffle order is a pure function of (seed, epoch), and `shard=(rank,
  count)` takes every count-th index of it, cut to the shortest shard.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import queue
import random
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

from face_recognition_models_tpu_torch.data.index import ImageFolderIndex
from face_recognition_models_tpu_torch.data.sampler import PKBatchSampler

Batch = Tuple[np.ndarray, np.ndarray]


def prefetched(produce: Callable[[], Iterable], depth: int) -> Iterator:
    """Iterate what `produce()` yields, made in a background thread at most
    `depth` items ahead. An exception in the producer is raised to the
    consumer instead of leaving it blocked; when the consumer stops early,
    the producer is stopped and the queue drained so its thread exits."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            with contextlib.closing(iter(produce())) as items:
                for item in items:
                    if stop.is_set():
                        return
                    q.put(item)
            q.put(None)
        except BaseException as exc:  # noqa: BLE001 — raised by the consumer
            q.put(exc)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.1)


def epoch_order(n: int, shuffle: bool, seed: int, epoch: int,
                shard: Optional[Tuple[int, int]]) -> np.ndarray:
    """The sample order of one epoch: a (seed + epoch) shuffle of range(n),
    and with `shard=(rank, count)` every count-th index from rank, cut to
    n // count so that every rank takes the same number of steps."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    if shard is not None:
        rank, count = shard
        order = order[rank::count][:n // count]
    return order


def check_shard(shard: Optional[Tuple[int, int]]) -> None:
    if shard is not None and not 0 <= shard[0] < shard[1]:
        raise ValueError(f"bad shard {shard}")


def steps_per_epoch(n: int, batch_size: int, drop_remainder: bool,
                    shard: Optional[Tuple[int, int]] = None) -> int:
    if shard is not None:
        n //= shard[1]
    return n // batch_size if drop_remainder else -(-n // batch_size)


def _decode_image(path: str, image_size: int) -> Optional[np.ndarray]:
    """uint8 HWC decode with PIL; None on failure."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            im = im.convert("RGB")
            if im.size != (image_size, image_size):
                im = im.resize((image_size, image_size))
            return np.asarray(im, dtype=np.uint8)
    except Exception:
        return None


class Loader:
    """Iterates (uint8 images [B,H,W,3], int32 labels [B]) epochs of an
    identity tree.

    backend:
      'native' — the C++ threaded libjpeg batch decoder (native/fastdecode);
                 raises with its build error where it does not build;
      'pil'    — thread-pool PIL decode;
      'auto'   — native when it builds and the first 64 files are JPEG,
                 else PIL.
    """

    def __init__(self, index: ImageFolderIndex, batch_size: int,
                 image_size: int = 112, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 drop_remainder: bool = True, prefetch: int = 2,
                 backend: str = "auto",
                 shard: Optional[Tuple[int, int]] = None):
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        check_shard(shard)
        self.shard = shard
        self._paths = index.absolute_paths()
        self._labels = np.asarray(index.labels(), dtype=np.int32)
        self.skipped_images = 0  # corrupt-image counter (observability)
        self._resample_lock = threading.Lock()

        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        self._native = False
        if backend in ("auto", "native"):
            from face_recognition_models_tpu_torch.native import (
                build_error, is_available)
            jpeg_only = all(p.lower().endswith((".jpg", ".jpeg"))
                            for p in self._paths[:64])
            self._native = is_available() and (jpeg_only
                                               or backend == "native")
            if backend == "native" and not self._native:
                raise RuntimeError(
                    f"native decode backend unavailable: {build_error()}")
        self.backend = "native" if self._native else "pil"

    def steps_per_epoch(self) -> int:
        return steps_per_epoch(len(self._paths), self.batch_size,
                               self.drop_remainder, self.shard)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return epoch_order(len(self._paths), self.shuffle, self.seed, epoch,
                           self.shard)

    def _resample(self, rng: random.Random, count: int = 1) -> int:
        """A replacement index for a slot that failed to decode."""
        with self._resample_lock:
            self.skipped_images += count
            return rng.randrange(len(self._paths))

    def _load_batch(self, pool: cf.ThreadPoolExecutor, idxs: np.ndarray,
                    rng: random.Random) -> Batch:
        if self._native:
            return self._load_batch_native(idxs, rng)
        return self._load_batch_pil(pool, idxs, rng)

    def _load_batch_native(self, idxs: np.ndarray, rng: random.Random
                           ) -> Batch:
        from face_recognition_models_tpu_torch.native import decode_batch

        n = len(self._paths)
        idxs = np.array(idxs)
        images, status = decode_batch(
            [self._paths[i] for i in idxs], self.image_size,
            n_threads=self.num_workers)
        # resample failed slots (static-shape policy), PIL as last resort
        for _attempt in range(8):
            bad = np.flatnonzero(status)
            if not len(bad):
                break
            self.skipped_images += len(bad)
            for slot in bad:
                idxs[slot] = rng.randrange(n)
            retry, status_r = decode_batch(
                [self._paths[idxs[s]] for s in bad], self.image_size,
                n_threads=self.num_workers)
            images[bad] = retry
            status[:] = 0
            status[bad] = status_r
        for slot in np.flatnonzero(status):
            arr = _decode_image(self._paths[idxs[slot]], self.image_size)
            if arr is None:
                raise RuntimeError(
                    "persistent image decode failures (last: "
                    f"{self._paths[idxs[slot]]}); dataset appears corrupt")
            images[slot] = arr
        return images, self._labels[idxs]

    def _load_batch_pil(self, pool: cf.ThreadPoolExecutor, idxs: np.ndarray,
                        rng: random.Random) -> Batch:
        images = np.empty((len(idxs), self.image_size, self.image_size, 3),
                          np.uint8)
        labels = np.empty((len(idxs),), np.int32)

        def fill(slot: int, idx: int, attempts: int = 8):
            arr = _decode_image(self._paths[idx], self.image_size)
            while arr is None and attempts > 0:
                # static-shape policy: resample instead of dropping
                idx = self._resample(rng)
                arr = _decode_image(self._paths[idx], self.image_size)
                attempts -= 1
            if arr is None:
                raise RuntimeError(
                    "persistent image decode failures (last: "
                    f"{self._paths[idx]}); dataset appears corrupt")
            images[slot] = arr
            labels[slot] = self._labels[idx]

        list(pool.map(fill, range(len(idxs)), idxs))
        return images, labels

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Yield the batches of one epoch, decoded ahead in the
        background."""
        order = self._epoch_order(epoch)
        bs = self.batch_size
        rng = random.Random(self.seed * 1000003 + epoch)

        def produce():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                for s in range(self.steps_per_epoch()):
                    yield self._load_batch(pool, order[s * bs:(s + 1) * bs],
                                           rng)

        return prefetched(produce, self.prefetch)


class PKLoader(Loader):
    """PK-structured streaming loader for triplet training: every batch
    holds P identities x K images (data/sampler.PKBatchSampler), decoded
    through the Loader's backends with its prefetch thread, so `facenet
    --dataset-path` trains an identity tree without holding it in host
    memory (the reference's DataLoader + PKSampler, FaceNet/main.py:48-77,
    133-139).

    Corrupt images follow the Loader's resample policy; a resampled slot
    may fall outside the batch's P identities, which the miner tolerates
    (pairs without a valid positive or negative are masked out,
    ops/mining.py)."""

    def __init__(self, index: ImageFolderIndex, p: int, k: int,
                 image_size: int = 112, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2, backend: str = "auto"):
        super().__init__(index, batch_size=p * k, image_size=image_size,
                         shuffle=False, seed=seed, num_workers=num_workers,
                         drop_remainder=True, prefetch=prefetch,
                         backend=backend)
        self._sampler = PKBatchSampler(self._labels, p, k, seed=seed)

    def steps_per_epoch(self) -> int:
        return len(self._sampler)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # one flat index array that epoch() slices back into the sampler's
        # PK batches (batch_size == p * k)
        return np.concatenate(list(self._sampler.epoch(epoch)))


class ArrayLoader:
    """In-memory variant (synthetic data, tests): the same epoch API over
    uint8 arrays, shuffled per epoch from `seed + epoch`; `shard=(rank,
    count)` follows Loader's law."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True,
                 shard: Optional[Tuple[int, int]] = None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be uint8 [N, H, W, 3]")
        check_shard(shard)
        self.shard = shard
        self.images = images
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder

    def steps_per_epoch(self) -> int:
        return steps_per_epoch(len(self.images), self.batch_size,
                               self.drop_remainder, self.shard)

    def epoch(self, epoch: int = 0):
        order = epoch_order(len(self.images), self.shuffle, self.seed, epoch,
                            self.shard)
        bs = self.batch_size
        for s in range(self.steps_per_epoch()):
            idxs = order[s * bs:(s + 1) * bs]
            yield self.images[idxs], self.labels[idxs]
