"""MXNet/insightface RecordIO dataset support (train.rec / train.idx). Port
of face_recognition_models_tpu/data/recordio.py.

Face training sets such as CASIA-WebFace and MS1M are distributed by the
insightface project as RecordIO pairs. This module reads (and, for tests
and conversion, writes) the format with struct / numpy parsing: no mxnet,
and no pandas (the `.idx` is parsed with numpy).

On-disk format (mxnet recordio semantics):

- ``train.idx``: text lines ``<key>\\t<byte offset into train.rec>``.
- ``train.rec``: a sequence of records, each
  ``uint32 magic (0xced7230a) | uint32 lrec | payload | pad to 4 bytes``
  where ``lrec >> 29`` is the continuation flag (0 for whole records —
  mxnet only splits >512 MB payloads, never images) and
  ``lrec & 0x1fffffff`` is the payload length.
- payload: ``IRHeader`` = little-endian struct ``IfQQ``
  (flag:u32, label:f32, id:u64, id2:u64; 24 bytes). ``flag > 0`` means the
  scalar label is replaced by ``flag`` float32s following the header; the
  image bytes (JPEG) start after the header(+label array).
- insightface face layout: the record at idx key 0 is a meta record whose
  label is ``(ident_start, ident_end)``; keys ``1..ident_start-1`` are the
  images (label[0] = identity id); keys ``ident_start..ident_end-1`` are
  per-identity records whose label is that identity's ``(img_start,
  img_end)`` key range. Plain recs (every keyed record an image with a
  scalar label) are also supported.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import os
import random
import struct
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from face_recognition_models_tpu_torch.data.pipeline import (
    Batch,
    check_shard,
    epoch_order,
    prefetched,
    steps_per_epoch,
)
from face_recognition_models_tpu_torch.data.sampler import PKBatchSampler

_MAGIC = 0xCED7230A
_LREC = struct.Struct("<II")
_HEADER = struct.Struct("<IfQQ")  # flag, label, id, id2


# --------------------------------------------------------------------------
# low-level read/write
# --------------------------------------------------------------------------

def read_idx(path: str) -> Dict[int, int]:
    """Parse a .idx file -> {key: byte offset}."""
    out: Dict[int, int] = {}
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            out[int(parts[0])] = int(parts[1])
    if not out:
        raise ValueError(f"no entries parsed from {path}")
    return out


def _read_idx_arrays(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """.idx -> (keys, offsets) int64 arrays, sorted by key. numpy's C text
    reader for the canonical two-column file (no pandas: the card's host
    has none), else the tolerant read_idx loop (a line with fewer
    fields)."""
    try:
        with warnings.catch_warnings():  # an empty file: read_idx raises
            warnings.simplefilter("ignore", UserWarning)
            table = np.loadtxt(path, dtype=np.int64, usecols=(0, 1),
                               ndmin=2)
    except ValueError:
        table = None
    if table is None or not len(table):
        d = read_idx(path)
        keys = np.fromiter(d.keys(), np.int64, len(d))
        offs = np.fromiter(d.values(), np.int64, len(d))
    else:
        keys, offs = table[:, 0], table[:, 1]
    order = np.argsort(keys, kind="stable")
    return keys[order], offs[order]


def read_record(buf, offset: int) -> Tuple[np.ndarray, bytes]:
    """Read one record at `offset` -> (label float32 array, payload bytes).

    `buf` is anything sliceable by bytes (an mmap or a bytes object).
    Scalar-label records return a length-1 array.
    """
    magic, lrec = _LREC.unpack_from(buf, offset)
    if magic != _MAGIC:
        raise ValueError(f"bad RecordIO magic at offset {offset}: "
                         f"0x{magic:08x}")
    cflag, length = lrec >> 29, lrec & ((1 << 29) - 1)
    if cflag != 0:
        raise ValueError("split (>512 MB) RecordIO records are not "
                         "supported (image records never split)")
    data = bytes(buf[offset + 8:offset + 8 + length])
    flag, label, _id, _id2 = _HEADER.unpack(data[:24])
    if flag > 0:
        labels = np.frombuffer(data, np.float32, flag, offset=24).copy()
        payload = data[24 + 4 * flag:]
    else:
        labels = np.asarray([label], np.float32)
        payload = data[24:]
    return labels, payload


def _read_header(buf, offset: int) -> Tuple[np.ndarray, int, int]:
    """(labels, payload offset, payload length) of the record at `offset`,
    without copying the payload."""
    magic, lrec = _LREC.unpack_from(buf, offset)
    if magic != _MAGIC:
        raise ValueError(f"bad RecordIO magic at offset {offset}")
    length = lrec & ((1 << 29) - 1)
    flag, label, _id, _id2 = _HEADER.unpack_from(buf, offset + 8)
    if flag > 0:
        labels = np.frombuffer(
            bytes(buf[offset + 32:offset + 32 + 4 * flag]), np.float32)
    else:
        labels = np.asarray([label], np.float32)
    head = 24 + 4 * flag
    return labels, offset + 8 + head, length - head


def _read_header_label(buf, offset: int) -> np.ndarray:
    """Label(s) of the record at `offset` without copying the payload."""
    return _read_header(buf, offset)[0]


def _scan_headers(buf: np.ndarray, offsets: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized header scan over all image records: (int labels,
    payload offsets, payload lengths).

    One fancy-indexed gather of the 32 header bytes per record instead of
    per-record struct.unpack calls — at MS1M scale (~5.8M records) the
    Python loop costs ~a minute, this ~a second. `buf` is the 1-D uint8
    mmap of the .rec.
    """
    n = len(offsets)
    if n == 0:
        z = np.zeros((0,), np.int64)
        return np.zeros((0,), np.int32), z, z
    offsets = np.asarray(offsets, np.int64)
    heads = np.ascontiguousarray(
        buf[offsets[:, None] + np.arange(32)])           # [N, 32] uint8
    h32 = heads.view(np.uint32)                          # [N, 8] LE words
    hf32 = heads.view(np.float32)
    magic = h32[:, 0]
    if (magic != _MAGIC).any():
        bad = int(offsets[int(np.argmax(magic != _MAGIC))])
        raise ValueError(f"bad RecordIO magic at offset {bad}")
    lrec = h32[:, 1].astype(np.int64)
    if (lrec >> 29).any():
        raise ValueError("split (>512 MB) RecordIO records are not "
                         "supported")
    length = lrec & ((1 << 29) - 1)
    flag = h32[:, 2].astype(np.int64)
    scalar_label = hf32[:, 3]
    # flag==0: label is the header scalar; flag>0: first float after the
    # header (bytes 32:36 — gathered separately for just those rows)
    labels = scalar_label.astype(np.float64)
    arr_rows = np.flatnonzero(flag > 0)
    if len(arr_rows):
        first = buf[offsets[arr_rows, None] + (32 + np.arange(4))]
        labels[arr_rows] = first.view(np.float32)[:, 0]
    head_bytes = 24 + 4 * flag
    p_offs = offsets + 8 + head_bytes
    p_lens = length - head_bytes
    if (p_lens < 0).any():
        raise ValueError("record shorter than its header")
    return labels.astype(np.int32), p_offs, p_lens


def write_recordio(prefix: str, payloads: Sequence[bytes],
                   labels: Sequence[int],
                   insightface_layout: bool = True) -> Tuple[str, str]:
    """Write `<prefix>.rec` + `<prefix>.idx` from encoded image bytes.

    With `insightface_layout` (the format real face .recs use) images get
    keys 1..N grouped by identity, identity range records follow, and the
    key-0 meta record points at them; otherwise keys are 0..N-1 with
    scalar labels. Returns (rec_path, idx_path). Test/interop utility —
    training reads this format, it does not require it.
    """
    labels = np.asarray(labels, np.int64)
    if len(payloads) != len(labels):
        raise ValueError("payloads/labels length mismatch")
    order = np.argsort(labels, kind="stable") if insightface_layout \
        else np.arange(len(labels))
    rec_path, idx_path = prefix + ".rec", prefix + ".idx"

    entries: List[Tuple[int, int]] = []  # (key, offset)

    def _pack(flag: int, label_f: Sequence[float], rid: int,
              payload: bytes) -> bytes:
        head = _HEADER.pack(flag, float(label_f[0]) if flag == 0 else 0.0,
                            rid, 0)
        if flag > 0:
            head += np.asarray(label_f, np.float32).tobytes()
        data = head + payload
        pad = (-len(data)) % 4
        return _LREC.pack(_MAGIC, len(data)) + data + b"\x00" * pad

    with open(rec_path, "wb") as f:
        def emit(key: int, record: bytes) -> None:
            entries.append((key, f.tell()))
            f.write(record)

        if insightface_layout:
            key = 1
            ident_ranges: List[Tuple[int, int]] = []  # key ranges per ident
            start, cur = key, int(labels[order[0]]) if len(order) else 0
            for i in order:
                lab = int(labels[i])
                if lab != cur:
                    ident_ranges.append((start, key))
                    start, cur = key, lab
                emit(key, _pack(0, [lab], key, payloads[i]))
                key += 1
            if len(order):
                ident_ranges.append((start, key))
            ident_start = key
            for a, b in ident_ranges:
                emit(key, _pack(2, [a, b], key, b""))
                key += 1
            # key-0 meta record: label = (ident_start, ident_end)
            emit(0, _pack(2, [ident_start, key], 0, b""))
        else:
            for key, i in enumerate(order):
                emit(key, _pack(0, [int(labels[i])], key, payloads[i]))

    with open(idx_path, "w") as f:
        for key, off in entries:
            f.write(f"{key}\t{off}\n")
    return rec_path, idx_path


# --------------------------------------------------------------------------
# dataset index
# --------------------------------------------------------------------------

def resolve_prefix(path: str) -> Optional[str]:
    """Normalize a user path to a rec prefix, or None if not RecordIO.

    Accepts `<p>.rec`, `<p>.idx`, a bare prefix `<p>` with both files, or
    a directory containing `train.rec`/`train.idx`.
    """
    if path.endswith(".rec") or path.endswith(".idx"):
        prefix = path[:-4]
    elif os.path.isdir(path):
        prefix = os.path.join(path, "train")
    else:
        prefix = path
    if os.path.isfile(prefix + ".rec") and os.path.isfile(prefix + ".idx"):
        return prefix
    return None


def is_recordio(path: str) -> bool:
    return resolve_prefix(path) is not None


class RecordIODataset:
    """Index over one .rec/.idx pair: image keys, offsets, int labels.

    Mirrors ImageFolderIndex's role for folder trees (data/index.py) —
    metadata only; decoding is the RecLoader's job.
    """

    def __init__(self, prefix: str, keys: np.ndarray, offsets: np.ndarray,
                 labels: np.ndarray, num_identities: int,
                 payload_offsets: Optional[np.ndarray] = None,
                 payload_lengths: Optional[np.ndarray] = None):
        self.prefix = prefix
        self.rec_path = prefix + ".rec"
        self.keys = keys
        self.offsets = offsets
        self.labels = labels
        self.num_identities = num_identities
        # absolute byte ranges of each image's encoded payload inside the
        # .rec (lets the native decoder read straight off the mmap)
        self.payload_offsets = payload_offsets
        self.payload_lengths = payload_lengths
        # pack/meta compatibility with ImageFolderIndex
        self.identities = [str(i) for i in range(num_identities)]

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def open(cls, path: str) -> "RecordIODataset":
        prefix = resolve_prefix(path)
        if prefix is None:
            raise FileNotFoundError(f"no .rec/.idx pair at {path}")
        all_keys, all_offs = _read_idx_arrays(prefix + ".idx")
        # mmap: the header scan touches ~32 B per record, never the payloads
        buf = np.memmap(prefix + ".rec", dtype=np.uint8, mode="r")
        num_identities = 0
        mask = np.ones(len(all_keys), bool)
        if len(all_keys) and all_keys[0] == 0:
            label0 = _read_header_label(buf, int(all_offs[0]))
            if len(label0) >= 2 and int(label0[0]) > 0:
                # insightface layout: images are keys 1..ident_start-1
                ident_start, ident_end = int(label0[0]), int(label0[1])
                mask = (all_keys > 0) & (all_keys < ident_start)
                num_identities = ident_end - ident_start
        keys, offsets = all_keys[mask], all_offs[mask]
        labels, p_offs, p_lens = _scan_headers(buf, offsets)
        if num_identities == 0:
            num_identities = int(labels.max()) + 1 if len(labels) else 0
        return cls(prefix, keys, offsets, labels,
                   num_identities, p_offs, p_lens)


# --------------------------------------------------------------------------
# loader
# --------------------------------------------------------------------------

def _decode_jpeg_bytes(payload: bytes, image_size: int
                       ) -> Optional[np.ndarray]:
    """uint8 HWC decode of encoded bytes with PIL; None on failure (the
    Loader's corrupt-image contract, data/pipeline.py)."""
    try:
        from PIL import Image
        with Image.open(io.BytesIO(payload)) as im:
            im = im.convert("RGB")
            if im.size != (image_size, image_size):
                im = im.resize((image_size, image_size))
            return np.asarray(im, dtype=np.uint8)
    except Exception:
        return None


class RecLoader:
    """Loader over a RecordIODataset with the Loader contract
    (data/pipeline.py): (uint8 [B,H,W,3], int32 [B]) batches, static shapes
    (corrupt records resampled, not dropped), the (seed, epoch) shuffle,
    `shard=(rank, count)` and background prefetch. Records decode from one
    shared mmap of the .rec.
    """

    def __init__(self, dataset: RecordIODataset, batch_size: int,
                 image_size: int = 112, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_remainder: bool = True,
                 prefetch: int = 2,
                 shard: Optional[Tuple[int, int]] = None,
                 backend: str = "auto"):
        """backend: 'native' = the C++ threaded libjpeg decoder straight off
        the .rec mmap (native/fastdecode.decode_batch_mem), 'pil' =
        thread-pool PIL over payload bytes, 'auto' = native when it
        builds."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        check_shard(shard)
        self.shard = shard
        self.skipped_images = 0
        self._resample_lock = threading.Lock()
        self._mm = np.memmap(dataset.rec_path, dtype=np.uint8, mode="r")
        if backend == "auto":
            from face_recognition_models_tpu_torch.native import is_available
            backend = "native" if (is_available()
                                   and dataset.payload_offsets is not None
                                   ) else "pil"
        if backend not in ("native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "native":
            from face_recognition_models_tpu_torch.native import (
                build_error, is_available)
            if dataset.payload_offsets is None:
                raise ValueError("native backend needs payload offsets "
                                 "(RecordIODataset.open provides them)")
            if not is_available():
                raise RuntimeError(
                    f"native decode backend unavailable: {build_error()}")
        self.backend = backend

    def steps_per_epoch(self) -> int:
        return steps_per_epoch(len(self.dataset), self.batch_size,
                               self.drop_remainder, self.shard)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return epoch_order(len(self.dataset), self.shuffle, self.seed, epoch,
                           self.shard)

    def _decode_row(self, row: int) -> Optional[np.ndarray]:
        _, payload = read_record(self._mm, int(self.dataset.offsets[row]))
        return _decode_jpeg_bytes(payload, self.image_size)

    def _load_batch(self, pool: cf.ThreadPoolExecutor, idxs: np.ndarray,
                    rng: random.Random) -> Batch:
        if self.backend == "native":
            return self._load_batch_native(idxs, rng)
        return self._load_batch_pil(pool, idxs, rng)

    def _load_batch_native(self, idxs: np.ndarray, rng: random.Random
                           ) -> Batch:
        from face_recognition_models_tpu_torch.native import decode_batch_mem

        ds = self.dataset
        n = len(ds)
        idxs = np.array(idxs)
        images, status = decode_batch_mem(
            self._mm, ds.payload_offsets[idxs], ds.payload_lengths[idxs],
            self.image_size, n_threads=self.num_workers)
        # resample failed slots (static-shape policy), PIL as last resort
        for _attempt in range(8):
            bad = np.flatnonzero(status)
            if not len(bad):
                break
            self.skipped_images += len(bad)
            for slot in bad:
                idxs[slot] = rng.randrange(n)
            retry, status_r = decode_batch_mem(
                self._mm, ds.payload_offsets[idxs[bad]],
                ds.payload_lengths[idxs[bad]], self.image_size,
                n_threads=self.num_workers)
            images[bad] = retry
            status[:] = 0
            status[bad] = status_r
        for slot in np.flatnonzero(status):
            arr = self._decode_row(int(idxs[slot]))
            if arr is None:
                raise RuntimeError(
                    f"persistent record decode failures (last: record "
                    f"{int(idxs[slot])}); dataset appears corrupt")
            images[slot] = arr
        return images, ds.labels[idxs]

    def _load_batch_pil(self, pool: cf.ThreadPoolExecutor,
                        idxs: np.ndarray, rng: random.Random) -> Batch:
        n = len(self.dataset)
        images = np.empty((len(idxs), self.image_size, self.image_size, 3),
                          np.uint8)
        labels = np.empty((len(idxs),), np.int32)

        def fill(slot: int, row: int, attempts: int = 8):
            arr = self._decode_row(row)
            while arr is None and attempts > 0:
                with self._resample_lock:
                    self.skipped_images += 1
                    row = rng.randrange(n)
                arr = self._decode_row(row)
                attempts -= 1
            if arr is None:
                raise RuntimeError(
                    f"persistent record decode failures (last: record "
                    f"{row}); dataset appears corrupt")
            images[slot] = arr
            labels[slot] = self.dataset.labels[row]

        list(pool.map(fill, range(len(idxs)), idxs))
        return images, labels

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = self._epoch_order(epoch)
        bs = self.batch_size
        rng = random.Random(self.seed * 1000003 + epoch)

        def produce():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                for s in range(self.steps_per_epoch()):
                    yield self._load_batch(pool, order[s * bs:(s + 1) * bs],
                                           rng)

        return prefetched(produce, self.prefetch)


class PKRecLoader(RecLoader):
    """PK-structured streaming loader over a RecordIO set for triplet
    training: every batch holds P identities x K images decoded off the
    .rec mmap; the RecordIO twin of `data.pipeline.PKLoader`, so `facenet
    --dataset-path train.rec` trains insightface-format sets without
    holding them in host memory."""

    def __init__(self, dataset: RecordIODataset, p: int, k: int,
                 image_size: int = 112, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2, backend: str = "auto"):
        super().__init__(dataset, batch_size=p * k, image_size=image_size,
                         shuffle=False, seed=seed, num_workers=num_workers,
                         drop_remainder=True, prefetch=prefetch,
                         backend=backend)
        self._sampler = PKBatchSampler(dataset.labels, p, k, seed=seed)

    def steps_per_epoch(self) -> int:
        return len(self._sampler)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # one flat index array that epoch() slices back into the sampler's
        # PK batches (batch_size == p * k)
        return np.concatenate(list(self._sampler.epoch(epoch)))
