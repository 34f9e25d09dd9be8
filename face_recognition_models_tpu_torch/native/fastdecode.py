"""ctypes binding and lazy build of the native batch JPEG decoder. Port of
face_recognition_models_tpu/native/fastdecode.py.

The first call compiles `fastdecode.cpp` with g++ against libjpeg into
`build/native/libfastdecode-<hash>.so` at the repository root (git-ignored),
the hash covering the source and the flags, as ops/_build.py does for the
CUDA sources; a built library is reused. No `-march=native`: a library built
on one host must run on another. Nothing runs at import time. Where g++ or
libjpeg is missing, `is_available()` is False and `build_error()` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fastdecode.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfastdecode-{digest[:12]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the shared library to `out`. Returns an error or None."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"compiler unavailable: {e}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr[-500:]}"
    os.replace(tmp, out)  # atomic: a concurrent reader sees all or none
    return None


def _load() -> None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        path = library_path()
        if not path.exists():
            _build_error = _build(path)
            if _build_error:
                return
        try:
            lib = ctypes.CDLL(str(path))
            lib.fd_decode_batch.restype = ctypes.c_int
            lib.fd_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
            lib.fd_decode_batch_mem.restype = ctypes.c_int
            lib.fd_decode_batch_mem.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
            _lib = lib
        except (OSError, AttributeError) as e:
            _build_error = f"dlopen failed: {e}"


def is_available() -> bool:
    """Whether the decoder builds and loads here (built on first call)."""
    _load()
    return _lib is not None


def build_error() -> Optional[str]:
    """Why the decoder is unavailable, or None when it loaded."""
    _load()
    return _build_error


def _check_out(out, n, out_size):
    if out is None:
        return np.empty((n, out_size, out_size, 3), np.uint8)
    if (out.shape != (n, out_size, out_size, 3) or out.dtype != np.uint8
            or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be a C-contiguous uint8 "
                         f"[{n}, {out_size}, {out_size}, 3] array")
    return out


def decode_batch(paths: Sequence[str], out_size: int,
                 out: Optional[np.ndarray] = None,
                 n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEG files into a uint8 [N, S, S, 3] array.

    Returns (images, status) where status[i] != 0 marks a failed decode
    (the caller resamples those slots, as the PIL path does).
    """
    _load()
    if _lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    n = len(paths)
    out = _check_out(out, n, out_size)
    status = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode("utf-8") for p in paths])
    _lib.fd_decode_batch(
        c_paths, n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return out, status


def decode_batch_mem(blob: np.ndarray, offsets: np.ndarray,
                     lengths: np.ndarray, out_size: int,
                     out: Optional[np.ndarray] = None,
                     n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEG byte ranges of one in-memory blob (e.g. an mmap'd
    RecordIO .rec) into a uint8 [N, S, S, 3] array.

    `blob` is a 1-D uint8 array or memmap; `offsets[i]` / `lengths[i]`
    bound image i's encoded bytes. Returns (images, status) as
    decode_batch does.
    """
    _load()
    if _lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n = len(offsets)
    if len(lengths) != n:
        raise ValueError("offsets/lengths length mismatch")
    if blob.dtype != np.uint8 or blob.ndim != 1:
        raise ValueError("blob must be a 1-D uint8 array")
    if n and int((offsets + lengths).max()) > blob.size:
        raise ValueError("offset+length beyond blob end")
    if n and (int(offsets.min()) < 0 or int(lengths.min()) < 0):
        raise ValueError("negative offset/length")
    out = _check_out(out, n, out_size)
    status = np.zeros((n,), np.int32)
    _lib.fd_decode_batch_mem(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return out, status
