"""Where the port's compiled programs live: `--compile-cache DIR`. Port of
face_recognition_models_tpu/utils/compile_cache.py.

Under XLA every program compiles on first use, and the JAX package keeps
the compiled executables in a persistent cache. The port compiles no
program at run time but its own native code: the CUDA kernels
(ops/_build.py, one nvcc per source) and the native JPEG decoder
(native/fastdecode.py, g++). Both are content-addressed shared libraries
(`lib<name>-<hash>.so`, the hash over the source, its headers and the
flags), built on first use and reused while they exist. By default they go
to `build/kernels/` and `build/native/` at the repository root;
`enable_compilation_cache(DIR)` roots them at `DIR/kernels/` and
`DIR/native/` instead, so a second process given the same DIR (a server's
restart, an evaluation sweep, a resumed run, another checkout) loads them
without running nvcc or g++.
"""

from __future__ import annotations

import os
from pathlib import Path


def enable_compilation_cache(directory: str) -> Path:
    """Build and load the kernels and the native decoder under
    `directory` (made if missing); returns its absolute path. Call before
    the first launch; a library already loaded stays in use."""
    from face_recognition_models_tpu_torch.native import fastdecode
    from face_recognition_models_tpu_torch.ops import _build

    root = Path(os.path.abspath(os.path.expanduser(directory)))
    root.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = root / "kernels"
    fastdecode.BUILD_DIR = root / "native"
    return root
