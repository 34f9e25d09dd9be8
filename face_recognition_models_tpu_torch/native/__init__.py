"""Native (C++) host components of the port, bound with ctypes.

`fastdecode`: threaded batch JPEG decode + resize straight into a
preallocated uint8 batch (libjpeg), built on first use into the git-ignored
`build/native/`; where it does not build, the loaders decode with PIL.
"""

from face_recognition_models_tpu_torch.native.fastdecode import (
    build_error,
    decode_batch,
    decode_batch_mem,
    is_available,
)

__all__ = ["build_error", "decode_batch", "decode_batch_mem", "is_available"]
