"""Face detection (the MTCNN cascade) and landmark alignment of the port."""

from face_recognition_models_tpu_torch.detection.align import (
    ARCFACE_TEMPLATE_112,
    WarpAligner,
    extract_aligned,
    norm_crop,
    umeyama,
)
from face_recognition_models_tpu_torch.detection.mtcnn import (
    MTCNN,
    load_facenet_pytorch_weights,
)

__all__ = [
    "ARCFACE_TEMPLATE_112",
    "MTCNN",
    "WarpAligner",
    "extract_aligned",
    "load_facenet_pytorch_weights",
    "norm_crop",
    "umeyama",
]
