"""Margin heads of the port (ArcFace, VPL-ArcFace, QAFace) and their
fused-kernel path."""

from face_recognition_models_tpu_torch.heads import margins  # noqa: F401  (registers)
from face_recognition_models_tpu_torch.heads.base import (  # noqa: F401
    Head,
    HeadOutput,
    available_heads,
    get_head,
    register_head,
)
