"""L2 normalisation and feature norms, in true fp32.

Port of face_recognition_models_tpu/ops/normalize.py; the heads' cosine
product of normalised features and columns is heads/margins._cosine (on
the rank's class shard under a model axis). It runs in IEEE fp32: the
acos-based margins downstream need full-precision cosines, so callers on
the card keep TF32 off for float32 products
(`torch.backends.cuda.matmul.allow_tf32 = False`).
"""

from __future__ import annotations

import torch

# torch.nn.functional.normalize default eps
_NORM_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = _NORM_EPS) -> torch.Tensor:
    """x / max(||x||_2, eps) along `dim`, in fp32."""
    x = x.to(torch.float32)
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def feature_norms(feats: torch.Tensor) -> torch.Tensor:
    """Per-row L2 norms, shape [N, 1], in fp32."""
    return torch.linalg.vector_norm(feats.to(torch.float32), dim=1,
                                    keepdim=True)
