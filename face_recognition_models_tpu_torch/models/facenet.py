"""FaceNet-style embedding network. Port of face_recognition_models_tpu/
models/facenet.py: a trunk of the registry (its embedding layer sized
`embed_dim`) then fp32 L2 normalisation onto the unit sphere, the
reference's EmbeddingNet (FaceNet/main.py:15-42)."""

from __future__ import annotations

import torch
from torch import nn

from face_recognition_models_tpu_torch.models.backbones import get_backbone
from face_recognition_models_tpu_torch.ops.normalize import l2_normalize


class FaceNetEmbedding(nn.Module):
    """trunk -> L2 normalize. forward takes NHWC images and returns fp32
    [N, embed_dim] of unit norm; `rng` goes to a trunk that takes one."""

    def __init__(self, trunk_name: str = "resnet50", embed_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 112):
        super().__init__()
        self.embed_dim = embed_dim
        self.trunk = get_backbone(trunk_name, embed_dim=embed_dim,
                                  dtype=dtype, image_size=image_size)
        self.takes_rng = getattr(self.trunk, "takes_rng", False)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        feats = (self.trunk(x, rng=rng) if self.takes_rng
                 else self.trunk(x))
        return l2_normalize(feats.to(torch.float32), dim=1)


def facenet_embedding(trunk: str = "resnet50", embed_dim: int = 128,
                      dtype: torch.dtype = torch.bfloat16,
                      image_size: int = 112) -> FaceNetEmbedding:
    return FaceNetEmbedding(trunk_name=trunk, embed_dim=embed_dim,
                            dtype=dtype, image_size=image_size)
