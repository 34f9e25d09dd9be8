"""On-device image preprocessing.

Port of `normalize_images` from face_recognition_models_tpu/ops/image_ops.py:
batches cross to the card as uint8 NHWC and are normalised there with one
multiply-add.
"""

from __future__ import annotations

from typing import Sequence

import torch


def normalization_constants(mean: Sequence[float] = (0.5, 0.5, 0.5),
                            std: Sequence[float] = (0.5, 0.5, 0.5),
                            dtype: torch.dtype = torch.float32,
                            device=None):
    """(scale, bias) [3] on `device` with ((x / 255) - mean) / std =
    x * scale + bias. A caller that makes them once copies nothing from
    the host per batch (a CUDA graph can hold the normalisation)."""
    mean = torch.tensor(mean, dtype=torch.float32)
    std = torch.tensor(std, dtype=torch.float32)
    scale = (1.0 / (255.0 * std)).to(dtype=dtype, device=device)
    bias = (-mean / std).to(dtype=dtype, device=device)
    return scale, bias


def normalize_images(images: torch.Tensor,
                     mean: Sequence[float] = (0.5, 0.5, 0.5),
                     std: Sequence[float] = (0.5, 0.5, 0.5),
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> ((x / 255) - mean) / std as x * scale + bias."""
    scale, bias = normalization_constants(mean, std, dtype, images.device)
    return images.to(dtype) * scale + bias
