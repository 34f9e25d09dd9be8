"""On-device image preprocessing.

Port of `normalize_images` from face_recognition_models_tpu/ops/image_ops.py:
batches cross to the card as uint8 NHWC and are normalised there with one
multiply-add, x * scale + bias, whose constants the train and eval steps
make once (`normalization_constants`). And `degrade_images` of
face_recognition_models_tpu/train/loop.py, QAFace's degraded view of a
batch, made on its device.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


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


def degrade_images(images: torch.Tensor) -> torch.Tensor:
    """Quality-degraded view for QAFace's `minput`: a 2x down / up bilinear
    resample of NHWC images on their device, antialiased as
    jax.image.resize is.

    Keeps the input dtype: a uint8 batch comes back uint8 (rounded, in
    [0, 255]) so the step normalises both views alike; a float batch stays
    float.
    """
    _, h, w, _ = images.shape
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    small = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                          align_corners=False, antialias=True)
    out = F.interpolate(small, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1)
    if images.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return out
