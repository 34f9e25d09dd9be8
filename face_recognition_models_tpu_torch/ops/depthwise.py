"""Depthwise convolutions. Port of face_recognition_models_tpu/ops/
depthwise.py.

The JAX functions are plain jnp (no Pallas kernel): a 3x3 depthwise conv as
nine shifted multiply-adds, and GDConv, a depthwise conv whose kernel spans
the whole map. Both round the taps to the input's dtype and accumulate the
products in fp32, which is what a grouped convolution with fp32
accumulation computes, so the port runs them as `F.conv2d(groups=C)` (cuDNN
on the card). Tensors are NCHW (channels-last in memory on the card) and
the weights torch's depthwise layout, [C, 1, kh, kw]; the JAX layout
[kh, kw, 1, C] crosses through utils/weights.from_jax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """Depthwise 3x3, padding 1, stride 1 or 2. x: [N, C, H, W]; weight:
    [C, 1, 3, 3]. Returns [N, C, H / stride, W / stride] in x's dtype."""
    c = x.shape[1]
    if tuple(weight.shape) != (c, 1, 3, 3):
        raise ValueError(f"weight must be [{c}, 1, 3, 3], got "
                         f"{tuple(weight.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=1,
                    groups=c)


def global_depthwise(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """GDConv: a depthwise conv whose kernel is the whole map (VALID), a
    learned per-channel spatial weighting. x: [N, C, H, W]; weight:
    [C, 1, H, W]. Returns [N, C, 1, 1] in x's dtype."""
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    if tuple(weight.shape) != (c, 1, h, w):
        raise ValueError(f"weight {tuple(weight.shape)} must be [{c}, 1, "
                         f"{h}, {w}] for input {tuple(x.shape)}")
    return F.conv2d(x, weight.to(x.dtype), groups=c)
