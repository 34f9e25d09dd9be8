"""Eager margin heads: the [N, C] path (`use_fused_head=False`).

Port of face_recognition_models_tpu/heads/margins.py, ArcFace only so far.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from face_recognition_models_tpu_torch.heads.base import (
    Head,
    HeadOutput,
    register_head,
)
from face_recognition_models_tpu_torch.ops.normalize import cosine_logits


def _xavier_uniform_kernel(cfg, generator: torch.Generator,
                           device="cpu") -> torch.Tensor:
    """Xavier-uniform [D, C] (reference ArcFace init, criterion.py:243-244;
    the bound is symmetric in (D, C))."""
    d, c = cfg.feature_dim, cfg.num_classes
    bound = math.sqrt(6.0 / (d + c))
    w = torch.empty((d, c), dtype=torch.float32)
    w.uniform_(-bound, bound, generator=generator)
    return w.to(device)


def _arc_margin(cos, one_hot, m: float, easy_margin: bool, s: float):
    """ArcFace additive-angular-margin combine (criterion.py:281-295)."""
    th, mm = math.cos(math.pi - m), math.sin(math.pi - m) * m
    sine = torch.sqrt((1.0 - cos ** 2).clamp(1e-9, 1.0))
    phi = cos * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cos > 0, phi, cos)
    else:
        phi = torch.where(cos > th, phi, cos - mm)
    return (one_hot * phi + (1.0 - one_hot) * cos) * s


def _arcface_apply(cfg, kernel, feats, labels, state=None, rng=None,
                   minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)  # no clamp (criterion.py:267)
    one_hot = F.one_hot(labels.long(), cfg.num_classes).to(torch.float32)
    logits = _arc_margin(cos, one_hot, cfg.m, cfg.easy_margin, cfg.s)
    return HeadOutput(cos * cfg.s, logits, norms,
                      torch.zeros((), device=feats.device), one_hot, state)


register_head(Head(
    name="arcface",
    init_kernel=_xavier_uniform_kernel,
    init_state=lambda cfg: None,
    apply=_arcface_apply,
))
