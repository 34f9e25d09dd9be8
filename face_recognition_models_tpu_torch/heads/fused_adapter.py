"""Adapter: margin heads -> the fused margin + CE kernels.

Port of face_recognition_models_tpu/heads/fused_adapter.py (ArcFace so far).
For each head it computes the per-row scalars (target value t, target cosine,
scale, mode parameters a / b) in O(N * D), then calls `fused_margin_ce`; the
[N, C] logits are never materialised.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from face_recognition_models_tpu_torch.ops.fused_head import (
    MODE_IDENTITY,
    fused_margin_ce,
)
from face_recognition_models_tpu_torch.ops.normalize import (
    feature_norms,
    l2_normalize,
)

FUSED_HEADS = ("arcface",)


def fused_supported(name: str) -> bool:
    return name in FUSED_HEADS


class FusedApplyOut(NamedTuple):
    loss_id: torch.Tensor   # scalar mean CE
    loss_g: torch.Tensor    # scalar auxiliary loss
    acc1: torch.Tensor      # percent
    acc5: torch.Tensor
    norms: torch.Tensor     # [N, 1]
    state: Any


class _RowParams(NamedTuple):
    t: torch.Tensor
    tcos: torch.Tensor
    scale: torch.Tensor
    ab: torch.Tensor
    mode: int
    clamp_eps: Optional[float]
    loss_g: torch.Tensor
    new_state: Any


def _row_params(cfg, tcos_raw, norms, state) -> _RowParams:
    """Per-head reduction to the kernel's row-scalar form. `tcos_raw` is the
    unclamped target cosine [N]."""
    n = tcos_raw.shape[0]
    dev = tcos_raw.device
    if cfg.name == "arcface":
        tcos = tcos_raw
        sine = torch.sqrt((1.0 - tcos ** 2).clamp(1e-9, 1.0))
        phi = tcos * math.cos(cfg.m) - sine * math.sin(cfg.m)
        if cfg.easy_margin:
            t = torch.where(tcos > 0, phi, tcos)
        else:
            th = math.cos(math.pi - cfg.m)
            mm = math.sin(math.pi - cfg.m) * cfg.m
            t = torch.where(tcos > th, phi, tcos - mm)
        return _RowParams(t, tcos, torch.full((n,), cfg.s, device=dev),
                          torch.zeros((n, 2), device=dev), MODE_IDENTITY,
                          None, torch.zeros((), device=dev), state)
    raise ValueError(f"head '{cfg.name}' is not fusable")


def fused_apply(cfg, kernel, feats, labels, state=None) -> FusedApplyOut:
    """Fused-path equivalent of head.apply + CE + top-k metrics.

    kernel [D, C]; feats [N, D]; labels [N], all in [0, C).
    """
    feats = feats.to(torch.float32)
    xn = l2_normalize(feats, dim=1)
    wn = l2_normalize(kernel, dim=0)
    norms = feature_norms(feats)
    # target cosine: a row gather of W columns, O(N * D)
    tcos_raw = (xn * wn.index_select(1, labels.long()).T).sum(1)
    rp = _row_params(cfg, tcos_raw, norms, state)
    out = fused_margin_ce(xn, wn, labels, rp.t, rp.tcos, rp.scale, rp.ab,
                          rp.mode, rp.clamp_eps)
    loss_id = (out.lse - out.target_logit).mean()
    acc1 = 100.0 * (out.higher < 1).to(torch.float32).mean()
    acc5 = 100.0 * (out.higher < 5).to(torch.float32).mean()
    return FusedApplyOut(loss_id, rp.loss_g, acc1, acc5, norms, rp.new_state)
