"""Adapter: margin heads -> the fused margin + CE kernels.

Port of face_recognition_models_tpu/heads/fused_adapter.py (ArcFace,
VPL-ArcFace, QAFace). For each head it computes the per-row scalars (target
value t, target cosine, scale, mode parameters a / b) in O(N * D), then calls
`fused_margin_ce`; the [N, C] logits are never materialised. The
memory-blended heads (MEM_FUSED_HEADS) also update their memory and hand the
blend to `fused_margin_ce_mem` as (memn [D, C], lam [C]).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from face_recognition_models_tpu_torch.heads import margins as m
from face_recognition_models_tpu_torch.heads.base import take_columns
from face_recognition_models_tpu_torch.ops.fused_head import (
    MODE_IDENTITY,
    fused_margin_ce,
    fused_margin_ce_mem,
)
from face_recognition_models_tpu_torch.ops.normalize import (
    feature_norms,
    l2_normalize,
)

# Heads whose non-target cosine blends a per-class memory product; they use
# fused_margin_ce_mem.
MEM_FUSED_HEADS = ("vpl_arcface", "qaface")
FUSED_HEADS = ("arcface",) + MEM_FUSED_HEADS


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


def _arc_t(tcos, m_val: float, easy_margin: bool):
    """ArcFace target-logit scalar (criterion.py:281-295) on a target
    cosine [N]."""
    sine = torch.sqrt((1.0 - tcos ** 2).clamp(1e-9, 1.0))
    phi = tcos * math.cos(m_val) - sine * math.sin(m_val)
    if easy_margin:
        return torch.where(tcos > 0, phi, tcos)
    th = math.cos(math.pi - m_val)
    mm = math.sin(math.pi - m_val) * m_val
    return torch.where(tcos > th, phi, tcos - mm)


def _arc_rows(cfg, t, tcos, clamp_eps, state) -> _RowParams:
    n, dev = t.shape[0], t.device
    return _RowParams(t, tcos, torch.full((n,), cfg.s, device=dev),
                      torch.zeros((n, 2), device=dev), MODE_IDENTITY,
                      clamp_eps, torch.zeros((), device=dev), state)


def _row_params(cfg, tcos_raw, norms, state) -> _RowParams:
    """Per-head reduction to the kernel's row-scalar form. `tcos_raw` is the
    unclamped target cosine [N]."""
    if cfg.name == "arcface":
        return _arc_rows(cfg, _arc_t(tcos_raw, cfg.m, cfg.easy_margin),
                         tcos_raw, None, state)
    raise ValueError(f"head '{cfg.name}' is not fusable")


class _MemRowParams(NamedTuple):
    rp: _RowParams
    memn: torch.Tensor  # [D, C] column-normalised memory prototypes
    lam: torch.Tensor   # [C] per-class blend weight (0: no blend)


def _mem_row_params(cfg, kernel, xn, feats, labels, tcos_raw, state,
                    minput) -> _MemRowParams:
    """VPL-ArcFace / QAFace reduction: the math of margins.py
    (_vpl_arcface_apply / _qaface_apply) with the [N, C] blend left to the
    kernel as (memn, lam)."""
    target = torch.where(labels >= 0, labels, 0).long()
    if cfg.name == "vpl_arcface":
        new_mem, new_life, use_mem = m._memory_step(cfg, feats, labels, state)
        new_state = m.VPLArcFaceState(new_mem, new_life, state.training_flag)
        # lam = 0 reproduces the `where(use_mem, blended, cos_w)` select
        lam = torch.where(use_mem, cfg.lamda * (new_life > 0).float(), 0.0)
        # target column: blend toward 1.0 (criterion.py:724-726)
        lam_t = lam.index_select(0, target)
        cosine2 = (1.0 - lam_t) * tcos_raw + lam_t * 1.0
    elif cfg.name == "qaface":
        minput = feats if minput is None else minput.to(torch.float32)
        injection, use_mem, new_state = m._qaface_step(cfg, minput, labels,
                                                       state)
        # full replacement where active (:1476)
        lam = torch.where(use_mem, (new_state.life > 0).float(), 0.0)
        # target: cosine against the RAW weight column + the injection
        # (:1479-1482); the gradient reaches `kernel` through this gather
        target_w = take_columns(kernel.to(torch.float32), target).T
        cosine2 = torch.where(
            use_mem,
            (xn * l2_normalize(target_w + injection, dim=1)).sum(1),
            tcos_raw)
    else:
        raise ValueError(f"head '{cfg.name}' is not a memory-blended head")
    tcos = cosine2.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
    rp = _arc_rows(cfg, _arc_t(tcos, cfg.m, cfg.easy_margin), tcos, cfg.eps,
                   new_state)
    return _MemRowParams(rp, l2_normalize(new_state.mem, dim=1).T, lam)


def fused_apply(cfg, kernel, feats, labels, state=None,
                minput=None) -> FusedApplyOut:
    """Fused-path equivalent of head.apply + CE + top-k metrics.

    kernel [D, C]; feats [N, D]; labels [N], all in [0, C). QAFace takes the
    degraded view's features through `minput`.
    """
    feats = feats.to(torch.float32)
    xn = l2_normalize(feats, dim=1)
    wn = l2_normalize(kernel, dim=0)
    norms = feature_norms(feats)
    # target cosine: a row gather of W columns, O(N * D), whose gradient
    # adds repeated labels in a fixed order
    tcos_raw = (xn * take_columns(wn, labels).T).sum(1)
    if cfg.name in MEM_FUSED_HEADS:
        rp, memn, lam = _mem_row_params(cfg, kernel, xn, feats, labels,
                                        tcos_raw, state, minput)
        out = fused_margin_ce_mem(xn, wn, memn, lam, labels, rp.t, rp.tcos,
                                  rp.scale, rp.ab, rp.mode, rp.clamp_eps)
    else:
        rp = _row_params(cfg, tcos_raw, norms, state)
        out = fused_margin_ce(xn, wn, labels, rp.t, rp.tcos, rp.scale, rp.ab,
                              rp.mode, rp.clamp_eps)
    loss_id = (out.lse - out.target_logit).mean()
    acc1 = 100.0 * (out.higher < 1).to(torch.float32).mean()
    acc5 = 100.0 * (out.higher < 5).to(torch.float32).mean()
    return FusedApplyOut(loss_id, rp.loss_g, acc1, acc5, norms, rp.new_state)
