"""Adapter: margin heads -> the fused margin + CE kernels.

Port of face_recognition_models_tpu/heads/fused_adapter.py: the twelve
heads the JAX package fuses (FUSED_HEADS). For each head it computes the
per-row scalars (target value t, target cosine, scale, mode parameters a / b,
the clamp) and the head's state update in O(N * D), with the math of
heads/margins.py, then calls `fused_margin_ce`; the [N, C] logits are never
materialised. MV-Softmax runs the kernels' MV mode, CurricularFace their
curricular mode, every other head the identity mode; SphereFace's per-row
scale is the feature norm, whose gradient the kernels return as dscale. The
memory-blended heads (MEM_FUSED_HEADS) also update their memory and hand the
blend to `fused_margin_ce_mem` as (memn [D, C], lam [C]).

Under a mesh (`fused_apply(..., mesh=)`) the rows are the rank's and, with
a model axis, the kernel and the head memories are the rank's class shard:
the target columns are gathered from their owning shard, the batch
statistics of the row parameters are the global batch's (heads/margins.py)
and the kernels run per shard (parallel/sharded_fused.py).

subcenter_arcface and adacos have no fused path, in the JAX package either.
`use_fused(name, head_path)` is the port's rule for `train --head-path`:
'auto' takes the kernels for every head in FUSED_HEADS.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from face_recognition_models_tpu_torch.heads import margins as m
from face_recognition_models_tpu_torch.ops.fused_head import (
    MODE_CURRICULAR,
    MODE_IDENTITY,
    MODE_MV,
    fused_margin_ce,
    fused_margin_ce_mem,
)
from face_recognition_models_tpu_torch.ops.normalize import (
    feature_norms,
    l2_normalize,
)
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.parallel.sharded_fused import (
    sharded_fused_margin_ce,
    take_class_values,
    take_target_columns,
)

# Heads whose non-target cosine blends a per-class memory product; they use
# fused_margin_ce_mem.
MEM_FUSED_HEADS = ("vpl_arcface", "qaface")
FUSED_HEADS = ("cosface", "arcface", "sphereface", "mv_softmax",
               "curricularface", "adaface", "elastic_cosface",
               "elastic_arcface", "magface",
               "combined_margin") + MEM_FUSED_HEADS
HEAD_PATHS = ("auto", "fused", "eager")


def fused_supported(name: str) -> bool:
    return name in FUSED_HEADS


def use_fused(name: str, head_path: str = "auto") -> bool:
    """Whether a run of head `name` takes the kernels: 'fused' always (a
    head with no fused path raises ValueError), 'eager' never, 'auto' for
    every head in FUSED_HEADS. 'auto' keeps the fused head wherever there is
    one, whatever the time: its purpose is O(N) head memory where the eager
    head holds several [N, C] tensors."""
    if head_path not in HEAD_PATHS:
        raise ValueError(f"head_path must be one of {HEAD_PATHS}, "
                         f"got {head_path!r}")
    if head_path == "fused" and not fused_supported(name):
        raise ValueError(f"head '{name}' has no fused-kernel path; use "
                         f"--head-path auto or eager")
    return head_path == "fused" or (head_path == "auto"
                                    and fused_supported(name))


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


def _rows(t, tcos, scale, clamp_eps, state, ab=None, mode=MODE_IDENTITY,
          loss_g=None) -> _RowParams:
    """Row parameters with a scalar or per-row `scale`; ab of zeros and
    loss_g of 0 unless given."""
    n, dev = t.shape[0], t.device
    if not isinstance(scale, torch.Tensor):
        scale = torch.full((n,), scale, device=dev)
    return _RowParams(t, tcos, scale,
                      torch.zeros((n, 2), device=dev) if ab is None else ab,
                      mode, clamp_eps,
                      torch.zeros((), device=dev) if loss_g is None
                      else loss_g, state)


def _row_params(cfg, tcos_raw, norms, state, rng=None) -> _RowParams:
    """Per-head reduction to the kernel's row-scalar form, as the JAX
    package builds it. `tcos_raw` is the unclamped target cosine [N]; the
    clamp is None for arcface and combined_margin, 0 for sphereface and
    curricularface, the head's eps otherwise."""
    name, n = cfg.name, tcos_raw.shape[0]
    if name == "arcface":
        return _rows(_arc_t(tcos_raw, cfg.m, cfg.easy_margin), tcos_raw,
                     cfg.s, None, state)
    if name == "cosface":
        tcos = tcos_raw.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
        return _rows(tcos - cfg.m, tcos, cfg.s, cfg.eps, state)
    if name == "sphereface":
        tcos = tcos_raw.clamp(-1.0, 1.0)
        new_iter = state.iter + 1
        lamb = m._sphere_lambda(cfg, new_iter)
        t = (m._sphere_phi(tcos, cfg.m) - tcos) / (1.0 + lamb) + tcos
        # the scale is the feature norm, with its gradient
        return _rows(t, tcos, norms[:, 0], 0.0,
                     m.SphereFaceState(new_iter))
    if name == "mv_softmax":
        tcos = tcos_raw.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
        if cfg.margin_type == "am":
            t = torch.where(tcos > cfg.m, tcos - cfg.m, tcos)
            a = tcos - cfg.m
        elif cfg.margin_type == "arc":
            sin_t = torch.sqrt(1.0 - tcos ** 2 + 1e-9)
            a = tcos * math.cos(cfg.m) - sin_t * math.sin(cfg.m)
            t = torch.where(tcos > 0.0, a, tcos)
        else:
            raise ValueError("margin_type must be 'am' or 'arc'")
        ab = torch.stack([a, torch.full_like(a, cfg.mv_weight)], 1)
        return _rows(t, tcos, cfg.s, cfg.eps, state, ab, MODE_MV)
    if name == "curricularface":
        tcos = tcos_raw.clamp(-1.0, 1.0)
        ctm = m._curricular_ctm(tcos, cfg.m)
        threshold = math.cos(math.pi - cfg.m)
        mm = math.sin(math.pi - cfg.m) * cfg.m
        t = torch.where(tcos > threshold, ctm, tcos - mm)
        new_t = (coll.batch_mean(tcos) * cfg.momentum
                 + (1.0 - cfg.momentum) * state.t).detach()
        # b is the new t, the same for every row
        ab = torch.stack([ctm, new_t.expand(n)], 1)
        return _rows(t, tcos, cfg.s, 0.0, m.CurricularFaceState(new_t), ab,
                     MODE_CURRICULAR)
    if name == "adaface":
        tcos = tcos_raw.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
        scaler, new_state = m._adaface_scaler(cfg, norms, state)
        scaler = scaler[:, 0]
        theta_m = (torch.acos(tcos) - cfg.m * scaler).clamp(
            cfg.eps, math.pi - cfg.eps)
        t = torch.cos(theta_m) - (cfg.m + cfg.m * scaler)
        return _rows(t, tcos, cfg.s, cfg.eps, new_state)
    if name in ("elastic_cosface", "elastic_arcface"):
        tcos = tcos_raw.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
        valid = torch.ones((n,), dtype=torch.bool, device=tcos.device)
        margin = m._elastic_margin(rng, tcos, valid, cfg.m, cfg.std,
                                   cfg.plus)
        if name == "elastic_cosface":
            t = tcos - margin
        else:
            t = torch.cos((torch.acos(tcos) + margin).clamp(0.0, math.pi))
        return _rows(t, tcos, cfg.s, cfg.eps, state)
    if name == "combined_margin":
        t = m._combined_t(cfg, tcos_raw.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps))
        # the pre-margin cosines stay unclamped (margins.py)
        return _rows(t, tcos_raw, cfg.s, None, state)
    if name == "magface":
        tcos = tcos_raw.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
        _, loss_g, ada_m = m._magface_margin(cfg, norms)
        t = m._magface_ctm(cfg, tcos, ada_m[:, 0])
        return _rows(t, tcos, cfg.s, cfg.eps, state, loss_g=loss_g)
    raise ValueError(f"head '{name}' is not fusable")


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
        lam_t = take_class_values(lam, target, coll.active())
        cosine2 = (1.0 - lam_t) * tcos_raw + lam_t * 1.0
    elif cfg.name == "qaface":
        minput = feats if minput is None else minput.to(torch.float32)
        injection, use_mem, new_state = m._qaface_step(cfg, minput, labels,
                                                       state)
        # full replacement where active (:1476)
        lam = torch.where(use_mem, (new_state.life > 0).float(), 0.0)
        # target: cosine against the RAW weight column + the injection
        # (:1479-1482); the gradient reaches `kernel` through this gather
        target_w = take_target_columns(kernel.to(torch.float32), target,
                                       coll.active())
        cosine2 = torch.where(
            use_mem,
            (xn * l2_normalize(target_w + injection, dim=1)).sum(1),
            tcos_raw)
    else:
        raise ValueError(f"head '{cfg.name}' is not a memory-blended head")
    tcos = cosine2.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
    rp = _rows(_arc_t(tcos, cfg.m, cfg.easy_margin), tcos, cfg.s, cfg.eps,
               new_state)
    return _MemRowParams(rp, l2_normalize(new_state.mem, dim=1).T, lam)


def fused_apply(cfg, kernel, feats, labels, state=None, rng=None,
                minput=None, mesh=None) -> FusedApplyOut:
    """Fused-path equivalent of head.apply + CE + top-k metrics.

    kernel [D, C]; feats [N, D]; labels [N], all in [0, C). The elastic
    heads draw their margins from the generator `rng`; QAFace takes the
    degraded view's features through `minput`. With `mesh`, feats and
    labels are the rank's rows, kernel [D, C/mp] and the memories the
    rank's class shard; the loss and metrics are the means over the rank's
    rows of the global statistics.
    """
    with coll.using(coll.active() if mesh is None else mesh):
        return _fused_apply(cfg, kernel, feats, labels, state, rng, minput,
                            mesh)


def _fused_apply(cfg, kernel, feats, labels, state, rng, minput, mesh):
    feats = feats.to(torch.float32)
    xn = l2_normalize(feats, dim=1)
    wn = l2_normalize(kernel, dim=0)
    norms = feature_norms(feats)
    # target cosine: a row gather of W columns, O(N * D), whose gradient
    # adds repeated labels in a fixed order
    tcos_raw = (xn * take_target_columns(wn, labels, mesh)).sum(1)
    memn = lam = None
    if cfg.name in MEM_FUSED_HEADS:
        rp, memn, lam = _mem_row_params(cfg, kernel, xn, feats, labels,
                                        tcos_raw, state, minput)
    else:
        rp = _row_params(cfg, tcos_raw, norms, state, rng)
    if coll.model_size(mesh) > 1:
        out = sharded_fused_margin_ce(mesh, xn, wn, labels, rp.t, rp.tcos,
                                      rp.scale, rp.ab, rp.mode, rp.clamp_eps,
                                      memn=memn, lam=lam)
    elif memn is not None:
        out = fused_margin_ce_mem(xn, wn, memn, lam, labels, rp.t, rp.tcos,
                                  rp.scale, rp.ab, rp.mode, rp.clamp_eps)
    else:
        out = fused_margin_ce(xn, wn, labels, rp.t, rp.tcos, rp.scale, rp.ab,
                              rp.mode, rp.clamp_eps)
    loss_id = (out.lse - out.target_logit).mean()
    acc1 = 100.0 * (out.higher < 1).to(torch.float32).mean()
    acc5 = 100.0 * (out.higher < 5).to(torch.float32).mean()
    if cfg.name == "magface":
        # the eager head returns the clamped norm (criterion.py:1290), the
        # feat_norm metric
        norms = norms.clamp(cfg.l_a, cfg.u_a)
    return FusedApplyOut(loss_id, rp.loss_g, acc1, acc5, norms, rp.new_state)
