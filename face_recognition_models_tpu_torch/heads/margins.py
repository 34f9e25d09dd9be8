"""Eager margin heads: the [N, C] path (`use_fused_head=False`).

Port of face_recognition_models_tpu/heads/margins.py: ArcFace and the two
memory-blended heads, VPL-ArcFace and QAFace. Head state is a NamedTuple of
tensors on the step's device, returned anew by every apply (the JAX package's
state pytrees); the train step detaches it before keeping it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from face_recognition_models_tpu_torch.heads.base import (
    Head,
    HeadOutput,
    register_head,
    take_columns,
)
from face_recognition_models_tpu_torch.heads.base import one_hot as _one_hot
from face_recognition_models_tpu_torch.ops.normalize import (
    cosine_logits,
    feature_norms,
    l2_normalize,
)


def _xavier_uniform_kernel(cfg, generator: torch.Generator,
                           device="cpu") -> torch.Tensor:
    """Xavier-uniform [D, C] (reference ArcFace init, criterion.py:243-244;
    the bound is symmetric in (D, C))."""
    d, c = cfg.feature_dim, cfg.num_classes
    bound = math.sqrt(6.0 / (d + c))
    w = torch.empty((d, c), dtype=torch.float32)
    w.uniform_(-bound, bound, generator=generator)
    return w.to(device)


def _class_mean_update(values, labels, valid, mem, life, delta: float):
    """Set mem[c] to the batch mean of the `values` rows labelled c (only for
    classes present in the batch), set their life to `delta`, then decay all
    lifetimes by 1 (reference VPL criterion.py:702-717 / QAFace :1455-1469).

    The per-class sums are a one-hot fp32 matmul, as in the JAX package: its
    summation order is fixed, where index_add_'s float atomics are not.
    Returns (new_mem [C, D], new_life [C], any_valid 0-d bool tensor).
    """
    oh = _one_hot(labels, mem.shape[0])                   # [N, C]
    counts = oh.sum(0)                                    # [C]
    sums = oh.T @ values.to(torch.float32)                # [C, D]
    seen = counts > 0
    new_mem = torch.where(seen[:, None], sums / counts.clamp_min(1.0)[:, None],
                          mem)
    new_life = torch.where(seen, float(delta), life) - 1.0
    return new_mem, new_life, valid.any()


def _memory_step(cfg, values, labels, state):
    """The memory update both heads share: class means of `values` (without
    gradient), kept only while the state trains and the batch has a valid
    label. Returns (new_mem, new_life, use_mem); use_mem is a 0-d device
    tensor, so the step needs no host sync."""
    new_mem, new_life, any_valid = _class_mean_update(
        values.detach(), labels, labels >= 0, state.mem, state.life,
        cfg.delta)
    use_mem = state.training_flag & any_valid
    return (torch.where(use_mem, new_mem, state.mem),
            torch.where(use_mem, new_life, state.life), use_mem)


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
    one_hot = _one_hot(labels, cfg.num_classes)  # -1: an all-zero row
    logits = _arc_margin(cos, one_hot, cfg.m, cfg.easy_margin, cfg.s)
    return HeadOutput(cos * cfg.s, logits, norms,
                      torch.zeros((), device=feats.device), one_hot, state)


register_head(Head(
    name="arcface",
    init_kernel=_xavier_uniform_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_arcface_apply,
))


# ---------------------------------------------------------------------------
# VPL-ArcFace (criterion.py:619-762)
# ---------------------------------------------------------------------------


class VPLArcFaceState(NamedTuple):
    mem: torch.Tensor            # [C, D] per-class feature-mean memory
    life: torch.Tensor           # [C] memory lifetimes
    training_flag: torch.Tensor  # 0-d bool


def _vpl_arcface_apply(cfg, kernel, feats, labels, state: VPLArcFaceState,
                       rng=None, minput=None) -> HeadOutput:
    feats = feats.to(torch.float32)
    cos_w, xn, norms = cosine_logits(feats, kernel)
    one_hot = _one_hot(labels, cfg.num_classes)

    new_mem, new_life, use_mem = _memory_step(cfg, feats, labels, state)
    active = (new_life > 0).to(torch.float32)[None, :]    # [1, C]
    cos_mem = xn @ l2_normalize(new_mem, dim=1).T
    lam = cfg.lamda
    # non-target: blend toward the memory cosine; target: toward 1.0
    # (criterion.py:724-726)
    cosine1 = (1.0 - active * lam) * cos_w + active * lam * cos_mem
    cosine2 = (1.0 - active * lam) * cos_w + active * lam * 1.0
    blended = one_hot * cosine2 + (1.0 - one_hot) * cosine1
    cosine = torch.where(use_mem, blended, cos_w)

    cosine = cosine.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)  # :733
    logits = _arc_margin(cosine, one_hot, cfg.m, cfg.easy_margin, cfg.s)
    return HeadOutput(cosine * cfg.s, logits, norms,
                      torch.zeros((), device=feats.device), one_hot,
                      VPLArcFaceState(new_mem, new_life, state.training_flag))


def _vpl_init_state(cfg, device="cpu") -> VPLArcFaceState:
    return VPLArcFaceState(
        mem=torch.zeros((cfg.num_classes, cfg.feature_dim), device=device),
        life=torch.zeros((cfg.num_classes,), device=device),
        training_flag=torch.tensor(True, device=device))


register_head(Head(
    name="vpl_arcface",
    init_kernel=_xavier_uniform_kernel,
    init_state=_vpl_init_state,
    apply=_vpl_arcface_apply,
))


# ---------------------------------------------------------------------------
# QAFace (criterion.py:1331-1520)
# ---------------------------------------------------------------------------


class QAFaceState(NamedTuple):
    mem: torch.Tensor            # [C, D] injection memory
    life: torch.Tensor           # [C]
    muy: torch.Tensor            # 0-d EMA of the minput magnitude mean
    std: torch.Tensor            # 0-d EMA of the minput magnitude std
    training_flag: torch.Tensor  # 0-d bool


def _qaface_step(cfg, minput, labels, state: QAFaceState):
    """(injection [N, D], use_mem, new state) from the degraded view's
    magnitudes (criterion.py:1438-1469). Gradients flow through the
    injection and the magnitude statistics, as in the JAX package."""
    mag = feature_norms(minput)                           # [N, 1]
    mag_mean = mag.mean()
    # torch .std() semantics (ddof=1) with a finite gradient at zero
    # variance: sqrt'(0) = inf would NaN the backward when every magnitude
    # in the batch is equal. The inner where keeps sqrt away from 0.
    var = mag.var(correction=1)
    mag_std = torch.where(var > 0, torch.sqrt(torch.where(var > 0, var, 1.0)),
                          0.0)
    first = state.muy == 0.0
    new_muy = torch.where(first, mag_mean,
                          cfg.alpha * state.muy + (1 - cfg.alpha) * mag_mean)
    new_std = torch.where(first, mag_std,
                          cfg.alpha * state.std + (1 - cfg.alpha) * mag_std)
    z = (mag - new_muy) / (new_std + 1e-6)                # :1451
    f = torch.where(z.abs() < cfg.tto, torch.exp(-z), 0.0)  # :1405-1409
    injection = f * minput / (mag + 1e-6)                 # :1453
    new_mem, new_life, use_mem = _memory_step(cfg, injection, labels, state)
    flag = state.training_flag
    return injection, use_mem, QAFaceState(
        new_mem, new_life, torch.where(flag, new_muy, state.muy),
        torch.where(flag, new_std, state.std), flag)


def _qaface_apply(cfg, kernel, feats, labels, state: QAFaceState, rng=None,
                  minput=None) -> HeadOutput:
    """`minput` is the feature of a degraded view of the batch; without one
    the head uses `feats`."""
    feats = feats.to(torch.float32)
    minput = feats if minput is None else minput.to(torch.float32)
    cos_w, xn, norms = cosine_logits(feats, kernel)
    one_hot = _one_hot(labels, cfg.num_classes)
    injection, use_mem, new_state = _qaface_step(cfg, minput, labels, state)

    active = (new_state.life > 0).to(torch.float32)[None, :]
    cos_mem = xn @ l2_normalize(new_state.mem, dim=1).T
    # non-target: full memory replacement where active (:1476)
    cosine1 = (1.0 - active) * cos_w + active * cos_mem
    # target: cosine against (raw class weight + injection) (:1479-1482)
    target_w = take_columns(kernel.to(torch.float32),
                            torch.where(labels >= 0, labels, 0)).T + injection
    cosine2 = (xn * l2_normalize(target_w, dim=1)).sum(1, keepdim=True)
    blended = one_hot * cosine2 + (1.0 - one_hot) * cosine1
    cosine = torch.where(use_mem, blended, cos_w)

    cosine = cosine.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
    logits = _arc_margin(cosine, one_hot, cfg.m, cfg.easy_margin, cfg.s)
    return HeadOutput(cosine * cfg.s, logits, norms,
                      torch.zeros((), device=feats.device), one_hot,
                      new_state)


def _qaface_init_state(cfg, device="cpu") -> QAFaceState:
    return QAFaceState(
        mem=torch.zeros((cfg.num_classes, cfg.feature_dim), device=device),
        life=torch.zeros((cfg.num_classes,), device=device),
        muy=torch.tensor(0.0, device=device),
        std=torch.tensor(1.0, device=device),
        training_flag=torch.tensor(True, device=device))


register_head(Head(
    name="qaface",
    init_kernel=_xavier_uniform_kernel,
    init_state=_qaface_init_state,
    apply=_qaface_apply,
    requires_minput=True,
))
