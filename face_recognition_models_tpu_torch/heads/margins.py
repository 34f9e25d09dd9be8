"""Eager margin heads: the [N, C] path (`use_fused_head=False`).

Port of face_recognition_models_tpu/heads/margins.py: the fourteen heads
(SphereFace, CosFace, ArcFace, MV-Softmax, CurricularFace, VPL-ArcFace,
AdaFace, the two elastic heads, MagFace, QAFace, the combined margin,
sub-center ArcFace and AdaCos) with the same fp32 math and clamps. Head
state is a NamedTuple of tensors on the step's device, returned anew by every
apply (the JAX package's state pytrees); the train step detaches it before
keeping it. A label of -1 (ignore) takes no margin: its one-hot row is zero.
The elastic heads draw their per-sample margins from the `rng` generator
the step passes (`_normal_noise`, one draw a step).
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


def _unit_column_kernel(cfg, generator: torch.Generator,
                        device="cpu") -> torch.Tensor:
    """InsightFace-style init (criterion.py:150-152): uniform(-1, 1), then
    every class column scaled to unit norm."""
    w = torch.empty((cfg.feature_dim, cfg.num_classes), dtype=torch.float32)
    w.uniform_(-1.0, 1.0, generator=generator)
    return l2_normalize(w, dim=0).to(device)


def _normal_kernel(cfg, generator: torch.Generator,
                   device="cpu") -> torch.Tensor:
    """normal(std=0.01) (reference CurricularFace / Elastic*,
    criterion.py:514)."""
    w = torch.empty((cfg.feature_dim, cfg.num_classes), dtype=torch.float32)
    w.normal_(0.0, 1.0, generator=generator)
    return (0.01 * w).to(device)


def _subcenter_kernel(cfg, generator: torch.Generator,
                      device="cpu") -> torch.Tensor:
    """Xavier-uniform [D, C * k], class-major: columns [c k, (c + 1) k) are
    class c's k sub-centers."""
    d, ck = cfg.feature_dim, cfg.num_classes * cfg.k
    bound = math.sqrt(6.0 / (d + ck))
    w = torch.empty((d, ck), dtype=torch.float32)
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


def _target_cos(cos, one_hot):
    """Per-row target cosine [N, 1], a reduction through the one-hot (0 for
    an ignore label)."""
    return (cos * one_hot).sum(1, keepdim=True)


def _zero(feats):
    """The loss_g of a head without an auxiliary loss."""
    return torch.zeros((), device=feats.device)


# ---------------------------------------------------------------------------
# SphereFace (criterion.py:12-107)
# ---------------------------------------------------------------------------


class SphereFaceState(NamedTuple):
    iter: torch.Tensor  # 0-d int32 step counter (criterion.py:33, :58)


def _chebyshev_cos_m_theta(cos, m: int):
    """cos(m theta) by the Chebyshev polynomials (criterion.py:40-47)."""
    polys = (
        lambda x: torch.ones_like(x),
        lambda x: x,
        lambda x: 2.0 * x ** 2 - 1.0,
        lambda x: 4.0 * x ** 3 - 3.0 * x,
        lambda x: 8.0 * x ** 4 - 8.0 * x ** 2 + 1.0,
        lambda x: 16.0 * x ** 5 - 20.0 * x ** 3 + 5.0 * x,
    )
    return polys[m](cos)


def _sphere_lambda(cfg, new_iter):
    """The annealing weight after `new_iter` steps (criterion.py:60)."""
    return torch.clamp_min(
        cfg.base * (1.0 + cfg.gamma * new_iter.to(torch.float32))
        ** (-cfg.power), cfg.lambda_min)


def _sphere_phi(cos, m: int):
    """phi(theta) = (-1)^k cos(m theta) - 2 k, k = floor(m theta / pi)
    (criterion.py:92), on a cosine clamped to [-1, 1]."""
    k = torch.floor(m * torch.acos(cos) / math.pi)
    return ((1.0 - 2.0 * torch.remainder(k, 2.0))
            * _chebyshev_cos_m_theta(cos, m) - 2.0 * k)


def _sphereface_apply(cfg, kernel, feats, labels, state: SphereFaceState,
                      rng=None, minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0, 1.0)
    new_iter = state.iter + 1
    lamb = _sphere_lambda(cfg, new_iter)
    phi = _sphere_phi(cos, cfg.m)
    one_hot = _one_hot(labels, cfg.num_classes)
    # the annealed blend, scaled by the FEATURE NORM (criterion.py:104-105)
    logits = (one_hot * (phi - cos) / (1.0 + lamb) + cos) * norms
    return HeadOutput(cos * norms, logits, norms, _zero(feats), one_hot,
                      SphereFaceState(new_iter))


register_head(Head(
    name="sphereface",
    init_kernel=_xavier_uniform_kernel,
    init_state=lambda cfg, device="cpu": SphereFaceState(
        torch.zeros((), dtype=torch.int32, device=device)),
    apply=_sphereface_apply,
))


# ---------------------------------------------------------------------------
# CosFace (criterion.py:137-197)
# ---------------------------------------------------------------------------


def _cosface_apply(cfg, kernel, feats, labels, state=None, rng=None,
                   minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)      # criterion.py:177
    one_hot = _one_hot(labels, cfg.num_classes)
    logits = (cos - one_hot * cfg.m) * cfg.s            # criterion.py:186-189
    return HeadOutput(cos * cfg.s, logits, norms, _zero(feats), one_hot,
                      state)


register_head(Head(
    name="cosface",
    init_kernel=_unit_column_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_cosface_apply,
))


# ---------------------------------------------------------------------------
# ArcFace (criterion.py:232-301)
# ---------------------------------------------------------------------------


def _arcface_apply(cfg, kernel, feats, labels, state=None, rng=None,
                   minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)  # no clamp (criterion.py:267)
    one_hot = _one_hot(labels, cfg.num_classes)  # -1: an all-zero row
    logits = _arc_margin(cos, one_hot, cfg.m, cfg.easy_margin, cfg.s)
    return HeadOutput(cos * cfg.s, logits, norms,
                      _zero(feats), one_hot, state)


register_head(Head(
    name="arcface",
    init_kernel=_xavier_uniform_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_arcface_apply,
))


# ---------------------------------------------------------------------------
# MV-Softmax (criterion.py:327-461)
# ---------------------------------------------------------------------------


def _mv_softmax_apply(cfg, kernel, feats, labels, state=None, rng=None,
                      minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)      # criterion.py:413
    pre = cos * cfg.s
    one_hot = _one_hot(labels, cfg.num_classes)
    t_cos = _target_cos(cos, one_hot)                   # [N, 1]
    if cfg.margin_type == "am":                         # criterion.py:420-424
        final_target = torch.where(t_cos > cfg.m, t_cos - cfg.m, t_cos)
        mask = cos > (t_cos - cfg.m)
    elif cfg.margin_type == "arc":                      # criterion.py:426-430
        sin_t = torch.sqrt(1.0 - t_cos ** 2 + 1e-9)
        ctm = t_cos * math.cos(cfg.m) - sin_t * math.sin(cfg.m)
        final_target = torch.where(t_cos > 0.0, ctm, t_cos)
        mask = cos > ctm
    else:
        raise ValueError("margin_type must be 'am' or 'arc'")
    # hard negatives t cos + (t - 1) (criterion.py:432-435); the target
    # column is overwritten after, in the reference's order
    cos = torch.where(mask, cfg.mv_weight * cos + (cfg.mv_weight - 1.0), cos)
    cos = one_hot * final_target + (1.0 - one_hot) * cos
    return HeadOutput(pre, cos * cfg.s, norms, _zero(feats), one_hot, state)


register_head(Head(
    name="mv_softmax",
    init_kernel=_unit_column_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_mv_softmax_apply,
))


# ---------------------------------------------------------------------------
# CurricularFace (criterion.py:491-587)
# ---------------------------------------------------------------------------


class CurricularFaceState(NamedTuple):
    t: torch.Tensor  # [1] EMA of the mean target cosine (criterion.py:517)


def _curricular_ctm(t_cos, m: float):
    """cos(theta + m) of a target cosine clamped to [-1, 1]. The reference
    has no eps here (:555) and NaNs where a target cosine reaches +-1
    (sqrt'(0) = inf); the sqrt's values are kept and the subgradient there
    is 0 (the JAX package's forward-exact guard)."""
    u = (1.0 - t_cos ** 2).clamp_min(0.0)
    sin_t = torch.where(u > 0, torch.sqrt(torch.where(u > 0, u, 1.0)), 0.0)
    return t_cos * math.cos(m) - sin_t * math.sin(m)


def _curricularface_apply(cfg, kernel, feats, labels,
                          state: CurricularFaceState, rng=None,
                          minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0, 1.0)                          # criterion.py:546
    pre = cos * cfg.s
    one_hot = _one_hot(labels, cfg.num_classes)
    t_cos = _target_cos(cos, one_hot)
    ctm = _curricular_ctm(t_cos, cfg.m)
    threshold = math.cos(math.pi - cfg.m)
    mm = math.sin(math.pi - cfg.m) * cfg.m
    mask = cos > ctm
    final_target = torch.where(t_cos > threshold, ctm, t_cos - mm)
    # t moves BEFORE the hard negatives are scaled, and the new t scales
    # them (criterion.py:569-575)
    new_t = (t_cos.mean() * cfg.momentum
             + (1.0 - cfg.momentum) * state.t).detach()
    cos = torch.where(mask, cos * (new_t + cos), cos)
    cos = one_hot * final_target + (1.0 - one_hot) * cos
    return HeadOutput(pre, cos * cfg.s, norms, _zero(feats), one_hot,
                      CurricularFaceState(new_t))


register_head(Head(
    name="curricularface",
    init_kernel=_normal_kernel,
    init_state=lambda cfg, device="cpu": CurricularFaceState(
        torch.zeros((1,), device=device)),
    apply=_curricularface_apply,
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
                      _zero(feats), one_hot,
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
# AdaFace (criterion.py:795-918)
# ---------------------------------------------------------------------------


class AdaFaceState(NamedTuple):
    t: torch.Tensor           # [1] unused buffer of the reference (:836)
    batch_mean: torch.Tensor  # [1], from 20 (:837)
    batch_std: torch.Tensor   # [1], from 100 (:838)


def _adaface_scaler(cfg, norms, state: AdaFaceState):
    """(margin scaler [N, 1], new state) from the clipped feature norms,
    without gradient (criterion.py:876-886). std is Bessel-corrected, as
    torch's .std(); the EMA leans toward the current batch, as the
    reference's does."""
    safe_norms = norms.clamp(0.001, 100.0).detach()
    mean = safe_norms.mean()
    std = safe_norms.std(correction=1)
    new_mean = mean * cfg.t_alpha + (1.0 - cfg.t_alpha) * state.batch_mean
    new_std = std * cfg.t_alpha + (1.0 - cfg.t_alpha) * state.batch_std
    scaler = ((safe_norms - new_mean) / (new_std + cfg.eps) * cfg.h).clamp(
        -1.0, 1.0)
    return scaler, AdaFaceState(state.t, new_mean, new_std)


def _adaface_apply(cfg, kernel, feats, labels, state: AdaFaceState, rng=None,
                   minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)      # eps = 1e-3, :872
    pre = cos * cfg.s
    scaler, new_state = _adaface_scaler(cfg, norms, state)
    one_hot = _one_hot(labels, cfg.num_classes)
    # angular: cos(theta - m * scaler) on the target column (:893-896)
    m_arc = one_hot * (cfg.m * scaler * -1.0)
    theta_m = (torch.acos(cos) + m_arc).clamp(cfg.eps, math.pi - cfg.eps)
    # additive: -m (1 + scaler) on the target column (:898-901)
    cosine = torch.cos(theta_m) - one_hot * (cfg.m + cfg.m * scaler)
    return HeadOutput(pre, cosine * cfg.s, norms, _zero(feats), one_hot,
                      new_state)


def _adaface_init_state(cfg, device="cpu") -> AdaFaceState:
    return AdaFaceState(t=torch.zeros((1,), device=device),
                        batch_mean=torch.full((1,), 20.0, device=device),
                        batch_std=torch.full((1,), 100.0, device=device))


register_head(Head(
    name="adaface",
    init_kernel=_unit_column_kernel,
    init_state=_adaface_init_state,
    apply=_adaface_apply,
))


# ---------------------------------------------------------------------------
# ElasticCosFace / ElasticArcFace (criterion.py:951-1030, 1054-1154)
# ---------------------------------------------------------------------------


def _normal_noise(rng: torch.Generator, n: int, device) -> torch.Tensor:
    """n standard-normal draws from the generator `rng` on `device`: the
    elastic heads' one random draw a step."""
    if rng is None:
        raise ValueError("the elastic heads draw their margins from a "
                         "torch.Generator: pass rng=")
    return torch.randn(n, generator=rng, device=device)


def _elastic_margin(rng, t_cos, valid, m: float, std: float, plus: bool):
    """Per-sample margin ~ N(m, std) clipped to m +- std. In plus mode the
    sorted margins are laid out by the rank of the target cosine
    (criterion.py:1003-1012), with stable sorts as jnp's. 0 where not
    valid."""
    margin = m + std * _normal_noise(rng, t_cos.shape[0], t_cos.device)
    margin = margin.clamp(m - std, m + std)
    if plus:
        rank = torch.argsort(-t_cos.detach(), stable=True)
        margin = torch.sort(margin, stable=True).values[rank]
    return torch.where(valid, margin, 0.0)


def _elastic_apply(cfg, kernel, feats, labels, rng, arc: bool) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
    pre = cos * cfg.s
    one_hot = _one_hot(labels, cfg.num_classes)
    valid = labels >= 0
    t_cos = _target_cos(cos, one_hot)[:, 0]
    margin = _elastic_margin(rng, t_cos, valid, cfg.m, cfg.std, cfg.plus)
    if arc:
        # cos(clip(acos(t) + m, 0, pi)) (criterion.py:1129-1132)
        new_target = torch.cos((torch.acos(t_cos) + margin).clamp(
            0.0, math.pi))
    else:
        new_target = t_cos - margin
    cos = torch.where((one_hot > 0) & valid[:, None], new_target[:, None],
                      cos)
    return HeadOutput(pre, cos * cfg.s, norms, _zero(feats), one_hot, None)


def _elastic_cosface_apply(cfg, kernel, feats, labels, state=None, rng=None,
                           minput=None) -> HeadOutput:
    return _elastic_apply(cfg, kernel, feats, labels, rng, arc=False)


def _elastic_arcface_apply(cfg, kernel, feats, labels, state=None, rng=None,
                           minput=None) -> HeadOutput:
    return _elastic_apply(cfg, kernel, feats, labels, rng, arc=True)


register_head(Head(
    name="elastic_cosface",
    init_kernel=_normal_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_elastic_cosface_apply,
    requires_rng=True,
))

register_head(Head(
    name="elastic_arcface",
    init_kernel=_normal_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_elastic_arcface_apply,
    requires_rng=True,
))


# ---------------------------------------------------------------------------
# MagFace (criterion.py:1178-1301)
# ---------------------------------------------------------------------------


def _magface_margin(cfg, norms):
    """(clamped norm [N, 1], loss_g, ada_m [N, 1]): the magnitude
    regulariser g = a / u_a^2 + 1 / a (criterion.py:1235-1238) and the
    linear norm-to-margin map (:1229-1232), both with gradient."""
    x_norm = norms.clamp(cfg.l_a, cfg.u_a)              # :1245
    loss_g = (x_norm / (cfg.u_a ** 2) + 1.0 / x_norm).mean()
    ada_m = ((cfg.u_margin - cfg.l_margin) / (cfg.u_a - cfg.l_a)
             * (x_norm - cfg.l_a) + cfg.l_margin)
    return x_norm, loss_g, ada_m


def _magface_ctm(cfg, cos, ada_m):
    """The margin-applied target value for cosines `cos` and per-row
    margins `ada_m` of a broadcastable shape."""
    sin_theta = torch.sqrt(1.0 - cos ** 2 + 1e-9)
    ctm = cos * torch.cos(ada_m) - sin_theta * torch.sin(ada_m)
    if cfg.easy_margin:
        return torch.where(cos > 0, ctm, cos)
    mm = torch.sin(math.pi - ada_m) * ada_m
    threshold = torch.cos(math.pi - ada_m)
    return torch.where(cos > threshold, ctm, cos - mm)


def _magface_apply(cfg, kernel, feats, labels, state=None, rng=None,
                   minput=None) -> HeadOutput:
    cos, _, norms = cosine_logits(feats, kernel)
    x_norm, loss_g, ada_m = _magface_margin(cfg, norms)
    cos = cos.clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
    ctm = _magface_ctm(cfg, cos, ada_m)
    one_hot = _one_hot(labels, cfg.num_classes)
    logits = (one_hot * ctm + (1.0 - one_hot) * cos) * cfg.s
    # the reference returns the CLAMPED norm as `norms` (:1290)
    return HeadOutput(cos * cfg.s, logits, x_norm, loss_g, one_hot, state)


register_head(Head(
    name="magface",
    init_kernel=_unit_column_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_magface_apply,
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
                      _zero(feats), one_hot,
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


# ---------------------------------------------------------------------------
# Combined margin (insightface's unified recipe)
# ---------------------------------------------------------------------------


def _combined_t(cfg, t_cos):
    """cos(clip(m1 theta + m2, 0, pi)) - m3 of a clamped target cosine."""
    theta = torch.acos(t_cos)
    return torch.cos((cfg.m1 * theta + cfg.m2).clamp(0.0, math.pi)) - cfg.m3


def _combined_margin_apply(cfg, kernel, feats, labels, state=None, rng=None,
                           minput=None) -> HeadOutput:
    """Target-column margin cos(m1 theta + m2) - m3, scaled by s; the
    other columns' cosines stay unclamped."""
    cos, _, norms = cosine_logits(feats, kernel)
    one_hot = _one_hot(labels, cfg.num_classes)
    t_cos = _target_cos(cos, one_hot).clamp(-1.0 + cfg.eps, 1.0 - cfg.eps)
    phi = _combined_t(cfg, t_cos)
    logits = (one_hot * phi + (1.0 - one_hot) * cos) * cfg.s
    return HeadOutput(cos * cfg.s, logits, norms, _zero(feats), one_hot,
                      state)


register_head(Head(
    name="combined_margin",
    init_kernel=_normal_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_combined_margin_apply,
))


# ---------------------------------------------------------------------------
# Sub-center ArcFace (Deng et al., ECCV 2020)
# ---------------------------------------------------------------------------


def _subcenter_arcface_apply(cfg, kernel, feats, labels, state=None,
                             rng=None, minput=None) -> HeadOutput:
    """ArcFace over each class's cosine max-pooled across its k sub-center
    columns (class-major [D, C k] kernel); the gradient reaches the winning
    sub-center (split evenly on a tie, as jnp.max's)."""
    cos_all, _, norms = cosine_logits(feats, kernel)    # [N, C k]
    cos = cos_all.reshape(cos_all.shape[0], cfg.num_classes, cfg.k).amax(2)
    one_hot = _one_hot(labels, cfg.num_classes)
    logits = _arc_margin(cos, one_hot, cfg.m, cfg.easy_margin, cfg.s)
    return HeadOutput(cos * cfg.s, logits, norms, _zero(feats), one_hot,
                      state)


register_head(Head(
    name="subcenter_arcface",
    init_kernel=_subcenter_kernel,
    init_state=lambda cfg, device="cpu": None,
    apply=_subcenter_arcface_apply,
))


# ---------------------------------------------------------------------------
# AdaCos (Zhang et al., CVPR 2019)
# ---------------------------------------------------------------------------


class AdaCosState(NamedTuple):
    s: torch.Tensor  # [1] the running scale


def _adacos_init_scale(cfg) -> float:
    """The fixed AdaCos scale sqrt(2) ln(C - 1) (paper eq. 11)."""
    return math.sqrt(2.0) * math.log(max(cfg.num_classes - 1, 2))


def _median(x):
    """jnp.median of a 1-d tensor: the mean of the two middle values when
    its length is even (torch.median takes the lower one)."""
    v = torch.sort(x).values
    n = v.shape[0]
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def _adacos_apply(cfg, kernel, feats, labels, state: AdaCosState, rng=None,
                  minput=None) -> HeadOutput:
    """Margin-free cosine logits at a scale set from the batch (paper eqs.
    12-13): B_avg the batch mean of the non-target exp(s_prev cos) mass,
    theta_med the median target angle (clipped to theta_clip), s_new =
    ln(B_avg) / cos(theta_med), without gradient; the batch's logits take
    s_new. Fixed: the state's scale."""
    cos, _, norms = cosine_logits(feats, kernel)
    cos = cos.clamp(-1.0 + 1e-7, 1.0 - 1e-7)
    one_hot = _one_hot(labels, cfg.num_classes)
    if cfg.dynamic:
        theta = torch.acos(_target_cos(cos, one_hot)[:, 0])
        b_avg = ((1.0 - one_hot) * torch.exp(state.s * cos)).sum(1).mean()
        theta_med = _median(theta).clamp(0.0, cfg.theta_clip)
        s_new = (torch.log(b_avg.clamp_min(1e-12))
                 / torch.cos(theta_med)).detach().reshape(1)
        new_state = AdaCosState(s_new)
    else:
        new_state = state
    logits = cos * new_state.s[0]
    # no margin: the pre-margin and the CE logits are the same
    return HeadOutput(logits, logits, norms, _zero(feats), one_hot,
                      new_state)


register_head(Head(
    name="adacos",
    init_kernel=_xavier_uniform_kernel,
    init_state=lambda cfg, device="cpu": AdaCosState(
        torch.full((1,), _adacos_init_scale(cfg), device=device)),
    apply=_adacos_apply,
))
