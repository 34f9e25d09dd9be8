"""Fused margin-head + cross-entropy, with hand-written Hopper kernels.

Port of face_recognition_models_tpu/ops/fused_head.py. Every supported head
reduces to

    logit[i, j]        = scale[i] * h(cos[i, j], a[i], b[i])   for j != label[i]
    logit[i, label[i]] = scale[i] * t[i]

with cos = xn @ wn (optionally clamped to [-1 + eps, 1 - eps]) and h one of
three modes (identity, MV, curricular). `fused_margin_ce` returns the
per-row logsumexp, the target logit and `higher` (#non-target classes whose
cosine beats the target's, for top-k accuracy) without materialising the
[N, C] logits on the card.

On CUDA tensors the three kernels of `csrc/fused_head.cu` run:
`fused_ce_fwd`, then `fused_ce_bwd_dx` and `fused_ce_bwd_dw` for the
gradient. On CPU tensors the wrappers compute the same function with the
plain [N, C] PyTorch versions below, which are also the reference the card
is checked against. There is no fallback from the card to the plain code.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

MODE_IDENTITY = 0
MODE_MV = 1
MODE_CURRICULAR = 2

# Launches per kernel since the last reset_launch_counts(); bumped only where
# a wrapper launches its kernel.
launch_counts = {"fused_ce_fwd": 0, "fused_ce_bwd_dx": 0, "fused_ce_bwd_dw": 0}
# Per-block shared memory of an H100 (bytes); bounds the embedding width.
_MAX_SMEM = 232_448


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class FusedHeadOut(NamedTuple):
    lse: torch.Tensor           # [N] logsumexp of post-margin logits
    target_logit: torch.Tensor  # [N] scale * t
    higher: torch.Tensor        # [N] #classes with pre-margin cos > tcos


# ---------------------------------------------------------------------------
# Plain PyTorch versions ([N, C] fp32)
# ---------------------------------------------------------------------------


def _h(mode: int, cos, a, b):
    if mode == MODE_IDENTITY:
        return cos
    if mode == MODE_MV:
        return torch.where(cos > a, b * cos + (b - 1.0), cos)
    if mode == MODE_CURRICULAR:
        return torch.where(cos > a, cos * (b + cos), cos)
    raise ValueError(mode)


def _h_grad(mode: int, cos, a, b):
    if mode == MODE_IDENTITY:
        return torch.ones_like(cos)
    if mode == MODE_MV:
        return torch.where(cos > a, b.expand_as(cos), torch.ones_like(cos))
    if mode == MODE_CURRICULAR:
        return torch.where(cos > a, b + 2.0 * cos, torch.ones_like(cos))
    raise ValueError(mode)


def _cos(xn, wn, clamp_eps):
    cos_raw = torch.matmul(xn, wn)
    if clamp_eps is None:
        return cos_raw, cos_raw
    return cos_raw, cos_raw.clamp(-1.0 + clamp_eps, 1.0 - clamp_eps)


def _target_mask(labels, c):
    cols = torch.arange(c, device=labels.device)
    return cols[None, :] == labels[:, None].long()


def fused_margin_ce_plain(xn, wn, labels, t, tcos, scale, ab, mode: int,
                          clamp_eps: Optional[float] = None) -> FusedHeadOut:
    """Forward as a straightforward [N, C] fp32 computation."""
    _, cos = _cos(xn, wn, clamp_eps)
    is_t = _target_mask(labels, wn.shape[1])
    a, b = ab[:, :1], ab[:, 1:]
    logits = scale[:, None] * torch.where(is_t, t[:, None], _h(mode, cos, a, b))
    higher = ((cos > tcos[:, None]) & ~is_t).sum(1).to(torch.float32)
    return FusedHeadOut(torch.logsumexp(logits, 1), scale * t, higher)


def _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse, mode, clamp_eps):
    """(dcos [N, C], dt without the direct term, dscale without it)."""
    cos_raw, cos = _cos(xn, wn, clamp_eps)
    is_t = _target_mask(labels, wn.shape[1])
    a, b = ab[:, :1], ab[:, 1:]
    h = _h(mode, cos, a, b)
    s = scale[:, None]
    logits = s * torch.where(is_t, t[:, None], h)
    dl = g_lse[:, None] * torch.exp(logits - lse[:, None])
    dcos = torch.where(is_t, torch.zeros_like(dl),
                       dl * s * _h_grad(mode, cos, a, b))
    if clamp_eps is not None:
        dcos = dcos * ((cos_raw >= -1.0 + clamp_eps)
                       & (cos_raw <= 1.0 - clamp_eps))
    dt = torch.where(is_t, dl * s, torch.zeros_like(dl)).sum(1)
    dscale = torch.where(is_t, dl * t[:, None], dl * h).sum(1)
    return dcos, dt, dscale


def fused_margin_ce_bwd_plain(xn, wn, labels, t, scale, ab, lse, g_lse, g_t,
                              mode: int, clamp_eps: Optional[float] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """Backward as a straightforward [N, C] fp32 computation.
    Returns (dx [N, D], dw [D, C], dt [N], dscale [N])."""
    dcos, dt, dscale = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode, clamp_eps)
    return (dcos @ wn.T, xn.T @ dcos, dt + g_t * scale, dscale + g_t * t)


def fused_ce_bwd_dx_plain(xn, wn, labels, t, scale, ab, lse, g_lse, g_t,
                          mode: int, clamp_eps: Optional[float] = None):
    """Plain version of fused_ce_bwd_dx: (dx, dt, dscale)."""
    dcos, dt, dscale = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode, clamp_eps)
    return dcos @ wn.T, dt + g_t * scale, dscale + g_t * t


def fused_ce_bwd_dw_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                          mode: int, clamp_eps: Optional[float] = None):
    """Plain version of fused_ce_bwd_dw: dw."""
    dcos, _, _ = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse, mode,
                             clamp_eps)
    return xn.T @ dcos


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from face_recognition_models_tpu_torch.ops import _build

    lib = _build.load("fused_head")
    if not getattr(lib, "_typed", False):
        lib.fused_ce_fwd.argtypes = [_P] * 10 + [_I] * 5 + [_F, _P]
        lib.fused_ce_bwd_dx.argtypes = [_P] * 12 + [_I] * 5 + [_F, _P]
        lib.fused_ce_bwd_dw.argtypes = [_P] * 9 + [_I] * 5 + [_F, _P]
        for fn in (lib.fused_ce_fwd, lib.fused_ce_bwd_dx, lib.fused_ce_bwd_dw):
            fn.restype = _I
        lib.fused_ce_smem_bytes.argtypes = [_I, _I]
        lib.fused_ce_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _check(name, xn, wn, labels, rows, ab):
    n, d = xn.shape
    if wn.dim() != 2 or wn.shape[0] != d:
        raise ValueError(f"{name}: wn must be [D={d}, C], got {tuple(wn.shape)}")
    if labels.shape != (n,) or labels.dtype != torch.int32:
        raise ValueError(f"{name}: labels must be int32 [N={n}]")
    if ab.shape != (n, 2):
        raise ValueError(f"{name}: ab must be [N={n}, 2]")
    for r in rows:
        if r.shape != (n,):
            raise ValueError(f"{name}: row scalars must be [N={n}]")
    for x in (xn, wn, ab, *rows):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")
    for x in (xn, wn, labels, ab, *rows):
        if x.device != xn.device:
            raise ValueError(f"{name}: all inputs must be on {xn.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if xn.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got "
                         f"{xn.device}")


def _launch(name, which, d, *args):
    lib = _lib()
    need = lib.fused_ce_smem_bytes(which, d)
    if need > _MAX_SMEM:
        raise ValueError(f"{name}: embedding width {d} needs {need} bytes of "
                         f"shared memory per block (limit {_MAX_SMEM})")
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launch_counts[name] += 1


def _ptr(x):
    return x.data_ptr()


def _eps_args(clamp_eps):
    return (0, 0.0) if clamp_eps is None else (1, float(clamp_eps))


def fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, mode: int,
                 clamp_eps: Optional[float] = None) -> FusedHeadOut:
    """Forward statistics (lse, target_logit, higher), each [N] fp32."""
    if xn.device.type == "cpu":
        return fused_margin_ce_plain(xn, wn, labels, t, tcos, scale, ab, mode,
                                     clamp_eps)
    _check("fused_ce_fwd", xn, wn, labels, (t, tcos, scale), ab)
    n, d = xn.shape
    out = torch.empty((3, n), dtype=torch.float32, device=xn.device)
    if n:
        with torch.cuda.device(xn.device):
            _launch("fused_ce_fwd", 0, d, _ptr(xn), _ptr(wn),
                    _ptr(labels), _ptr(t), _ptr(tcos), _ptr(scale), _ptr(ab),
                    _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), n, d,
                    wn.shape[1], mode, *_eps_args(clamp_eps))
    return FusedHeadOut(out[0], out[1], out[2])


def fused_ce_bwd_dx(xn, wn, labels, t, scale, ab, lse, g_lse, g_t, mode: int,
                    clamp_eps: Optional[float] = None):
    """(dx [N, D], dt [N], dscale [N]): the row-major half of the backward."""
    if xn.device.type == "cpu":
        return fused_ce_bwd_dx_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                     g_t, mode, clamp_eps)
    _check("fused_ce_bwd_dx", xn, wn, labels, (t, scale, lse, g_lse, g_t), ab)
    n, d = xn.shape
    dx = torch.empty_like(xn)
    rows = torch.empty((2, n), dtype=torch.float32, device=xn.device)
    if n:
        with torch.cuda.device(xn.device):
            _launch("fused_ce_bwd_dx", 1, d, _ptr(xn),
                    _ptr(wn), _ptr(labels), _ptr(t), _ptr(scale), _ptr(ab),
                    _ptr(lse), _ptr(g_lse), _ptr(g_t), _ptr(dx),
                    _ptr(rows[0]), _ptr(rows[1]), n, d, wn.shape[1], mode,
                    *_eps_args(clamp_eps))
    return dx, rows[0], rows[1]


def fused_ce_bwd_dw(xn, wn, labels, t, scale, ab, lse, g_lse, mode: int,
                    clamp_eps: Optional[float] = None):
    """dw [D, C]: the class-major half of the backward."""
    if xn.device.type == "cpu":
        return fused_ce_bwd_dw_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                     mode, clamp_eps)
    _check("fused_ce_bwd_dw", xn, wn, labels, (t, scale, lse, g_lse), ab)
    n, d = xn.shape
    dw = torch.zeros_like(wn) if n == 0 else torch.empty_like(wn)
    if n:
        with torch.cuda.device(xn.device):
            _launch("fused_ce_bwd_dw", 2, d, _ptr(xn),
                    _ptr(wn), _ptr(labels), _ptr(t), _ptr(scale), _ptr(ab),
                    _ptr(lse), _ptr(g_lse), _ptr(dw), n, d, wn.shape[1],
                    mode, *_eps_args(clamp_eps))
    return dw


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _FusedMarginCE(torch.autograd.Function):
    """Gradients for xn, wn, t and scale, None for labels, tcos and ab; the
    gradient of `higher` is ignored (it is a statistic). This is the JAX
    custom VJP's contract exactly: for the MV / curricular modes no gradient
    reaches a / b even where a depends on tcos."""

    @staticmethod
    def forward(ctx, xn, wn, labels, t, tcos, scale, ab, mode, clamp_eps):
        out = fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, mode,
                           clamp_eps)
        ctx.save_for_backward(xn, wn, labels, t, scale, ab, out.lse)
        ctx.mode, ctx.clamp_eps = mode, clamp_eps
        ctx.mark_non_differentiable(out.higher)
        return out.lse, out.target_logit, out.higher

    @staticmethod
    def backward(ctx, g_lse, g_t, _g_higher):
        xn, wn, labels, t, scale, ab, lse = ctx.saved_tensors
        g_lse = (torch.zeros_like(lse) if g_lse is None
                 else g_lse.contiguous().float())
        g_t = (torch.zeros_like(lse) if g_t is None
               else g_t.contiguous().float())
        dx, dt, dscale = fused_ce_bwd_dx(xn, wn, labels, t, scale, ab, lse,
                                         g_lse, g_t, ctx.mode, ctx.clamp_eps)
        dw = fused_ce_bwd_dw(xn, wn, labels, t, scale, ab, lse, g_lse,
                             ctx.mode, ctx.clamp_eps)
        return dx, dw, None, dt, None, dscale, None, None, None


def fused_margin_ce(xn, wn, labels, t, tcos, scale, ab, mode: int,
                    clamp_eps: Optional[float] = None) -> FusedHeadOut:
    """Fused margin + cross-entropy statistics over all classes.

    xn [N, D] row-normalised embeddings; wn [D, C] column-normalised class
    weights; labels [N] (a label outside [0, C) marks no target column);
    t [N] target value before scaling; tcos [N] target cosine before the
    margin; scale [N]; ab [N, 2] mode parameters. Returns
    (lse [N], target_logit [N], higher [N]), all fp32.
    """
    f32 = lambda x: x.to(torch.float32).contiguous()
    lse, tlogit, higher = _FusedMarginCE.apply(
        f32(xn), f32(wn), labels.to(torch.int32).contiguous(), f32(t),
        f32(tcos), f32(scale), f32(ab), mode, clamp_eps)
    return FusedHeadOut(lse, tlogit, higher)
