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

The memory-blended heads (VPL-ArcFace, QAFace) use `fused_margin_ce_mem`,
where every column's cosine is blended, before the clamp, with a per-class
memory:

    cos[i, j] = (1 - lam[j]) * (xn @ wn)[i, j] + lam[j] * (xn @ memn)[i, j]

memn [D, C] and lam [C] are constants: dx flows through both products, dw
only through the (1 - lam) share.

On CUDA tensors the kernels of `csrc/fused_head.cu` run: `fused_ce_fwd`,
then `fused_ce_bwd_dx` and `fused_ce_bwd_dw` for the gradient, or their
`_mem` variants. On CPU tensors the wrappers compute the same function with
the plain [N, C] PyTorch versions below, which are also the reference the
card is checked against. There is no fallback from the card to the plain
code.

The fp32 `fused_ce_fwd(_mem)` and `fused_ce_bwd_dx(_mem)` split the class
axis into ranges (`split_ranges`), one block per row tile and range, and
combine the ranges' partials in a second launch in a fixed order: per row
(m, l, higher) with lse = M + log sum_s l_s exp(m_s - M), and dx, dt,
dscale summed. The fp32 `fused_ce_bwd_dw(_mem)` splits the row axis the
same way, one block per 32-wide class tile and row range (`dw_split_plan`),
and where it runs more than one range sums the ranges' dw in a second
launch. The wrappers allocate the workspace of partials (O(S N) for the
forward, O(S N D) for dx, O(S D C) for dw when S > 1).
`fused_ce_{fwd,bwd_dx,bwd_dw}_partials_plain` and
`fused_ce_{fwd,bwd_dx,bwd_dw}_combine_plain` are that decomposition in plain
PyTorch, for the tests and the card checks; the main path never calls them.

`mm_dtype=torch.bfloat16` (the JAX package's `mm_dtype=jnp.bfloat16`) runs
every product on bf16 operands with fp32 accumulation: the `_bf16` kernels
on the tensor cores. The bf16 forward and dx entries are split-C like the
fp32 ones (128-wide class tiles, `split_plan(..., mm_dtype=torch.bfloat16)`
and `split_plan(..., dx=True, mm_dtype=torch.bfloat16)`), and the bf16 dw
entries split rows like the fp32 dw (32-wide class tiles x ranges of
32-row tiles, 16 with the blend, `dw_split_plan(...,
mm_dtype=torch.bfloat16)`). Their workspace holds the partials in the fp32
layout ([S, 3, N]; dx [S, N, round4(D)] then [S, 2, N]; dw [S, D, C] when
S > 1) and, after them, the operands rounded to bf16 once by a pre-pass
(for dw, xn only). The operands are rounded to bf16 (round to nearest
even) at exactly six places, and everything else stays fp32: xn and wn
before every cosine product, memn, dcos before the dx and dw products, and,
with the blend, dcos * (1 - lam) and dcos * lam, each rounded on its own.
The plain versions round at the same places and multiply in fp32, which is
what a bf16 x bf16 product with an fp32 accumulator computes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

MODE_IDENTITY = 0
MODE_MV = 1
MODE_CURRICULAR = 2

# Launches per kernel since the last reset_launch_counts(); bumped only where
# a wrapper launches its kernel. A launch recorded into a CUDA graph being
# captured runs nothing: it goes to captured_counts instead, and the graph's
# owner counts its replays (train/graphed.py).
_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dw",
            "fused_ce_fwd_mem", "fused_ce_bwd_dx_mem", "fused_ce_bwd_dw_mem")
launch_counts = {name + suffix: 0 for suffix in ("", "_bf16")
                 for name in _KERNELS}
captured_counts = dict.fromkeys(launch_counts, 0)
# Per-block shared memory of an H100 (bytes); bounds the embedding width.
_MAX_SMEM = 232_448
# Widest embedding of the bwd_dx and bwd_dw kernels, fp32 and bf16: 8 warps
# hold 64 columns of D each of the dx (dw) accumulator in registers.
_MAX_SPLIT_WIDTH = 512
# A range with no valid column carries this max logit (the kernels' -1e30).
_NEG_INF = -1e30


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


def _check_mm_dtype(mm_dtype):
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mm_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {mm_dtype}")


def _mm(x, mm_dtype):
    """x as a product operand: rounded to bf16 (and back to fp32) when the
    products run in bf16."""
    if mm_dtype == torch.float32:
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def _cos(xn, wn, clamp_eps, memn=None, lam=None, mm_dtype=torch.float32):
    """(cos before the clamp, cos after it); blended with the memory first
    when memn is given."""
    xm = _mm(xn, mm_dtype)
    cos_raw = torch.matmul(xm, _mm(wn, mm_dtype))
    if memn is not None:
        cos_raw = ((1.0 - lam) * cos_raw
                   + lam * torch.matmul(xm, _mm(memn, mm_dtype)))
    if clamp_eps is None:
        return cos_raw, cos_raw
    return cos_raw, cos_raw.clamp(-1.0 + clamp_eps, 1.0 - clamp_eps)


def _target_mask(labels, c):
    cols = torch.arange(c, device=labels.device)
    return cols[None, :] == labels[:, None].long()


def _logits_plain(xn, wn, memn, lam, labels, t, tcos, scale, ab, mode,
                  clamp_eps, mm_dtype):
    """(post-margin logits [N, C], the `higher` indicator [N, C]: non-target
    columns whose cosine beats the target's)."""
    _check_mm_dtype(mm_dtype)
    _, cos = _cos(xn, wn, clamp_eps, memn, lam, mm_dtype)
    is_t = _target_mask(labels, wn.shape[1])
    a, b = ab[:, :1], ab[:, 1:]
    logits = scale[:, None] * torch.where(is_t, t[:, None], _h(mode, cos, a, b))
    return logits, (cos > tcos[:, None]) & ~is_t


def _fwd_plain(xn, wn, memn, lam, labels, t, tcos, scale, ab, mode,
               clamp_eps, mm_dtype) -> FusedHeadOut:
    logits, above = _logits_plain(xn, wn, memn, lam, labels, t, tcos, scale,
                                  ab, mode, clamp_eps, mm_dtype)
    higher = above.sum(1).to(torch.float32)
    return FusedHeadOut(torch.logsumexp(logits, 1), scale * t, higher)


def fused_margin_ce_plain(xn, wn, labels, t, tcos, scale, ab, mode: int,
                          clamp_eps: Optional[float] = None,
                          mm_dtype=torch.float32) -> FusedHeadOut:
    """Forward as a straightforward [N, C] fp32 computation."""
    return _fwd_plain(xn, wn, None, None, labels, t, tcos, scale, ab, mode,
                      clamp_eps, mm_dtype)


def fused_margin_ce_mem_plain(xn, wn, memn, lam, labels, t, tcos, scale, ab,
                              mode: int, clamp_eps: Optional[float] = None,
                              mm_dtype=torch.float32) -> FusedHeadOut:
    """Memory-blended forward as a straightforward [N, C] fp32 computation:
    the blend comes before the clamp."""
    return _fwd_plain(xn, wn, memn, lam, labels, t, tcos, scale, ab, mode,
                      clamp_eps, mm_dtype)


def _dcos_terms_plain(xn, wn, labels, t, scale, ab, lse, g_lse, mode,
                      clamp_eps, memn=None, lam=None, mm_dtype=torch.float32):
    """(dcos, dt terms, dscale terms), each [N, C]; the row sums of the
    terms are dt and dscale without the direct path."""
    _check_mm_dtype(mm_dtype)
    cos_raw, cos = _cos(xn, wn, clamp_eps, memn, lam, mm_dtype)
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
    return (dcos, torch.where(is_t, dl * s, torch.zeros_like(dl)),
            torch.where(is_t, dl * t[:, None], dl * h))


def _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse, mode, clamp_eps,
                memn=None, lam=None, mm_dtype=torch.float32):
    """(dcos [N, C], dt without the direct term, dscale without it). dcos
    is the gradient of the (blended) cosine before the blend is split, in
    fp32 (not yet rounded for a bf16 product)."""
    dcos, dt, dscale = _dcos_terms_plain(xn, wn, labels, t, scale, ab, lse,
                                         g_lse, mode, clamp_eps, memn, lam,
                                         mm_dtype)
    return dcos, dt.sum(1), dscale.sum(1)


def fused_margin_ce_bwd_plain(xn, wn, labels, t, scale, ab, lse, g_lse, g_t,
                              mode: int, clamp_eps: Optional[float] = None,
                              mm_dtype=torch.float32
                              ) -> Tuple[torch.Tensor, ...]:
    """Backward as a straightforward [N, C] fp32 computation.
    Returns (dx [N, D], dw [D, C], dt [N], dscale [N])."""
    dx, dt, dscale = fused_ce_bwd_dx_plain(xn, wn, labels, t, scale, ab, lse,
                                           g_lse, g_t, mode, clamp_eps,
                                           mm_dtype)
    dw = fused_ce_bwd_dw_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                               mode, clamp_eps, mm_dtype)
    return dx, dw, dt, dscale


def fused_ce_bwd_dx_plain(xn, wn, labels, t, scale, ab, lse, g_lse, g_t,
                          mode: int, clamp_eps: Optional[float] = None,
                          mm_dtype=torch.float32):
    """Plain version of fused_ce_bwd_dx: (dx, dt, dscale)."""
    dcos, dt, dscale = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode, clamp_eps, mm_dtype=mm_dtype)
    dx = _mm(dcos, mm_dtype) @ _mm(wn, mm_dtype).T
    return dx, dt + g_t * scale, dscale + g_t * t


def fused_ce_bwd_dw_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                          mode: int, clamp_eps: Optional[float] = None,
                          mm_dtype=torch.float32):
    """Plain version of fused_ce_bwd_dw: dw."""
    dcos, _, _ = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse, mode,
                             clamp_eps, mm_dtype=mm_dtype)
    return _mm(xn, mm_dtype).T @ _mm(dcos, mm_dtype)


def fused_ce_bwd_dx_mem_plain(xn, wn, memn, lam, labels, t, scale, ab, lse,
                              g_lse, g_t, mode: int,
                              clamp_eps: Optional[float] = None,
                              mm_dtype=torch.float32):
    """Plain version of fused_ce_bwd_dx_mem: (dx, dt, dscale), with dcos
    split as dcos * (1 - lam) into wn and dcos * lam into memn."""
    dcos, dt, dscale = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode, clamp_eps, memn, lam, mm_dtype)
    dx = (_mm(dcos * (1.0 - lam), mm_dtype) @ _mm(wn, mm_dtype).T
          + _mm(dcos * lam, mm_dtype) @ _mm(memn, mm_dtype).T)
    return dx, dt + g_t * scale, dscale + g_t * t


def fused_ce_bwd_dw_mem_plain(xn, wn, memn, lam, labels, t, scale, ab, lse,
                              g_lse, mode: int,
                              clamp_eps: Optional[float] = None,
                              mm_dtype=torch.float32):
    """Plain version of fused_ce_bwd_dw_mem: dw takes only the
    dcos * (1 - lam) share."""
    dcos, _, _ = _dcos_plain(xn, wn, labels, t, scale, ab, lse, g_lse, mode,
                             clamp_eps, memn, lam, mm_dtype)
    return _mm(xn, mm_dtype).T @ _mm(dcos * (1.0 - lam), mm_dtype)


# ---------------------------------------------------------------------------
# The split decomposition of the fp32 kernels, in plain PyTorch: fwd and
# bwd_dx over class ranges, bwd_dw over row ranges
# ---------------------------------------------------------------------------


def split_ranges(c: int, splits: int, range_cols: int):
    """[(lo, hi)] bounds of the `splits` ranges of `range_cols` entries each
    along an axis of length c (classes, or rows for dw); ranges past c are
    empty."""
    return [(min(c, s * range_cols), min(c, (s + 1) * range_cols))
            for s in range(splits)]


def fused_ce_fwd_partials_plain(xn, wn, labels, t, tcos, scale, ab,
                                mode: int, clamp_eps: Optional[float] = None,
                                *, splits: int, range_cols: int, memn=None,
                                lam=None, mm_dtype=torch.float32
                                ) -> torch.Tensor:
    """Per-range partials of the forward, [S, 3, N]: the range's max logit m
    (-1e30 for an empty range), l = sum exp(logit - m) and the `higher`
    count. With memn and lam, the memory-blended head; with
    mm_dtype=torch.bfloat16, the products on bf16 operands."""
    logits, above = _logits_plain(xn, wn, memn, lam, labels, t, tcos, scale,
                                  ab, mode, clamp_eps, mm_dtype)
    parts = []
    for lo, hi in split_ranges(wn.shape[1], splits, range_cols):
        seg = logits[:, lo:hi]
        if hi > lo:
            m = seg.max(1).values
            l = torch.exp(seg - m[:, None]).sum(1)
        else:
            m = torch.full_like(t, _NEG_INF)
            l = torch.zeros_like(t)
        parts.append(torch.stack([m, l, above[:, lo:hi].sum(1).float()]))
    return torch.stack(parts)


def fused_ce_fwd_combine_plain(parts, t, scale) -> FusedHeadOut:
    """lse = M + log sum_s l_s exp(m_s - M) (M = max_s m_s), higher summed
    over the ranges; target logit = scale * t."""
    m, l, h = parts.unbind(1)
    top = m.max(0).values
    lse = top + torch.log((l * torch.exp(m - top)).sum(0))
    return FusedHeadOut(lse, scale * t, h.sum(0))


def fused_ce_bwd_dx_partials_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode: int,
                                   clamp_eps: Optional[float] = None, *,
                                   splits: int, range_cols: int, memn=None,
                                   lam=None, mm_dtype=torch.float32):
    """Per-range partials of dx: (dx [S, N, D], (dt, dscale) [S, 2, N]
    without the direct path). With memn and lam, dcos * (1 - lam) goes into
    wn and dcos * lam into memn; with mm_dtype=torch.bfloat16, the products
    on bf16 operands (dcos, or each of its two shares, rounded on its
    own)."""
    dcos, dt, dscale = _dcos_terms_plain(xn, wn, labels, t, scale, ab, lse,
                                         g_lse, mode, clamp_eps, memn, lam,
                                         mm_dtype)
    wm = _mm(wn, mm_dtype)
    mm = None if memn is None else _mm(memn, mm_dtype)
    dx_parts, row_parts = [], []
    for lo, hi in split_ranges(wn.shape[1], splits, range_cols):
        g = dcos[:, lo:hi]
        if memn is None:
            dx = _mm(g, mm_dtype) @ wm[:, lo:hi].T
        else:
            lr = lam[lo:hi]
            dx = (_mm(g * (1.0 - lr), mm_dtype) @ wm[:, lo:hi].T
                  + _mm(g * lr, mm_dtype) @ mm[:, lo:hi].T)
        dx_parts.append(dx)
        row_parts.append(torch.stack([dt[:, lo:hi].sum(1),
                                      dscale[:, lo:hi].sum(1)]))
    return torch.stack(dx_parts), torch.stack(row_parts)


def fused_ce_bwd_dx_combine_plain(dx_parts, row_parts, t, scale, g_t):
    """(dx, dt, dscale): the ranges' partials summed, plus the direct path
    target_logit = scale * t."""
    dt, dscale = row_parts.sum(0)
    return dx_parts.sum(0), dt + g_t * scale, dscale + g_t * t


def fused_ce_bwd_dw_partials_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode: int,
                                   clamp_eps: Optional[float] = None, *,
                                   splits: int, range_rows: int, memn=None,
                                   lam=None, mm_dtype=torch.float32
                                   ) -> torch.Tensor:
    """Per-range partials of dw, [S, D, C]: xn^T . dcos over the rows of
    each range (a range past N gives zeros). With memn and lam, the
    dcos * (1 - lam) share; with mm_dtype=torch.bfloat16, the products on
    bf16 operands (xn, and dcos or its share)."""
    dcos, _, _ = _dcos_terms_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                   mode, clamp_eps, memn, lam, mm_dtype)
    if memn is not None:
        dcos = dcos * (1.0 - lam)
    xm, dm = _mm(xn, mm_dtype), _mm(dcos, mm_dtype)
    return torch.stack([xm[lo:hi].T @ dm[lo:hi] for lo, hi
                        in split_ranges(xn.shape[0], splits, range_rows)])


def fused_ce_bwd_dw_combine_plain(parts) -> torch.Tensor:
    """dw: the ranges' partials summed in the order s = 0, 1, ..."""
    dw = parts[0].clone()
    for p in parts[1:]:
        dw += p
    return dw


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
        # each _mem entry takes memn and lam right after wn; each entry a
        # workspace after its outputs
        for name, ptrs in (("fused_ce_fwd", 10), ("fused_ce_bwd_dx", 12),
                           ("fused_ce_bwd_dw", 9)):
            for mem, extra in (("", 0), ("_mem", 2)):
                for bf16 in ("", "_bf16"):
                    fn = getattr(lib, name + mem + bf16)
                    fn.argtypes = ([_P] * (ptrs + extra + 1) + [_I] * 5
                                   + [_F, _P])
                    fn.restype = _I
        lib.fused_ce_smem_bytes.argtypes = [_I, _I]
        lib.fused_ce_smem_bytes.restype = ctypes.c_size_t
        lib.fused_ce_range_cols.argtypes = [_I] * 3
        lib.fused_ce_range_cols.restype = _I
        lib.fused_ce_dw_range_rows.argtypes = [_I] * 3
        lib.fused_ce_dw_range_rows.restype = _I
        lib.fused_ce_workspace_floats.argtypes = [_I] * 4
        lib.fused_ce_workspace_floats.restype = ctypes.c_size_t
        lib.fused_ce_fwd_combine.argtypes = [_P] * 6 + [_I] * 2 + [_P]
        lib.fused_ce_fwd_combine.restype = _I
        lib.fused_ce_bwd_dx_combine.argtypes = [_P] * 8 + [_I] * 3 + [_P]
        lib.fused_ce_bwd_dx_combine.restype = _I
        lib.fused_ce_bwd_dw_combine.argtypes = [_P] * 2 + [_I] * 3 + [_P]
        lib.fused_ce_bwd_dw_combine.restype = _I
        lib._typed = True
    return lib


def _check(name, xn, wn, labels, rows, ab, mem=()):
    """Device, type, shape and contiguity of a wrapper's inputs; `mem` is ()
    or (memn, lam)."""
    n, d = xn.shape
    if wn.dim() != 2 or wn.shape[0] != d:
        raise ValueError(f"{name}: wn must be [D={d}, C], got {tuple(wn.shape)}")
    if mem:
        memn, lam = mem
        if memn.shape != wn.shape or lam.shape != (wn.shape[1],):
            raise ValueError(f"{name}: memn must be [D, C] like wn and lam "
                             f"[C={wn.shape[1]}]")
    if labels.shape != (n,) or labels.dtype != torch.int32:
        raise ValueError(f"{name}: labels must be int32 [N={n}]")
    if ab.shape != (n, 2):
        raise ValueError(f"{name}: ab must be [N={n}, 2]")
    for r in rows:
        if r.shape != (n,):
            raise ValueError(f"{name}: row scalars must be [N={n}]")
    for x in (xn, wn, ab, *rows, *mem):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")
    for x in (xn, wn, labels, ab, *rows, *mem):
        if x.device != xn.device:
            raise ValueError(f"{name}: all inputs must be on {xn.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if xn.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got "
                         f"{xn.device}")


def _kernel(name, which, mm_dtype):
    """(entry name, shared-memory index) of the fp32 kernel `name` or its
    bf16 counterpart."""
    _check_mm_dtype(mm_dtype)
    if mm_dtype == torch.bfloat16:
        return name + "_bf16", which + 6
    return name, which


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
    if torch.cuda.is_current_stream_capturing():
        captured_counts[name] += 1
    else:
        launch_counts[name] += 1


def _ptr(x):
    return x.data_ptr()


def _check_width(name, which, d):
    """The bwd_dx and bwd_dw kernels, fp32 and bf16, take D up to
    _MAX_SPLIT_WIDTH."""
    if which % 3 != 0 and d > _MAX_SPLIT_WIDTH:
        raise ValueError(f"{name}: embedding width {d} above the kernel's "
                         f"{_MAX_SPLIT_WIDTH}")


def _eps_args(clamp_eps):
    return (0, 0.0) if clamp_eps is None else (1, float(clamp_eps))


def split_plan(n: int, c: int, dx: bool = False, device=None,
               mm_dtype=torch.float32) -> Tuple[int, int]:
    """(ranges S, columns per range) of the fwd (or, with `dx`, bwd_dx)
    kernels, fp32 or with mm_dtype=torch.bfloat16 bf16, at (n, c) on the card
    `device`: at least two blocks per SM where C allows."""
    _check_mm_dtype(mm_dtype)
    which = int(dx) + (6 if mm_dtype == torch.bfloat16 else 0)
    with torch.cuda.device(device):
        cols = _lib().fused_ce_range_cols(which, n, c)
    return max(1, -(-c // cols)), cols


def dw_split_plan(n: int, c: int, device=None, mm_dtype=torch.float32,
                  mem: bool = False) -> Tuple[int, int]:
    """(ranges S, rows per range) of the bwd_dw kernels (with `mem` the
    _mem ones), fp32 or with mm_dtype=torch.bfloat16 bf16, at (n, c) on the
    card `device`: at least two blocks per SM where N allows."""
    which = _kernel("", 5 if mem else 2, mm_dtype)[1]
    with torch.cuda.device(device):
        rows = _lib().fused_ce_dw_range_rows(which, n, c)
    return max(1, -(-n // rows)), rows


def _workspace(which, n, d, c, device):
    """The workspace an entry fills (fused_ce_workspace_floats: partials,
    none for a bwd_dw of one range; for the bf16 entries their bf16
    operands after the partials)."""
    floats = _lib().fused_ce_workspace_floats(which, n, d, c)
    return torch.empty(floats, dtype=torch.float32, device=device)


def _fwd(name, which, xn, wn, mem, labels, t, tcos, scale, ab, mode,
         clamp_eps, mm_dtype, parts=None) -> FusedHeadOut:
    """The forward entry; `parts`, a list, receives its workspace, which
    starts with the per-range partials ([S, 3, N] flattened)."""
    name, which = _kernel(name, which, mm_dtype)
    _check(name, xn, wn, labels, (t, tcos, scale), ab, mem)
    n, d = xn.shape
    out = torch.empty((3, n), dtype=torch.float32, device=xn.device)
    if n:
        with torch.cuda.device(xn.device):
            ws = _workspace(which, n, d, wn.shape[1], xn.device)
            _launch(name, which, d, _ptr(xn), _ptr(wn), *map(_ptr, mem),
                    _ptr(labels), _ptr(t), _ptr(tcos), _ptr(scale), _ptr(ab),
                    _ptr(out[0]), _ptr(out[1]), _ptr(out[2]),
                    _ptr(ws), n, d, wn.shape[1], mode,
                    *_eps_args(clamp_eps))
            if parts is not None:
                parts.append(ws)
    return FusedHeadOut(out[0], out[1], out[2])


def _bwd_dx(name, which, xn, wn, mem, labels, t, scale, ab, lse, g_lse, g_t,
            mode, clamp_eps, mm_dtype, parts=None):
    """The dx entry; `parts`, a list, receives its workspace, which starts
    with the per-range partials (dx [S, N, round4(D)], then [S, 2, N])."""
    name, which = _kernel(name, which, mm_dtype)
    _check(name, xn, wn, labels, (t, scale, lse, g_lse, g_t), ab, mem)
    n, d = xn.shape
    _check_width(name, which, d)
    dx = torch.empty_like(xn)
    rows = torch.empty((2, n), dtype=torch.float32, device=xn.device)
    if n:
        with torch.cuda.device(xn.device):
            ws = _workspace(which, n, d, wn.shape[1], xn.device)
            _launch(name, which, d, _ptr(xn), _ptr(wn), *map(_ptr, mem),
                    _ptr(labels), _ptr(t), _ptr(scale), _ptr(ab), _ptr(lse),
                    _ptr(g_lse), _ptr(g_t), _ptr(dx), _ptr(rows[0]),
                    _ptr(rows[1]), _ptr(ws), n, d, wn.shape[1], mode,
                    *_eps_args(clamp_eps))
            if parts is not None:
                parts.append(ws)
    return dx, rows[0], rows[1]


def dx_workspace_views(ws, splits: int, n: int, d: int):
    """(dx [S, N, D], rows [S, 2, N]) views of the partials at the front of
    a bwd_dx workspace (fp32 or bf16)."""
    dp = -(-d // 4) * 4
    dx = ws[:splits * n * dp].view(splits, n, dp)[:, :, :d]
    return dx, ws[splits * n * dp:splits * n * (dp + 2)].view(splits, 2, n)


def fused_ce_fwd_combine(parts, t, scale) -> FusedHeadOut:
    """The forward's combine on partials [S, 3, N] (the combine kernel on
    the card, `fused_ce_fwd_combine_plain` on the CPU). The fp32 forward
    entries launch the same kernel themselves."""
    if parts.device.type == "cpu":
        return fused_ce_fwd_combine_plain(parts, t, scale)
    splits, _, n = parts.shape
    parts = parts.contiguous()
    out = torch.empty((3, n), dtype=torch.float32, device=parts.device)
    with torch.cuda.device(parts.device):
        err = _lib().fused_ce_fwd_combine(
            _ptr(parts), _ptr(t), _ptr(scale), _ptr(out[0]), _ptr(out[1]),
            _ptr(out[2]), n, splits, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd_combine: CUDA error {err} at launch")
    return FusedHeadOut(out[0], out[1], out[2])


def fused_ce_bwd_dx_combine(dx_parts, row_parts, t, scale, g_t):
    """dx's combine on partials dx [S, N, D], rows [S, 2, N] (the combine
    kernel on the card, `fused_ce_bwd_dx_combine_plain` on the CPU)."""
    if dx_parts.device.type == "cpu":
        return fused_ce_bwd_dx_combine_plain(dx_parts, row_parts, t, scale,
                                             g_t)
    splits, n, d = dx_parts.shape
    dp = -(-d // 4) * 4
    ws = torch.zeros(splits * n * dp + 2 * splits * n, dtype=torch.float32,
                     device=dx_parts.device)
    ws_dx, ws_rows = dx_workspace_views(ws, splits, n, d)
    ws_dx.copy_(dx_parts)
    ws_rows.copy_(row_parts)
    dx = torch.empty((n, d), dtype=torch.float32, device=dx_parts.device)
    rows = torch.empty((2, n), dtype=torch.float32, device=dx_parts.device)
    with torch.cuda.device(dx_parts.device):
        err = _lib().fused_ce_bwd_dx_combine(
            _ptr(ws), _ptr(ws_rows), _ptr(t), _ptr(scale), _ptr(g_t),
            _ptr(dx), _ptr(rows[0]), _ptr(rows[1]), n, d, splits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_bwd_dx_combine: CUDA error {err} at "
                           "launch")
    return dx, rows[0], rows[1]


def _bwd_dw(name, which, xn, wn, mem, labels, t, scale, ab, lse, g_lse, mode,
            clamp_eps, mm_dtype, parts=None):
    """The dw entry; `parts`, a list, receives its workspace, which starts
    with the per-range partials ([S, D, C] flattened; none when S = 1, where
    the kernel writes dw itself; a bf16 launch's bf16 xn follows them)."""
    name, which = _kernel(name, which, mm_dtype)
    _check(name, xn, wn, labels, (t, scale, lse, g_lse), ab, mem)
    n, d = xn.shape
    _check_width(name, which, d)
    dw = torch.zeros_like(wn) if n == 0 else torch.empty_like(wn)
    if n:
        with torch.cuda.device(xn.device):
            ws = _workspace(which, n, d, wn.shape[1], xn.device)
            _launch(name, which, d, _ptr(xn), _ptr(wn), *map(_ptr, mem),
                    _ptr(labels), _ptr(t), _ptr(scale), _ptr(ab), _ptr(lse),
                    _ptr(g_lse), _ptr(dw), _ptr(ws), n, d, wn.shape[1],
                    mode, *_eps_args(clamp_eps))
            if parts is not None:
                parts.append(ws)
    return dw


def fused_ce_bwd_dw_combine(parts):
    """dw's combine on partials [S, D, C] (the combine kernel on the card,
    `fused_ce_bwd_dw_combine_plain` on the CPU)."""
    if parts.device.type == "cpu":
        return fused_ce_bwd_dw_combine_plain(parts)
    splits, d, c = parts.shape
    parts = parts.contiguous()
    dw = torch.empty((d, c), dtype=torch.float32, device=parts.device)
    with torch.cuda.device(parts.device):
        err = _lib().fused_ce_bwd_dw_combine(
            _ptr(parts), _ptr(dw), d, c, splits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_bwd_dw_combine: CUDA error {err} at "
                           "launch")
    return dw


def fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, mode: int,
                 clamp_eps: Optional[float] = None,
                 mm_dtype=torch.float32) -> FusedHeadOut:
    """Forward statistics (lse, target_logit, higher), each [N] fp32.
    mm_dtype=torch.bfloat16 launches `fused_ce_fwd_bf16`."""
    if xn.device.type == "cpu":
        return fused_margin_ce_plain(xn, wn, labels, t, tcos, scale, ab, mode,
                                     clamp_eps, mm_dtype)
    return _fwd("fused_ce_fwd", 0, xn, wn, (), labels, t, tcos, scale, ab,
                mode, clamp_eps, mm_dtype)


def fused_ce_bwd_dx(xn, wn, labels, t, scale, ab, lse, g_lse, g_t, mode: int,
                    clamp_eps: Optional[float] = None,
                    mm_dtype=torch.float32):
    """(dx [N, D], dt [N], dscale [N]): the row-major half of the backward."""
    if xn.device.type == "cpu":
        return fused_ce_bwd_dx_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                     g_t, mode, clamp_eps, mm_dtype)
    return _bwd_dx("fused_ce_bwd_dx", 1, xn, wn, (), labels, t, scale, ab,
                   lse, g_lse, g_t, mode, clamp_eps, mm_dtype)


def fused_ce_bwd_dw(xn, wn, labels, t, scale, ab, lse, g_lse, mode: int,
                    clamp_eps: Optional[float] = None,
                    mm_dtype=torch.float32):
    """dw [D, C]: the class-major half of the backward."""
    if xn.device.type == "cpu":
        return fused_ce_bwd_dw_plain(xn, wn, labels, t, scale, ab, lse, g_lse,
                                     mode, clamp_eps, mm_dtype)
    return _bwd_dw("fused_ce_bwd_dw", 2, xn, wn, (), labels, t, scale, ab,
                   lse, g_lse, mode, clamp_eps, mm_dtype)


def fused_ce_fwd_mem(xn, wn, memn, lam, labels, t, tcos, scale, ab,
                     mode: int, clamp_eps: Optional[float] = None,
                     mm_dtype=torch.float32) -> FusedHeadOut:
    """Memory-blended forward statistics (lse, target_logit, higher)."""
    if xn.device.type == "cpu":
        return fused_margin_ce_mem_plain(xn, wn, memn, lam, labels, t, tcos,
                                         scale, ab, mode, clamp_eps, mm_dtype)
    return _fwd("fused_ce_fwd_mem", 3, xn, wn, (memn, lam), labels, t, tcos,
                scale, ab, mode, clamp_eps, mm_dtype)


def fused_ce_bwd_dx_mem(xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse,
                        g_t, mode: int, clamp_eps: Optional[float] = None,
                        mm_dtype=torch.float32):
    """(dx, dt, dscale) of the memory-blended head."""
    if xn.device.type == "cpu":
        return fused_ce_bwd_dx_mem_plain(xn, wn, memn, lam, labels, t, scale,
                                         ab, lse, g_lse, g_t, mode, clamp_eps,
                                         mm_dtype)
    return _bwd_dx("fused_ce_bwd_dx_mem", 4, xn, wn, (memn, lam), labels, t,
                   scale, ab, lse, g_lse, g_t, mode, clamp_eps, mm_dtype)


def fused_ce_bwd_dw_mem(xn, wn, memn, lam, labels, t, scale, ab, lse, g_lse,
                        mode: int, clamp_eps: Optional[float] = None,
                        mm_dtype=torch.float32):
    """dw [D, C] of the memory-blended head (the (1 - lam) share)."""
    if xn.device.type == "cpu":
        return fused_ce_bwd_dw_mem_plain(xn, wn, memn, lam, labels, t, scale,
                                         ab, lse, g_lse, mode, clamp_eps,
                                         mm_dtype)
    return _bwd_dw("fused_ce_bwd_dw_mem", 5, xn, wn, (memn, lam), labels, t,
                   scale, ab, lse, g_lse, mode, clamp_eps, mm_dtype)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _row_grads(g_lse, g_t, lse):
    """Upstream gradients of lse and target_logit as contiguous fp32 [N]."""
    def grad(g):
        return (torch.zeros_like(lse) if g is None
                else g.contiguous().float())
    return grad(g_lse), grad(g_t)


class _FusedMarginCE(torch.autograd.Function):
    """Gradients for xn, wn, t and scale, None for labels, tcos and ab; the
    gradient of `higher` is ignored (it is a statistic). This is the JAX
    custom VJP's contract exactly: for the MV / curricular modes no gradient
    reaches a / b even where a depends on tcos."""

    @staticmethod
    def forward(ctx, xn, wn, labels, t, tcos, scale, ab, mode, clamp_eps,
                mm_dtype):
        out = fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, mode,
                           clamp_eps, mm_dtype)
        ctx.save_for_backward(xn, wn, labels, t, scale, ab, out.lse)
        ctx.mode, ctx.clamp_eps, ctx.mm_dtype = mode, clamp_eps, mm_dtype
        ctx.mark_non_differentiable(out.higher)
        return out.lse, out.target_logit, out.higher

    @staticmethod
    def backward(ctx, g_lse, g_t, _g_higher):
        xn, wn, labels, t, scale, ab, lse = ctx.saved_tensors
        g_lse, g_t = _row_grads(g_lse, g_t, lse)
        dx, dt, dscale = fused_ce_bwd_dx(xn, wn, labels, t, scale, ab, lse,
                                         g_lse, g_t, ctx.mode, ctx.clamp_eps,
                                         ctx.mm_dtype)
        dw = fused_ce_bwd_dw(xn, wn, labels, t, scale, ab, lse, g_lse,
                             ctx.mode, ctx.clamp_eps, ctx.mm_dtype)
        return dx, dw, None, dt, None, dscale, None, None, None, None


def fused_margin_ce(xn, wn, labels, t, tcos, scale, ab, mode: int,
                    clamp_eps: Optional[float] = None,
                    mm_dtype=torch.float32) -> FusedHeadOut:
    """Fused margin + cross-entropy statistics over all classes.

    xn [N, D] row-normalised embeddings; wn [D, C] column-normalised class
    weights; labels [N] (a label outside [0, C) marks no target column);
    t [N] target value before scaling; tcos [N] target cosine before the
    margin; scale [N]; ab [N, 2] mode parameters. Returns
    (lse [N], target_logit [N], higher [N]), all fp32.

    mm_dtype=torch.bfloat16 runs the products on bf16 operands with fp32
    accumulation (the bf16 tensor-core kernels on the card): about 1e-2 of
    logit error. The fp32 default keeps parity with the fp32 reference.
    """
    f32 = lambda x: x.to(torch.float32).contiguous()
    lse, tlogit, higher = _FusedMarginCE.apply(
        f32(xn), f32(wn), labels.to(torch.int32).contiguous(), f32(t),
        f32(tcos), f32(scale), f32(ab), mode, clamp_eps, mm_dtype)
    return FusedHeadOut(lse, tlogit, higher)


class _FusedMarginCEMem(torch.autograd.Function):
    """The memory-blended head with the JAX VJP's contract: gradients for xn,
    wn, t and scale; None for memn, lam, labels, tcos and ab (the heads
    update their memories without gradient)."""

    @staticmethod
    def forward(ctx, xn, wn, memn, lam, labels, t, tcos, scale, ab, mode,
                clamp_eps, mm_dtype):
        out = fused_ce_fwd_mem(xn, wn, memn, lam, labels, t, tcos, scale, ab,
                               mode, clamp_eps, mm_dtype)
        ctx.save_for_backward(xn, wn, memn, lam, labels, t, scale, ab,
                              out.lse)
        ctx.mode, ctx.clamp_eps, ctx.mm_dtype = mode, clamp_eps, mm_dtype
        ctx.mark_non_differentiable(out.higher)
        return out.lse, out.target_logit, out.higher

    @staticmethod
    def backward(ctx, g_lse, g_t, _g_higher):
        xn, wn, memn, lam, labels, t, scale, ab, lse = ctx.saved_tensors
        g_lse, g_t = _row_grads(g_lse, g_t, lse)
        dx, dt, dscale = fused_ce_bwd_dx_mem(xn, wn, memn, lam, labels, t,
                                             scale, ab, lse, g_lse, g_t,
                                             ctx.mode, ctx.clamp_eps,
                                             ctx.mm_dtype)
        dw = fused_ce_bwd_dw_mem(xn, wn, memn, lam, labels, t, scale, ab, lse,
                                 g_lse, ctx.mode, ctx.clamp_eps, ctx.mm_dtype)
        return (dx, dw, None, None, None, dt, None, dscale, None, None, None,
                None)


def fused_margin_ce_mem(xn, wn, memn, lam, labels, t, tcos, scale, ab,
                        mode: int, clamp_eps: Optional[float] = None,
                        mm_dtype=torch.float32) -> FusedHeadOut:
    """Fused margin + cross-entropy with a per-class memory blend on every
    column (the target column's logit is scale * t whatever its blend).

    memn [D, C] column-normalised memory prototypes; lam [C] blend weights
    (0 leaves a class unblended). The other arguments, mm_dtype among them,
    and the result are those of `fused_margin_ce`.
    """
    f32 = lambda x: x.to(torch.float32).contiguous()
    lse, tlogit, higher = _FusedMarginCEMem.apply(
        f32(xn), f32(wn), f32(memn), f32(lam),
        labels.to(torch.int32).contiguous(), f32(t), f32(tcos), f32(scale),
        f32(ab), mode, clamp_eps, mm_dtype)
    return FusedHeadOut(lse, tlogit, higher)
