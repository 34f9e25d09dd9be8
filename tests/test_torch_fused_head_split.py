"""The split decomposition of the port's fp32 kernels against the unsplit
head and the JAX package's.

On the card `fused_ce_fwd(_mem)` and `fused_ce_bwd_dx(_mem)` cut the class
axis into ranges, compute per-range partials (m, l, higher; dx, dt, dscale)
and combine them in a second launch; `fused_ce_bwd_dw(_mem)` cuts the row
axis into ranges and sums their dw. `fused_ce_*_partials_plain` and
`fused_ce_*_combine_plain` are that decomposition in plain PyTorch; here it
runs for S = 1, 3, 7 and 10 ranges of whole 16-column tiles at C = 100 (not
a tile multiple; S = 10 leaves three ranges empty), or of ceil(N / S) rows
at N = 24 (S = 7 and 10 leave ranges past N), and is held against the
unsplit plain versions, the JAX package's `fused_margin_ce` /
`fused_margin_ce_mem` in interpret mode (block_n=16, block_c=64, as
tests/test_torch_fused_head.py runs them), and the JAX backward for dx, dt,
dscale and dw: its single sweep (_bwd_fused_kernel) and, for dw, its
two-kernel form (_bwd_dw_kernel, K3b). Inputs are made with numpy from a
seed: all three margin modes, an out-of-range label, and for the memory
blend lam mixing 0, 0.15 and 1.

Tolerances are those of tests/test_torch_fused_head.py and
tests/test_torch_fused_head_mem.py: lse / target logit rtol = atol = 2e-5
(fp32 logsumexp summed in different orders), `higher` exact, gradients rtol
5e-4 with atol 2e-6 (1e-6 with the memory blend).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.ops import fused_head as jfh
from face_recognition_models_tpu_torch.ops import fused_head as tfh

N, D, C = 24, 64, 100   # C deliberately not a multiple of the tiles
TILE = 16
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = {False: dict(rtol=5e-4, atol=2e-6),
            True: dict(rtol=5e-4, atol=1e-6)}
MODES = [(tfh.MODE_IDENTITY, None), (tfh.MODE_MV, 1e-7),
         (tfh.MODE_CURRICULAR, 0.0)]


def _ceil(a, b):
    return -(-a // b)


def _unit(x, axis):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _inputs(mode, seed=0):
    rs = np.random.RandomState(seed)
    xn = _unit(rs.randn(N, D), 1).astype(np.float32)
    wn = _unit(rs.randn(D, C), 0).astype(np.float32)
    memn = _unit(rs.randn(D, C), 0).astype(np.float32)
    lam = rs.choice(np.array([0.0, 0.15, 1.0], np.float32), C)
    labels = rs.randint(0, C, N).astype(np.int32)
    labels[5] = C + 7  # out of range: marks no column as target
    labels[6] = C - 1  # the last column: alone in the last range below
    tcos = np.einsum("nd,dn->n", xn, wn[:, np.minimum(labels, C - 1)])
    tcos[5] = 0.1
    tcos = tcos.astype(np.float32)
    t = (tcos - 0.3).astype(np.float32)
    scale = rs.uniform(16.0, 64.0, N).astype(np.float32)
    if mode == tfh.MODE_IDENTITY:
        ab = np.zeros((N, 2), np.float32)
    else:
        ab = np.stack([tcos - 0.2, rs.uniform(1.05, 1.2, N)], 1)
        ab = ab.astype(np.float32)
    g_lse = rs.randn(N).astype(np.float32) / N
    g_t = rs.randn(N).astype(np.float32) / N
    return dict(xn=xn, wn=wn, memn=memn, lam=lam, labels=labels, t=t,
                tcos=tcos, scale=scale, ab=ab, g_lse=g_lse, g_t=g_t)


@functools.lru_cache(maxsize=None)
def _jax_reference(mode, clamp_eps, mem):
    """The JAX head's (lse, target_logit, higher, dx, dt, dscale, dw)."""
    x = _inputs(mode)
    const = {k: jnp.asarray(x[k]) for k in ("memn", "lam", "labels", "tcos",
                                             "ab")}

    def jfun(xn_, wn_, t_, scale_):
        if mem:
            return jfh.fused_margin_ce_mem(
                xn_, wn_, const["memn"], const["lam"], const["labels"], t_,
                const["tcos"], scale_, const["ab"], mode, clamp_eps, 16, 64,
                True)
        return jfh.fused_margin_ce(xn_, wn_, const["labels"], t_,
                                   const["tcos"], scale_, const["ab"], mode,
                                   clamp_eps, 16, 64, True)

    out, vjp = jax.vjp(jfun, *(jnp.asarray(x[k])
                               for k in ("xn", "wn", "t", "scale")))
    dx, dw, dt, dscale = vjp(jfh.FusedHeadOut(
        jnp.asarray(x["g_lse"]), jnp.asarray(x["g_t"]),
        jnp.zeros(N, jnp.float32)))
    return tuple(np.asarray(v) for v in (*out, dx, dt, dscale, dw))


def _split(x, mode, clamp_eps, mem, splits, range_cols):
    """Split-then-combine in plain PyTorch: (forward, (dx, dt, dscale)) and
    the two sets of partials."""
    kw = dict(memn=x["memn"], lam=x["lam"]) if mem else {}
    plan = dict(splits=splits, range_cols=range_cols)
    parts = tfh.fused_ce_fwd_partials_plain(
        x["xn"], x["wn"], x["labels"], x["t"], x["tcos"], x["scale"], x["ab"],
        mode, clamp_eps, **plan, **kw)
    out = tfh.fused_ce_fwd_combine_plain(parts, x["t"], x["scale"])
    dx_parts, row_parts = tfh.fused_ce_bwd_dx_partials_plain(
        x["xn"], x["wn"], x["labels"], x["t"], x["scale"], x["ab"], out.lse,
        x["g_lse"], mode, clamp_eps, **plan, **kw)
    grads = tfh.fused_ce_bwd_dx_combine_plain(dx_parts, row_parts, x["t"],
                                              x["scale"], x["g_t"])
    return out, grads, parts, (dx_parts, row_parts)


def _unsplit(x, mode, clamp_eps, mem):
    extra = (x["memn"], x["lam"]) if mem else ()
    sfx = "_mem" if mem else ""
    out = getattr(tfh, f"fused_margin_ce{sfx}_plain")(
        x["xn"], x["wn"], *extra, x["labels"], x["t"], x["tcos"], x["scale"],
        x["ab"], mode, clamp_eps)
    grads = getattr(tfh, f"fused_ce_bwd_dx{sfx}_plain")(
        x["xn"], x["wn"], *extra, x["labels"], x["t"], x["scale"], x["ab"],
        out.lse, x["g_lse"], x["g_t"], mode, clamp_eps)
    return out, grads


@pytest.mark.parametrize("splits", [1, 3, 7, 10])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_split_then_combine_matches_unsplit_and_jax(splits, mode, clamp_eps,
                                                    mem):
    x = {k: torch.tensor(v) for k, v in _inputs(mode).items()}
    range_cols = TILE * _ceil(_ceil(C, splits), TILE)
    ranges = tfh.split_ranges(C, splits, range_cols)
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    out, grads, parts, (dx_parts, row_parts) = _split(
        x, mode, clamp_eps, mem, splits, range_cols)
    assert parts.shape == (splits, 3, N)
    assert dx_parts.shape == (splits, N, D) and row_parts.shape == (splits,
                                                                    2, N)
    for (lo, hi), p, g in zip(ranges, parts, dx_parts):
        if hi == lo:  # an empty range carries nothing into the combine
            assert bool((p[0] == -1e30).all())
            assert float(p[1:].abs().max()) == 0
            assert float(g.abs().max()) == 0
    ref, ref_grads = _unsplit(x, mode, clamp_eps, mem)
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, **OUT_TOL)
    torch.testing.assert_close(out.higher, ref.higher, rtol=0, atol=0)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, **GRAD_TOL[mem])

    jlse, jtlogit, jhigher, jdx, jdt, jdscale, _ = _jax_reference(
        mode, clamp_eps, mem)
    np.testing.assert_allclose(out.lse.numpy(), jlse, **OUT_TOL)
    np.testing.assert_allclose(out.target_logit.numpy(), jtlogit, **OUT_TOL)
    np.testing.assert_array_equal(out.higher.numpy(), jhigher)
    for got, want, name in zip(grads, (jdx, jdt, jdscale),
                               ("dx", "dt", "dscale")):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                   **GRAD_TOL[mem])


@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_range_of_only_the_target_column(mode, clamp_eps, mem):
    """Two ranges, [0, 99) and [99, 100): for row 6 the last range holds only
    its target column (logit scale * t, no dcos, all of its dt); for row 5
    (out-of-range label) an ordinary column. The combine stays finite and
    equal to the unsplit head."""
    x = {k: torch.tensor(v) for k, v in _inputs(mode).items()}
    out, grads, parts, (dx_parts, row_parts) = _split(x, mode, clamp_eps, mem,
                                                      2, C - 1)
    assert bool(torch.isfinite(parts).all())
    last = parts[1]
    torch.testing.assert_close(last[0, 6], x["scale"][6] * x["t"][6])
    assert float(last[1, 6]) == 1.0 and float(last[2, 6]) == 0.0
    assert float(dx_parts[1, 6].abs().max()) == 0.0
    assert float(row_parts[1, 0, 6].abs()) > 0.0
    ref, ref_grads = _unsplit(x, mode, clamp_eps, mem)
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, **OUT_TOL)
    torch.testing.assert_close(out.higher, ref.higher, rtol=0, atol=0)
    for a, b in zip(grads, ref_grads):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, **GRAD_TOL[mem])


def test_combine_wrappers_compute_plain_versions_on_cpu():
    """On CPU tensors the combine wrappers return the plain combine exactly
    and launch nothing."""
    x = {k: torch.tensor(v) for k, v in _inputs(tfh.MODE_MV, seed=2).items()}
    tfh.reset_launch_counts()
    _, _, parts, (dx_parts, row_parts) = _split(x, tfh.MODE_MV, 1e-7, True,
                                                3, 48)
    for a, b in zip(tfh.fused_ce_fwd_combine(parts, x["t"], x["scale"]),
                    tfh.fused_ce_fwd_combine_plain(parts, x["t"],
                                                   x["scale"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(
            tfh.fused_ce_bwd_dx_combine(dx_parts, row_parts, x["t"],
                                        x["scale"], x["g_t"]),
            tfh.fused_ce_bwd_dx_combine_plain(dx_parts, row_parts, x["t"],
                                              x["scale"], x["g_t"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dw_parts = _dw_split(x, tfh.MODE_MV, 1e-7, True, 3)
    torch.testing.assert_close(tfh.fused_ce_bwd_dw_combine(dw_parts),
                               tfh.fused_ce_bwd_dw_combine_plain(dw_parts),
                               rtol=0, atol=0)
    assert all(v == 0 for v in tfh.launch_counts.values())


def _dw_split(x, mode, clamp_eps, mem, splits):
    """dw's per-range partials [S, D, C] in plain PyTorch, over S ranges of
    ceil(N / S) rows, with the lse of the unsplit plain forward."""
    kw = dict(memn=x["memn"], lam=x["lam"]) if mem else {}
    out, _ = _unsplit(x, mode, clamp_eps, mem)
    return tfh.fused_ce_bwd_dw_partials_plain(
        x["xn"], x["wn"], x["labels"], x["t"], x["scale"], x["ab"], out.lse,
        x["g_lse"], mode, clamp_eps, splits=splits,
        range_rows=_ceil(N, splits), **kw)


def _dw_unsplit(x, mode, clamp_eps, mem):
    extra = (x["memn"], x["lam"]) if mem else ()
    out, _ = _unsplit(x, mode, clamp_eps, mem)
    return getattr(tfh, f"fused_ce_bwd_dw{'_mem' if mem else ''}_plain")(
        x["xn"], x["wn"], *extra, x["labels"], x["t"], x["scale"], x["ab"],
        out.lse, x["g_lse"], mode, clamp_eps)


def _check_dw_split(x, mode, clamp_eps, mem, splits, *wants):
    """Split-then-combine of dw over `splits` row ranges against each of
    `wants`: ranges past N carry exact zeros, and with the blend the lam = 1
    columns of every partial and of dw are exactly 0."""
    parts = _dw_split(x, mode, clamp_eps, mem, splits)
    assert parts.shape == (splits, D, C)
    for part, (lo, hi) in zip(parts, tfh.split_ranges(N, splits,
                                                      _ceil(N, splits))):
        if hi == lo:
            assert float(part.abs().max()) == 0.0
    dw = tfh.fused_ce_bwd_dw_combine_plain(parts)
    if mem:
        assert float(parts[:, :, x["lam"] == 1].abs().max()) == 0.0
        assert float(dw[:, x["lam"] == 1].abs().max()) == 0.0
    for want in wants:
        np.testing.assert_allclose(dw.numpy(), want, **GRAD_TOL[mem])


@pytest.mark.parametrize("splits", [1, 3, 7, 10])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_dw_split_then_combine_matches_unsplit_and_jax(splits, mode,
                                                       clamp_eps, mem):
    """dw over S row ranges, summed in range order, against the unsplit
    plain dw and the JAX single-sweep backward's."""
    x = {k: torch.tensor(v) for k, v in _inputs(mode).items()}
    _check_dw_split(x, mode, clamp_eps, mem, splits,
                    _dw_unsplit(x, mode, clamp_eps, mem).numpy(),
                    _jax_reference(mode, clamp_eps, mem)[-1])


@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_dw_split_matches_jax_two_kernel_backward(monkeypatch, mode,
                                                  clamp_eps, mem):
    """The JAX package takes its two-kernel backward (_bwd_dx_kernel, then
    _bwd_dw_kernel: K3b) when the dx scratch would pass its VMEM budget; a
    budget of 0 sends N = 24 there. dw split over S = 1, 3, 7 and 10 row
    ranges against that dw."""
    calls = []

    def counted(*refs, **kw):
        calls.append(1)
        return bwd_dw_kernel(*refs, **kw)

    bwd_dw_kernel = jfh._bwd_dw_kernel
    monkeypatch.setattr(jfh, "_DX_SCRATCH_BUDGET", 0)
    monkeypatch.setattr(jfh, "_bwd_dw_kernel", counted)
    x = _inputs(mode)
    const = {k: jnp.asarray(x[k]) for k in ("memn", "lam", "labels", "tcos",
                                             "ab")}

    def jfun(wn_):
        if mem:
            return jfh.fused_margin_ce_mem(
                jnp.asarray(x["xn"]), wn_, const["memn"], const["lam"],
                const["labels"], jnp.asarray(x["t"]), const["tcos"],
                jnp.asarray(x["scale"]), const["ab"], mode, clamp_eps, 16, 64,
                True)
        return jfh.fused_margin_ce(
            jnp.asarray(x["xn"]), wn_, const["labels"], jnp.asarray(x["t"]),
            const["tcos"], jnp.asarray(x["scale"]), const["ab"], mode,
            clamp_eps, 16, 64, True)

    _, vjp = jax.vjp(jfun, jnp.asarray(x["wn"]))
    (jdw,) = vjp(jfh.FusedHeadOut(jnp.asarray(x["g_lse"]),
                                  jnp.asarray(x["g_t"]),
                                  jnp.zeros(N, jnp.float32)))
    assert calls, "the two-kernel backward did not run"
    xt = {k: torch.tensor(v) for k, v in x.items()}
    for splits in (1, 3, 7, 10):
        _check_dw_split(xt, mode, clamp_eps, mem, splits, np.asarray(jdw))
