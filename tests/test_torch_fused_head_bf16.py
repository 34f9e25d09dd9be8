"""The port's bf16 option of the fused head (`mm_dtype=torch.bfloat16`)
against the JAX package's `mm_dtype=jnp.bfloat16`.

The JAX side runs its Pallas kernels in interpret mode with small tiles
(block_n=16, block_c=64), as its own tests do; the port's side runs the plain
PyTorch versions, which round the product operands to bf16 at the same six
places as the Pallas kernels and multiply in fp32. Inputs are made with
numpy from a seed and handed to both; the memory-blended case mixes lam of
0, 0.15 and 1. The tolerances are those of tests/test_torch_fused_head.py:
outputs rtol = atol = 2e-5, `higher` exact, gradients rtol 5e-4 atol 2e-6.
Both sides multiply the same bf16-rounded operands exactly and sum in fp32
in different orders. dcos is rounded to bf16 after an fp32 computation
whose order differs too, so a dcos within that difference of a bf16
rounding boundary could round one way in JAX and the other in the port,
moving one term of dx or dw by one bf16 ulp; on these inputs that does not
happen at a visible size: the largest gradient difference measured over the
six cases is 3.6e-7 (dx), the largest lse difference 3.8e-6.

The split-C decomposition of the bf16 forward and dx (the kernels' per-range
partials and their combine, in plain PyTorch) is held against the same JAX
functions over several range plans, a last range past C among them; dx also
against the JAX package's two-kernel backward (_bwd_dx_kernel), reached with
its dx scratch budget set to 0. The bf16 dw's split over row ranges is held
the same way, over row plans with a ragged range and a range past N,
against the single sweep and the two-kernel backward (_bwd_dw_kernel). The
tolerances are the ones above.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.ops import fused_head as jfh
from face_recognition_models_tpu_torch.ops import fused_head as tfh

N, D, C = 24, 64, 100   # C deliberately not a multiple of block_c
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=2e-6)
MODES = [(tfh.MODE_IDENTITY, None), (tfh.MODE_MV, 1e-7),
         (tfh.MODE_CURRICULAR, 0.0)]
GRADS = ("dx", "dw", "dt", "dscale")


def _unit(x, axis):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _inputs(mode, seed=0, mem=False):
    rs = np.random.RandomState(seed)
    xn = _unit(rs.randn(N, D), 1).astype(np.float32)
    wn = _unit(rs.randn(D, C), 0).astype(np.float32)
    labels = rs.randint(0, C, N).astype(np.int32)
    labels[5] = C + 7  # out of range: marks no column as target
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
    x = dict(xn=xn, wn=wn, labels=labels, t=t, tcos=tcos, scale=scale, ab=ab,
             g_lse=rs.randn(N).astype(np.float32) / N,
             g_t=rs.randn(N).astype(np.float32) / N)
    if mem:
        x["memn"] = _unit(rs.randn(D, C), 0).astype(np.float32)
        x["lam"] = rs.choice(np.array([0.0, 0.15, 1.0], np.float32), C)
    return x


def _jax(x, mode, clamp_eps, mm_dtype):
    """The JAX package's forward and VJP (dx, dw, dt, dscale)."""
    mem = "memn" in x
    const = {k: jnp.asarray(x[k]) for k in ("labels", "tcos", "ab", "memn",
                                             "lam") if k in x}

    def fun(xn, wn, t, scale):
        if mem:
            return jfh.fused_margin_ce_mem(
                xn, wn, const["memn"], const["lam"], const["labels"], t,
                const["tcos"], scale, const["ab"], mode, clamp_eps, 16, 64,
                True, mm_dtype)
        return jfh.fused_margin_ce(xn, wn, const["labels"], t, const["tcos"],
                                   scale, const["ab"], mode, clamp_eps, 16,
                                   64, True, mm_dtype)

    out, vjp = jax.vjp(fun, *(jnp.asarray(x[k])
                              for k in ("xn", "wn", "t", "scale")))
    grads = vjp(jfh.FusedHeadOut(jnp.asarray(x["g_lse"]),
                                 jnp.asarray(x["g_t"]),
                                 jnp.zeros(N, jnp.float32)))
    return out, [np.asarray(g) for g in grads]


def _torch(x, mode, clamp_eps, mm_dtype):
    """The port's forward and gradients through the public autograd API."""
    leaves = [torch.tensor(x[k], requires_grad=True)
              for k in ("xn", "wn", "t", "scale")]
    tx, tw, tt, ts = leaves
    rest = (torch.tensor(x["labels"]), tt, torch.tensor(x["tcos"]), ts,
            torch.tensor(x["ab"]), mode, clamp_eps)
    if "memn" in x:
        out = tfh.fused_margin_ce_mem(tx, tw, torch.tensor(x["memn"]),
                                      torch.tensor(x["lam"]), *rest,
                                      mm_dtype=mm_dtype)
    else:
        out = tfh.fused_margin_ce(tx, tw, *rest, mm_dtype=mm_dtype)
    ((out.lse * torch.tensor(x["g_lse"])).sum()
     + (out.target_logit * torch.tensor(x["g_t"])).sum()).backward()
    return out, [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_bf16_matches_jax(mode, clamp_eps, mem):
    x = _inputs(mode, seed=mode + 10 * mem, mem=mem)
    jout, jgrads = _jax(x, mode, clamp_eps, jnp.bfloat16)
    out, grads = _torch(x, mode, clamp_eps, torch.bfloat16)

    np.testing.assert_allclose(out.lse.detach().numpy(), np.asarray(jout.lse),
                               **OUT_TOL)
    np.testing.assert_allclose(out.target_logit.detach().numpy(),
                               np.asarray(jout.target_logit), **OUT_TOL)
    np.testing.assert_array_equal(out.higher.numpy(), np.asarray(jout.higher))
    for got, want, name in zip(grads, jgrads, GRADS):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_differs_from_fp32(mem):
    """The option takes effect: the bf16 products move the statistics by
    far more than the fp32 tolerance (bf16 keeps ~3 significant digits)."""
    x = _inputs(tfh.MODE_IDENTITY, seed=4, mem=mem)
    out16, _ = _torch(x, tfh.MODE_IDENTITY, None, torch.bfloat16)
    out32, _ = _torch(x, tfh.MODE_IDENTITY, None, torch.float32)
    gap = float((out16.lse - out32.lse).detach().abs().max())
    assert gap > 1e-4, gap


def test_bf16_loss_close_to_fp32():
    """The JAX package's own contract for the option
    (tests/test_fused_head.py::test_bf16_matmul_variant_close): the mean
    loss through bf16 products stays within 5% of the fp32 one, here on an
    ArcFace-like margin at scale 64."""
    x = _inputs(tfh.MODE_IDENTITY, seed=6)
    tcos = x["tcos"]
    x["t"] = np.cos(np.arccos(np.clip(tcos, -1, 1)) + 0.5).astype(np.float32)
    x["scale"] = np.full(N, 64.0, np.float32)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        out, _ = _torch(x, tfh.MODE_IDENTITY, None, dtype)
        losses[dtype] = float((out.lse - out.target_logit).detach().mean())
    loss32, loss16 = losses[torch.float32], losses[torch.bfloat16]
    assert abs(loss32 - loss16) / abs(loss32) < 0.05


def test_bf16_kernel_wrappers_compute_plain_versions_on_cpu():
    """On CPU tensors the six wrappers with mm_dtype=bfloat16 return their
    plain bf16 versions exactly and launch nothing."""
    x = {k: torch.tensor(v) for k, v in _inputs(tfh.MODE_MV, seed=3,
                                               mem=True).items()}
    tfh.reset_launch_counts()
    bf = dict(mm_dtype=torch.bfloat16)
    for mem in ((), (x["memn"], x["lam"])):
        sfx = "_mem" if mem else ""
        fwd = (x["xn"], x["wn"], *mem, x["labels"], x["t"], x["tcos"],
               x["scale"], x["ab"], tfh.MODE_MV, 1e-7)
        out = getattr(tfh, "fused_ce_fwd" + sfx)(*fwd, **bf)
        plain = getattr(tfh, f"fused_margin_ce{sfx}_plain")(*fwd, **bf)
        for a, b in zip(out, plain):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        bwd = (x["xn"], x["wn"], *mem, x["labels"], x["t"], x["scale"],
               x["ab"], out.lse, x["g_lse"])
        for got, want in zip(
                getattr(tfh, "fused_ce_bwd_dx" + sfx)(
                    *bwd, x["g_t"], tfh.MODE_MV, 1e-7, **bf),
                getattr(tfh, f"fused_ce_bwd_dx{sfx}_plain")(
                    *bwd, x["g_t"], tfh.MODE_MV, 1e-7, **bf)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(
            getattr(tfh, "fused_ce_bwd_dw" + sfx)(*bwd, tfh.MODE_MV, 1e-7,
                                                  **bf),
            getattr(tfh, f"fused_ce_bwd_dw{sfx}_plain")(*bwd, tfh.MODE_MV,
                                                        1e-7, **bf),
            rtol=0, atol=0)
    assert all(v == 0 for v in tfh.launch_counts.values())


def test_plain_bf16_rounds_the_operands_once():
    """The plain bf16 forward is the fp32 computation on operands rounded to
    bf16 once: feeding it pre-rounded fp32 operands changes nothing."""
    x = {k: torch.tensor(v) for k, v in _inputs(tfh.MODE_IDENTITY,
                                               seed=8).items()}
    r = lambda a: a.to(torch.bfloat16).to(torch.float32)
    rest = (x["labels"], x["t"], x["tcos"], x["scale"], x["ab"],
            tfh.MODE_IDENTITY)
    a = tfh.fused_margin_ce_plain(x["xn"], x["wn"], *rest,
                                  mm_dtype=torch.bfloat16)
    b = tfh.fused_margin_ce_plain(r(x["xn"]), r(x["wn"]), *rest)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_mm_dtypes_are_refused(dtype):
    x = {k: torch.tensor(v) for k, v in _inputs(tfh.MODE_IDENTITY,
                                               mem=True).items()}
    with pytest.raises(ValueError, match="mm_dtype"):
        tfh.fused_margin_ce(x["xn"], x["wn"], x["labels"], x["t"], x["tcos"],
                            x["scale"], x["ab"], tfh.MODE_IDENTITY,
                            mm_dtype=dtype)
    with pytest.raises(ValueError, match="mm_dtype"):
        tfh.fused_margin_ce_mem(x["xn"], x["wn"], x["memn"], x["lam"],
                                x["labels"], x["t"], x["tcos"], x["scale"],
                                x["ab"], tfh.MODE_IDENTITY, mm_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_forward(mode, clamp_eps, mem):
    x = _inputs(mode, seed=20 + mode + 10 * mem, mem=mem)
    out, _ = _jax(x, mode, clamp_eps, jnp.bfloat16)
    return x, [np.asarray(v) for v in out]


# (ranges S, columns per range) over C = 100: one range, a ragged last
# range, ranges of whole 32-wide tiles, and a last range past C (empty)
SPLIT_PLANS = [(1, 100), (3, 40), (4, 32), (5, 25), (6, 20)]


@pytest.mark.parametrize("splits,range_cols", SPLIT_PLANS)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_bf16_split_forward_matches_jax(mode, clamp_eps, mem, splits,
                                        range_cols):
    """The arithmetic of the bf16 split-C forward: per-range partials with
    bf16 products (fused_ce_fwd_partials_plain), merged by
    fused_ce_fwd_combine_plain, equal the JAX package's unsplit bf16
    forward (interpret mode)."""
    x, (lse, tlogit, higher) = _jax_forward(mode, clamp_eps, mem)
    t = {k: torch.tensor(v) for k, v in x.items()}
    kw = dict(memn=t["memn"], lam=t["lam"]) if mem else {}
    parts = tfh.fused_ce_fwd_partials_plain(
        t["xn"], t["wn"], t["labels"], t["t"], t["tcos"], t["scale"],
        t["ab"], mode, clamp_eps, splits=splits, range_cols=range_cols,
        mm_dtype=torch.bfloat16, **kw)
    assert parts.shape == (splits, 3, N)
    if splits * range_cols > C + range_cols - 1:   # a range past C
        assert bool((parts[-1, 0] == torch.tensor(-1e30)).all())
        assert float(parts[-1, 1:].abs().max()) == 0.0
    out = tfh.fused_ce_fwd_combine_plain(parts, t["t"], t["scale"])
    np.testing.assert_allclose(out.lse.numpy(), lse, **OUT_TOL)
    np.testing.assert_allclose(out.target_logit.numpy(), tlogit, **OUT_TOL)
    np.testing.assert_array_equal(out.higher.numpy(), higher)


@functools.lru_cache(maxsize=None)
def _jax_backward(mode, clamp_eps, mem):
    """Inputs and the JAX package's bf16 forward and (dx, dw, dt, dscale)
    through its single-sweep backward (interpret mode)."""
    x = _inputs(mode, seed=30 + mode + 10 * mem, mem=mem)
    out, grads = _jax(x, mode, clamp_eps, jnp.bfloat16)
    return x, np.asarray(out.lse), grads


def _check_dx_split(x, lse, mode, clamp_eps, splits, range_cols, jgrads):
    """The arithmetic of the bf16 split-C dx: per-range partials with bf16
    products (fused_ce_bwd_dx_partials_plain, on the JAX forward's lse),
    merged by fused_ce_bwd_dx_combine_plain, against the JAX package's bf16
    dx, dt and dscale; a range past C carries exact zeros."""
    t = {k: torch.tensor(v) for k, v in x.items()}
    kw = dict(memn=t["memn"], lam=t["lam"]) if "memn" in x else {}
    dx_parts, row_parts = tfh.fused_ce_bwd_dx_partials_plain(
        t["xn"], t["wn"], t["labels"], t["t"], t["scale"], t["ab"],
        torch.tensor(lse), t["g_lse"], mode, clamp_eps, splits=splits,
        range_cols=range_cols, mm_dtype=torch.bfloat16, **kw)
    assert dx_parts.shape == (splits, N, D)
    assert row_parts.shape == (splits, 2, N)
    for (lo, hi), p, r in zip(tfh.split_ranges(C, splits, range_cols),
                              dx_parts, row_parts):
        if hi == lo:
            assert float(p.abs().max()) == 0.0
            assert float(r.abs().max()) == 0.0
    got = tfh.fused_ce_bwd_dx_combine_plain(dx_parts, row_parts, t["t"],
                                            t["scale"], t["g_t"])
    for a, want, name in zip(got, (jgrads[0], jgrads[2], jgrads[3]),
                             ("dx", "dt", "dscale")):
        np.testing.assert_allclose(a.numpy(), want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("splits,range_cols", SPLIT_PLANS)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_bf16_split_dx_matches_jax(mode, clamp_eps, mem, splits, range_cols):
    """The bf16 split-C dx against the JAX package's bf16 single-sweep
    backward (_bwd_fused_kernel, interpret mode), at the gradient tolerance
    above."""
    x, lse, jgrads = _jax_backward(mode, clamp_eps, mem)
    _check_dx_split(x, lse, mode, clamp_eps, splits, range_cols, jgrads)


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_bf16_split_dx_matches_jax_two_kernel_backward(monkeypatch, mode,
                                                       clamp_eps, mem):
    """The JAX package takes its two-kernel backward (_bwd_dx_kernel: K3a)
    when the dx scratch would pass its VMEM budget; a budget of 0 sends
    N = 24 there. The bf16 split-C dx over every plan of SPLIT_PLANS against
    that dx, dt and dscale."""
    calls = []

    def counted(*refs, **kw):
        calls.append(1)
        return bwd_dx_kernel(*refs, **kw)

    bwd_dx_kernel = jfh._bwd_dx_kernel
    monkeypatch.setattr(jfh, "_DX_SCRATCH_BUDGET", 0)
    monkeypatch.setattr(jfh, "_bwd_dx_kernel", counted)
    x = _inputs(mode, seed=40 + mode + 10 * mem, mem=mem)
    out, jgrads = _jax(x, mode, clamp_eps, jnp.bfloat16)
    assert calls, "the two-kernel backward did not run"
    for splits, range_cols in SPLIT_PLANS:
        _check_dx_split(x, np.asarray(out.lse), mode, clamp_eps, splits,
                        range_cols, jgrads)


# (ranges S, rows per range) over N = 24: one range, ranges that cut N
# evenly, a ragged last range, and a last range past N (empty)
ROW_PLANS = [(1, 24), (3, 8), (4, 6), (5, 5), (7, 4)]


def _check_dw_split(x, lse, mode, clamp_eps, splits, range_rows, jdw):
    """The arithmetic of the bf16 dw over row ranges: per-range partials
    with bf16 products (fused_ce_bwd_dw_partials_plain, on the JAX
    forward's lse), summed by fused_ce_bwd_dw_combine_plain, against the
    JAX package's bf16 dw; a range past N carries exact zeros, and with
    the blend the lam = 1 columns of every partial and of dw are 0."""
    t = {k: torch.tensor(v) for k, v in x.items()}
    kw = dict(memn=t["memn"], lam=t["lam"]) if "memn" in x else {}
    parts = tfh.fused_ce_bwd_dw_partials_plain(
        t["xn"], t["wn"], t["labels"], t["t"], t["scale"], t["ab"],
        torch.tensor(lse), t["g_lse"], mode, clamp_eps, splits=splits,
        range_rows=range_rows, mm_dtype=torch.bfloat16, **kw)
    assert parts.shape == (splits, D, C)
    for (lo, hi), p in zip(tfh.split_ranges(N, splits, range_rows), parts):
        if hi == lo:
            assert float(p.abs().max()) == 0.0
    dw = tfh.fused_ce_bwd_dw_combine_plain(parts)
    if kw:
        assert float(parts[:, :, t["lam"] == 1].abs().max()) == 0.0
        assert float(dw[:, t["lam"] == 1].abs().max()) == 0.0
    np.testing.assert_allclose(dw.numpy(), jdw, err_msg="dw", **GRAD_TOL)


@pytest.mark.parametrize("splits,range_rows", ROW_PLANS)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_bf16_split_dw_matches_jax(mode, clamp_eps, mem, splits, range_rows):
    """The bf16 dw over row ranges against the JAX package's bf16
    single-sweep backward (_bwd_fused_kernel, interpret mode), at the
    gradient tolerance above."""
    x, lse, jgrads = _jax_backward(mode, clamp_eps, mem)
    _check_dw_split(x, lse, mode, clamp_eps, splits, range_rows, jgrads[1])


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_bf16_split_dw_matches_jax_two_kernel_backward(monkeypatch, mode,
                                                       clamp_eps, mem):
    """The JAX package takes its two-kernel backward (_bwd_dw_kernel: K3b)
    when the dx scratch would pass its VMEM budget; a budget of 0 sends
    N = 24 there. The bf16 dw over every plan of ROW_PLANS against that
    dw."""
    calls = []

    def counted(*refs, **kw):
        calls.append(1)
        return bwd_dw_kernel(*refs, **kw)

    bwd_dw_kernel = jfh._bwd_dw_kernel
    monkeypatch.setattr(jfh, "_DX_SCRATCH_BUDGET", 0)
    monkeypatch.setattr(jfh, "_bwd_dw_kernel", counted)
    x = _inputs(mode, seed=50 + mode + 10 * mem, mem=mem)
    out, jgrads = _jax(x, mode, clamp_eps, jnp.bfloat16)
    assert calls, "the two-kernel backward did not run"
    for splits, range_rows in ROW_PLANS:
        _check_dw_split(x, np.asarray(out.lse), mode, clamp_eps, splits,
                        range_rows, jgrads[1])
