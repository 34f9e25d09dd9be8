"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: the three margin + CE kernels, their memory-blended (_mem) variants,
the split decomposition of the fp32 fwd and bwd_dx over class ranges and
of the fp32 bwd_dw over row ranges (partials, combine, bitwise
determinism),
the bf16 tensor-core versions of all six (_bf16) with the split bf16
forward's and dx's partials, combine and determinism and the bf16 dw's over
row ranges, and the implicit-GEMM
3x3 conv on each of its routes (fp32: the 3xTF32 route and the ragged IEEE
one, bitwise repeats of both). Marked `cuda`: they skip where there is no CUDA device. On a
machine with a card (the JAX package need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: kernel and plain version both run IEEE fp32 on the card and sum
in different orders: statistics rtol = atol = 1e-5; gradients rtol 1e-3 with
an atol of 1e-5 x the largest value; `higher` may flip by 1 where a cosine
lies within rounding of the target's. The bf16 gradients add one bf16 ulp
(2^-7 of it) of the largest term of each output element: dcos is computed
in fp32 in different orders, and one within that difference of a bf16
rounding boundary rounds one way in the kernel and the other in the plain
version. The conv: fp32 at rtol = atol = 1e-5, bf16 at 2e-2 (outputs
rounded to bf16 one ulp apart), as tests/test_conv3x3.py.
"""

import pytest
import torch

from face_recognition_models_tpu_torch.ops import conv3x3
from face_recognition_models_tpu_torch.ops import fused_head as fh
from face_recognition_models_tpu_torch.ops.normalize import l2_normalize

pytestmark = pytest.mark.cuda

MODES = [(fh.MODE_IDENTITY, None), (fh.MODE_MV, 1e-7),
         (fh.MODE_CURRICULAR, 0.0)]
PLAIN = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dw")
MEM = ("fused_ce_fwd_mem", "fused_ce_bwd_dx_mem", "fused_ce_bwd_dw_mem")
BF16 = tuple(k + "_bf16" for k in PLAIN + MEM)
BF16_ULP = 2.0 ** -7


def _counts(launched):
    """The launch counters expected after one launch of each of `launched`."""
    return {k: int(k in launched) for k in PLAIN + MEM + BF16}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, c, mode, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    xn = l2_normalize(torch.randn(n, d, device=dev, generator=g), dim=1)
    wn = l2_normalize(torch.randn(d, c, device=dev, generator=g), dim=0)
    labels = torch.randint(0, c, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    tcos = (xn * wn[:, labels.long()].T).sum(1)
    labels[n // 2] = c + 3  # out of range: no target column
    t = tcos - 0.3
    scale = torch.rand(n, device=dev, generator=g) * 48 + 16
    ab = torch.stack([tcos - 0.2, torch.full_like(tcos, 1.12)], 1)
    if mode == fh.MODE_IDENTITY:
        ab = torch.zeros_like(ab)
    return xn, wn, labels, t, tcos, scale, ab.contiguous()


def _mem_inputs(d, c, seed, dev):
    """memn with unit columns and lam mixing 0, VPL's 0.15 and QAFace's 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    memn = l2_normalize(torch.randn(d, c, device=dev, generator=g), dim=0)
    choice = torch.randint(0, 3, (c,), device=dev, generator=g)
    lam = torch.tensor([0.0, 0.15, 1.0], device=dev)[choice]
    return memn, lam


def _grad_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("n,c", [(24, 100), (512, 1000)])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_kernels_match_plain(cuda, n, c, mode, clamp_eps):
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, 512, c, mode, n + mode,
                                                 cuda)
    fh.reset_launch_counts()
    out = fh.fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, mode,
                          clamp_eps)
    ref = fh.fused_margin_ce_plain(xn, wn, labels, t, tcos, scale, ab, mode,
                                   clamp_eps)
    torch.testing.assert_close(out.lse, ref.lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.target_logit, ref.target_logit,
                               rtol=1e-5, atol=1e-5)
    assert float((out.higher - ref.higher).abs().max()) <= 1
    g_lse = torch.full_like(t, 1.0 / n)
    g_t = torch.full_like(t, -1.0 / n)
    args = (xn, wn, labels, t, scale, ab, ref.lse, g_lse)
    got = fh.fused_ce_bwd_dx(*args, g_t, mode, clamp_eps)
    for a, b in zip(got, fh.fused_ce_bwd_dx_plain(*args, g_t, mode,
                                                   clamp_eps)):
        _grad_close(a, b)
    _grad_close(fh.fused_ce_bwd_dw(*args, mode, clamp_eps),
                fh.fused_ce_bwd_dw_plain(*args, mode, clamp_eps))
    torch.cuda.synchronize()
    assert fh.launch_counts == _counts(PLAIN)


@pytest.mark.parametrize("n,c", [(24, 100), (512, 1000)])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_mem_kernels_match_plain(cuda, n, c, mode, clamp_eps):
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, 512, c, mode, n + mode,
                                                 cuda)
    memn, lam = _mem_inputs(512, c, n + 7 * mode, cuda)
    fh.reset_launch_counts()
    out = fh.fused_ce_fwd_mem(xn, wn, memn, lam, labels, t, tcos, scale, ab,
                              mode, clamp_eps)
    ref = fh.fused_margin_ce_mem_plain(xn, wn, memn, lam, labels, t, tcos,
                                       scale, ab, mode, clamp_eps)
    torch.testing.assert_close(out.lse, ref.lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.target_logit, ref.target_logit,
                               rtol=1e-5, atol=1e-5)
    assert float((out.higher - ref.higher).abs().max()) <= 1
    g_lse = torch.full_like(t, 1.0 / n)
    g_t = torch.full_like(t, -1.0 / n)
    args = (xn, wn, memn, lam, labels, t, scale, ab, ref.lse, g_lse)
    got = fh.fused_ce_bwd_dx_mem(*args, g_t, mode, clamp_eps)
    for a, b in zip(got, fh.fused_ce_bwd_dx_mem_plain(*args, g_t, mode,
                                                       clamp_eps)):
        _grad_close(a, b)
    dw = fh.fused_ce_bwd_dw_mem(*args, mode, clamp_eps)
    _grad_close(dw, fh.fused_ce_bwd_dw_mem_plain(*args, mode, clamp_eps))
    torch.cuda.synchronize()
    assert float(dw[:, lam == 1].abs().max()) == 0.0
    assert fh.launch_counts == _counts(MEM)


def test_mem_autograd_runs_the_kernels(cuda):
    xn, wn, labels, t, tcos, scale, ab = _inputs(64, 128, 300, 0, 6, cuda)
    memn, lam = _mem_inputs(128, 300, 6, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (xn, wn, t, scale)]
    fh.reset_launch_counts()
    out = fh.fused_margin_ce_mem(leaves[0], leaves[1], memn, lam, labels,
                                 leaves[2], tcos, leaves[3], ab,
                                 fh.MODE_IDENTITY, 1e-7)
    (out.lse - out.target_logit).mean().backward()
    assert fh.launch_counts == _counts(MEM)
    g = torch.full_like(t, 1.0 / 64)
    lse = out.lse.detach()
    args = (xn, wn, memn, lam, labels, t, scale, ab, lse, g)
    dx, dt, dscale = fh.fused_ce_bwd_dx_mem_plain(*args, -g,
                                                  fh.MODE_IDENTITY, 1e-7)
    dw = fh.fused_ce_bwd_dw_mem_plain(*args, fh.MODE_IDENTITY, 1e-7)
    for leaf, w in zip(leaves, (dx, dw, dt, dscale)):
        _grad_close(leaf.grad, w)


def test_autograd_runs_the_kernels(cuda):
    xn, wn, labels, t, tcos, scale, ab = _inputs(64, 128, 300, 0, 5, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (xn, wn, t, scale)]
    fh.reset_launch_counts()
    out = fh.fused_margin_ce(leaves[0], leaves[1], labels, leaves[2], tcos,
                             leaves[3], ab, fh.MODE_IDENTITY)
    (out.lse - out.target_logit).mean().backward()
    assert fh.launch_counts == _counts(PLAIN)
    g = torch.full_like(t, 1.0 / 64)
    want = fh.fused_margin_ce_bwd_plain(xn, wn, labels, t, scale, ab,
                                        out.lse.detach(), g, -g,
                                        fh.MODE_IDENTITY)
    for leaf, w in zip(leaves, want):
        _grad_close(leaf.grad, w)


def test_wrappers_reject_bad_inputs(cuda):
    xn, wn, labels, t, tcos, scale, ab = _inputs(8, 64, 50, 0, 1, cuda)
    with pytest.raises(ValueError, match="float32"):
        fh.fused_ce_fwd(xn.double(), wn, labels, t, tcos, scale, ab, 0)
    with pytest.raises(ValueError, match="int32"):
        fh.fused_ce_fwd(xn, wn, labels.long(), t, tcos, scale, ab, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fh.fused_ce_fwd(xn, wn.T.contiguous().T, labels, t, tcos, scale, ab,
                        0)
    with pytest.raises(ValueError, match="embedding width 4096"):
        wide = torch.zeros(8, 4096, device=cuda)
        fh.fused_ce_bwd_dw(wide, torch.zeros(4096, 50, device=cuda), labels,
                           t, scale, ab, t, t, 0)
    memn, lam = _mem_inputs(64, 50, 2, cuda)
    with pytest.raises(ValueError, match="memn"):
        fh.fused_ce_fwd_mem(xn, wn, memn[:, :40].contiguous(), lam, labels,
                            t, tcos, scale, ab, 0)
    with pytest.raises(ValueError, match="embedding width 640"):
        # 8 warps x 64 columns of D hold the dw accumulator: D <= 512
        d = 640
        fh.fused_ce_bwd_dw_mem(
            torch.zeros(8, d, device=cuda), torch.zeros(d, 50, device=cuda),
            torch.zeros(d, 50, device=cuda), lam, labels, t, scale, ab, t, t,
            0)


# The fp32 fwd / bwd_dx split C into ranges of whole 256-wide tiles. These
# shapes give more than one range (split_plan): N = 1; N not a multiple of
# the 32-row tile; a ragged last range; D = 72 and 200 (dx's narrow and wide
# register layouts); and (last) a final range of one column, the target of
# row 0.
SPLIT_SHAPES = [(1, 64, 300, False), (40, 72, 300, False),
                (33, 200, 600, False), (70, 512, 2000, False),
                (1, 64, 257, True)]


def _stats_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,c,last", SPLIT_SHAPES)
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_split_kernels_partials_combine_determinism(cuda, n, d, c, last, mode,
                                                    clamp_eps, mem):
    """The fp32 fwd and bwd_dx entries: each range's partials against
    fused_ce_*_partials_plain, the combine kernels against their plain
    versions, the results against the unsplit plain versions, and two
    launches bitwise equal."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, d, c, mode, n + d + mode,
                                                 cuda)
    if last:
        labels[0] = c - 1
    extra = _mem_inputs(d, c, n + 7 * mode, cuda) if mem else ()
    kw = dict(memn=extra[0], lam=extra[1]) if mem else {}
    sfx, which = ("_mem", 3) if mem else ("", 0)
    splits, cols = fh.split_plan(n, c)
    assert splits > 1
    fwd = (labels, t, tcos, scale, ab, mode, clamp_eps)
    ref = getattr(fh, f"fused_margin_ce{sfx}_plain")(xn, wn, *extra, *fwd)
    outs, parts = [], []
    for _ in range(2):
        outs.append(fh._fwd("fused_ce_fwd" + sfx, which, xn, wn, extra, *fwd,
                            torch.float32, parts))
    got_parts = parts[0].view(splits, 3, n)
    want_parts = fh.fused_ce_fwd_partials_plain(
        xn, wn, *fwd, splits=splits, range_cols=cols, **kw)
    _stats_close(got_parts[:, :2], want_parts[:, :2])
    assert float((got_parts[:, 2] - want_parts[:, 2]).abs().max()) <= 1
    comb = fh.fused_ce_fwd_combine(want_parts, t, scale)
    for a, b in zip(comb, fh.fused_ce_fwd_combine_plain(want_parts, t,
                                                         scale)):
        _stats_close(a, b)
    _stats_close(outs[0].lse, ref.lse)
    _stats_close(outs[0].target_logit, ref.target_logit)
    assert float((outs[0].higher - ref.higher).abs().max()) <= 1
    assert all(torch.equal(a, b) for a, b in zip(*outs))

    g_lse = torch.full_like(t, 1.0 / n)
    g_t = torch.full_like(t, -1.0 / n)
    bwd = (labels, t, scale, ab, ref.lse, g_lse)
    want = getattr(fh, f"fused_ce_bwd_dx{sfx}_plain")(xn, wn, *extra, *bwd,
                                                      g_t, mode, clamp_eps)
    splits, cols = fh.split_plan(n, c, dx=True)
    assert splits > 1
    outs, parts = [], []
    for _ in range(2):
        outs.append(fh._bwd_dx("fused_ce_bwd_dx" + sfx, which + 1, xn, wn,
                               extra, *bwd, g_t, mode, clamp_eps,
                               torch.float32, parts))
    got_dx, got_rows = fh.dx_workspace_views(parts[0], splits, n, d)
    want_dx, want_rows = fh.fused_ce_bwd_dx_partials_plain(
        xn, wn, *bwd, mode, clamp_eps, splits=splits, range_cols=cols, **kw)
    _grad_close(got_dx, want_dx)
    _grad_close(got_rows, want_rows)
    comb = fh.fused_ce_bwd_dx_combine(want_dx, want_rows, t, scale, g_t)
    for a, b in zip(comb, fh.fused_ce_bwd_dx_combine_plain(
            want_dx, want_rows, t, scale, g_t)):
        _grad_close(a, b)
    for a, b in zip(outs[0], want):
        _grad_close(a, b)
        assert bool(torch.isfinite(a).all())
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_split_dx_rejects_wide_embeddings(cuda):
    xn, wn, labels, t, tcos, scale, ab = _inputs(8, 64, 50, 0, 1, cuda)
    wide = torch.zeros(8, 640, device=cuda)
    with pytest.raises(ValueError, match="embedding width"):
        fh.fused_ce_bwd_dx(wide, torch.zeros(640, 50, device=cuda), labels,
                           t, scale, ab, t, t, t, 0)


# The fp32 bwd_dw splits N into ranges of whole 256-row tiles where the
# class tiles (32 wide) leave the card short of two blocks per SM. These
# shapes give N = 1, D = 72 and 512, class tiles that C does not fill, and
# (dw_split_plan) 3, 2 and 3 row ranges with a ragged last range.
DW_SHAPES = [(1, 512, 100), (24, 72, 100), (600, 72, 300), (300, 200, 33),
             (520, 512, 1000)]


@pytest.mark.parametrize("n,d,c", DW_SHAPES)
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_split_dw_kernels_partials_combine_determinism(cuda, n, d, c, mode,
                                                       clamp_eps, mem):
    """The fp32 bwd_dw entries: dw against the unsplit plain version, each
    row range's partials against fused_ce_bwd_dw_partials_plain, the combine
    kernel against its plain version, two launches bitwise equal, and with
    the blend exact zeros in the lam = 1 columns."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, d, c, mode, n + d + mode,
                                                 cuda)
    extra = _mem_inputs(d, c, n + 7 * mode, cuda) if mem else ()
    kw = dict(memn=extra[0], lam=extra[1]) if mem else {}
    sfx, which = ("_mem", 5) if mem else ("", 2)
    ref = getattr(fh, f"fused_margin_ce{sfx}_plain")(
        xn, wn, *extra, labels, t, tcos, scale, ab, mode, clamp_eps)
    g_lse = torch.full_like(t, 1.0 / n)
    bwd = (labels, t, scale, ab, ref.lse, g_lse)
    want = getattr(fh, f"fused_ce_bwd_dw{sfx}_plain")(xn, wn, *extra, *bwd,
                                                      mode, clamp_eps)
    splits, rows = fh.dw_split_plan(n, c)
    assert splits == (3 if n in (520, 600) else 2 if n == 300 else 1)
    fh.reset_launch_counts()
    outs, parts = [], []
    for _ in range(2):
        outs.append(fh._bwd_dw("fused_ce_bwd_dw" + sfx, which, xn, wn, extra,
                               *bwd, mode, clamp_eps, torch.float32, parts))
    torch.cuda.synchronize()
    assert fh.launch_counts["fused_ce_bwd_dw" + sfx] == 2
    _grad_close(outs[0], want)
    assert torch.equal(outs[0], outs[1])
    want_parts = fh.fused_ce_bwd_dw_partials_plain(
        xn, wn, *bwd, mode, clamp_eps, splits=splits, range_rows=rows, **kw)
    if splits > 1:
        _grad_close(parts[0].view(splits, d, c), want_parts)
    else:
        assert parts[0].numel() == 0
    _grad_close(fh.fused_ce_bwd_dw_combine(want_parts),
                fh.fused_ce_bwd_dw_combine_plain(want_parts))
    if mem:
        assert float(outs[0][:, extra[1] == 1].abs().max()) == 0.0


def _bf16_grad_close(got, want, term):
    """_grad_close plus one bf16 ulp of `term`, each output element's
    largest product term (see the module docstring)."""
    atol = 1e-5 * float(want.abs().max()) + BF16_ULP * term
    bad = (got - want).abs() > 1e-3 * want.abs() + atol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements out of tolerance, max abs err "
        f"{float((got - want).abs().max()):.3e}")


@pytest.mark.parametrize("n,d,c", [(24, 64, 100), (40, 72, 300),
                                   (512, 512, 1000)])
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_kernels_match_plain(cuda, n, d, c, mode, clamp_eps, mem):
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, d, c, mode, n + mode,
                                                 cuda)
    extra = _mem_inputs(d, c, n + 7 * mode, cuda) if mem else ()
    sfx = "_mem" if mem else ""
    bf = dict(mm_dtype=torch.bfloat16)
    fh.reset_launch_counts()
    fwd = (xn, wn, *extra, labels, t, tcos, scale, ab, mode, clamp_eps)
    out = getattr(fh, "fused_ce_fwd" + sfx)(*fwd, **bf)
    ref = getattr(fh, f"fused_margin_ce{sfx}_plain")(*fwd, **bf)
    torch.testing.assert_close(out.lse, ref.lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.target_logit, ref.target_logit,
                               rtol=1e-5, atol=1e-5)
    assert float((out.higher - ref.higher).abs().max()) <= 1
    g_lse = torch.full_like(t, 1.0 / n)
    g_t = torch.full_like(t, -1.0 / n)
    args = (xn, wn, *extra, labels, t, scale, ab, ref.lse, g_lse)
    dcos, _, _ = fh._dcos_plain(xn, wn, labels, t, scale, ab, ref.lse, g_lse,
                                mode, clamp_eps, *(extra or (None, None)),
                                torch.bfloat16)
    wmax = torch.stack([w.abs().amax(1) for w in (wn, *extra[:1])]).amax(0)
    got = getattr(fh, "fused_ce_bwd_dx" + sfx)(*args, g_t, mode, clamp_eps,
                                               **bf)
    want = getattr(fh, f"fused_ce_bwd_dx{sfx}_plain")(*args, g_t, mode,
                                                      clamp_eps, **bf)
    _bf16_grad_close(got[0], want[0],
                     dcos.abs().amax(1)[:, None] * wmax[None, :])
    for a, b in zip(got[1:], want[1:]):
        _grad_close(a, b)
    dw = getattr(fh, "fused_ce_bwd_dw" + sfx)(*args, mode, clamp_eps, **bf)
    _bf16_grad_close(dw, getattr(fh, f"fused_ce_bwd_dw{sfx}_plain")(
        *args, mode, clamp_eps, **bf),
        xn.abs().amax(0)[:, None] * dcos.abs().amax(0)[None, :])
    torch.cuda.synchronize()
    if mem:
        assert float(dw[:, extra[1] == 1].abs().max()) == 0.0
    assert fh.launch_counts == _counts(
        [k + sfx + "_bf16" for k in ("fused_ce_fwd", "fused_ce_bwd_dx",
                                     "fused_ce_bwd_dw")])


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_autograd_runs_the_kernels(cuda, mem):
    xn, wn, labels, t, tcos, scale, ab = _inputs(64, 128, 300, 0, 8, cuda)
    extra = _mem_inputs(128, 300, 8, cuda) if mem else ()
    leaves = [x.clone().requires_grad_(True) for x in (xn, wn, t, scale)]
    fh.reset_launch_counts()
    fn = fh.fused_margin_ce_mem if mem else fh.fused_margin_ce
    out = fn(leaves[0], leaves[1], *extra, labels, leaves[2], tcos,
             leaves[3], ab, fh.MODE_IDENTITY, 1e-7, mm_dtype=torch.bfloat16)
    (out.lse - out.target_logit).mean().backward()
    sfx = "_mem" if mem else ""
    assert fh.launch_counts == _counts(
        [k + sfx + "_bf16" for k in ("fused_ce_fwd", "fused_ce_bwd_dx",
                                     "fused_ce_bwd_dw")])
    assert all(bool(torch.isfinite(leaf.grad).all()) for leaf in leaves)


# The bf16 fwd splits C into ranges of whole 128-wide tiles: N = 1, N not a
# multiple of the 64-row tile, a ragged last range, D = 72 and 200, and
# (last) a final range of one column, the target of row 0.
@pytest.mark.parametrize("n,d,c,last", SPLIT_SHAPES)
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_split_forward_partials_combine_determinism(cuda, n, d, c, last,
                                                         mode, clamp_eps,
                                                         mem):
    """The bf16 fwd entries: each range's partials against
    fused_ce_fwd_partials_plain with bf16 products, the combine kernel
    against its plain version, the result against the unsplit plain
    version, and two launches bitwise equal."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, d, c, mode, n + d + mode,
                                                 cuda)
    if last:
        labels[0] = c - 1
    extra = _mem_inputs(d, c, n + 7 * mode, cuda) if mem else ()
    kw = dict(memn=extra[0], lam=extra[1]) if mem else {}
    sfx, which = ("_mem", 3) if mem else ("", 0)
    splits, cols = fh.split_plan(n, c, mm_dtype=torch.bfloat16)
    assert splits > 1 and cols % 128 == 0
    fwd = (labels, t, tcos, scale, ab, mode, clamp_eps)
    ref = getattr(fh, f"fused_margin_ce{sfx}_plain")(
        xn, wn, *extra, *fwd, mm_dtype=torch.bfloat16)
    fh.reset_launch_counts()
    outs, parts = [], []
    for _ in range(2):
        outs.append(fh._fwd("fused_ce_fwd" + sfx, which, xn, wn, extra, *fwd,
                            torch.bfloat16, parts))
    torch.cuda.synchronize()
    name = "fused_ce_fwd" + sfx + "_bf16"
    assert fh.launch_counts == {k: 2 * int(k == name)
                                for k in fh.launch_counts}
    got_parts = parts[0][:splits * 3 * n].view(splits, 3, n)
    want_parts = fh.fused_ce_fwd_partials_plain(
        xn, wn, *fwd, splits=splits, range_cols=cols, mm_dtype=torch.bfloat16,
        **kw)
    _stats_close(got_parts[:, :2], want_parts[:, :2])
    assert float((got_parts[:, 2] - want_parts[:, 2]).abs().max()) <= 1
    comb = fh.fused_ce_fwd_combine(want_parts, t, scale)
    for a, b in zip(comb, fh.fused_ce_fwd_combine_plain(want_parts, t,
                                                         scale)):
        _stats_close(a, b)
    _stats_close(outs[0].lse, ref.lse)
    _stats_close(outs[0].target_logit, ref.target_logit)
    assert float((outs[0].higher - ref.higher).abs().max()) <= 1
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert torch.equal(parts[0][:splits * 3 * n], parts[1][:splits * 3 * n])


# The bf16 bwd_dx splits C into ranges of whole 128-wide tiles over 32-row
# tiles: the same shapes (N = 1, ragged ranges, D = 72 and 200, a last range
# holding only row 0's target).
@pytest.mark.parametrize("n,d,c,last", SPLIT_SHAPES)
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_split_dx_partials_combine_determinism(cuda, n, d, c, last, mode,
                                                    clamp_eps, mem):
    """The bf16 bwd_dx entries: each range's partials from the workspace
    against fused_ce_bwd_dx_partials_plain with bf16 products, the combine
    kernel against its plain version, the result against the unsplit plain
    version, and two launches bitwise equal."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, d, c, mode, n + d + mode,
                                                 cuda)
    if last:
        labels[0] = c - 1
    extra = _mem_inputs(d, c, n + 7 * mode, cuda) if mem else ()
    kw = dict(memn=extra[0], lam=extra[1]) if mem else {}
    sfx, which = ("_mem", 4) if mem else ("", 1)
    bf = torch.bfloat16
    splits, cols = fh.split_plan(n, c, dx=True, mm_dtype=bf)
    assert splits > 1 and cols % 128 == 0
    ref = getattr(fh, f"fused_margin_ce{sfx}_plain")(
        xn, wn, *extra, labels, t, tcos, scale, ab, mode, clamp_eps,
        mm_dtype=bf)
    g_lse = torch.full_like(t, 1.0 / n)
    g_t = torch.full_like(t, -1.0 / n)
    bwd = (labels, t, scale, ab, ref.lse, g_lse)
    want = getattr(fh, f"fused_ce_bwd_dx{sfx}_plain")(
        xn, wn, *extra, *bwd, g_t, mode, clamp_eps, mm_dtype=bf)
    dcos, _, _ = fh._dcos_plain(xn, wn, labels, t, scale, ab, ref.lse, g_lse,
                                mode, clamp_eps, *(extra or (None, None)), bf)
    wmax = torch.stack([w.abs().amax(1) for w in (wn, *extra[:1])]).amax(0)
    term = dcos.abs().amax(1)[:, None] * wmax[None, :]
    fh.reset_launch_counts()
    outs, parts = [], []
    for _ in range(2):
        outs.append(fh._bwd_dx("fused_ce_bwd_dx" + sfx, which, xn, wn, extra,
                               *bwd, g_t, mode, clamp_eps, bf, parts))
    torch.cuda.synchronize()
    name = "fused_ce_bwd_dx" + sfx + "_bf16"
    assert fh.launch_counts == {k: 2 * int(k == name)
                                for k in fh.launch_counts}
    got_dx, got_rows = fh.dx_workspace_views(parts[0], splits, n, d)
    want_dx, want_rows = fh.fused_ce_bwd_dx_partials_plain(
        xn, wn, *bwd, mode, clamp_eps, splits=splits, range_cols=cols,
        mm_dtype=bf, **kw)
    _bf16_grad_close(got_dx, want_dx, term)
    _grad_close(got_rows, want_rows)
    if last:  # the last range holds row 0's target only: no dx from it
        assert float(got_dx[-1, 0].abs().max()) == 0.0
    comb = fh.fused_ce_bwd_dx_combine(want_dx, want_rows, t, scale, g_t)
    for a, b in zip(comb, fh.fused_ce_bwd_dx_combine_plain(
            want_dx, want_rows, t, scale, g_t)):
        _grad_close(a, b)
    _bf16_grad_close(outs[0][0], want[0], term)
    for a, b in zip(outs[0][1:], want[1:]):
        _grad_close(a, b)
    assert all(bool(torch.isfinite(a).all()) for a in outs[0])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    views = [fh.dx_workspace_views(p, splits, n, d) for p in parts]
    assert all(torch.equal(a, b) for a, b in zip(*views))


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_split_dx_rejects_wide_embeddings(cuda, mem):
    """8 warps x 64 columns of D hold the bf16 dx accumulator: D <= 512."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(8, 64, 50, 0, 1, cuda)
    d = 528
    wide = torch.zeros(8, d, device=cuda)
    w = torch.zeros(d, 50, device=cuda)
    extra = (w, torch.zeros(50, device=cuda)) if mem else ()
    fn = fh.fused_ce_bwd_dx_mem if mem else fh.fused_ce_bwd_dx
    with pytest.raises(ValueError, match="embedding width 528"):
        fn(wide, w, *extra, labels, t, scale, ab, t, t, t, 0,
           mm_dtype=torch.bfloat16)


# The bf16 bwd_dw splits N into ranges of whole row tiles (32 rows, 16 with
# the blend) where the class tiles leave the card short of two blocks per
# SM: N = 600, 300 and 520 of DW_SHAPES run more than one range
# (dw_split_plan with mm_dtype=torch.bfloat16), and D = 72 and 200 leave
# warps with part of a 64-column slice of D or none.
@pytest.mark.parametrize("n,d,c", DW_SHAPES)
@pytest.mark.parametrize("mode,clamp_eps", MODES)
@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_split_dw_partials_combine_determinism(cuda, n, d, c, mode,
                                                    clamp_eps, mem):
    """The bf16 bwd_dw entries: each row range's partials from the
    workspace against fused_ce_bwd_dw_partials_plain with bf16 products,
    the combine kernel against its plain version, dw against the unsplit
    plain version, one launch counted per call, two launches bitwise
    equal, and with the blend exact zeros in the lam = 1 columns."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(n, d, c, mode, n + d + mode,
                                                 cuda)
    extra = _mem_inputs(d, c, n + 7 * mode, cuda) if mem else ()
    kw = dict(memn=extra[0], lam=extra[1]) if mem else {}
    sfx, which = ("_mem", 5) if mem else ("", 2)
    bf = torch.bfloat16
    ref = getattr(fh, f"fused_margin_ce{sfx}_plain")(
        xn, wn, *extra, labels, t, tcos, scale, ab, mode, clamp_eps,
        mm_dtype=bf)
    g_lse = torch.full_like(t, 1.0 / n)
    bwd = (labels, t, scale, ab, ref.lse, g_lse)
    want = getattr(fh, f"fused_ce_bwd_dw{sfx}_plain")(
        xn, wn, *extra, *bwd, mode, clamp_eps, mm_dtype=bf)
    dcos, _, _ = fh._dcos_plain(xn, wn, labels, t, scale, ab, ref.lse, g_lse,
                                mode, clamp_eps, *(extra or (None, None)), bf)
    term = xn.abs().amax(0)[:, None] * dcos.abs().amax(0)[None, :]
    splits, rows = fh.dw_split_plan(n, c, mm_dtype=bf, mem=mem)
    assert rows % 16 == 0 and splits == -(-n // rows)
    if n >= 300:
        assert splits > 1
    fh.reset_launch_counts()
    outs, parts = [], []
    for _ in range(2):
        outs.append(fh._bwd_dw("fused_ce_bwd_dw" + sfx, which, xn, wn, extra,
                               *bwd, mode, clamp_eps, bf, parts))
    torch.cuda.synchronize()
    name = "fused_ce_bwd_dw" + sfx + "_bf16"
    assert fh.launch_counts == {k: 2 * int(k == name)
                                for k in fh.launch_counts}
    _bf16_grad_close(outs[0], want, term)
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])
    want_parts = fh.fused_ce_bwd_dw_partials_plain(
        xn, wn, *bwd, mode, clamp_eps, splits=splits, range_rows=rows,
        mm_dtype=bf, **kw)
    if splits > 1:
        got = parts[0][:splits * d * c].view(splits, d, c)
        _bf16_grad_close(got, want_parts, term)
        assert torch.equal(got, parts[1][:splits * d * c].view(splits, d, c))
    _grad_close(fh.fused_ce_bwd_dw_combine(want_parts),
                fh.fused_ce_bwd_dw_combine_plain(want_parts))
    if mem:
        assert float(outs[0][:, extra[1] == 1].abs().max()) == 0.0


@pytest.mark.parametrize("mem", [False, True], ids=["plain", "mem"])
def test_bf16_dw_rejects_wide_embeddings(cuda, mem):
    """8 warps x 64 columns of D hold the bf16 dw accumulator: D <= 512."""
    xn, wn, labels, t, tcos, scale, ab = _inputs(8, 64, 50, 0, 1, cuda)
    d = 528
    wide = torch.zeros(8, d, device=cuda)
    w = torch.zeros(d, 50, device=cuda)
    extra = (w, torch.zeros(50, device=cuda)) if mem else ()
    fn = fh.fused_ce_bwd_dw_mem if mem else fh.fused_ce_bwd_dw
    fh.reset_launch_counts()
    with pytest.raises(ValueError, match="embedding width 528"):
        fn(wide, w, *extra, labels, t, scale, ab, t, t, 0,
           mm_dtype=torch.bfloat16)
    assert all(v == 0 for v in fh.launch_counts.values())


def test_bf16_wrappers_reject_bad_inputs(cuda):
    xn, wn, labels, t, tcos, scale, ab = _inputs(8, 64, 50, 0, 1, cuda)
    with pytest.raises(ValueError, match="mm_dtype"):
        fh.fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, 0,
                        mm_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        fh.fused_ce_fwd(xn.bfloat16(), wn, labels, t, tcos, scale, ab, 0,
                        mm_dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "n,h,w,c,co,dtype",
    [(4, 7, 7, 16, 24, torch.float32), (4, 14, 14, 8, 8, torch.float32),
     (2, 5, 9, 4, 12, torch.float32), (6, 4, 4, 8, 8, torch.float32),
     (2, 7, 7, 32, 16, torch.bfloat16), (32, 14, 14, 64, 96, torch.bfloat16),
     (16, 7, 7, 72, 40, torch.float32),
     # the bf16 16-byte route: M not a multiple of the 128-row tile, C_out
     # not a multiple of 128, C not a multiple of 64, two C_out tiles
     (3, 5, 9, 40, 24, torch.bfloat16), (8, 14, 14, 72, 40, torch.bfloat16),
     (1, 12, 12, 136, 136, torch.bfloat16),
     # the ragged route: C or C_out not a multiple of 8
     (4, 7, 7, 12, 16, torch.bfloat16), (2, 6, 6, 16, 12, torch.bfloat16),
     # the fp32 3xTF32 route: M = 135 (not a multiple of the 128-row tile)
     # with C = 40 (a 32-channel stage padded past C) and C_out = 136 (two
     # output tiles); C_out = 4
     (3, 5, 9, 40, 136, torch.float32), (2, 7, 7, 8, 4, torch.float32),
     # the fp32 ragged route: C or C_out not a multiple of 4
     (2, 6, 6, 6, 10, torch.float32), (4, 7, 7, 12, 10, torch.float32),
     (2, 5, 5, 6, 8, torch.float32)])
def test_conv3x3_matches_plain(cuda, n, h, w, c, co, dtype):
    g = torch.Generator(device=cuda).manual_seed(n + c)
    x = torch.randn(n, h, w, c, device=cuda, generator=g).to(dtype)
    k = (0.1 * torch.randn(3, 3, c, co, device=cuda, generator=g)).to(dtype)
    conv3x3.reset_launch_counts()
    got = conv3x3.conv3x3_same(x, k, block_n=n // 2 if n % 2 == 0 else n)
    want = conv3x3.conv3x3_same_plain(x, k)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, h, w, co)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    route = conv3x3.route(dtype, c, co)
    assert conv3x3.launch_counts == {k: int(k == route)
                                     for k in conv3x3.launch_counts}


def test_conv3x3_takes_an_unaligned_view(cuda):
    """A contiguous view that starts 2 bytes into its storage still runs
    the 16-byte route (the wrapper copies it to an aligned start)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n, h, w, c, co = 2, 6, 6, 16, 24
    buf = torch.randn(1 + n * h * w * c, device=cuda, generator=g)
    x = buf.to(torch.bfloat16)[1:].view(n, h, w, c)
    assert x.data_ptr() % 16 and x.is_contiguous()
    k = (0.1 * torch.randn(3, 3, c, co, device=cuda, generator=g)).to(
        torch.bfloat16)
    conv3x3.reset_launch_counts()
    got = conv3x3.conv3x3_same(x, k, block_n=n)
    torch.cuda.synchronize()
    assert conv3x3.launch_counts["conv3x3_same"] == 1
    torch.testing.assert_close(got.float(),
                               conv3x3.conv3x3_same_plain(x, k).float(),
                               rtol=2e-2, atol=2e-2)


def test_conv3x3_f32_takes_an_unaligned_view(cuda):
    """An fp32 view that starts 4 bytes into its storage still runs the
    3xTF32 route (the wrapper copies it to an aligned start)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    n, h, w, c, co = 2, 6, 6, 16, 24
    buf = torch.randn(1 + n * h * w * c, device=cuda, generator=g)
    x = buf[1:].view(n, h, w, c)
    assert x.data_ptr() % 16 and x.is_contiguous()
    k = 0.1 * torch.randn(3, 3, c, co, device=cuda, generator=g)
    conv3x3.reset_launch_counts()
    got = conv3x3.conv3x3_same(x, k, block_n=n)
    torch.cuda.synchronize()
    assert conv3x3.launch_counts["conv3x3_same_f32"] == 1
    torch.testing.assert_close(got, conv3x3.conv3x3_same_plain(x, k),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,co", [(72, 136), (6, 10)])
def test_conv3x3_f32_repeats_bitwise(cuda, c, co):
    """Two launches of each fp32 route on the same inputs are bitwise
    equal: the sums run in a fixed order, with no atomics."""
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(4, 9, 9, c, device=cuda, generator=g)
    k = 0.1 * torch.randn(3, 3, c, co, device=cuda, generator=g)
    conv3x3.reset_launch_counts()
    a = conv3x3.conv3x3_same(x, k, block_n=4)
    b = conv3x3.conv3x3_same(x, k, block_n=4)
    torch.cuda.synchronize()
    assert conv3x3.launch_counts[conv3x3.route(x.dtype, c, co)] == 2
    assert torch.equal(a, b)


def test_conv3x3_rejects_bad_inputs(cuda):
    x = torch.zeros(4, 7, 7, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        conv3x3.conv3x3_same(x, torch.zeros(3, 3, 8, 8, device=cuda),
                             block_n=4)
    with pytest.raises(ValueError, match="block_n"):
        conv3x3.conv3x3_same(x.float(), torch.zeros(3, 3, 8, 8, device=cuda),
                             block_n=3)


def test_train_steps_repeat_bitwise(cuda):
    """Two default-mode runs of 3 full-width ArcFace steps (resnet18,
    C=10,575, b512, 112 px) on the same batches, whose labels repeat, give
    bitwise equal losses and weights: the target-column gather adds
    repeated labels' gradients in a fixed order (heads.base.take_columns),
    where index_select's backward adds them with float atomics."""
    import numpy as np

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit

    assert not torch.are_deterministic_algorithms_enabled()
    bs, steps, c = 512, 3, 10575
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (steps * bs, 112, 112, 3), np.uint8)
    labels = rs.randint(0, c, steps * bs).astype(np.int32)
    assert all(len(np.unique(labels[i * bs:(i + 1) * bs])) < bs
               for i in range(steps))
    cfg = cfg_lib.TrainConfig(num_classes=c, batch_size=bs, epochs=1,
                              print_freq=100, seed=0)
    runs = []
    for _ in range(2):
        res = fit(cfg, ArrayLoader(images, labels, batch_size=bs, seed=0),
                  device=cuda)
        runs.append((res.losses, res.state.kernel_w.detach().clone(),
                     {k: v.clone() for k, v in
                      res.state.backbone.state_dict().items()}))
        del res
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    for key, value in runs[0][2].items():
        assert torch.equal(value, runs[1][2][key]), key


def test_host_staging_copies_every_batch(cuda):
    """`fit`'s pinned staging: each batch arrives on the card intact,
    though its two host buffers are refilled while earlier copies may be
    in flight, and a batch of another shape gets a buffer of its own."""
    import numpy as np

    from face_recognition_models_tpu_torch.train.loop import HostStaging

    stage = HostStaging(cuda)
    rs = np.random.RandomState(0)
    sent, got = [], []
    for n in (64, 64, 64, 64, 40, 64):
        images = rs.randint(0, 256, (n, 112, 112, 3), np.uint8)
        labels = rs.randint(0, 10575, n).astype(np.int32)
        dev_images, dev_labels = stage(images, labels)
        assert dev_images.is_cuda and dev_labels.dtype == torch.int32
        sent.append((images, labels))
        got.append((dev_images, dev_labels))
    torch.cuda.synchronize()
    for (images, labels), (dev_images, dev_labels) in zip(sent, got):
        assert np.array_equal(dev_images.cpu().numpy(), images)
        assert np.array_equal(dev_labels.cpu().numpy(), labels)
