"""The CUDA kernels of the port against their plain PyTorch versions, on the
card: the three margin + CE kernels and their memory-blended (_mem)
variants. Marked `cuda`: they skip where there is no CUDA device. On a machine
with a card (the JAX package need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: kernel and plain version both run IEEE fp32 on the card and sum
in different orders: statistics rtol = atol = 1e-5; gradients rtol 1e-3 with
an atol of 1e-5 x the largest value; `higher` may flip by 1 where a cosine
lies within rounding of the target's.
"""

import pytest
import torch

from face_recognition_models_tpu_torch.ops import fused_head as fh
from face_recognition_models_tpu_torch.ops.normalize import l2_normalize

pytestmark = pytest.mark.cuda

MODES = [(fh.MODE_IDENTITY, None), (fh.MODE_MV, 1e-7),
         (fh.MODE_CURRICULAR, 0.0)]
PLAIN = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dw")
MEM = ("fused_ce_fwd_mem", "fused_ce_bwd_dx_mem", "fused_ce_bwd_dw_mem")


def _counts(launched):
    """The launch counters expected after one launch of each of `launched`."""
    return {k: int(k in launched) for k in PLAIN + MEM}


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
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros(8, 4096, device=cuda)
        fh.fused_ce_bwd_dw(wide, torch.zeros(4096, 50, device=cuda), labels,
                           t, scale, ab, t, t, 0)
    memn, lam = _mem_inputs(64, 50, 2, cuda)
    with pytest.raises(ValueError, match="memn"):
        fh.fused_ce_fwd_mem(xn, wn, memn[:, :40].contiguous(), lam, labels,
                            t, tcos, scale, ab, 0)
    with pytest.raises(ValueError, match="shared memory"):
        # 3 x 640 x 32 x 4 B for the resident wn / memn / dw tiles alone
        # leaves the 232,448 B limit behind
        d = 640
        fh.fused_ce_bwd_dw_mem(
            torch.zeros(8, d, device=cuda), torch.zeros(d, 50, device=cuda),
            torch.zeros(d, 50, device=cuda), lam, labels, t, scale, ab, t, t,
            0)
