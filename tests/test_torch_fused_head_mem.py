"""The port's memory-blended fused head (`fused_margin_ce_mem`) against the
JAX package's.

The JAX side runs its Pallas kernels in interpret mode with small tiles
(block_n=16, block_c=64), as its own tests do; the port's side runs the plain
PyTorch versions, which are what its wrappers compute on CPU tensors.
Inputs are made with numpy from a seed and handed to both; lam mixes 0, the
VPL weight 0.15 and QAFace's 1. Tolerances are those of
tests/test_fused_head.py:292-350: outputs rtol = atol = 2e-5 (fp32
logsumexp over 100 classes summed in different orders), `higher` exact,
gradients rtol 5e-4 atol 1e-6 (fp32 products in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.ops import fused_head as jfh
from face_recognition_models_tpu_torch.ops import fused_head as tfh

N, D, C = 24, 64, 100   # C deliberately not a multiple of block_c
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
MODES = [(tfh.MODE_IDENTITY, None), (tfh.MODE_MV, 1e-7),
         (tfh.MODE_CURRICULAR, 0.0)]


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


@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_fused_margin_ce_mem_matches_jax(mode, clamp_eps):
    x = _inputs(mode)
    const = {k: jnp.asarray(x[k]) for k in ("memn", "lam", "labels", "tcos",
                                             "ab")}

    def jfun(xn_, wn_, t_, scale_):
        return jfh.fused_margin_ce_mem(
            xn_, wn_, const["memn"], const["lam"], const["labels"], t_,
            const["tcos"], scale_, const["ab"], mode, clamp_eps, 16, 64, True)

    jout, vjp = jax.vjp(jfun, *(jnp.asarray(x[k])
                                for k in ("xn", "wn", "t", "scale")))
    jgrads = vjp(jfh.FusedHeadOut(jnp.asarray(x["g_lse"]),
                                  jnp.asarray(x["g_t"]),
                                  jnp.zeros(N, jnp.float32)))

    leaves = [torch.tensor(x[k], requires_grad=True)
              for k in ("xn", "wn", "t", "scale")]
    tx, tw, tt, ts = leaves
    out = tfh.fused_margin_ce_mem(tx, tw, torch.tensor(x["memn"]),
                                  torch.tensor(x["lam"]),
                                  torch.tensor(x["labels"]), tt,
                                  torch.tensor(x["tcos"]), ts,
                                  torch.tensor(x["ab"]), mode, clamp_eps)
    ((out.lse * torch.tensor(x["g_lse"])).sum()
     + (out.target_logit * torch.tensor(x["g_t"])).sum()).backward()

    np.testing.assert_allclose(out.lse.detach().numpy(), np.asarray(jout.lse),
                               **OUT_TOL)
    np.testing.assert_allclose(out.target_logit.detach().numpy(),
                               np.asarray(jout.target_logit), **OUT_TOL)
    np.testing.assert_array_equal(out.higher.numpy(), np.asarray(jout.higher))
    for leaf, want, name in zip(leaves, jgrads, ("dx", "dw", "dt", "dscale")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_mem_kernel_wrappers_compute_plain_versions_on_cpu(mode, clamp_eps):
    """On CPU tensors the three _mem wrappers return their plain versions
    exactly and launch nothing."""
    x = {k: torch.tensor(v) for k, v in _inputs(mode, seed=3).items()}
    tfh.reset_launch_counts()
    fwd = (x["xn"], x["wn"], x["memn"], x["lam"], x["labels"], x["t"],
           x["tcos"], x["scale"], x["ab"], mode, clamp_eps)
    out = tfh.fused_ce_fwd_mem(*fwd)
    for a, b in zip(out, tfh.fused_margin_ce_mem_plain(*fwd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bwd = (x["xn"], x["wn"], x["memn"], x["lam"], x["labels"], x["t"],
           x["scale"], x["ab"], out.lse, x["g_lse"])
    for a, b in zip(tfh.fused_ce_bwd_dx_mem(*bwd, x["g_t"], mode, clamp_eps),
                    tfh.fused_ce_bwd_dx_mem_plain(*bwd, x["g_t"], mode,
                                                  clamp_eps)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        tfh.fused_ce_bwd_dw_mem(*bwd, mode, clamp_eps),
        tfh.fused_ce_bwd_dw_mem_plain(*bwd, mode, clamp_eps), rtol=0, atol=0)
    assert all(v == 0 for v in tfh.launch_counts.values())


def test_mem_plain_at_lam_zero_and_one():
    """lam = 0 everywhere is the unblended head; a column with lam = 1 takes
    no dw and sends all of its dx through memn."""
    x = {k: torch.tensor(v) for k, v in _inputs(tfh.MODE_IDENTITY,
                                               seed=5).items()}
    zero = torch.zeros(C)
    fwd = (x["labels"], x["t"], x["tcos"], x["scale"], x["ab"],
           tfh.MODE_IDENTITY, 1e-7)
    blended = tfh.fused_margin_ce_mem_plain(x["xn"], x["wn"], x["memn"], zero,
                                            *fwd)
    plain = tfh.fused_margin_ce_plain(x["xn"], x["wn"], *fwd)
    for a, b in zip(blended, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    lam = x["lam"]
    bwd = (x["labels"], x["t"], x["scale"], x["ab"], blended.lse,
           x["g_lse"])
    dw = tfh.fused_ce_bwd_dw_mem_plain(x["xn"], x["wn"], x["memn"], lam, *bwd,
                                       tfh.MODE_IDENTITY, 1e-7)
    assert (lam == 1).any() and (lam == 0).any()
    assert float(dw[:, lam == 1].abs().max()) == 0.0
    assert float(dw[:, lam == 0].abs().max()) > 0.0
    # dx with wn zeroed in the lam = 1 columns is unchanged: those columns
    # reach dx only through memn
    wn_cut = x["wn"].clone()
    wn_cut[:, lam == 1] = 0.0
    dx, _, _ = tfh.fused_ce_bwd_dx_mem_plain(x["xn"], x["wn"], x["memn"], lam,
                                             *bwd, x["g_t"],
                                             tfh.MODE_IDENTITY, 1e-7)
    dcos, _, _ = tfh._dcos_plain(x["xn"], x["wn"], *bwd, tfh.MODE_IDENTITY,
                                 1e-7, x["memn"], lam)
    want = (dcos * (1 - lam)) @ wn_cut.T + (dcos * lam) @ x["memn"].T
    torch.testing.assert_close(dx, want, rtol=1e-6, atol=1e-7)
