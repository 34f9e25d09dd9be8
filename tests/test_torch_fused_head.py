"""The port's fused margin + CE head against the JAX package's.

The JAX side runs its Pallas kernels in interpret mode with small tiles
(block_n=16, block_c=64), as its own tests do; the port's side runs the plain
PyTorch versions, which are what its wrappers compute on CPU tensors.
Inputs are made with numpy from a seed and handed to both. Tolerances are
those of tests/test_fused_head.py: lse / target logit rtol = atol = 2e-5
(fp32 logsumexp over 100 classes summed in different orders), `higher`
exact, gradients rtol 5e-4 atol 2e-6 (fp32 products in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.heads.fused_adapter import (
    fused_apply as jfused_apply)
from face_recognition_models_tpu.ops import fused_head as jfh
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads.fused_adapter import (
    fused_apply as tfused_apply)
from face_recognition_models_tpu_torch.ops import fused_head as tfh

N, D, C = 24, 64, 100   # C deliberately not a multiple of block_c
GRAD_TOL = dict(rtol=5e-4, atol=2e-6)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)


def _unit(x, axis):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _inputs(mode, seed=0):
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
    g_lse = rs.randn(N).astype(np.float32) / N
    g_t = rs.randn(N).astype(np.float32) / N
    return xn, wn, labels, t, tcos, scale, ab, g_lse, g_t


MODES = [(tfh.MODE_IDENTITY, None), (tfh.MODE_MV, 1e-7),
         (tfh.MODE_CURRICULAR, 0.0)]


@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_fused_margin_ce_matches_jax(mode, clamp_eps):
    xn, wn, labels, t, tcos, scale, ab, g_lse, g_t = _inputs(mode)
    assert jfh.MODE_IDENTITY == tfh.MODE_IDENTITY
    assert jfh.MODE_MV == tfh.MODE_MV
    assert jfh.MODE_CURRICULAR == tfh.MODE_CURRICULAR

    def jfun(xn_, wn_, t_, scale_):
        return jfh.fused_margin_ce(xn_, wn_, jnp.asarray(labels), t_,
                                   jnp.asarray(tcos), scale_, jnp.asarray(ab),
                                   mode, clamp_eps, 16, 64, True)

    jout, vjp = jax.vjp(jfun, *map(jnp.asarray, (xn, wn, t, scale)))
    jdx, jdw, jdt, jdscale = vjp(jfh.FusedHeadOut(
        jnp.asarray(g_lse), jnp.asarray(g_t), jnp.zeros(N, jnp.float32)))

    tx, tw, tt, ts = (torch.tensor(a, requires_grad=True)
                      for a in (xn, wn, t, scale))
    out = tfh.fused_margin_ce(tx, tw, torch.tensor(labels), tt,
                              torch.tensor(tcos), ts, torch.tensor(ab), mode,
                              clamp_eps)
    ((out.lse * torch.tensor(g_lse)).sum()
     + (out.target_logit * torch.tensor(g_t)).sum()).backward()

    np.testing.assert_allclose(out.lse.detach().numpy(), np.asarray(jout.lse),
                               **OUT_TOL)
    np.testing.assert_allclose(out.target_logit.detach().numpy(),
                               np.asarray(jout.target_logit), **OUT_TOL)
    np.testing.assert_array_equal(out.higher.numpy(),
                                  np.asarray(jout.higher))
    for got, want, name in ((tx.grad, jdx, "dx"), (tw.grad, jdw, "dw"),
                            (tt.grad, jdt, "dt"), (ts.grad, jdscale, "dscale")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("mode,clamp_eps", MODES)
def test_kernel_wrappers_match_plain_backward_on_cpu(mode, clamp_eps):
    """On CPU tensors the three kernel wrappers compute the plain versions:
    together they give the whole plain backward, and the forward wrapper
    the plain forward."""
    xn, wn, labels, t, tcos, scale, ab, g_lse, g_t = (
        torch.tensor(a) for a in _inputs(mode, seed=3))
    out = tfh.fused_ce_fwd(xn, wn, labels, t, tcos, scale, ab, mode,
                           clamp_eps)
    plain = tfh.fused_margin_ce_plain(xn, wn, labels, t, tcos, scale, ab,
                                      mode, clamp_eps)
    for a, b in zip(out, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dx, dt, dscale = tfh.fused_ce_bwd_dx(xn, wn, labels, t, scale, ab,
                                         out.lse, g_lse, g_t, mode, clamp_eps)
    dw = tfh.fused_ce_bwd_dw(xn, wn, labels, t, scale, ab, out.lse, g_lse,
                             mode, clamp_eps)
    ref = tfh.fused_margin_ce_bwd_plain(xn, wn, labels, t, scale, ab,
                                        out.lse, g_lse, g_t, mode, clamp_eps)
    for got, want in zip((dx, dw, dt, dscale), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(v == 0 for v in tfh.launch_counts.values())


def test_arcface_fused_apply_matches_jax():
    """The arcface row reduction + fused CE + top-k metrics, and the
    gradients with respect to the class kernel and the raw features."""
    rs = np.random.RandomState(1)
    kernel = rs.uniform(-0.2, 0.2, (D, C)).astype(np.float32)
    feats = (10.0 * rs.randn(N, D)).astype(np.float32)
    labels = rs.randint(0, C, N).astype(np.int32)
    jc = jcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    tc = tcfg.make_head_config("arcface", feature_dim=D, num_classes=C)

    def jloss(k, f):
        out = jfused_apply(jc, k, f, jnp.asarray(labels), None, block_n=16,
                           block_c=64, interpret=True)
        return out.loss_id, out

    (jl, jout), (jgk, jgf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(kernel),
                                             jnp.asarray(feats))
    tk = torch.tensor(kernel, requires_grad=True)
    tf = torch.tensor(feats, requires_grad=True)
    tout = tfused_apply(tc, tk, tf, torch.tensor(labels))
    tout.loss_id.backward()

    np.testing.assert_allclose(float(tout.loss_id.detach()), float(jl), **OUT_TOL)
    assert float(tout.acc1) == float(jout.acc1)
    assert float(tout.acc5) == float(jout.acc5)
    np.testing.assert_allclose(tout.norms.detach().numpy(),
                               np.asarray(jout.norms), rtol=1e-6)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgk), **GRAD_TOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), **GRAD_TOL)


def test_arcface_fused_matches_eager_head():
    """Within the port: the fused path and the eager [N, C] head give the
    same loss, metrics and gradients (the contract of tests/
    test_fused_head.py, same tolerances)."""
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.train.losses import (
        mean_cross_entropy)
    from face_recognition_models_tpu_torch.train.metrics import topk_accuracy

    rs = np.random.RandomState(2)
    kernel = rs.uniform(-0.2, 0.2, (D, C)).astype(np.float32)
    feats = (10.0 * rs.randn(N, D)).astype(np.float32)
    labels = torch.tensor(rs.randint(0, C, N).astype(np.int32))
    cfg = tcfg.make_head_config("arcface", feature_dim=D, num_classes=C)

    k1 = torch.tensor(kernel, requires_grad=True)
    f1 = torch.tensor(feats, requires_grad=True)
    fused = tfused_apply(cfg, k1, f1, labels)
    fused.loss_id.backward()
    k2 = torch.tensor(kernel, requires_grad=True)
    f2 = torch.tensor(feats, requires_grad=True)
    eager = get_head("arcface").apply(cfg, k2, f2, labels)
    loss = mean_cross_entropy(eager.logits, labels)
    loss.backward()
    acc1, acc5 = topk_accuracy(eager.pre_logits, labels)

    np.testing.assert_allclose(float(fused.loss_id.detach()), float(loss.detach()), **OUT_TOL)
    assert float(fused.acc1) == float(acc1)
    assert float(fused.acc5) == float(acc5)
    np.testing.assert_allclose(k1.grad.numpy(), k2.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(f1.grad.numpy(), f2.grad.numpy(), **GRAD_TOL)


def test_kernel_init_matches_jax_distribution():
    """Xavier-uniform kernels: same shape and bound as the JAX head's init
    (the generators differ, so the values do)."""
    from face_recognition_models_tpu_torch.heads import get_head

    cfg = tcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    w = get_head("arcface").init_kernel(cfg, torch.Generator().manual_seed(0))
    jw = jget_head("arcface").init_kernel(
        jax.random.PRNGKey(0),
        jcfg.make_head_config("arcface", feature_dim=D, num_classes=C))
    bound = float(np.sqrt(6.0 / (D + C)))
    assert tuple(w.shape) == jw.shape == (D, C)
    assert float(w.abs().max()) <= bound
    assert float(np.abs(np.asarray(jw)).max()) <= bound
