"""The port's on-device semi-hard mining (ops/mining.py) and the FaceNet
losses (triplet/losses.py) against the JAX package's, on numpy-seeded
embeddings (B = 32, D = 16, 6 identities, the cases of the JAX package's
tests/test_mining.py):

- `pairwise_sq_distances` against JAX's (rtol 1e-5, atol 1e-6, that
  test's bound) and the numpy oracle;
- `semi_hard_negatives_from_noise` with JAX's own Gumbel draw
  (jax.random.gumbel of the key semi_hard_negatives splits nothing from):
  the negatives and `valid` equal to JAX's, index for index, also on a
  batch with tied distances (first index wins in both); the port's own
  draw against the rule oracle of the JAX test (a random pick inside the
  semi-hard set, else the hardest beyond d_ap);
- `semi_hard_triplet_loss` with the noise injected against JAX's (rtol
  1e-5), the hand-computed single-candidate case, and 0 with a zero
  gradient when nothing is valid; its gradient is bitwise repeatable;
- `triplet_loss`, `cosface_loss`, `arcface_loss` and their gradients
  against JAX's (rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.ops import mining as jmining
from face_recognition_models_tpu.triplet import losses as jlosses
from face_recognition_models_tpu_torch.ops import mining
from face_recognition_models_tpu_torch.triplet import losses

B, D = 32, 16
MARGIN = 0.2


def _embeddings(seed=0, b=B):
    rs = np.random.RandomState(seed)
    emb = rs.randn(b, D)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = rs.randint(0, 6, b)
    return emb.astype(np.float32), labels.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pairwise_sq_distances():
    emb, _ = _embeddings()
    got = mining.pairwise_sq_distances(_t(emb)).numpy()
    want = np.asarray(jmining.pairwise_sq_distances(jnp.asarray(emb)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.maximum(2.0 - 2.0 * emb @ emb.T, 0.0),
                               rtol=1e-5, atol=1e-6)
    assert np.allclose(np.diag(got), 0.0, atol=1e-6)


def _tied_embeddings():
    """Two identities of identical images each and one other: every
    distance repeats, so every pick is a tie."""
    emb, labels = _embeddings(2, b=12)
    emb[1:4] = emb[0]
    emb[5:8] = emb[4]
    labels[:4], labels[4:8], labels[8:] = 0, 1, 2
    return emb, labels


@pytest.mark.parametrize("case", ["random", "tied", "single_class"])
def test_semi_hard_negatives_matches_jax(case):
    emb, labels = {"random": lambda: _embeddings(3),
                   "tied": _tied_embeddings,
                   "single_class": lambda: (_embeddings(4)[0],
                                            np.zeros(B, np.int32))}[case]()
    b = len(labels)
    dist = np.asarray(jmining.pairwise_sq_distances(jnp.asarray(emb)))
    key = jax.random.PRNGKey(11)
    want = jmining.semi_hard_negatives(jnp.asarray(dist), jnp.asarray(labels),
                                       MARGIN, key)
    noise = jax.random.gumbel(key, (b, b, b))
    got = mining.semi_hard_negatives_from_noise(_t(dist), _t(labels), MARGIN,
                                                _t(noise))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.negatives.numpy(),
                                  np.asarray(want.negatives))
    assert got.valid.any() == (case != "single_class")


def test_selection_matches_reference_rules():
    """The port's own draw (its generator) against the JAX test's oracle
    (tests/test_mining.py:35)."""
    emb, labels = _embeddings(3)
    dist = np.maximum(2.0 - 2.0 * emb @ emb.T, 0.0)
    mined = mining.semi_hard_negatives(_t(dist), _t(labels), MARGIN,
                                       torch.Generator().manual_seed(0))
    negatives, valid = mined.negatives.numpy(), mined.valid.numpy()
    n_semi = 0
    for i in range(B):
        for j in range(B):
            is_pos = labels[i] == labels[j] and i != j
            d_ap = dist[i, j]
            neg_idx = np.flatnonzero(labels != labels[i])
            semi = neg_idx[(dist[i, neg_idx] > d_ap)
                           & (dist[i, neg_idx] < d_ap + MARGIN)]
            harder = neg_idx[dist[i, neg_idx] > d_ap]
            if not is_pos or (len(semi) == 0 and len(harder) == 0):
                assert not valid[i, j]
                continue
            assert valid[i, j]
            if len(semi) > 0:
                assert negatives[i, j] in semi
                n_semi += 1
            else:
                assert negatives[i, j] == harder[np.argmin(dist[i, harder])]
    assert n_semi > 0


def test_semi_hard_triplet_loss_matches_jax(monkeypatch):
    emb, labels = _embeddings(5)
    key = jax.random.PRNGKey(7)
    want = float(jmining.semi_hard_triplet_loss(
        jnp.asarray(emb), jnp.asarray(labels), MARGIN, key))
    noise = _t(jax.random.gumbel(key, (B, B, B)))
    monkeypatch.setattr(mining, "gumbel", lambda *a: noise)
    x = _t(emb).requires_grad_()
    got = mining.semi_hard_triplet_loss(x, _t(labels), MARGIN)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    jgrad = jax.grad(lambda e: jmining.semi_hard_triplet_loss(
        e, jnp.asarray(labels), MARGIN, key))(jnp.asarray(emb))
    got.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)
    # the gradient is the same bits on a second run
    y = _t(emb).requires_grad_()
    mining.semi_hard_triplet_loss(y, _t(labels), MARGIN).backward()
    assert torch.equal(x.grad, y.grad)


def test_loss_exact_when_single_candidate():
    """The JAX test's hand-computable case: each anchor-positive pair has
    at most one semi-hard negative."""
    def unit(theta):
        return np.array([np.cos(theta), np.sin(theta)] + [0.0] * (D - 2))

    emb = np.stack([unit(0.0), unit(0.05), unit(0.9), unit(2.5)]).astype(
        np.float32)
    labels = np.array([0, 0, 1, 1], np.int32)
    dist = np.maximum(2.0 - 2.0 * emb @ emb.T, 0.0)
    margin = 1.0
    loss = float(mining.semi_hard_triplet_loss(
        _t(emb), _t(labels), margin, torch.Generator().manual_seed(0)))
    total, count = 0.0, 0
    for i in range(4):
        for j in range(4):
            if labels[i] != labels[j] or i == j:
                continue
            d_ap = dist[i, j]
            neg_idx = np.flatnonzero(labels != labels[i])
            semi = neg_idx[(dist[i, neg_idx] > d_ap)
                           & (dist[i, neg_idx] < d_ap + margin)]
            harder = neg_idx[dist[i, neg_idx] > d_ap]
            if len(semi) == 1:
                n = semi[0]
            elif len(semi) == 0 and len(harder) > 0:
                n = harder[np.argmin(dist[i, harder])]
            else:
                continue
            total += max(np.sqrt(d_ap) - np.sqrt(dist[i, n]) + margin, 0.0)
            count += 1
    assert count > 0
    np.testing.assert_allclose(loss, total / count, rtol=1e-4)


def test_no_valid_triplets_zero_loss():
    emb, _ = _embeddings()
    x = _t(emb).requires_grad_()
    loss = mining.semi_hard_triplet_loss(x, torch.zeros(B, dtype=torch.int32),
                                         MARGIN)
    assert float(loss.detach()) == 0.0
    loss.backward()
    assert not x.grad.any()


def _loss_inputs(seed=0, n=12, c=7):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, D).astype(np.float32),
            rs.randn(D, c).astype(np.float32),
            rs.randint(0, c, n).astype(np.int32))


@pytest.mark.parametrize("name", ["cosface_loss", "arcface_loss"])
def test_margin_losses_match_jax(name):
    feats, weight, labels = _loss_inputs()
    jfn = getattr(jlosses, name)
    want, (jgf, jgw) = jax.value_and_grad(
        lambda f, w: jfn(f, w, jnp.asarray(labels)), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(weight))
    f, w = _t(feats).requires_grad_(), _t(weight).requires_grad_()
    got = getattr(losses, name)(f, w, _t(labels))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgf), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)


def test_triplet_loss_matches_jax():
    rs = np.random.RandomState(1)
    a, p, n = (rs.randn(10, D).astype(np.float32) for _ in range(3))
    want = float(jlosses.triplet_loss(a, p, n, margin=0.3))
    got = float(losses.triplet_loss(_t(a), _t(p), _t(n), margin=0.3))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0.0
