"""The port's augmentations (ops/image_ops.py) against the JAX package's.

Each apply takes the parameters the JAX function draws from the same
`jax.random` key splits (its own code, reproduced here on the JAX side) and
must give the JAX function's output within 1e-6. The port's draws, from a
torch.Generator, are held to the JAX distributions by their statistics on
many images. A disabled augmentation draws nothing: the batch, the
generator and a whole train step stay as they are without the flags.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.ops import image_ops as jops
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.ops import image_ops as ops
from face_recognition_models_tpu_torch.train.state import (
    create_train_state,
    state_tensors,
)
from face_recognition_models_tpu_torch.train.step import make_train_step

N, H, W = 8, 16, 12
TOL = {"rtol": 0.0, "atol": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _images(seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1.0, 1.0, (N, H, W, 3)).astype(np.float32)


def _jax_flip(key):
    return np.asarray(jax.random.bernoulli(key, 0.5, (N, 1, 1, 1))
                      ).reshape(N)


def _jax_shift(key, pad):
    ky, kx = jax.random.split(key)
    return (np.asarray(jax.random.randint(ky, (N,), -pad, pad + 1)),
            np.asarray(jax.random.randint(kx, (N,), -pad, pad + 1)))


def _jax_jitter(key, s):
    kb, kc = jax.random.split(key)
    b = jax.random.uniform(kb, (N, 1, 1, 1), jnp.float32, -s, s)
    c = jax.random.uniform(kc, (N, 1, 1, 1), jnp.float32, 1.0 - s, 1.0 + s)
    return np.asarray(b).reshape(N), np.asarray(c).reshape(N)


def _jax_erasing(key, p, n=N, h=H, w=W):
    """random_erasing's draws (image_ops.py:436-446)."""
    karea, kaspect, ky, kx, kp = jax.random.split(key, 5)
    area = jax.random.uniform(karea, (n,), jnp.float32, 0.02, 0.2) * (h * w)
    aspect = jnp.exp(jax.random.uniform(kaspect, (n,), jnp.float32,
                                        -1.204, 1.204))
    eh = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, h)
    ew = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, w)
    y0 = (jax.random.uniform(ky, (n,)) * (h - eh + 1)).astype(jnp.int32)
    x0 = (jax.random.uniform(kx, (n,)) * (w - ew + 1)).astype(jnp.int32)
    live = jax.random.bernoulli(kp, p, (n,))
    return tuple(np.asarray(v) for v in (y0, x0, eh, ew, live))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_flip_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    x = _images(seed)
    want = np.asarray(jops.random_horizontal_flip(key, jnp.asarray(x)))
    got = ops.apply_flip(torch.from_numpy(x), *_t(_jax_flip(key)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pad", [1, 4, 8])
def test_shift_crop_matches_jax(pad):
    key = jax.random.PRNGKey(pad)
    x = _images(pad)
    want = np.asarray(jops.random_shift_crop(key, jnp.asarray(x), pad))
    got = ops.apply_shift(torch.from_numpy(x), *_t(*_jax_shift(key, pad)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("strength", [0.1, 0.4])
def test_color_jitter_matches_jax(strength):
    key = jax.random.PRNGKey(3)
    x = _images(3)
    want = np.asarray(jops.random_color_jitter(key, jnp.asarray(x),
                                               strength))
    got = ops.apply_jitter(torch.from_numpy(x),
                           *_t(*_jax_jitter(key, strength)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("p", [0.25, 1.0])
def test_random_erasing_matches_jax(p):
    key = jax.random.PRNGKey(4)
    x = _images(4)
    want = np.asarray(jops.random_erasing(key, jnp.asarray(x), p))
    got = ops.apply_erasing(torch.from_numpy(x), *_t(*_jax_erasing(key, p)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if p == 1.0:
        assert (got == 0).any()


def test_chain_matches_jax():
    """All four, in the JAX order, from apply_augmentations' key split."""
    key = jax.random.PRNGKey(5)
    x = _images(5)
    want = np.asarray(jops.apply_augmentations(key, jnp.asarray(x), True, 4,
                                               0.3, 0.5))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    got = torch.from_numpy(x)
    got = ops.apply_flip(got, *_t(_jax_flip(k1)))
    got = ops.apply_shift(got, *_t(*_jax_shift(k2, 4)))
    got = ops.apply_jitter(got, *_t(*_jax_jitter(k3, 0.3)))
    got = ops.apply_erasing(got, *_t(*_jax_erasing(k4, 0.5)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_draws_follow_the_jax_distributions():
    """The port's draws against JAX's on 20,000 images: the same support
    and means within a few standard errors."""
    n = 20000
    gen = torch.Generator().manual_seed(0)
    flip = ops.draw_flip(gen, n, "cpu").float()
    assert abs(float(flip.mean()) - 0.5) < 0.02

    dy, dx = ops.draw_shift(gen, n, 3, "cpu")
    for d in (dy, dx):
        assert set(d.tolist()) == set(range(-3, 4))
        assert abs(float(d.float().mean())) < 0.05

    b, c = ops.draw_jitter(gen, n, 0.2, "cpu")
    assert float(b.min()) >= -0.2 and float(b.max()) <= 0.2
    assert float(c.min()) >= 0.8 and float(c.max()) <= 1.2
    assert abs(float(b.mean())) < 0.005 and abs(float(c.mean()) - 1) < 0.005

    h, w = 112, 112
    y0, x0, eh, ew, live = ops.draw_erasing(gen, n, h, w, 0.25, "cpu")
    jy0, jx0, jeh, jew, jlive = _jax_erasing(jax.random.PRNGKey(0), 0.25,
                                             n, h, w)
    assert bool((y0 >= 0).all() and (y0 + eh <= h).all())
    assert bool((x0 >= 0).all() and (x0 + ew <= w).all())
    assert bool((eh >= 1).all() and (ew >= 1).all())
    assert abs(float(live.float().mean()) - 0.25) < 0.02
    for got, want in ((eh, jeh), (ew, jew), (y0, jy0), (x0, jx0)):
        got = got.float().numpy()
        se = 4 * want.std() / np.sqrt(n) * np.sqrt(2)
        assert abs(got.mean() - want.mean()) < se + 1e-3, (got.mean(),
                                                           want.mean())
        assert abs(got.std() - want.std()) < 0.05 * want.std()


def test_disabled_augmentations_draw_nothing():
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    x = torch.from_numpy(_images())
    assert ops.apply_augmentations(gen, x) is x
    assert ops.apply_augmentations(None, x, False, 0, 0.0, 0.0) is x
    assert torch.equal(gen.get_state(), before)


@pytest.mark.parametrize("name", ["arcface", "elastic_arcface"])
def test_default_step_is_unchanged(name):
    """With every augmentation off, a train step built with the new
    arguments given at their defaults equals one built without them, bit
    for bit, and the generator moves only by the head's own draws."""
    cfg = tcfg.TrainConfig(head=name, num_classes=8, batch_size=N, seed=0,
                           data=tcfg.DataConfig(image_size=16))
    head_cfg = tcfg.make_head_config(name, feature_dim=32, num_classes=8)
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (N, 16, 16, 3), np.uint8)
    labels = rs.randint(0, 8, N).astype(np.int32)
    out = []
    for kw in ({}, {"horizontal_flip": False, "crop_pad": 0,
                    "color_jitter": 0.0, "random_erasing": 0.0,
                    "freeze_backbone": False, "grad_accum": 1,
                    "model_ema": 0.0}):
        _, head, state = create_train_state(cfg, head_cfg,
                                            torch.device("cpu"))
        gen0 = state.rng.get_state()
        step = make_train_step(get_head(name), head_cfg, device="cpu", **kw)
        _, m = step(state, images, labels)
        out.append((float(m["loss"]), state))
        if not head.requires_rng:
            assert torch.equal(state.rng.get_state(), gen0)
    assert out[0][0] == out[1][0]
    for x, y in zip(state_tensors(out[0][1]), state_tensors(out[1][1]),
                    strict=True):
        assert torch.equal(x, y)
    assert torch.equal(out[0][1].rng.get_state(), out[1][1].rng.get_state())
