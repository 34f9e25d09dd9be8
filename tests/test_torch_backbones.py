"""The port's trunks against the JAX registry's: resnet18, mobilefacenet,
iresnet18 and iresnet50 here (iresnet100 and inception_v3 in
test_torch_backbones_deep.py, mobilenet_v2, efficientnet_b0 and resnet50
in test_torch_backbones_cnn.py, the ViTs in test_torch_backbones_vit.py),
forward in eval and train mode, train-mode
BatchNorm statistics, and the input and parameter gradients, through
`from_jax` of the JAX weights (tests/torch_backbone_parity.py states the
sizes, the two precisions and the tolerances). Also: the registry, the
depthwise ops against ops/depthwise.py, the initialisers, the bridge's
refusals, the FaceNet wrapper and the dropout law.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_backbone_parity as parity
from torch_backbone_parity import (  # noqa: F401  (fixture and tests)
    cases,
    test_eval_forward_matches_jax,
    test_input_gradient_matches_jax,
    test_parameter_gradients_match_jax,
    test_train_forward_and_statistics_match_jax,
)
from face_recognition_models_tpu.models import BACKBONES as JBACKBONES
from face_recognition_models_tpu.models.facenet import FaceNetEmbedding
from face_recognition_models_tpu.ops import depthwise as jdw
from face_recognition_models_tpu_torch.models import BACKBONES, get_backbone
from face_recognition_models_tpu_torch.models import facenet
from face_recognition_models_tpu_torch.models.dropout import (
    drop_path,
    dropout,
)
from face_recognition_models_tpu_torch.models.iresnet import PReLU
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.ops import depthwise
from face_recognition_models_tpu_torch.utils.weights import from_jax

TRUNKS = ("resnet18", "mobilefacenet", "iresnet18", "iresnet50")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", TRUNKS)


def test_registry_is_the_jax_registry_in_its_order():
    assert list(BACKBONES) == list(JBACKBONES)
    assert len(BACKBONES) == 12


# --- ops/depthwise.py: tests/test_depthwise.py's bounds --------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw,c", [(8, 16), (7, 8)])
def test_depthwise_matches_jax(stride, hw, c):
    rs = np.random.RandomState(hw + c + stride)
    x = rs.randn(4, hw, hw, c).astype(np.float32)
    kern = rs.randn(3, 3, 1, c).astype(np.float32)
    want = np.asarray(jdw.depthwise_conv3x3(jnp.asarray(x), jnp.asarray(
        kern), stride=stride))
    got = depthwise.depthwise_conv3x3(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(kern.transpose(3, 2, 0, 1)), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_depthwise_gradients_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 8, 8).astype(np.float32)
    kern = rs.randn(3, 3, 1, 8).astype(np.float32)
    gx, gk = jax.grad(lambda a, b: jnp.sum(
        jdw.depthwise_conv3x3(a, b) ** 2), (0, 1))(jnp.asarray(x),
                                                   jnp.asarray(kern))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    tk = torch.from_numpy(kern.transpose(3, 2, 0, 1)).requires_grad_(True)
    (depthwise.depthwise_conv3x3(tx, tk) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tk.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(gk), atol=1e-3, rtol=1e-4)


def test_global_depthwise_matches_jax_and_checks_its_kernel():
    rs = np.random.RandomState(3)
    x = rs.randn(3, 7, 7, 16).astype(np.float32)
    kern = rs.randn(7, 7, 1, 16).astype(np.float32)
    want = np.asarray(jdw.global_depthwise(jnp.asarray(x),
                                           jnp.asarray(kern)))
    got = depthwise.global_depthwise(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(kern.transpose(3, 2, 0, 1)))
    assert got.shape == (3, 16, 1, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="must be"):
        depthwise.global_depthwise(torch.zeros(1, 16, 6, 6),
                                   torch.zeros(16, 1, 7, 7))
    with pytest.raises(ValueError, match="stride"):
        depthwise.depthwise_conv3x3(torch.zeros(1, 4, 6, 6),
                                    torch.zeros(4, 1, 3, 3), stride=3)


# --- initialisers, the bridge's refusals ----------------------------------

def test_init_weights_uses_each_flax_initialiser():
    vit = get_backbone("vit_t", embed_dim=16, image_size=32)
    init_weights(vit, torch.Generator().manual_seed(0))
    std = float(vit.pos_embed.detach().std())
    assert 0.018 < std < 0.022, std
    init_weights(vit, torch.Generator().manual_seed(0))
    again = vit.pos_embed.detach().clone()
    init_weights(vit, torch.Generator().manual_seed(0))
    assert torch.equal(vit.pos_embed, again)
    net = get_backbone("iresnet18", embed_dim=16, image_size=32)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, PReLU):
                m.weight.fill_(1.0)
    init_weights(net, torch.Generator().manual_seed(0))
    slopes = [m.weight for m in net.modules() if isinstance(m, PReLU)]
    assert slopes and all(bool((s == 0.25).all()) for s in slopes)
    # the feature BatchNorm has no scale: a buffer of ones, no parameter
    names = dict(net.named_parameters())
    assert "features.weight" not in names and "features.bias" in names
    assert torch.equal(net.state_dict()["features.weight"],
                       torch.ones(16))
    mfn = get_backbone("mobilefacenet", embed_dim=16, image_size=32)
    init_weights(mfn, torch.Generator().manual_seed(1))
    w = mfn.block0_0.depthwise.weight           # [C, 1, 3, 3], fan-in 9
    assert w.shape[1:] == (1, 3, 3)
    assert 0.25 < float(w.std()) < 0.42, float(w.std())   # ~ 1 / 3


def test_from_jax_refuses_what_it_does_not_know():
    module = parity.jax_module("mobilefacenet")
    params, stats = parity.seeded_variables(module, 32)
    params = dict(params)
    params["stem"] = {**params["stem"], "extra": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unknown JAX leaves"):
        from_jax(params, stats)
    params, stats = parity.seeded_variables(module, 32)
    stats = {**stats, "orphan": {"mean": np.zeros(2), "var": np.ones(2)}}
    with pytest.raises(ValueError, match="did not use"):
        from_jax(params, stats)
    params, stats = parity.seeded_variables(module, 32)
    sd, _ = from_jax(params, stats)
    sd.pop("gdconv.weight")
    with pytest.raises(RuntimeError, match="gdconv.weight"):
        parity.port_module("mobilefacenet").load_state_dict(sd, strict=True)


def test_facenet_wrapper_matches_jax():
    jmodel = FaceNetEmbedding(trunk_name="mobilefacenet", embed_dim=16,
                              dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, 32, seed=5)
    x = np.random.RandomState(6).randn(3, 32, 32, 3).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(lambda p, xs: jmodel.apply(
            {"params": p, "batch_stats": stats}, xs, train=False))(
                params, jnp.asarray(x)))
    model = facenet.facenet_embedding("mobilefacenet", embed_dim=16,
                                      dtype=torch.float32, image_size=32)
    sd, _ = from_jax(params, stats)
    assert all(k.startswith("trunk.") for k in sd)
    model.load_state_dict(sd, strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    parity.close(got, want)


# --- the dropout law (models/dropout.py) ----------------------------------

def test_dropout_keeps_at_the_rate_scales_and_repeats():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    y = dropout(x, 0.2, gen, training=True)
    kept = y != 0
    frac = float(kept.float().mean())
    # binomial sd at n = 2e5, p = 0.8: 8.9e-4; 5 sd
    assert abs(frac - 0.8) < 5 * 8.9e-4, frac
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    gen.set_state(state)
    assert torch.equal(dropout(x, 0.2, gen, training=True), y)
    assert not torch.equal(dropout(x, 0.2, gen, training=True), y)
    assert dropout(x, 0.2, None, training=False) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.2, None, training=True)


def test_drop_path_keeps_whole_rows():
    y = torch.ones(20_000, 3, 2, 2)
    gen = torch.Generator().manual_seed(4)
    out = drop_path(y, 0.25, gen, training=True)
    rows = out.flatten(1)
    kept = rows[:, 0] != 0
    assert torch.equal(rows != 0, kept[:, None].expand_as(rows))
    # binomial sd at n = 2e4, p = 0.75: 3.1e-3; 5 sd
    assert abs(float(kept.float().mean()) - 0.75) < 5 * 3.1e-3
    assert torch.allclose(rows[kept], torch.full_like(rows[kept], 1 / 0.75))
    assert drop_path(y, 0.25, None, training=False) is y


def test_dropout_trunks_need_the_generator_in_train_mode():
    for name in ("mobilenet_v2", "efficientnet_b0"):
        model = get_backbone(name, embed_dim=8, dtype=torch.float32)
        x = torch.zeros(2, 32, 32, 3)
        model.train()
        with pytest.raises(ValueError, match="generator"):
            model(x)
        gen = torch.Generator().manual_seed(0)
        state = gen.get_state()
        a = model(x, rng=gen)
        gen.set_state(state)
        assert torch.equal(model(x, rng=gen), a)
        model.eval()
        with torch.no_grad():
            model(x)
