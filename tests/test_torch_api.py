"""The port's reference-style API (face_recognition_models_tpu_torch/api.py)
against the JAX package's api.py, on the CPU.

ArcFaceNet and VPLArcFaceNet on a tiny fp32 ResNet (one BasicBlock stage, 8
filters, 16-d embeddings, 16 px) swapped in for the backbone on both sides,
with the JAX weights bridged by utils/weights.from_jax: the train-mode
forward's HeadOutput fields, the new head state and the new BatchNorm
statistics, the eval embedding and get_proxy. Tolerances: rtol 1e-4 /
atol 1e-4 on logits (scale 64), rtol 1e-5 / atol 1e-5 elsewhere (fp32 on
both sides); one_hot and get_proxy equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu import api as japi
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu_torch import api as tapi
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.utils.weights import (
    from_jax,
    head_state_from_jax,
)

D, C, IMAGE = 16, 10, 16
NETS = ["SphereFaceNet", "CosFaceNet", "ArcFaceNet", "MV_SoftmaxNet",
        "CurricularFaceNet", "VPLArcFaceNet", "AdaFaceNet",
        "ElasticArcFaceNet", "ElasticCosFaceNet", "MagFaceNet", "QAFaceNet"]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(ctor_name):
    """(JAX model, variables, kernel, state, port model, port state) with
    the same weights."""
    jm = getattr(japi, ctor_name)(num_classes=C, feature_dim=D)
    jm.image_size = IMAGE
    jm.backbone = JResNet(stage_sizes=(1,), block=JBasic, embed_dim=D,
                          num_filters=8, dtype=jnp.float32)
    variables, kernel, state = jm.init(jax.random.PRNGKey(0))
    tm = getattr(tapi, ctor_name)(num_classes=C, feature_dim=D)
    tm.backbone = ResNet((1,), BasicBlock, embed_dim=D, num_filters=8,
                         dtype=torch.float32)
    tstate = tm.init(torch.Generator().manual_seed(0), device="cpu")
    sd, _ = from_jax(_host(variables["params"]),
                     _host(variables["batch_stats"]))
    tm.backbone.load_state_dict(sd)
    with torch.no_grad():
        tm.kernel.copy_(torch.from_numpy(np.asarray(kernel)))
    if state is not None:
        tstate = head_state_from_jax(jm.head_name, _host(state))
    return jm, variables, kernel, state, tm, tstate


def _batch():
    rs = np.random.RandomState(1)
    return (rs.randint(0, 256, (4, IMAGE, IMAGE, 3), np.uint8),
            np.asarray([0, 1, 2, 3], np.int32))


@pytest.mark.parametrize("ctor_name", ["ArcFaceNet", "VPLArcFaceNet"])
def test_train_forward_embed_and_proxy_match_jax(ctor_name):
    jm, variables, kernel, state, tm, tstate = _pair(ctor_name)
    images, labels = _batch()
    jout, jstats = jm.train_forward(variables, kernel, jnp.asarray(images),
                                    jnp.asarray(labels), state,
                                    rng=jax.random.PRNGKey(2))
    tout, tstats = tm.train_forward(torch.from_numpy(images),
                                    torch.from_numpy(labels), tstate)
    for field in ("pre_logits", "logits"):
        np.testing.assert_allclose(getattr(tout, field).detach().numpy(),
                                   np.asarray(getattr(jout, field)),
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    np.testing.assert_allclose(tout.norms.detach().numpy(),
                               np.asarray(jout.norms), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tout.loss_g), float(jout.loss_g),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tout.one_hot.numpy(),
                                  np.asarray(jout.one_hot))
    if state is not None:
        want = head_state_from_jax(jm.head_name, _host(jout.state))
        for a, b in zip(tout.state, want):
            np.testing.assert_allclose(a.detach().float().numpy(),
                                       b.float().numpy(), rtol=1e-5,
                                       atol=1e-5)
    want_sd, _ = from_jax(_host(variables["params"]), _host(jstats))
    assert tstats and set(tstats) <= set(want_sd)
    for name, v in tstats.items():
        np.testing.assert_allclose(v.numpy(), want_sd[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the port's train-mode forward moved its running statistics in place:
    # the JAX embedding with the new batch_stats
    emb = tm.embed(torch.from_numpy(images))
    assert emb.dtype == torch.float32 and emb.shape == (4, D)
    moved = {"params": variables["params"], "batch_stats": jstats}
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(jm.embed(moved, jnp.asarray(images))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tm.get_proxy(torch.from_numpy(labels)).detach().numpy(),
        np.asarray(jm.get_proxy(kernel, jnp.asarray(labels))))


def test_all_net_constructors_exist():
    for name in NETS:
        model = getattr(tapi, name)(num_classes=7)
        assert model.head_cfg.num_classes == 7
        assert model.loss_model == model.head_name
        assert model.head_name == getattr(japi, name)(7).head_name
        assert model.kernel.shape == (512, 7)


def test_head_overrides():
    model = tapi.MV_SoftmaxNet(num_classes=5, margin_type="arc")
    assert model.head_cfg.margin_type == "arc"


def test_memory_training_toggle_and_frozen_memory():
    _, _, _, _, tm, state = _pair("VPLArcFaceNet")
    assert bool(state.training_flag)
    off = tapi.set_memory_training(state, False)
    assert not bool(off.training_flag)
    assert off.training_flag.dtype == state.training_flag.dtype
    images, labels = _batch()
    out, _ = tm.train_forward(torch.from_numpy(images),
                              torch.from_numpy(labels), off)
    torch.testing.assert_close(out.state.mem, off.mem, rtol=0, atol=0)
    torch.testing.assert_close(out.state.life, off.life, rtol=0, atol=0)
    on, _ = tm.train_forward(torch.from_numpy(images),
                             torch.from_numpy(labels), state)
    assert not torch.equal(on.state.mem, state.mem)
    with pytest.raises(ValueError, match="training flag"):
        tapi.set_memory_training(None, False)


def test_init_is_seeded_and_defaults_to_the_card():
    a = tapi.ArcFaceNet(num_classes=C, feature_dim=D)
    b = tapi.ArcFaceNet(num_classes=C, feature_dim=D)
    assert a.init(torch.Generator().manual_seed(3), device="cpu") is None
    b.init(torch.Generator().manual_seed(3), device="cpu")
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    assert float(a.kernel.abs().sum()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            a.init(torch.Generator().manual_seed(3))
