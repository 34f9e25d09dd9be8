"""The port's train step for the eleven heads beyond ArcFace and the
memory-blended two, against the JAX package's train step, and a resumed
`fit` of the heads with step-to-step state against the uninterrupted run.

Both steps start from the same weights (carried over by
`utils/weights.from_jax`) and take the same two batches. The port runs the
path `train --head-path auto` gives the head (the fused kernels' plain
versions on the CPU for the nine fused heads, the eager head for
subcenter_arcface and adacos); the JAX step runs its jnp head, so each fused
head is held to the other path within the bounds of the JAX package's own
fused-vs-jnp step test (tests/test_fused_head.py:101-164): loss rtol 1e-4,
parameters rtol 1e-3 atol 1e-5; the head states (statistics of features
the two paths compute in other orders) rtol 1e-4 atol 1e-5. The elastic
heads' normal draw is the one the JAX step makes from its key, handed to
the port through `margins._normal_noise`. Tiny ResNet in fp32, N=16, D=32,
C=64, 16 px, SGD lr 0.05 momentum 0.9 wd 5e-4.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu.train import TrainState as JTrainState
from face_recognition_models_tpu.train import get_optimizer as jget_optimizer
from face_recognition_models_tpu.train import make_train_step as jmake_step
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities)
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.heads import margins as tmargins
from face_recognition_models_tpu_torch.heads.fused_adapter import use_fused
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import (
    from_jax,
    head_state_from_jax,
)
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

N, D, C = 16, 32, 64
IMAGE = 16
STEPS = 2
LR = 0.05
# (head, config overrides, lambda_g)
CASES = [("sphereface", {}, 0.0), ("cosface", {}, 0.0),
         ("mv_softmax", {}, 0.0), ("mv_softmax", {"margin_type": "arc"}, 0.0),
         ("curricularface", {}, 0.0), ("adaface", {}, 0.0),
         ("elastic_cosface", {}, 0.0),
         ("elastic_arcface", {"plus": True}, 0.0),
         ("magface", {}, 0.0), ("magface", {}, 0.5),
         ("combined_margin", {}, 0.0), ("subcenter_arcface", {}, 0.0),
         ("adacos", {}, 0.0)]


def _id(case):
    name, kw, lambda_g = case
    return (name + "".join(f"-{k}={v}" for k, v in kw.items())
            + (f"-lambda_g={lambda_g}" if lambda_g else ""))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_setup(name, kw, lambda_g):
    cfg = jcfg.make_head_config(name, feature_dim=D, num_classes=C, **kw)
    head = jget_head(name)
    backbone = JResNet(stage_sizes=(1, 1), block=JBasic, embed_dim=D,
                       num_filters=8, dtype=jnp.float32)
    rng = jax.random.PRNGKey(42)
    variables = backbone.init(rng, jnp.zeros((1, IMAGE, IMAGE, 3)),
                              train=False)
    params = {"backbone": variables["params"],
              "kernel_w": head.init_kernel(rng, cfg)}
    tx = jget_optimizer("sgd", LR, momentum=0.9, weight_decay=5e-4)
    state = JTrainState(step=jnp.int32(0),
                        params=jax.tree.map(jnp.copy, params),
                        batch_stats=variables["batch_stats"],
                        head_state=head.init_state(cfg),
                        opt_state=tx.init(params),
                        rng=jax.random.PRNGKey(7))
    step = jax.jit(jmake_step(backbone, head, cfg, tx, lambda_g=lambda_g,
                              use_fused_head=False))
    return state, step


def _port_state(name, kw, jstate, lambda_g):
    sd, kernel_w = from_jax(_host(jstate.params), _host(jstate.batch_stats))
    backbone = ResNet((1, 1), BasicBlock, embed_dim=D, num_filters=8,
                      dtype=torch.float32)
    backbone.load_state_dict(sd, strict=True)
    kernel_w = torch.nn.Parameter(kernel_w)
    opt = get_optimizer("sgd", [*backbone.parameters(), kernel_w], LR,
                        momentum=0.9, weight_decay=5e-4)
    cfg = tcfg.make_head_config(name, feature_dim=D, num_classes=C, **kw)
    step = make_train_step(get_head(name), cfg, use_fused_head=use_fused(name),
                           lambda_g=lambda_g, device="cpu")
    return TrainState(backbone=backbone, kernel_w=kernel_w, optimizer=opt,
                      head_state=head_state_from_jax(
                          name, _host(jstate.head_state)),
                      rng=torch.Generator().manual_seed(0)), step


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_train_step_matches_jax(case, monkeypatch):
    name, kw, lambda_g = case
    jstate, jstep = _jax_setup(name, kw, lambda_g)
    tstate, tstep = _port_state(name, kw, jstate, lambda_g)
    keys = []
    monkeypatch.setattr(tmargins, "_normal_noise", lambda rng, n, device:
                        torch.from_numpy(np.array(jax.random.normal(
                            keys[-1], (n,), jnp.float32))))
    rs = np.random.RandomState(3)
    for k in range(STEPS):
        images = rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8)
        labels = rs.randint(0, C, N).astype(np.int32)
        # the JAX step's head key: the second of four from its state key
        keys.append(jax.random.split(jstate.rng, 4)[1])
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        tstate, tm = tstep(tstate, images, labels)
        for key in ("loss", "loss_id", "loss_mag"):
            lj, lt = float(jm[key]), float(tm[key])
            assert abs(lt - lj) <= 1e-4 * max(1.0, abs(lj)), \
                f"step {k} {key}: port {lt:.6f} vs jax {lj:.6f}"
        np.testing.assert_allclose(float(tm["feat_norm"]),
                                   float(jm["feat_norm"]), rtol=1e-4)
        # a top-k tie may break the other way between the two paths
        assert abs(float(tm["acc1"]) - float(jm["acc1"])) <= 100.0 / N + 1e-6
    if lambda_g:
        assert float(tm["loss_mag"]) > 0.0
        assert float(tm["loss"]) == pytest.approx(
            float(tm["loss_id"]) + float(tm["loss_mag"]), rel=1e-6)
    want, want_kernel = from_jax(_host(jstate.params),
                                 _host(jstate.batch_stats))
    got = tstate.backbone.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(tstate.kernel_w.detach().numpy(),
                               want_kernel.numpy(), rtol=1e-3, atol=1e-5)
    if tstate.head_state is not None:
        want_state = head_state_from_jax(name, _host(jstate.head_state))
        for field, a, b in zip(want_state._fields, tstate.head_state,
                               want_state):
            assert a.dtype == b.dtype, field
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=field)


def test_step_without_lambda_g_drops_loss_g():
    """lambda_g = 0 (the default): MagFace's loss is its CE alone, and
    loss_mag is 0."""
    jstate, _ = _jax_setup("magface", {}, 0.0)
    tstate, tstep = _port_state("magface", {}, jstate, 0.0)
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8)
    labels = rs.randint(0, C, N).astype(np.int32)
    _, tm = tstep(tstate, images, labels)
    assert float(tm["loss_mag"]) == 0.0
    assert float(tm["loss"]) == float(tm["loss_id"])


def test_fused_step_refuses_a_head_without_kernels():
    for name in ("subcenter_arcface", "adacos"):
        cfg = tcfg.make_head_config(name, feature_dim=D, num_classes=C)
        with pytest.raises(ValueError, match="no fused-kernel path"):
            make_train_step(get_head(name), cfg, use_fused_head=True,
                            device="cpu")


def _tensors(state):
    out = {f"b.{k}": v for k, v in state.backbone.state_dict().items()}
    out["kernel_w"] = state.kernel_w.detach()
    for i, slot in state.optimizer.state_dict()["state"].items():
        out[f"m.{i}"] = slot["momentum_buffer"]
    for i, x in enumerate(state.head_state or ()):
        out[f"h.{i}"] = x
    out["rng"] = state.rng.get_state()
    return out


@pytest.mark.parametrize("head", ["elastic_arcface", "sphereface"])
def test_fit_resumed_equals_uninterrupted(tmp_path, head):
    """2 epochs against 1 + a resumed one: losses, parameters, momentum,
    the head state (SphereFace's int32 iter) and the step generator (the
    elastic margins' draws) bit for bit."""
    images, labels = synthetic_identities(8, 3, image_size=24, seed=1)
    loader = ArrayLoader(images, labels, batch_size=8, seed=0)

    def run(epochs, resume=None):
        cfg = tcfg.TrainConfig(head=head, num_classes=8, batch_size=8,
                               epochs=epochs, print_freq=100, seed=0,
                               continue_train=resume)
        mgr = CheckpointManager(str(tmp_path / head), head)
        return loop.fit(cfg, loader, device="cpu", checkpoint_manager=mgr)

    whole = run(2)
    first = run(1)
    second = run(1, "latest")
    assert first.losses + second.losses == whole.losses
    a, b = _tensors(second.state), _tensors(whole.state)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    assert second.state.step == whole.state.step
    if head == "sphereface":
        assert second.state.head_state.iter.dtype == torch.int32
        assert int(second.state.head_state.iter) == whole.state.step
    else:
        # the generator moved: a run that restarts it draws other margins
        fresh = torch.Generator().manual_seed(0)
        assert not torch.equal(fresh.get_state(), a["rng"])
    assert sorted(os.listdir(tmp_path / head)) == ["epoch_1", "epoch_2",
                                                   "min_loss"]
