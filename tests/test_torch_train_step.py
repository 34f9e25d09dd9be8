"""A 6-step training trajectory of the port against the JAX package's fused
train step, from the same weights on the same batches.

JAX runs `make_train_step(use_fused_head=True)` with its Pallas kernels in
interpret mode (block_n=16, block_c=64), the way tests/test_fused_trajectory.py
does; the port runs on the CPU, where its kernel wrappers compute their plain
versions. Tiny ResNet in fp32, N=16, D=32, C=128, 16 px, SGD lr 0.05
momentum 0.9 wd 5e-4. Bounds are those of tests/test_fused_trajectory.py:
per-step loss 1e-4 relative, feat_norm rtol 1e-4 (atol 1e-5), final
parameters rtol 5e-3 atol 2e-3 (per-step rounding drift of two fp32
programs, compounded over momentum-SGD steps).
"""

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
from face_recognition_models_tpu.train.schedules import (
    get_schedule as jget_schedule)
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.schedules import get_schedule
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import from_jax

N, D, C = 16, 32, 128
IMAGE = 16
STEPS = 6
LR = 0.05


@pytest.fixture()
def interpret_fused(monkeypatch):
    """The JAX fused kernel in Pallas interpret mode with small tiles."""
    import face_recognition_models_tpu.heads.fused_adapter as fa

    orig = fa.fused_apply

    def fused_interp(*args, **kw):
        kw.setdefault("interpret", True)
        kw.setdefault("block_n", 16)
        kw.setdefault("block_c", 64)
        return orig(*args, **kw)

    monkeypatch.setattr(fa, "fused_apply", fused_interp)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_setup():
    cfg = jcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    head = jget_head("arcface")
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
    step = jax.jit(jmake_step(backbone, head, cfg, tx, use_fused_head=True))
    return state, step


def _port_state(jstate, use_fused):
    sd, kernel_w = from_jax(_host(jstate.params), _host(jstate.batch_stats))
    backbone = ResNet((1, 1), BasicBlock, embed_dim=D, num_filters=8,
                      dtype=torch.float32)
    backbone.load_state_dict(sd, strict=True)
    kernel_w = torch.nn.Parameter(kernel_w)
    opt = get_optimizer("sgd", [*backbone.parameters(), kernel_w], LR,
                        momentum=0.9, weight_decay=5e-4)
    cfg = tcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    step = make_train_step(get_head("arcface"), cfg,
                           use_fused_head=use_fused, device="cpu")
    return TrainState(backbone=backbone, kernel_w=kernel_w,
                      optimizer=opt), step


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "eager"])
def test_trajectory_matches_jax_fused_step(use_fused, interpret_fused):
    jstate, jstep = _jax_setup()
    tstate, tstep = _port_state(jstate, use_fused)
    rs = np.random.RandomState(3)
    for k in range(STEPS):
        images = rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8)
        labels = rs.randint(0, C, N).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        tstate, tm = tstep(tstate, images, labels)
        lj, lt = float(jm["loss"]), float(tm["loss"])
        assert abs(lt - lj) <= 1e-4 * max(1.0, abs(lj)), \
            f"step {k}: port loss {lt:.6f} vs jax {lj:.6f}"
        np.testing.assert_allclose(float(tm["feat_norm"]),
                                   float(jm["feat_norm"]), rtol=1e-4,
                                   atol=1e-5)
        # top-k ties may break differently between the two programs
        assert abs(float(tm["acc1"]) - float(jm["acc1"])) <= 100.0 / N + 1e-6
    assert tstate.step == STEPS

    want, want_kernel = from_jax(_host(jstate.params),
                                 _host(jstate.batch_stats))
    got = tstate.backbone.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=5e-3, atol=2e-3, err_msg=key)
    np.testing.assert_allclose(tstate.kernel_w.detach().numpy(),
                               want_kernel.numpy(), rtol=5e-3, atol=2e-3)


def test_customstep_lr_sequence_matches_jax():
    sched_cfg = jcfg.ScheduleConfig(name="customstep", steps=(1, 2, 4),
                                    ratio=0.1)
    jsched = jget_schedule(sched_cfg, 0.1, steps_per_epoch=3)
    tsched = get_schedule(tcfg.ScheduleConfig(steps=(1, 2, 4), ratio=0.1),
                          0.1, steps_per_epoch=3)
    got = [tsched(i) for i in range(20)]
    want = [float(jsched(i)) for i in range(20)]
    # JAX evaluates the power in fp32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[2] == 0.1 and got[3] < 0.1  # boundary at 1 epoch = step 3
