"""Train steps of a world against the step one process gives on the global
batch.

- A resnet18 (BasicBlock stages 2-2-2-2, 8 filters, 16 px, fp32) + ArcFace
  fused step in a data=2 world of gloo ranks (8 of the N=16 rows each,
  BatchNorm over the global batch, the head's plain kernel versions)
  against the JAX `make_train_step` on the whole batch (its Pallas kernels
  in interpret mode): one step, the loss at 1e-4 relative, every parameter
  and BatchNorm running statistic at tests/test_torch_train_step.py's rtol
  5e-3 / atol 2e-3, and bitwise equal on both ranks.
- The port's world against its own one-process step from the same weights
  and seed, two steps at lr 0.01, in a world of 4: the fused head over
  2 x 2 and 4 x 1 meshes (CurricularFace's t, AdaFace's statistics, MagFace, the
  elastic margins drawn over the global batch), the eager head gathering
  the class shards (AdaFace, VPL-ArcFace over a 1 x 4 mesh, AdaCos's
  median), and the four augmentations drawn for the global batch. Losses
  at 1e-4 relative, the state and the head state at rtol 5e-3 / atol
  2e-3; every rank's backbone bitwise equal. (The two
  programs' fp32 rounding differs by about 2e-5 of a step's update; at this
  narrow trunk's large updates the gap grows some 30-fold a step, so the
  runs are kept short and the lr of the longer one small.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu.train import TrainState as JTrainState
from face_recognition_models_tpu.train import get_optimizer as jget_optimizer
from face_recognition_models_tpu.train import make_train_step as jmake_step
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.utils.weights import from_jax

import torch_mesh_jobs as jobs
from torch_mesh_world import World

N, D, C = 16, 32, 96
IMAGE = 16
LR = 0.05
STAGES, WIDTH = (2, 2, 2, 2), 8


@pytest.fixture(scope="module")
def worlds():
    """The module's gloo worlds, by size, started when first asked for."""
    started = {}

    def get(size):
        if size not in started:
            started[size] = World(size)
        return started[size]

    yield get
    for w in started.values():
        w.close()


@pytest.fixture()
def interpret_fused(monkeypatch):
    import face_recognition_models_tpu.heads.fused_adapter as fa

    orig = fa.fused_apply

    def fused_interp(*args, **kw):
        kw.setdefault("interpret", True)
        kw.setdefault("block_n", 16)
        kw.setdefault("block_c", 96)
        return orig(*args, **kw)

    monkeypatch.setattr(fa, "fused_apply", fused_interp)


def _batches(steps, seed=3):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8),
             rs.randint(0, C, N).astype(np.int64)) for _ in range(steps)]


def _assert_state_close(got, want_sd, want_kernel, counts=True):
    for name, v in want_sd.items():
        if not v.dtype.is_floating_point:
            # num_batches_tracked: flax keeps no such count
            if counts:
                np.testing.assert_array_equal(got["sd"][name], v.numpy())
            continue
        np.testing.assert_allclose(got["sd"][name], v.numpy(), rtol=5e-3,
                                   atol=2e-3, err_msg=name)
    np.testing.assert_allclose(got["kernel"], want_kernel, rtol=5e-3,
                               atol=2e-3)


def test_data_parallel_step_matches_jax_global_step(worlds, interpret_fused):
    cfg = jcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    head = jget_head("arcface")
    backbone = JResNet(stage_sizes=STAGES, block=JBasic, embed_dim=D,
                       num_filters=WIDTH, dtype=jnp.float32)
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
                        opt_state=tx.init(params), rng=jax.random.PRNGKey(7))
    step = jax.jit(jmake_step(backbone, head, cfg, tx, use_fused_head=True))
    host = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    sd, kernel = from_jax(host(state.params), host(state.batch_stats))
    batches = _batches(1)
    losses = []
    for images, labels in batches:
        state, m = step(state, jnp.asarray(images),
                        jnp.asarray(labels.astype(np.int32)))
        losses.append(float(m["loss"]))
    want_sd, want_kernel = from_jax(host(state.params),
                                    host(state.batch_stats))

    out = worlds(2).run("train_steps", "arcface", 2, 1, STAGES, WIDTH, sd,
                        kernel.numpy(), batches, LR)
    for r in out:
        for lt, lj in zip(r["losses"], losses):
            assert abs(lt - lj) <= 1e-4 * max(1.0, abs(lj)), (lt, lj)
        _assert_state_close(r, want_sd, want_kernel.numpy(), counts=False)
        for name, v in r["sd"].items():
            np.testing.assert_array_equal(v, out[0]["sd"][name])


WORLD_CASES = [
    pytest.param("arcface", True, 2, 2, {}, id="arcface-fused-2x2"),
    pytest.param("curricularface", True, 4, 1, {}, id="curricular-fused-4x1"),
    pytest.param("adaface", True, 2, 2, {}, id="adaface-fused-2x2"),
    pytest.param("magface", True, 2, 2, {"lambda_g": 35.0},
                 id="magface-fused-2x2"),
    pytest.param("elastic_arcface", True, 2, 2, {}, id="elastic-fused-2x2"),
    pytest.param("adaface", False, 2, 2, {}, id="adaface-eager-2x2"),
    pytest.param("vpl_arcface", False, 1, 4, {}, id="vpl-eager-1x4"),
    pytest.param("vpl_arcface", True, 2, 2, {}, id="vpl-fused-2x2"),
    pytest.param("adacos", False, 4, 1, {}, id="adacos-eager-4x1"),
    pytest.param("arcface", True, 2, 2,
                 {"horizontal_flip": True, "crop_pad": 2,
                  "color_jitter": 0.2, "random_erasing": 0.5},
                 id="augment-fused-2x2"),
]


@pytest.mark.parametrize("name,fused,data,model,step_kw", WORLD_CASES)
def test_world_step_equals_one_process_step(worlds, name, fused, data,
                                            model, step_kw):
    bb = jobs.tiny_resnet(STAGES, WIDTH, D)
    init_weights(bb, torch.Generator().manual_seed(1))
    sd = {k: v.clone() for k, v in bb.state_dict().items()}
    kernel = 0.1 * np.random.RandomState(2).randn(D, C).astype(np.float32)
    batches = _batches(2, seed=5)
    args = (STAGES, WIDTH, sd, kernel, batches, 0.01)
    kw = dict(use_fused=fused, step_kw=step_kw)
    want = jobs.train_steps(name, 0, 0, *args, **kw)
    out = worlds(4).run("train_steps", name, data, model, *args, **kw)
    want_sd = {k: torch.as_tensor(v) for k, v in want["sd"].items()}
    for r in out:
        for lt, lw in zip(r["losses"], want["losses"]):
            assert abs(lt - lw) <= 1e-4 * max(1.0, abs(lw)), (lt, lw)
        _assert_state_close(r, want_sd, want["kernel"])
        for a, b in zip(r["state"], want["state"]):
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=5e-3,
                                       atol=2e-3)
        for n, v in r["sd"].items():
            np.testing.assert_array_equal(v, out[0]["sd"][n])



# clipping that binds; the kernel starts at KERNEL_SCALE of its JAX init,
# which makes its gradient (ArcFace's cosine is 1 / |w| steep) most of the
# global norm, so a norm over one rank's shard is off by some 40%
CLIP = 0.5
KERNEL_SCALE = 1e-2


def _jax_step(clip):
    """((sd, kernel) at the start, (sd, kernel) after, loss) of one JAX
    global-batch ArcFace step, SGD momentum 0.9 with no weight decay,
    clipped at `clip` (0: off), from KERNEL_SCALE x the kernel's init, on
    the tiny ResNet with the Pallas kernels in interpret mode."""
    cfg = jcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    head = jget_head("arcface")
    backbone = JResNet(stage_sizes=STAGES, block=JBasic, embed_dim=D,
                       num_filters=WIDTH, dtype=jnp.float32)
    rng = jax.random.PRNGKey(42)
    variables = backbone.init(rng, jnp.zeros((1, IMAGE, IMAGE, 3)),
                              train=False)
    params = {"backbone": variables["params"],
              "kernel_w": KERNEL_SCALE * head.init_kernel(rng, cfg)}
    tx = jget_optimizer("sgd", LR, momentum=0.9, weight_decay=0.0,
                        clip_grad_norm=clip)
    state = JTrainState(step=jnp.int32(0),
                        params=jax.tree.map(jnp.copy, params),
                        batch_stats=variables["batch_stats"],
                        head_state=head.init_state(cfg),
                        opt_state=tx.init(params), rng=jax.random.PRNGKey(7))
    step = jax.jit(jmake_step(backbone, head, cfg, tx, use_fused_head=True))
    host = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    start = from_jax(host(state.params), host(state.batch_stats))
    images, labels = _batches(1)[0]
    state, m = step(state, jnp.asarray(images),
                    jnp.asarray(labels.astype(np.int32)))
    after = from_jax(host(state.params), host(state.batch_stats))
    return start, after, float(m["loss"])


def _update(sd, kernel, start):
    """{name: after - start} of every float tensor and of the kernel."""
    sd0, kernel0 = start
    out = {n: np.asarray(v, np.float64) - sd0[n].numpy()
           for n, v in sd.items() if sd0[n].dtype.is_floating_point}
    out["kernel"] = np.asarray(kernel, np.float64) - kernel0.numpy()
    return out


def test_clipped_world_step_equals_one_process_and_jax_step(
        worlds, interpret_fused):
    """--clip-grad-norm under a class-sharded kernel: one step of a 2 x 2
    world (each rank a [32, 48] kernel shard) with clipping at CLIP, which
    binds, against the port's one-process step and the JAX global step
    (optax.clip_by_global_norm of the whole kernel and backbone). The
    states at this file's bounds (rtol 5e-3, atol 2e-3), the loss at 1e-4
    relative, and, since a clipped update is ~1e-3 of the weights, each
    tensor's update (after - before) at rtol 5e-3 with an atol of 2e-3 x
    that update's largest element plus two fp32 steps of the tensor's
    largest weight (the rounding of after - before): a norm over the
    rank's shard alone scales the update by another factor and fails it."""
    start, (jsd, jkernel), jloss = _jax_step(CLIP)
    _, (usd, ukernel), _ = _jax_step(0.0)
    sd, kernel = start
    args = (STAGES, WIDTH, sd, kernel.numpy(), _batches(1), LR)
    opt_kw = {"weight_decay": 0.0, "clip_grad_norm": CLIP}
    one = jobs.train_steps("arcface", 0, 0, *args, opt_kw=opt_kw)
    out = worlds(4).run("train_steps", "arcface", 2, 2, *args, opt_kw=opt_kw)
    jax_update = _update({n: v.numpy() for n, v in jsd.items()},
                         jkernel.numpy(), start)
    free = _update({n: v.numpy() for n, v in usd.items()}, ukernel.numpy(),
                   start)
    # the clip binds: the update is a small fraction of the unclipped one
    assert (np.abs(jax_update["kernel"]).max()
            < 0.01 * np.abs(free["kernel"]).max())
    one_update = _update(one["sd"], one["kernel"], start)
    for r in [one] + out:
        assert abs(r["losses"][0] - jloss) <= 1e-4 * max(1.0, abs(jloss))
        _assert_state_close(r, jsd, jkernel.numpy(), counts=False)
        got = _update(r["sd"], r["kernel"], start)
        for want in (jax_update, one_update):
            for n, u in want.items():
                w0 = kernel if n == "kernel" else sd[n]
                ulp = 2.0 ** -22 * max(1.0, float(w0.abs().max()))
                np.testing.assert_allclose(
                    got[n], u, rtol=5e-3,
                    atol=2e-3 * np.abs(u).max() + ulp, err_msg=n)
    for r in out:
        for n, v in r["sd"].items():
            np.testing.assert_array_equal(v, out[0]["sd"][n])
