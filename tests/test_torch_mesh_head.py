"""The mesh's layout and the class-sharded fused head against the JAX
package.

- `parallel/mesh.mesh_shape` and `parallel/sharding.spec_for` against the
  JAX `make_mesh` (on the 8-device CPU mesh of tests/conftest.py) and
  `_spec_for` on the same names and shapes, with the same errors; a world
  of 4 gloo ranks lays out its ranks row-major.
- The class-sharded fused head in a 2 x 2 world (data x model; each rank
  8 of the N=16 rows and 48 of the C=96 classes, its kernels' plain
  versions on the CPU) for seven heads against the JAX eager head on the
  whole batch, the function JAX's own (slow-marked) sharded test equates
  with its sharded head: the loss at rtol = atol 2e-5, the kernel and
  feature gradients at rtol 5e-4 / atol 1e-6 (tests/test_sharded_fused.py's
  bounds), and each rank's (lse, target, higher) against the JAX fused
  kernel in interpret mode on its rows. The new head state (CurricularFace's
  t, AdaFace's statistics, the VPL memory) matches too.

The ranks are the module's one world (tests/torch_mesh_world.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.heads.fused_adapter import (
    _mem_row_params as j_mem_row_params,
)
from face_recognition_models_tpu.heads.fused_adapter import (
    _row_params as j_row_params,
)
from face_recognition_models_tpu.ops import fused_head as jfh
from face_recognition_models_tpu.ops.normalize import (
    feature_norms as j_feature_norms,
)
from face_recognition_models_tpu.ops.normalize import l2_normalize as j_l2n
from face_recognition_models_tpu.parallel import make_mesh as jmake_mesh
from face_recognition_models_tpu.parallel.sharding import _spec_for
from face_recognition_models_tpu.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.parallel import sharding
from face_recognition_models_tpu_torch.parallel.mesh import mesh_shape
from face_recognition_models_tpu_torch.utils.weights import (
    head_state_from_jax,
)

from torch_mesh_world import World

N, D, C = 16, 32, 96
HEADS = ["arcface", "cosface", "curricularface", "mv_softmax", "magface",
         "adaface", "vpl_arcface"]


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.mark.parametrize("data,model,n", [
    (-1, 1, 8), (-1, 2, 8), (2, 4, 8), (4, 2, 8), (-1, 4, 4), (2, 1, 2),
    (3, 2, 8), (-1, 3, 8), (2, 2, 8)])
def test_mesh_shape_matches_jax(data, model, n):
    cfg_t = tcfg.MeshConfig(data=data, model=model)
    cfg_j = jcfg.MeshConfig(data=data, model=model)
    devices = jax.devices()[:n]
    try:
        want = jmake_mesh(cfg_j, devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(cfg_t, n)
        assert str(got.value) == str(e)
        return
    assert mesh_shape(cfg_t, n) == (want.shape["data"], want.shape["model"])


# the JAX state's paths (jax.tree_util.keystr) and the names the port gives
# the same tensors
SPEC_CASES = [
    ("['params']['kernel_w']", (D, C)),
    ("['opt_state']['kernel_mom']", (D, C)),
    ("['params']['kernel_w']", (D, C * 3)),            # sub-center
    ("['head_state'].mem", (C, D)),
    ("['head_state'].life", (C,)),
    ("['head_state'].t", (1,)),
    ("['head_state'].training_flag", ()),
    ("['params']['backbone']['conv']['kernel']", (3, 3, 3, C)),
    ("['params']['backbone']['fc']['kernel']", (D, C)),
    ("['ema_params']['kernel_w']", (D, C)),
    ("['opt_state'][0].mu['kernel_w']", (D, C)),
]


@pytest.mark.parametrize("path,shape", SPEC_CASES)
def test_spec_for_matches_jax(path, shape):
    want = _spec_for(path, np.zeros(shape, np.float32), C)
    assert sharding.spec_for(path, shape, C) == tuple(want)


def test_indivisible_classes_raise_as_in_jax():
    from face_recognition_models_tpu.parallel.sharded_fused import (
        sharded_fused_margin_ce as j_sharded)

    mesh = jmake_mesh(jcfg.MeshConfig(data=4, model=2))
    with pytest.raises(ValueError) as want:
        j_sharded(mesh, jnp.zeros((8, 16)), jnp.zeros((16, 97)),
                  jnp.zeros((8,), jnp.int32), jnp.zeros(8), jnp.zeros(8),
                  jnp.ones(8), jnp.zeros((8, 2)), 0)

    class _Mesh:
        model, model_index = 2, 0

    with pytest.raises(ValueError) as got:
        sharding.shard(torch.zeros(16, 97), sharding.CLASS_COLUMNS, _Mesh)
    assert str(got.value) == str(want.value)


def test_world_layout_is_row_major(world):
    for data, model in ((2, 2), (4, 1), (1, 4)):
        out = world.run("mesh_layout", data, model)
        for rank, (r, di, mi, data_ranks, model_ranks) in enumerate(out):
            assert (r, di, mi) == (rank, rank // model, rank % model)
            assert data_ranks == [mi + model * i for i in range(data)]
            assert model_ranks == [di * model + j for j in range(model)]


def _jax_case(name):
    cfg = jcfg.make_head_config(name, feature_dim=D, num_classes=C)
    head = jget_head(name)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    kernel = head.init_kernel(k1, cfg)
    feats = 10.0 * jax.random.normal(k2, (N, D), jnp.float32)
    labels = jax.random.randint(k2, (N,), 0, C)
    state = head.init_state(cfg)
    if name == "vpl_arcface":
        # one warm-up step, so the memories are active
        state = head.apply(cfg, kernel, feats, labels, state).state
    return cfg, head, kernel, feats, labels, state


def _jax_stats(cfg, kernel, feats, labels, state, rows):
    """(lse, target, higher) of the JAX fused kernel (interpret mode) on
    the rows `rows` of the batch, from the whole batch's row parameters."""
    xn, wn = j_l2n(feats, axis=1), j_l2n(kernel, axis=0)
    tcos_raw = jnp.sum(xn * jnp.take(wn, labels, axis=1).T, axis=1)
    if cfg.name == "vpl_arcface":
        m = j_mem_row_params(cfg, kernel, xn, wn, feats, labels, tcos_raw,
                             j_feature_norms(feats), state, None)
        rp = m.rp
        out = jfh.fused_margin_ce_mem(
            xn[rows], wn, m.memn, m.lam, labels[rows], rp.t[rows],
            rp.tcos[rows], rp.scale[rows], rp.ab[rows], rp.mode,
            rp.clamp_eps, 8, 48, True)
    else:
        rp = j_row_params(cfg, tcos_raw, j_feature_norms(feats), state, None)
        out = jfh.fused_margin_ce(
            xn[rows], wn, labels[rows], rp.t[rows], rp.tcos[rows],
            rp.scale[rows], rp.ab[rows], rp.mode, rp.clamp_eps, 8, 48, True)
    return out, rp.new_state


@pytest.mark.parametrize("name", HEADS)
def test_sharded_fused_head_matches_jax(world, name):
    cfg, head, kernel, feats, labels, state = _jax_case(name)

    def loss_jnp(kernel, feats):
        out = head.apply(cfg, kernel, feats, labels, state)
        return mean_cross_entropy(out.logits, labels)

    lj, (gkj, gfj) = jax.value_and_grad(loss_jnp, argnums=(0, 1))(kernel,
                                                                  feats)
    t_state = (None if state is None
               else head_state_from_jax(name, jax.device_get(state)))
    out = world.run("fused_head", name, 2, 2, np.asarray(kernel),
                    np.asarray(feats), np.asarray(labels), t_state)
    half_n, half_c = N // 2, C // 2
    gk = np.zeros((D, C), np.float32)
    gf = np.zeros((N, D), np.float32)
    for r in out:
        np.testing.assert_allclose(r["loss"], float(lj), rtol=2e-5,
                                   atol=2e-5)
        cols = slice(r["model_index"] * half_c, (r["model_index"] + 1)
                     * half_c)
        rows = slice(r["data_index"] * half_n, (r["data_index"] + 1)
                     * half_n)
        gk[:, cols] = r["gk"]
        # the rank's gradient is `data` times the global loss's
        gf[rows] = r["gf"] / 2
        jout, j_new = _jax_stats(cfg, kernel, feats, labels, state, rows)
        np.testing.assert_allclose(r["lse"], np.asarray(jout.lse),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["target"],
                                   np.asarray(jout.target_logit),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(r["higher"], np.asarray(jout.higher))
        for a, b in zip(r["state"] or (), jax.tree.leaves(j_new)):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gk, np.asarray(gkj), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(gf, np.asarray(gfj), rtol=5e-4, atol=1e-6)
