"""The class-sharded Partial-FC (train/partial_fc_sharded.py) and the
checkpoints of a world (checkpoint/manager.py under a mesh).

- `local_sample_from_draws` on the JAX package's draws (per shard m,
  uniform scores from fold_in(key, m) and the bucket shift from
  fold_in(fold_in(key, m), 1)) gives the JAX `_local_sample`'s classes,
  col_valid and positive count exactly, up to C = 1,048,576 over 4 shards
  (the bucketed negatives).
- In a 2 x 2 world of gloo ranks, every shard's sample covering its whole
  class range (batch = C, one label a class, no negatives) makes the
  sharded sampled step the dense step: two steps against the port's dense
  eager step in one process, at tests/test_partial_fc_sharded.py's bounds
  (loss rtol 2e-4, acc1 equal, kernel and backbone rtol 5e-3 / atol 5e-5).
- A step writes exactly each shard's sampled columns of kernel_w, and
  kernel_mom is non-zero on those alone; the memory-blended heads are
  refused as in JAX.
- A 2 x 2 world's `fit` checkpoint restores in one process, and one
  process's in a 2 x 2 world, bitwise (Partial-FC with kernel_mom, and the
  dense fused VPL-ArcFace with its class-sharded memory and the kernel's
  optimizer slots).
- A SIGTERM that reaches one rank of a 2 x 2 world's `fit` stops every
  rank at the same step: the first `print_freq` step after it, or the
  epoch's end, where the ranks vote; each returns preempted and rank 0
  saves the epoch before.
- The replicated Partial-FC over a data-only 4 x 1 mesh (every rank
  samples from the global labels with the same draws) against one
  process's `fit` on the same global batch, one step in fp32: the loss
  at 1e-4 relative, kernel_w and the trunk at rtol 5e-3 / atol 5e-5,
  kernel_mom (the gradients) at atol 1e-4 of its largest element. (The world's step-1 gradients differ from one process's by
  about 2e-5 of their largest: PyTorch's CPU BatchNorm sums its
  statistics in fp64, the synced one in fp32; later steps at this trunk's
  large updates grow such a gap some 50-fold a step, and bf16
  convolutions would round it further.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.parallel import make_mesh as jmake_mesh
from face_recognition_models_tpu.train.partial_fc_sharded import (
    _local_sample,
)
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.train.partial_fc_sharded import (
    local_sample_from_draws,
    make_sharded_partial_fc_train_step,
)

import torch_mesh_jobs as jobs
from torch_mesh_world import World

D, IMAGE = 32, 16
STAGES, WIDTH = (1, 1), 8


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


@pytest.mark.parametrize("c,model,c_s_local,n", [
    (64, 4, 8, 8), (1 << 20, 4, 4096, 64)])
def test_local_sample_matches_jax_on_jax_draws(c, model, c_s_local, n):
    mesh = jmake_mesh(jcfg.MeshConfig(data=8 // model, model=model))
    c_local = c // model
    n_slots = min(n, c_local)
    rs = np.random.RandomState(c_s_local)
    labels = jnp.asarray(rs.randint(0, c, n).astype(np.int32))
    labels = labels.at[1].set(labels[0])            # a repeated label
    key = jax.random.PRNGKey(3)

    def block(labels_f, rng):
        classes, col_valid, u, offset = _local_sample(
            rng, labels_f, c_local, n_slots, c_s_local, "model")
        return classes[None], col_valid[None], u[None], offset[None]

    classes, valid, u, _ = shard_map(
        block, mesh=mesh, in_specs=(P(), P()),
        out_specs=(P("model"),) * 4, check_vma=False)(labels, key)
    for m in range(model):
        shard_rng = jax.random.fold_in(key, m)
        scores = jax.random.uniform(shard_rng, (c_local + 1,))
        shift = jax.random.randint(jax.random.fold_in(shard_rng, 1), (), 0,
                                   c_local)
        got = local_sample_from_draws(
            torch.as_tensor(np.asarray(labels)), c_local, n_slots,
            c_s_local, m * c_local, torch.as_tensor(np.asarray(scores)),
            torch.as_tensor(np.asarray(shift)).long())
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(classes[m]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(valid[m]))
        assert int(got[2]) == int(u[m])


@pytest.mark.parametrize("name", ["vpl_arcface", "qaface",
                                  "subcenter_arcface", "adacos"])
def test_unsupported_heads_refused(name):
    class _Mesh:
        model, model_index = 2, 0

    cfg = tcfg.make_head_config(name, num_classes=64)
    with pytest.raises(ValueError, match="does not support"):
        make_sharded_partial_fc_train_step(get_head(name), cfg, 8, _Mesh,
                                           device="cpu")


def _weights(c):
    bb = jobs.tiny_resnet(STAGES, WIDTH, D)
    init_weights(bb, torch.Generator().manual_seed(1))
    sd = {k: v.clone() for k, v in bb.state_dict().items()}
    kernel = 0.1 * np.random.RandomState(2).randn(D, c).astype(np.float32)
    return sd, kernel


def test_full_local_coverage_is_the_dense_step(world):
    c = 32
    sd, kernel = _weights(c)
    rs = np.random.RandomState(0)
    batches = [(rs.randint(0, 256, (c, IMAGE, IMAGE, 3), np.uint8),
                rs.permutation(c).astype(np.int64)) for _ in range(2)]
    want = jobs.train_steps("arcface", 0, 0, STAGES, WIDTH, sd, kernel,
                            batches, 0.1, use_fused=False)
    out = world.run("pfc_steps", "arcface", 2, 2, STAGES, WIDTH, sd, kernel,
                    batches, 0.1, c // 2, logq=False)
    for r in out:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=2e-4)
        np.testing.assert_allclose(r["kernel"], want["kernel"], rtol=5e-3,
                                   atol=5e-5)
        for name, v in want["sd"].items():
            np.testing.assert_allclose(r["sd"][name], v, rtol=5e-3,
                                       atol=5e-5, err_msg=name)


def test_step_writes_the_sampled_columns_alone(world):
    c, n, c_s_local = 512, 8, 16
    sd, kernel = _weights(c)
    rs = np.random.RandomState(1)
    batches = [(rs.randint(0, 256, (n, IMAGE, IMAGE, 3), np.uint8),
                rs.choice(c, n, replace=False).astype(np.int64))]
    out = world.run("pfc_steps", "cosface", 2, 2, STAGES, WIDTH, sd, kernel,
                    batches, 0.1, c_s_local)
    for r in out:
        assert r["written"][0] == r["sampled"][0]
        assert len(r["sampled"][0]) <= c_s_local
        assert r["mom_cols"] == r["written"][0]
    # every label's column was sampled by its shard and written
    shards = {0: out[0], 1: out[1]}     # the model coordinates of data 0
    written = set(shards[0]["written"][0]) | set(shards[1]["written"][0])
    assert set(batches[0][1].tolist()) <= written
    # the data peers of a shard sampled and wrote alike
    assert out[0]["written"] == out[2]["written"]
    assert out[1]["written"] == out[3]["written"]


@pytest.mark.parametrize("head,pfc", [("arcface", 0.1),
                                      ("vpl_arcface", 0.0)])
def test_checkpoint_resumes_across_world_sizes(world, tmp_path, head, pfc):
    c, n = 2048, 8
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (4 * n, IMAGE, IMAGE, 3), np.uint8)
    labels = rs.randint(0, c, 4 * n).astype(np.int32)
    cfg = tcfg.TrainConfig(
        backbone="resnet18", head=head, num_classes=c, batch_size=n,
        epochs=1, partial_fc=pfc, print_freq=1000,
        data=tcfg.DataConfig(image_size=IMAGE),
        optimizer=tcfg.OptimizerConfig(learning_rate=0.05))
    # a 2 x 2 world saves, one process restores
    world_dir = str(tmp_path / "world")
    saved = world.run("fit_checkpoint", cfg, images, labels, world_dir, 2, 2)
    restored = jobs.fit_checkpoint(cfg, None, None, world_dir, resume=True)
    for r in saved:
        _assert_same(r, restored)
    # one process saves, a 2 x 2 world restores
    one_dir = str(tmp_path / "one")
    saved = jobs.fit_checkpoint(cfg, images, labels, one_dir)
    for r in world.run("fit_checkpoint", cfg, None, None, one_dir, 2, 2,
                       resume=True):
        _assert_same(saved, r)
    assert saved["step"] == 4


def _assert_same(a, b):
    assert a["step"] == b["step"]
    for key in ("kernel_w", "kernel_mom"):
        if key in a or key in b:
            np.testing.assert_array_equal(a[key], b[key])
    assert len(a["kernel_slots"]) == len(b["kernel_slots"])
    for x, y in zip(a["kernel_slots"], b["kernel_slots"]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a["head_state"], b["head_state"], strict=True):
        np.testing.assert_array_equal(x, y)
    for name, v in a["sd"].items():
        np.testing.assert_array_equal(v, b["sd"][name])


@pytest.mark.parametrize("signal_rank,signal_batch,steps", [
    (1, 1, 4),     # stops at the vote after step 4 (print_freq 3)
    (2, 5, 6)])    # at the vote at the epoch's end
def test_preemption_stops_every_rank_at_the_same_step(
        world, tmp_path, signal_rank, signal_batch, steps):
    c, n = 64, 4
    rs = np.random.RandomState(8)
    images = rs.randint(0, 256, (6 * n, IMAGE, IMAGE, 3), np.uint8)
    labels = rs.randint(0, c, 6 * n).astype(np.int32)
    cfg = tcfg.TrainConfig(
        backbone="resnet18", head="arcface", num_classes=c, batch_size=n,
        epochs=2, print_freq=3, compute_dtype="float32",
        data=tcfg.DataConfig(image_size=IMAGE))
    out = world.run("fit_preempted", cfg, images, labels,
                    str(tmp_path / "ckpt"), 2, 2, signal_rank, signal_batch)
    assert [r["steps"] for r in out] == [steps] * 4
    assert all(r["preempted"] for r in out)
    assert out[0]["files"] == ["epoch_0"]


def test_replicated_partial_fc_over_the_data_axis(world, tmp_path):
    c, n = 2048, 8
    rs = np.random.RandomState(6)
    images = rs.randint(0, 256, (n, IMAGE, IMAGE, 3), np.uint8)
    labels = rs.randint(0, c, n).astype(np.int32)
    cfg = tcfg.TrainConfig(
        backbone="resnet18", head="cosface", num_classes=c, batch_size=n,
        epochs=1, partial_fc=0.1, print_freq=1000, compute_dtype="float32",
        data=tcfg.DataConfig(image_size=IMAGE),
        optimizer=tcfg.OptimizerConfig(learning_rate=0.01))
    want = jobs.fit_checkpoint(cfg, images, labels, str(tmp_path / "one"),
                               shuffle=False)
    out = world.run("fit_checkpoint", cfg, images, labels,
                    str(tmp_path / "world"), 4, 1, shuffle=False)
    for r in out:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(r["kernel_w"], want["kernel_w"],
                                   rtol=5e-3, atol=5e-5)
        # the momentum holds the sampled columns' gradients
        np.testing.assert_allclose(
            r["kernel_mom"], want["kernel_mom"], rtol=5e-3,
            atol=1e-4 * np.abs(want["kernel_mom"]).max())
        for name, v in want["sd"].items():
            np.testing.assert_allclose(r["sd"][name], v, rtol=5e-3,
                                       atol=5e-5, err_msg=name)
