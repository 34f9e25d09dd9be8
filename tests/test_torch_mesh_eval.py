"""The data-parallel triplet step, the sharded gallery and the sharded
embedding passes, in a world of 2 gloo ranks.

- The triplet step with `mesh=` (each rank embeds 8 of the 16 rows of a
  P4 x K4 batch, the embeddings gathered before the mining, BatchNorm over
  the global batch) mines exactly the triplets the one-process step mines
  from the same weights and seed (the valid pairs and their negatives, as
  tests/test_mining.py holds JAX's sharded mining to its unsharded one),
  with the same losses (rtol 1e-5) and the same trunk after two steps
  (rtol 1e-4 / atol 1e-6), bitwise equal on both ranks.
- `pooled_scores_device` with its gallery split over the two ranks (27
  images over 5 identities: a padded row, identities across the split)
  equals the JAX package's `shard=True` on the 8-device CPU mesh and the
  host pooling (atol 1e-6), as tests/test_openset.py holds JAX's.
- `make_embed_fn(mesh=)` gives each rank the whole batch's embeddings, the
  one-process eval step's (rtol 1e-5 / atol 1e-6), and refuses a batch the
  data axis does not divide with the JAX message.
"""

import numpy as np
import pytest
import torch

from face_recognition_models_tpu.evaluation.openset import (
    pooled_scores_device as j_pooled,
)
from face_recognition_models_tpu_torch.evaluation.openset import (
    _best_per_identity,
)
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.train.step import make_eval_step

import torch_mesh_jobs as jobs
from torch_mesh_world import World

STAGES, WIDTH = (1, 1), 8


@pytest.fixture(scope="module")
def world():
    w = World(2)
    yield w
    w.close()


def _trunk():
    bb = jobs.tiny_resnet(STAGES, WIDTH, 16)
    init_weights(bb, torch.Generator().manual_seed(3))
    return bb, {k: v.clone() for k, v in bb.state_dict().items()}


def test_data_parallel_triplet_step_mines_the_same_triplets(world):
    _, sd = _trunk()
    rs = np.random.RandomState(0)
    batches = [(rs.randint(0, 256, (16, 16, 16, 3), np.uint8),
                np.repeat(rs.choice(50, 4, replace=False), 4).astype(
                    np.int32)) for _ in range(2)]
    want = jobs.triplet_steps(STAGES, WIDTH, sd, batches)
    out = world.run("triplet_steps", STAGES, WIDTH, sd, batches, data=2)
    for r in out:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        for (v, neg), (wv, wneg) in zip(r["mined"], want["mined"]):
            np.testing.assert_array_equal(v, wv)
            np.testing.assert_array_equal(neg[wv], wneg[wv])
        assert any(v.any() for v, _ in r["mined"])
        for name, v in want["sd"].items():
            np.testing.assert_allclose(r["sd"][name], v, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_array_equal(r["sd"][name],
                                          out[0]["sd"][name])


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_sharded_gallery_matches_jax_shard(world):
    rng = np.random.default_rng(17)
    gal_ids = np.array([f"id{i % 5}" for i in range(27)])
    gal = _unit(rng.normal(size=(27, 16))).astype(np.float32)
    probes = _unit(rng.normal(size=(9, 16))).astype(np.float32)
    want, uniq_j = j_pooled(gal, gal_ids, probes, chunk=4, shard=True)
    host, uniq_h = _best_per_identity(probes @ gal.T, gal_ids)
    for pooled, uniq in world.run("pooled_scores", gal, gal_ids, probes, 4):
        np.testing.assert_array_equal(uniq, uniq_j)
        np.testing.assert_array_equal(uniq, uniq_h)
        np.testing.assert_allclose(pooled, np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(pooled, host, atol=1e-6)


def test_sharded_embedding_passes(world):
    bb, sd = _trunk()
    rs = np.random.RandomState(1)
    batches = [rs.randint(0, 256, (8, 16, 16, 3), np.uint8)
               for _ in range(2)]
    step = make_eval_step(bb, device="cpu")
    want = [step(torch.as_tensor(b)).numpy() for b in batches]
    for r in world.run("embed_batches", STAGES, WIDTH, sd, batches, 2):
        for got, w in zip(r[:2], want):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
        assert r[2] == "batch 3 not divisible by mesh data axis 2"
