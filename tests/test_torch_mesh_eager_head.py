"""The class-sharded eager head against the JAX eager head.

Every registered head (and the CLI's `mv_softmax_arc`, MV-Softmax with the
arc margin) runs the train step's eager head (train/step.eager_apply: the
apply of heads/margins.py, the loss of train/losses.py and the top-k of
train/metrics.py) on each rank's rows and class shard, in one gloo world
of 4 CPU ranks (tests/torch_mesh_world.py) laid out 2 x 2 and 1 x 4 (data
x model): each rank holds C/2 or C/4 of the C = 96 classes ([D, C k/m]
columns for sub-center) and the head memories' rows of its classes, and
may not gather the whole class axis (the job makes
collectives.gather_classes and sharding.gather_head_state raise).

The JAX side is `get_head(name).apply` + `mean_cross_entropy` +
`topk_accuracy` on the whole batch (N = 16, D = 32), from the same numpy-
seeded features and labels (row 3 labelled -1), the JAX initialiser's
kernel and the same head state (VPL-ArcFace and QAFace after one warm-up
apply, so their memories are active); the elastic heads' normal draw is
JAX's, handed to the ranks. The loss is the CE plus 0.1 loss_g (MagFace's
regulariser, a row term that must not be summed over the model group).
Bounds: the loss at rtol = atol 2e-5; the kernel gradient (the ranks'
shards joined) and the feature gradient at rtol 5e-4, atol 1e-6 (those of
tests/test_torch_mesh_head.py); top-1 and top-5 equal; the new head state
at rtol 1e-5, atol 1e-6. With model = 4, three of every row's four ranks
do not own its label, which a backward that keeps only the owner's share
of a value reduced over the model group gets wrong.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.train.losses import (
    mean_cross_entropy as jmean_ce,
)
from face_recognition_models_tpu.train.metrics import topk_accuracy as jtopk
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import available_heads, get_head
from face_recognition_models_tpu_torch.train.step import eager_apply
from face_recognition_models_tpu_torch.utils.weights import (
    head_state_from_jax,
)

from torch_mesh_world import World

N, D, C = 16, 32, 96
LAMBDA_G = 0.1
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = {name: (name, {}) for name in available_heads()}
CASES["mv_softmax_arc"] = ("mv_softmax", {"margin_type": "arc"})
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


_JAX = {}


def _jax_case(case):
    """The inputs and the JAX eager head's results for one case, made once
    for both meshes."""
    if case in _JAX:
        return _JAX[case]
    name, kw = CASES[case]
    cfg = jcfg.make_head_config(name, feature_dim=D, num_classes=C, **kw)
    head = jget_head(name)
    k_kernel, k_noise = jax.random.split(jax.random.PRNGKey(0))
    kernel = np.asarray(head.init_kernel(k_kernel, cfg))
    rs = np.random.RandomState(1)
    feats = (10.0 * rs.randn(N, D)).astype(np.float32)
    labels = rs.randint(0, C, N).astype(np.int32)
    labels[3] = -1
    jlab = jnp.asarray(labels)
    state = head.init_state(cfg)
    if name in ("vpl_arcface", "qaface"):
        # one warm-up apply on other rows, so the memories are active
        warm = (5.0 * rs.randn(N, D)).astype(np.float32)
        state = head.apply(cfg, jnp.asarray(kernel), jnp.asarray(warm),
                           jnp.asarray(rs.randint(0, C, N), jnp.int32),
                           state).state

    def loss_fn(k, f):
        out = head.apply(cfg, k, f, jlab, state, rng=k_noise)
        return jmean_ce(out.logits, jlab) + LAMBDA_G * out.loss_g, out

    (loss, out), (gk, gf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(kernel),
                                                jnp.asarray(feats))
    host = lambda t: jax.tree.map(np.asarray, jax.device_get(t))
    want = {"loss": float(loss), "gk": np.asarray(gk), "gf": np.asarray(gf),
            "acc": [float(a) for a in jtopk(out.pre_logits, jlab)],
            "state": (None if out.state is None else
                      {f: np.asarray(getattr(out.state, f))
                       for f in out.state.__dataclass_fields__})}
    inputs = {"kernel": kernel, "feats": feats, "labels": labels,
              "state": (None if state is None
                        else head_state_from_jax(name, host(state))),
              "noise": np.asarray(jax.random.normal(k_noise, (N,),
                                                    jnp.float32)),
              "kw": kw}
    _JAX[case] = (inputs, want)
    return _JAX[case]


def test_cases_cover_every_registered_head():
    assert sorted({name for name, _ in CASES.values()}) == available_heads()
    assert len(available_heads()) == 14


def test_logits_not_covering_the_shard_raise():
    """A kernel that is not the rank's shard of the configured classes
    (here half of them, with no model axis) raises, naming the head."""
    cfg = tcfg.make_head_config("arcface", feature_dim=D, num_classes=8)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="head 'arcface' gave 4 logit"):
        eager_apply(get_head("arcface"), cfg, torch.randn(D, 4, generator=g),
                    torch.randn(3, D, generator=g), torch.tensor([0, 1, 2]),
                    None)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_sharded_eager_head_matches_jax(world, case, mesh):
    name = CASES[case][0]
    data, model = MESHES[mesh]
    inputs, want = _jax_case(case)
    kernel = inputs["kernel"]
    out = world.run("eager_head", name, data, model, kernel,
                    inputs["feats"], inputs["labels"], inputs["state"],
                    head_args=inputs["kw"], noise=inputs["noise"],
                    num_classes=C, lambda_g=LAMBDA_G)
    width = kernel.shape[1] // model
    gk = np.zeros_like(kernel)
    gf = np.zeros((N, D), np.float32)
    for r in out:
        assert r["logit_columns"] == C // model
        np.testing.assert_allclose(r["loss"], want["loss"], **LOSS_TOL)
        assert [r["acc1"], r["acc5"]] == want["acc"]
        cols = slice(r["model_index"] * width, (r["model_index"] + 1) * width)
        rows = slice(r["data_index"] * N // data,
                     (r["data_index"] + 1) * N // data)
        gk[:, cols] = r["gk"]
        # the rank's feature gradient is `data` times the global loss's
        gf[rows] = r["gf"] / data
        if want["state"] is None:
            assert r["state"] is None
            continue
        assert sorted(r["state"]) == sorted(want["state"])
        for field, w in want["state"].items():
            got = r["state"][field]
            assert got.dtype == w.dtype, field
            np.testing.assert_allclose(got, w, err_msg=field, **STATE_TOL)
    np.testing.assert_allclose(gk, want["gk"], err_msg="d kernel", **GRAD_TOL)
    np.testing.assert_allclose(gf, want["gf"], err_msg="d feats", **GRAD_TOL)
