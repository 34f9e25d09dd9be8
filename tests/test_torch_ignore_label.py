"""The ignore label (-1) on the port's eager head path, against the JAX
package: each eager head's logits (arcface, vpl_arcface, qaface),
`mean_cross_entropy`, `topk_accuracy` and one eager train step, on a batch
with one -1 label and on a batch whose labels are all -1.

The JAX package documents -1 as "ignore" (heads/margins.py:73-75,
train/losses.py:29-34): its one-hot gives a -1 row no target column, the
loss masks the row and divides by max(count, 1), and top-k scores the
target through the one-hot, so a -1 row has target score 0 and counts the
logits above 0.

Inputs are made with numpy from a seed and handed to both packages; the
memory heads start from a JAX state after one step on valid labels (active
memories), carried over with `head_state_from_jax`; the train step's
weights cross with `from_jax`. Tolerances (fp32 on both sides): logits rtol
1e-5 atol 1e-4 (scale 64 times a few ulps of a 512-deep cosine); loss rtol =
atol = 3e-5 (tests/test_fused_head.py's); top-k the same rows exactly;
the all -1 batch's loss exactly 0 with an exactly zero gradient; the train
step's loss 1e-4 relative and feat_norm rtol 1e-4 (tests/
test_fused_trajectory.py's).
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
from face_recognition_models_tpu.train.losses import (
    mean_cross_entropy as jmean_ce)
from face_recognition_models_tpu.train.metrics import topk_accuracy as jtopk
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import (
    from_jax,
    head_state_from_jax,
)

N, D, C = 8, 512, 10
IMAGE = 16
HEADS = ("arcface", "vpl_arcface", "qaface")
BATCHES = ("one_ignored", "all_ignored")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
LOSS_TOL = dict(rtol=3e-5, atol=3e-5)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _labels(rs, batch):
    labels = rs.randint(0, C, N).astype(np.int32)
    if batch == "one_ignored":
        labels[3] = -1
    else:
        labels[:] = -1
    return labels


def _head_case(name, batch, seed=0):
    """(JAX cfg, port cfg, kernel, feats, labels, minput, JAX state, port
    state): the memory heads' state is the JAX head's after one step on
    valid labels, so the blend is live."""
    jc = jcfg.make_head_config(name, feature_dim=D, num_classes=C)
    tc = tcfg.make_head_config(name, feature_dim=D, num_classes=C)
    rs = np.random.RandomState(seed)
    bound = np.sqrt(6.0 / (D + C))
    kernel = rs.uniform(-bound, bound, (D, C)).astype(np.float32)

    def view():
        feats = (10.0 * rs.randn(N, D)).astype(np.float32)
        minput = (feats + 2.0 * rs.randn(N, D)).astype(np.float32)
        return feats, (minput if name == "qaface" else None)

    jstate = jget_head(name).init_state(jc)
    if jstate is not None:
        f0, m0 = view()
        jstate = jget_head(name).apply(
            jc, jnp.asarray(kernel), jnp.asarray(f0),
            jnp.asarray(rs.randint(0, C, N).astype(np.int32)), jstate,
            minput=None if m0 is None else jnp.asarray(m0)).state
    feats, minput = view()
    labels = _labels(rs, batch)
    tstate = head_state_from_jax(name, _host(jstate))
    return jc, tc, kernel, feats, labels, minput, jstate, tstate


def _apply_both(name, batch):
    """((JAX pre_logits, logits), (port pre_logits, logits), labels)."""
    jc, tc, kernel, feats, labels, minput, jstate, tstate = _head_case(
        name, batch)
    jout = jget_head(name).apply(
        jc, jnp.asarray(kernel), jnp.asarray(feats), jnp.asarray(labels),
        jstate, minput=None if minput is None else jnp.asarray(minput))
    tout = get_head(name).apply(
        tc, torch.tensor(kernel), torch.tensor(feats), torch.tensor(labels),
        tstate, minput=None if minput is None else torch.tensor(minput))
    return jout, tout, labels


def _hits(acc):
    """Rows counted by a top-k accuracy in percent."""
    return round(float(acc) * N / 100.0)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", HEADS)
def test_eager_head_logits_match_jax(name, batch):
    """The head runs on -1 labels (no target column in the row) and gives
    the JAX head's pre-margin and post-margin logits and one-hot."""
    jout, tout, _ = _apply_both(name, batch)
    np.testing.assert_allclose(tout.pre_logits.numpy(),
                               np.asarray(jout.pre_logits), **LOGIT_TOL)
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jout.logits),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(tout.one_hot.numpy(),
                                  np.asarray(jout.one_hot))
    assert float(tout.one_hot.sum()) == (N - 1 if batch == "one_ignored"
                                         else 0)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", HEADS)
def test_mean_cross_entropy_matches_jax(name, batch):
    """The -1 rows are masked out of the mean; an all -1 batch gives 0 (not
    NaN) and a zero gradient."""
    jout, tout, labels = _apply_both(name, batch)
    want = float(jmean_ce(jout.logits, jnp.asarray(labels)))
    logits = tout.logits.detach().clone().requires_grad_(True)
    loss = mean_cross_entropy(logits, torch.tensor(labels))
    np.testing.assert_allclose(float(loss.detach()), want, **LOSS_TOL)
    loss.backward()
    assert bool(torch.isfinite(logits.grad).all())
    if batch == "all_ignored":
        assert float(loss.detach()) == 0.0 and want == 0.0
        assert float(logits.grad.abs().max()) == 0.0
    else:
        assert float(logits.grad[3].abs().max()) == 0.0


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", HEADS)
def test_topk_accuracy_matches_jax(name, batch):
    """A -1 row scores its target as 0 and counts the logits above 0: the
    result equals JAX's, row counts exactly."""
    jout, tout, labels = _apply_both(name, batch)
    got = topk_accuracy(tout.pre_logits, torch.tensor(labels))
    want = jtopk(jout.pre_logits, jnp.asarray(labels))
    assert [_hits(g) for g in got] == [_hits(w) for w in want]
    # the -1 row alone: right at k when fewer than k logits exceed 0
    row = tout.pre_logits[3:4]
    above = int((row > 0).sum())
    got_row = topk_accuracy(row, torch.tensor(labels[3:4]))
    want_row = jtopk(jout.pre_logits[3:4], jnp.asarray(labels[3:4]))
    assert [float(g) for g in got_row] == [100.0 * (above < k)
                                           for k in (1, 5)]
    assert [float(g) for g in got_row] == [float(w) for w in want_row]


def _jax_step(name, cfg):
    backbone = JResNet(stage_sizes=(1, 1), block=JBasic, embed_dim=D,
                       num_filters=8, dtype=jnp.float32)
    head = jget_head(name)
    rng = jax.random.PRNGKey(42)
    variables = backbone.init(rng, jnp.zeros((1, IMAGE, IMAGE, 3)),
                              train=False)
    params = {"backbone": variables["params"],
              "kernel_w": head.init_kernel(rng, cfg)}
    tx = jget_optimizer("sgd", 0.05, momentum=0.9, weight_decay=5e-4)
    state = JTrainState(step=jnp.int32(0),
                        params=jax.tree.map(jnp.copy, params),
                        batch_stats=variables["batch_stats"],
                        head_state=head.init_state(cfg),
                        opt_state=tx.init(params),
                        rng=jax.random.PRNGKey(7))
    return state, jax.jit(jmake_step(backbone, head, cfg, tx,
                                     use_fused_head=False))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", HEADS)
def test_eager_train_step_matches_jax(name, batch):
    """One eager train step (`use_fused_head=False`) from the same weights
    on a batch with -1 labels: loss, acc1, acc5 and feat_norm equal the JAX
    eager step's."""
    jc = jcfg.make_head_config(name, feature_dim=D, num_classes=C)
    jstate, jstep = _jax_step(name, jc)
    sd, kernel_w = from_jax(_host(jstate.params), _host(jstate.batch_stats))
    backbone = ResNet((1, 1), BasicBlock, embed_dim=D, num_filters=8,
                      dtype=torch.float32)
    backbone.load_state_dict(sd, strict=True)
    kernel_w = torch.nn.Parameter(kernel_w)
    opt = get_optimizer("sgd", [*backbone.parameters(), kernel_w], 0.05,
                        momentum=0.9, weight_decay=5e-4)
    tc = tcfg.make_head_config(name, feature_dim=D, num_classes=C)
    tstate = TrainState(backbone=backbone, kernel_w=kernel_w, optimizer=opt,
                        head_state=head_state_from_jax(
                            name, _host(jstate.head_state)))
    tstep = make_train_step(get_head(name), tc, use_fused_head=False,
                            device="cpu")
    rs = np.random.RandomState(5)
    images = rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8)
    labels = _labels(rs, batch)
    args = [images, labels]
    if get_head(name).requires_minput:
        args.append(rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8))
    _, jm = jstep(jstate, *map(jnp.asarray, args))
    _, tm = tstep(tstate, *args)
    lj, lt = float(jm["loss"]), float(tm["loss"])
    assert np.isfinite(lt)
    assert abs(lt - lj) <= 1e-4 * max(1.0, abs(lj)), (lt, lj)
    if batch == "all_ignored":
        assert lt == 0.0 and lj == 0.0
    for key in ("acc1", "acc5"):
        assert _hits(tm[key]) == _hits(jm[key]), key
    np.testing.assert_allclose(float(tm["feat_norm"]), float(jm["feat_norm"]),
                               rtol=1e-4, atol=1e-5)
