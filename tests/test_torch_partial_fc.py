"""Partial-FC (`TrainConfig.partial_fc`, `train --partial-fc`) in the port
against the JAX package's train/partial_fc.py:

- `num_sampled_classes` over a table of (C, ratio, N);
- `sample_negatives` on the exact and the bucketed route and
  `sample_classes` (through `sample_classes_from_draws`) with JAX's own
  uniform scores and bucket shift: indices, col_valid and target equal,
  at C = 10,575 (exact), 65,536 and 1,048,576 (bucketed);
- two Partial-FC steps against JAX's `make_partial_fc_train_step` with
  JAX's sampled classes injected (the tiny ResNet of
  tests/test_torch_train_step.py at 16 px in fp32, D = 32, C = 64,
  C_s = 24, batch 8): the losses within 1e-4 relative, the backbone,
  BatchNorm buffers, kernel_w and kernel_mom within the recipe tests'
  rtol 5e-3 / atol 2e-3;
- a step writes only the sampled columns of kernel_w and kernel_mom (the
  others stay bit for bit, the sampled ones move), and a padded positive
  slot (repeated labels) writes its column's one value;
- a full sample (C_s = C, unique labels) against the dense eager step
  from the same state (loss rtol 1e-6, kernel_w rtol 1e-5 / atol 1e-7,
  kernel_mom atol 1e-5);
- the logQ shift;
- `fit`'s refusals with the JAX messages and its dense fallback;
- a resumed CPU `fit` bitwise equal to an uninterrupted one, and
  `train --partial-fc` through the CLI.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu.train import partial_fc as jpfc
from face_recognition_models_tpu.train import state as jstate_mod
from face_recognition_models_tpu.train.optim import (
    get_optimizer as jget_optimizer)
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train import partial_fc as pfc
from face_recognition_models_tpu_torch.train import state as tstate_mod
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import (
    from_jax,
    head_state_from_jax,
)
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

N, D, C, C_S, IMAGE = 8, 32, 64, 24, 16
LR, MOMENTUM, WD = 0.1, 0.9, 5e-4
TOL = {"rtol": 5e-3, "atol": 2e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jget_backbone(name, embed_dim=D, dtype=jnp.float32, **kw):
    return JResNet(stage_sizes=(1, 1), block=JBasic, embed_dim=embed_dim,
                   num_filters=8, dtype=jnp.float32)


def get_backbone(name="resnet18", embed_dim=D, dtype=torch.float32, **kw):
    return ResNet((1, 1), BasicBlock, embed_dim=embed_dim, num_filters=8,
                  dtype=torch.float32)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(jstate_mod, "get_backbone", jget_backbone)
    monkeypatch.setattr(tstate_mod, "get_backbone", get_backbone)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("c, ratio, n", [
    (10575, 0.1, 512), (1048576, 0.1, 512), (1048576, 0.01, 512),
    (100, 0.5, 8), (2000, 0.01, 16), (64, 0.1, 16), (300, 0.1, 8),
    (85742, 0.2, 256)])
def test_num_sampled_classes(c, ratio, n):
    assert pfc.num_sampled_classes(c, ratio, n) == \
        jpfc.num_sampled_classes(c, ratio, n)


def _jax_scores(seed, c, positives):
    scores = jax.random.uniform(jax.random.PRNGKey(seed), (c,))
    scores = scores.at[jnp.asarray(positives)].set(-1.0)
    shift = jax.random.randint(jax.random.PRNGKey(seed + 1), (), 0, c)
    return scores, shift


@pytest.mark.parametrize("c, k, max_pos, bucketed", [
    (10575, 768, 512, False), (65536, 4096, 64, True),
    (4096, 256, 8, True), (2048, 64, 1000, False)])
def test_sample_negatives_matches_jax(c, k, max_pos, bucketed):
    """The port's bucketed and exact top-k on JAX's scores and shift:
    the same indices in the same order."""
    rs = np.random.RandomState(c)
    positives = rs.choice(c, max_pos, replace=False)
    scores, shift = _jax_scores(c, c, positives)
    want = np.asarray(jpfc.sample_negatives(scores, k, max_pos, shift=shift))
    got = pfc.sample_negatives(torch.from_numpy(np.array(scores)), k,
                               max_pos, shift=torch.tensor(int(shift)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == k and not set(want) & set(positives)
    # the route: the bucketed form is not the global top-k
    exact = np.asarray(jax.lax.top_k(scores, k)[1])
    assert (set(want) != set(exact)) == bucketed


@pytest.mark.parametrize("c, ratio, n, repeats", [
    (10575, 0.1, 512, True), (65536, 0.1, 64, True),
    (1048576, 0.1, 512, True), (300, 0.1, 8, False)])
def test_sample_classes_matches_jax(c, ratio, n, repeats):
    """sample_classes_from_draws on the draws JAX's sample_classes makes
    from its key (uniform scores [C + 1], the shift from fold_in(key, 1)):
    classes, col_valid and target equal, repeated labels included."""
    c_s = jpfc.num_sampled_classes(c, ratio, n)
    rs = np.random.RandomState(n)
    pool = rs.choice(c, n // 3 if repeats else n, replace=False)
    labels = rs.choice(pool, n, replace=repeats).astype(np.int32)
    key = jax.random.PRNGKey(n + c)
    want = [np.asarray(x) for x in jpfc.sample_classes(
        key, jnp.asarray(labels), c, c_s)]
    scores = np.asarray(jax.random.uniform(key, (c + 1,)))
    shift = int(jax.random.randint(jax.random.fold_in(key, 1), (), 0, c))
    got = pfc.sample_classes_from_draws(
        torch.from_numpy(labels), c, c_s, torch.from_numpy(np.array(scores)),
        torch.tensor(shift))
    for name, g, w in zip(("classes", "col_valid", "target"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # and the port's own draw keeps the contract
    classes, col_valid, target = pfc.sample_classes(
        torch.Generator().manual_seed(0), torch.from_numpy(labels), c, c_s)
    assert np.array_equal(classes[target].numpy(), labels)
    assert col_valid[target].all()
    assert len(np.unique(classes[col_valid].numpy())) == int(col_valid.sum())


def test_logq_shift_value():
    """ln((C - u) / (C_s - N)) on the negative slots, 0 on the positives;
    floored at 0."""
    labels = torch.tensor([5, 5, 9, 1, 1, 1, 30, 2], dtype=torch.int32)
    c = 1000
    _, col_valid, _ = pfc.sample_classes(torch.Generator().manual_seed(1),
                                         labels, c, 256)
    shift = pfc.logq_shift(col_valid, 8, c)
    u = 5  # unique labels
    want = np.float32(np.log(np.float32(c - u) / np.float32(256 - 8)))
    np.testing.assert_allclose(shift[8:].numpy(), want, rtol=1e-6)
    assert not shift[:8].any()
    # the full sample: (C - u) / (C - N) <= 1 -> floored at 0
    _, col_valid, _ = pfc.sample_classes(
        torch.Generator().manual_seed(1), torch.arange(8), 16, 16)
    assert not pfc.logq_shift(col_valid, 8, 16).any()


# --------------------------------------------------------------------------
# The step against JAX
# --------------------------------------------------------------------------


def _batches(steps, c=C, seed=3, unique=False):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        labels = (rs.choice(c, N, replace=False) if unique
                  else rs.randint(0, c // 4, N))
        out.append((rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8),
                    labels.astype(np.int32)))
    return out


def _port_state(cfg, head_cfg, jstate=None):
    """The port's Partial-FC TrainState, on the JAX state's weights."""
    _, head, state = tstate_mod.create_train_state(
        cfg, head_cfg, torch.device("cpu"), partial_fc=True)
    if jstate is not None:
        sd, kernel_w = from_jax(_host(jstate.params),
                                _host(jstate.batch_stats))
        state.backbone.load_state_dict(sd)
        with torch.no_grad():
            state.kernel_w.copy_(kernel_w)
            if state.head_state is not None:
                for x, y in zip(state.head_state, head_state_from_jax(
                        cfg.head, _host(jstate.head_state))):
                    x.copy_(y)
    return head, state


STEP_CASES = {
    "arcface": dict(head="arcface"),
    "curricularface_nesterov": dict(head="curricularface", nesterov=True),
    "cosface_no_logq": dict(head="cosface", logq=False),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_partial_fc_steps_match_jax(case, tiny, monkeypatch):
    kw = STEP_CASES[case]
    head_name, nesterov = kw["head"], kw.get("nesterov", False)
    logq = kw.get("logq", True)
    jc, tc = (lib.TrainConfig(
        backbone="resnet18", head=head_name, num_classes=C, batch_size=N,
        compute_dtype="float32", data=lib.DataConfig(image_size=IMAGE),
        optimizer=lib.OptimizerConfig(learning_rate=LR, momentum=MOMENTUM,
                                      weight_decay=WD, nesterov=nesterov))
        for lib in (jcfg, tcfg))
    jhc = jcfg.make_head_config(head_name, feature_dim=D, num_classes=C)
    thc = tcfg.make_head_config(head_name, feature_dim=D, num_classes=C)
    tx = jget_optimizer("sgd", LR, momentum=MOMENTUM, weight_decay=WD,
                        nesterov=nesterov)
    jbackbone, jhead, jstate = jstate_mod.create_train_state(jc, jhc, tx)
    jstate = jstate.replace(
        opt_state=jpfc.init_partial_fc_opt_state(tx, jstate.params))
    jstep = jax.jit(jpfc.make_partial_fc_train_step(
        jbackbone, jhead, jhc, tx, C_S, LR, momentum=MOMENTUM,
        weight_decay=WD, nesterov=nesterov, logq_correction=logq))
    head, state = _port_state(tc, thc, jstate)
    step = pfc.make_partial_fc_train_step(
        head, thc, C_S, momentum=MOMENTUM, weight_decay=WD,
        nesterov=nesterov, logq_correction=logq, device="cpu")

    samples = []
    monkeypatch.setattr(pfc, "sample_classes",
                        lambda *a: samples.pop(0))
    for images, labels in _batches(2):
        # the JAX step's sample key: the 5th of split(state.rng, 5)
        key = jax.random.split(jstate.rng, 5)[4]
        drawn = jpfc.sample_classes(key, jnp.asarray(labels), C, C_S)
        samples.append(tuple(torch.from_numpy(np.array(x, np.int64)
                                              if x.dtype != jnp.bool_
                                              else np.array(x))
                             for x in drawn))
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        state, m = step(state, images, labels)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * max(
            1.0, abs(float(jm["loss"]))), (float(m["loss"]),
                                           float(jm["loss"]))
        for name in ("acc1", "acc5", "lr"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=1e-6, err_msg=name)
    assert not samples
    want, want_kernel = from_jax(_host(jstate.params),
                                 _host(jstate.batch_stats))
    got = state.backbone.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       err_msg=key, **TOL)
    np.testing.assert_allclose(state.kernel_w.detach().numpy(),
                               want_kernel.numpy(), **TOL)
    np.testing.assert_allclose(
        state.kernel_mom.numpy(),
        np.asarray(jstate.opt_state["kernel_mom"]), **TOL)
    if state.head_state is not None:
        want_state = head_state_from_jax(head_name,
                                         _host(jstate.head_state))
        for x, y in zip(state.head_state, want_state):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def test_step_writes_only_the_sampled_columns(tiny, monkeypatch):
    """After a step kernel_w and kernel_mom equal their old values bit for
    bit outside the sampled classes and differ on every sampled one; a
    batch with repeated labels (padded positive slots) writes the same
    values as one written column by column."""
    c = 300
    cfg = tcfg.TrainConfig(head="arcface", num_classes=c, batch_size=N,
                           compute_dtype="float32",
                           data=tcfg.DataConfig(image_size=IMAGE))
    hc = tcfg.make_head_config("arcface", feature_dim=D, num_classes=c)
    head, state = _port_state(cfg, hc)
    with torch.no_grad():   # a momentum to move
        state.kernel_mom.normal_(generator=torch.Generator().manual_seed(2))
    step = pfc.make_partial_fc_train_step(head, hc, 32, device="cpu")
    drawn = []
    sample = pfc.sample_classes
    monkeypatch.setattr(pfc, "sample_classes",
                        lambda *a: drawn.append(sample(*a)) or drawn[-1])
    w0, m0 = state.kernel_w.detach().clone(), state.kernel_mom.clone()
    images, labels = _batches(1, c=c)[0]
    labels[1] = labels[0]               # a padded positive slot
    state, _ = step(state, images, labels)
    classes, col_valid, _ = drawn[0]
    sampled = np.zeros(c, bool)
    sampled[classes[col_valid].numpy()] = True
    w1, m1 = state.kernel_w.detach(), state.kernel_mom
    assert torch.equal(w1[:, ~sampled], w0[:, ~sampled])
    assert torch.equal(m1[:, ~sampled], m0[:, ~sampled])
    assert (w1[:, sampled] != w0[:, sampled]).any(0).all()
    assert (m1[:, sampled] != m0[:, sampled]).any(0).all()


def test_full_sample_equals_the_dense_step(tiny):
    """C_s = C with unique labels covers every class (the logQ shift is 0):
    the sampled step equals the dense eager step from the same state."""
    c = 16
    cfg = tcfg.TrainConfig(head="arcface", num_classes=c, batch_size=N,
                           compute_dtype="float32",
                           data=tcfg.DataConfig(image_size=IMAGE))
    hc = tcfg.make_head_config("arcface", feature_dim=D, num_classes=c)
    head, sampled = _port_state(cfg, hc)
    _, _, dense = tstate_mod.create_train_state(cfg, hc, torch.device("cpu"))
    step_s = pfc.make_partial_fc_train_step(head, hc, c, device="cpu")
    step_d = make_train_step(head, hc, use_fused_head=False, device="cpu")
    for images, labels in _batches(2, c=c, unique=True):
        sampled, ms = step_s(sampled, images, labels)
        dense, md = step_d(dense, images, labels)
        np.testing.assert_allclose(float(ms["loss"]), float(md["loss"]),
                                   rtol=1e-6)
        for name in ("acc1", "acc5"):
            assert float(ms[name]) == float(md[name])
    np.testing.assert_allclose(sampled.kernel_w.detach().numpy(),
                               dense.kernel_w.detach().numpy(), rtol=1e-5,
                               atol=1e-7)
    # the momentum is the kernel's gradient (up to 8.5 here): the
    # permuted columns sum the softmax in another order
    buf = dense.optimizer.state[dense.kernel_w]["momentum_buffer"]
    np.testing.assert_allclose(sampled.kernel_mom.numpy(), buf.numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(sampled.backbone.parameters(),
                    dense.backbone.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------


def _fit_cfg(**kw):
    opt = kw.pop("optimizer", {})
    return tcfg.TrainConfig(
        head=kw.pop("head", "arcface"), num_classes=kw.pop("num_classes", 300),
        batch_size=N, epochs=kw.pop("epochs", 1), print_freq=100,
        compute_dtype="float32", partial_fc=kw.pop("partial_fc", 0.1),
        data=tcfg.DataConfig(image_size=IMAGE),
        optimizer=tcfg.OptimizerConfig(**opt), **kw)


def _loader(c=300, steps=3):
    rs = np.random.RandomState(5)
    images = rs.randint(0, 256, (steps * N, IMAGE, IMAGE, 3), np.uint8)
    return ArrayLoader(images, rs.randint(0, c, steps * N).astype(np.int32),
                       batch_size=N, seed=0)


REFUSALS = {
    "grad_accum": (dict(grad_accum=2), "grad_accum requires --partial-fc 0"),
    "distill": (dict(distill=tcfg.DistillConfig(weight=1.0,
                                                checkpoint_dir="x")),
                "distillation requires --partial-fc 0"),
    "freeze": (dict(freeze_backbone=True),
               "freeze_backbone is not supported with partial_fc"),
    "adamw": (dict(optimizer={"name": "adamw"}),
              "partial_fc requires optimizer 'sgd' \\(got 'adamw'\\)"),
    "clip": (dict(optimizer={"clip_grad_norm": 1.0}),
             "clip_grad_norm is not supported with partial_fc"),
    "vpl_arcface": (dict(head="vpl_arcface"),
                    "partial_fc does not support head 'vpl_arcface'"),
    "adacos": (dict(head="adacos"),
               "partial_fc does not support head 'adacos'"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_fit_refusals(case, tiny, monkeypatch):
    kw, message = REFUSALS[case]
    monkeypatch.setattr(loop, "get_backbone", get_backbone)
    with pytest.raises(ValueError, match=message):
        loop.fit(_fit_cfg(**kw), _loader(), device="cpu")


def test_fit_dense_fallback(tiny, capsys):
    """C too small for the batch and ratio: the JAX print, then the dense
    step (no kernel_mom, the optimizer holds kernel_w)."""
    res = loop.fit(_fit_cfg(num_classes=40, head="vpl_arcface"),
                   _loader(c=40), device="cpu")
    assert "[partial_fc] C=40 too small for batch 8 / ratio 0.1 — using " \
           "the dense path" in capsys.readouterr().out
    assert res.state.kernel_mom is None
    assert res.state.kernel_w in res.state.optimizer.state
    assert np.isfinite(res.losses).all()


def test_resumed_fit_equals_uninterrupted(tiny, tmp_path):
    """1 epoch, then a resumed epoch, against 2 epochs uninterrupted: the
    losses, kernel_w, kernel_mom, the backbone and its slots bit for bit
    (the step generator and kernel_mom go through the checkpoint)."""
    def run(directory, epochs, resume=None):
        mgr = CheckpointManager(str(directory), "arcface")
        return loop.fit(_fit_cfg(epochs=epochs, continue_train=resume,
                                 model_ema=0.5), _loader(), device="cpu",
                        checkpoint_manager=mgr)

    whole = run(tmp_path / "a", 2)
    first = run(tmp_path / "b", 1)
    second = run(tmp_path / "b", 1, resume="latest")
    assert first.losses + second.losses == whole.losses
    for x, y in zip(tstate_mod.state_tensors(second.state),
                    tstate_mod.state_tensors(whole.state), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(second.state.rng.get_state(),
                       whole.state.rng.get_state())
    assert whole.state.kernel_mom.abs().sum() > 0


def test_train_cli_partial_fc(tmp_path, capsys):
    rc = cli(["train", "--synthetic", "--device", "cpu",
              "--synthetic-classes", "300", "--synthetic-per-class", "1",
              "--batch_size", "16", "--epochs", "1", "--image-size", "16",
              "--partial-fc", "0.1", "--working-path", str(tmp_path),
              "--print_freq", "1000"])
    out = capsys.readouterr().out
    assert rc == 0 and "partial-fc head" in out and "dense path" not in out
    state = torch.load(tmp_path / "checkpoints" / "arcface" / "epoch_1",
                       weights_only=True)["state"]
    assert state["kernel_mom"].shape == (512, 300)
    assert state["kernel_w"].shape == (512, 300)
