"""The port's memory-blended heads (VPL-ArcFace, QAFace) against the JAX
package's: the eager [N, C] heads and the fused path, their state sequences
and gradients, QAFace's degraded view (`degrade_images`) and the BatchNorm
buffers of its second forward, the state bridge and the CLI.

Inputs are made with numpy from a seed and handed to both packages; the JAX
fused path runs its Pallas kernels in interpret mode (block_n=16,
block_c=64). Tolerances are those of tests/test_fused_head.py:292-350: loss
rtol = atol = 3e-5, acc1 / acc5 the same rows, state leaves rtol 1e-5 atol 1e-6
(delta=2, so memories expire mid-sequence), gradients rtol 5e-4 atol 1e-6.
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.heads import margins as jmargins
from face_recognition_models_tpu.heads.fused_adapter import (
    fused_apply as jfused_apply)
from face_recognition_models_tpu.train.loop import (
    degrade_images as jdegrade_images)
from face_recognition_models_tpu.train.losses import (
    mean_cross_entropy as jmean_ce)
from face_recognition_models_tpu.train.metrics import topk_accuracy as jtopk
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.heads import margins as tmargins
from face_recognition_models_tpu_torch.heads.fused_adapter import (
    fused_apply as tfused_apply)
from face_recognition_models_tpu_torch.models.resnet import (
    BasicBlock,
    ResNet,
    running_stats_frozen,
)
from face_recognition_models_tpu_torch.train.loop import degrade_images
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import (
    head_state_from_jax)

N, D, C = 24, 64, 100
HEADS = ("vpl_arcface", "qaface")
PATHS = ("eager", "fused")
LOSS_TOL = dict(rtol=3e-5, atol=3e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _setup(name, seed=0, steps=3):
    """(JAX cfg, port cfg, kernel, [(feats, labels, minput)]) in numpy."""
    jc = jcfg.make_head_config(name, feature_dim=D, num_classes=C, delta=2)
    tc = tcfg.make_head_config(name, feature_dim=D, num_classes=C, delta=2)
    rs = np.random.RandomState(seed)
    bound = np.sqrt(6.0 / (D + C))
    kernel = rs.uniform(-bound, bound, (D, C)).astype(np.float32)
    batches = []
    for _ in range(steps):
        feats = (10.0 * rs.randn(N, D)).astype(np.float32)
        labels = rs.randint(0, C, N).astype(np.int32)
        minput = (feats + 2.0 * rs.randn(N, D)).astype(np.float32)
        batches.append((feats, labels, minput if name == "qaface" else None))
    return jc, tc, kernel, batches


def _jax_head(path, cfg, kernel, feats, labels, state, minput):
    """(loss, acc1, acc5, new state) of the JAX package's head."""
    if path == "fused":
        out = jfused_apply(cfg, kernel, feats, labels, state, minput=minput,
                           block_n=16, block_c=64, interpret=True)
        return out.loss_id, out.acc1, out.acc5, out.state
    out = jget_head(cfg.name).apply(cfg, kernel, feats, labels, state,
                                    minput=minput)
    return (jmean_ce(out.logits, labels), *jtopk(out.pre_logits, labels),
            out.state)


def _port_head(path, cfg, kernel, feats, labels, state, minput):
    if path == "fused":
        out = tfused_apply(cfg, kernel, feats, labels, state, minput=minput)
        return out.loss_id, out.acc1, out.acc5, out.state
    out = get_head(cfg.name).apply(cfg, kernel, feats, labels, state,
                                   minput=minput)
    return (mean_cross_entropy(out.logits, labels),
            *topk_accuracy(out.pre_logits, labels), out.state)


def _hits(acc):
    """Rows counted by a top-k accuracy in percent: exact, where the two
    packages' percentages may round differently."""
    return round(float(acc) * N / 100.0)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, grad=False):
    return None if x is None else torch.tensor(x, requires_grad=grad)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", HEADS)
def test_mem_head_sequence_matches_jax(name, path):
    """Three steps from the initial state: loss, top-k and every state leaf
    (memory, lifetimes, QAFace's magnitude EMAs) track the JAX head."""
    jc, tc, kernel, batches = _setup(name)
    jstate = jget_head(name).init_state(jc)
    tstate = get_head(name).init_state(tc, "cpu")
    for step, (feats, labels, minput) in enumerate(batches):
        jl, ja1, ja5, jstate = _jax_head(path, jc, jnp.asarray(kernel),
                                         jnp.asarray(feats),
                                         jnp.asarray(labels), jstate,
                                         _j(minput))
        tl, ta1, ta5, tstate = _port_head(path, tc, torch.tensor(kernel),
                                          torch.tensor(feats),
                                          torch.tensor(labels), tstate,
                                          _t(minput))
        np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL,
                                   err_msg=f"loss step {step}")
        assert _hits(ta1) == _hits(ja1), f"acc1 step {step}"
        assert _hits(ta5) == _hits(ja5), f"acc5 step {step}"
        jleaves = jax.tree.leaves(jstate)
        assert len(jleaves) == len(tstate)
        for field, got, want in zip(tstate._fields, tstate, jleaves):
            np.testing.assert_allclose(got.numpy().astype(np.float32),
                                       np.asarray(want, np.float32),
                                       **STATE_TOL,
                                       err_msg=f"{field} step {step}")
    # the classes of the last batch are active: the blend was exercised
    assert float((tstate.life > 0).sum()) > 0


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", HEADS)
def test_mem_head_gradients_match_jax(name, path):
    """Gradients with respect to the class kernel, the features and (QAFace)
    the degraded view's features, from a state with active memories."""
    jc, tc, kernel, batches = _setup(name, seed=3, steps=2)
    f0, l0, m0 = batches[0]
    jstate = jget_head(name).apply(jc, jnp.asarray(kernel), jnp.asarray(f0),
                                   jnp.asarray(l0), jget_head(name)
                                   .init_state(jc), minput=_j(m0)).state
    tstate = head_state_from_jax(name, _host(jstate))
    feats, labels, minput = batches[1]
    has_m = minput is not None

    def jloss(k, f, mi):
        return _jax_head(path, jc, k, f, jnp.asarray(labels), jstate,
                         mi if has_m else None)[0]

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(kernel), jnp.asarray(feats),
        jnp.asarray(minput if has_m else feats))
    tk, tf = _t(kernel, True), _t(feats, True)
    tm = _t(minput, True)
    loss = _port_head(path, tc, tk, tf, torch.tensor(labels), tstate, tm)[0]
    loss.backward()
    assert float(tstate.life.max()) > 0  # the blend is exercised
    pairs = [(tk, jgrads[0], "kernel"), (tf, jgrads[1], "feats")]
    if has_m:
        pairs.append((tm, jgrads[2], "minput"))
    for leaf, want, what in pairs:
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   err_msg=what, **GRAD_TOL)


@pytest.mark.parametrize("path", PATHS)
def test_qaface_equal_magnitudes_give_finite_gradients(path):
    """Every magnitude of the degraded view equal: the zero-variance guard
    keeps the gradients finite, and equal to the JAX package's."""
    jc, tc, kernel, batches = _setup("qaface", seed=4, steps=1)
    feats, labels, _ = batches[0]
    minput = np.zeros((N, D), np.float32)
    minput[np.arange(N), np.arange(N) % D] = 4.0  # every row norm exactly 4
    jstate = jget_head("qaface").init_state(jc)
    tstate = get_head("qaface").init_state(tc, "cpu")

    def jloss(k, f, mi):
        return _jax_head(path, jc, k, f, jnp.asarray(labels), jstate, mi)[0]

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(kernel), jnp.asarray(feats), jnp.asarray(minput))
    leaves = [_t(x, True) for x in (kernel, feats, minput)]
    loss = _port_head(path, tc, *leaves[:2], torch.tensor(labels), tstate,
                      leaves[2])[0]
    loss.backward()
    for leaf, want in zip(leaves, jgrads):
        assert bool(torch.isfinite(leaf.grad).all())
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_class_mean_update_matches_jax():
    rs = np.random.RandomState(6)
    values = rs.randn(N, D).astype(np.float32)
    labels = rs.randint(0, 10, N).astype(np.int32)
    labels[3] = -1  # ignored
    mem = rs.randn(12, D).astype(np.float32)
    life = rs.randint(-3, 5, 12).astype(np.float32)
    want = jmargins._class_mean_update(
        jnp.asarray(values), jnp.asarray(labels), jnp.asarray(labels >= 0),
        jnp.asarray(mem), jnp.asarray(life), 5)
    lab = torch.tensor(labels)
    got = tmargins._class_mean_update(torch.tensor(values), lab, lab >= 0,
                                      torch.tensor(mem), torch.tensor(life),
                                      5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)


@pytest.mark.parametrize("name", HEADS)
def test_head_state_from_jax(name):
    jc, tc, kernel, batches = _setup(name, seed=7, steps=1)
    feats, labels, minput = batches[0]
    assert len(jax.tree.leaves(jget_head(name).init_state(jc))) == len(
        get_head(name).init_state(tc))
    jstate = jget_head(name).apply(jc, jnp.asarray(kernel),
                                   jnp.asarray(feats), jnp.asarray(labels),
                                   jget_head(name).init_state(jc),
                                   minput=_j(minput)).state
    got = head_state_from_jax(name, _host(jstate))
    assert type(got) is {"vpl_arcface": tmargins.VPLArcFaceState,
                         "qaface": tmargins.QAFaceState}[name]
    for field, g, w in zip(got._fields, got, jax.tree.leaves(_host(jstate))):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    assert got.training_flag.dtype == torch.bool
    assert got.mem.dtype == torch.float32
    assert head_state_from_jax("arcface", None) is None


def test_degrade_images_matches_jax():
    """Against jax.image.resize's antialiased bilinear 2x down / up: floats
    within 1e-4, the rounded uint8 view within 1 level."""
    rs = np.random.RandomState(8)
    u8 = rs.randint(0, 256, (4, 112, 112, 3), np.uint8)
    f32 = u8.astype(np.float32)
    got_f = degrade_images(torch.tensor(f32))
    want_f = np.asarray(jdegrade_images(jnp.asarray(f32)))
    assert got_f.dtype == torch.float32 and got_f.shape == f32.shape
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=1e-4)
    got_u = degrade_images(torch.tensor(u8))
    want_u = np.asarray(jdegrade_images(jnp.asarray(u8)))
    assert got_u.dtype == torch.uint8
    diff = np.abs(got_u.numpy().astype(int) - want_u.astype(int))
    assert int(diff.max()) <= 1


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    backbone = ResNet((1, 1), BasicBlock, embed_dim=16, num_filters=8,
                      dtype=torch.float32)
    kernel_w = torch.nn.Parameter(0.1 * torch.randn(16, 12))
    opt = get_optimizer("sgd", [*backbone.parameters(), kernel_w], 0.05,
                        momentum=0.9, weight_decay=5e-4)
    cfg = tcfg.make_head_config("qaface", feature_dim=16, num_classes=12)
    return TrainState(backbone=backbone, kernel_w=kernel_w, optimizer=opt,
                      head_state=get_head("qaface").init_state(cfg)), cfg


@pytest.mark.parametrize("path", PATHS)
def test_qaface_degraded_view_leaves_bn_buffers_unmoved(path):
    """The second (degraded) forward runs in train mode but moves no
    BatchNorm buffer: after one step they equal those of a step that skips
    it, as the JAX step drops the statistics it mutates."""
    rs = np.random.RandomState(9)
    images = torch.tensor(rs.randint(0, 256, (8, 16, 16, 3), np.uint8))
    labels = rs.randint(0, 12, 8).astype(np.int32)
    with_view, cfg = _tiny_state()
    without_view = copy.deepcopy(with_view)
    step = make_train_step(get_head("qaface"), cfg,
                           use_fused_head=path == "fused", device="cpu")
    _, m1 = step(with_view, images, labels, degrade_images(images))
    _, m2 = step(without_view, images, labels)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    got = {k: v for k, v in with_view.backbone.state_dict().items()
           if "running" in k or "num_batches" in k}
    want = without_view.backbone.state_dict()
    assert got
    for key, value in got.items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)
    # the kept head state carries no autograd history into the next step
    assert all(not x.requires_grad for x in with_view.head_state)
    # the flag is restored after the block, even when it raises
    with pytest.raises(RuntimeError):
        with running_stats_frozen(with_view.backbone):
            raise RuntimeError("inside")
    assert with_view.backbone.bn1.update_stats


def test_parse_head_overrides_matches_jax():
    items = ["delta=1", "tto=0", "easy_margin=true", "alpha=0.5"]
    assert (tcfg.parse_head_overrides("qaface", items)
            == jcfg.parse_head_overrides("qaface", items))
    for bad in (["num_classes=3"], ["nokey=1"], ["delta"]):
        with pytest.raises(ValueError):
            tcfg.parse_head_overrides("vpl_arcface", bad)
    cfg = tcfg.make_head_config(
        "vpl_arcface", **tcfg.parse_head_overrides("vpl_arcface",
                                                   ["lamda=0.3"]))
    assert cfg.lamda == 0.3 and cfg.delta == 100


@pytest.mark.parametrize("name,extra", [("vpl_arcface", []),
                                        ("qaface", ["--head-arg",
                                                    "delta=1"])])
def test_cli_trains_mem_head_on_cpu(name, extra, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "face_recognition_models_tpu_torch.cli",
         "train", "--synthetic", "--head", name, *extra,
         "--synthetic-classes", "8", "--synthetic-per-class", "4",
         "--batch_size", "16", "--epochs", "1", "--image-size", "32",
         "--print_freq", "1", "--device", "cpu",
         "--working-path", str(tmp_path / "work")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    losses = [float(x) for x in re.findall(r"\] loss (\S+)", proc.stdout)]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), proc.stdout
    assert f"Training {name}" in proc.stdout
