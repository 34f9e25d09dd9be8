"""Step batching (`TrainConfig.scan_steps`, `train --scan-steps K`): the
port's chunk function (train/graphed.py) against its own single steps bit
for bit and against the JAX package's `lax.scan` chunk; the train state's
tensors keeping their addresses across a step; `fit` with chunks and
leftover batches, and resumed, bitwise equal to `fit` one step at a time;
the CLI flag; and, on a card (marked `cuda`), CUDA-graph replays equal to
eager steps and a step that waits for the host refused.

resnet18 at 16 px, batch 8, C = 8, D = 32. Against JAX the backbones run
in fp32, the JAX step its jnp head (`use_pallas_head=False`), the port its
fused head's plain versions on the CPU; the losses are held to rtol 5e-4,
the bound of the JAX package's own chunk-against-steps test
(tests/test_loop_e2e.py:180-220). JAX is imported inside the tests that
run it: the card's machine has none. On a card:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_steps.py
"""

import numpy as np
import pytest
import torch

from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.cli.main import main
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities)
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.heads.fused_adapter import use_fused
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.ops.image_ops import degrade_images
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.graphed import make_chunk_fn
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    state_tensors,
)
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import (
    from_jax,
    head_state_from_jax,
)

N, D, C = 8, 32, 8
IMAGE = 16
LR = 0.1
HEADS = ("arcface", "vpl_arcface", "qaface")
STATE_HEADS = ("sphereface", "curricularface", "vpl_arcface", "adaface",
               "qaface", "adacos")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(k, seed=3):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (k, N, IMAGE, IMAGE, 3), np.uint8)
    labels = rs.randint(0, C, (k, N)).astype(np.int32)
    return images, labels


def _train_cfg(name, num_classes=C, **kw):
    return tcfg.TrainConfig(head=name, num_classes=num_classes, batch_size=N,
                            seed=0, use_fused_head=use_fused(name),
                            data=tcfg.DataConfig(image_size=IMAGE), **kw)


def _port(name, **kw):
    """(state, step) of resnet18 + head `name` from cfg.seed."""
    cfg = _train_cfg(name, **kw)
    head_cfg = tcfg.make_head_config(name, feature_dim=D, num_classes=C)
    _, head, state = create_train_state(cfg, head_cfg, torch.device("cpu"))
    step = make_train_step(head, head_cfg, use_fused_head=cfg.use_fused_head,
                           device="cpu")
    return state, step


def _single_steps(state, step, name, images, labels):
    losses = []
    for im, lb in zip(torch.from_numpy(images), torch.from_numpy(labels)):
        view = (degrade_images(im),) if get_head(name).requires_minput else ()
        state, m = step(state, im, lb, *view)
        losses.append(float(m["loss"]))
    return losses


def _assert_same_state(got, want):
    a, b = state_tensors(got), state_tensors(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"tensor {i}"
    assert got.step == want.step
    if want.rng is not None:
        assert torch.equal(got.rng.get_state(), want.rng.get_state())


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", HEADS)
def test_chunk_equals_single_steps(name, k):
    images, labels = _batches(k)
    chunked, step = _port(name)
    singles, step1 = _port(name)
    chunk = make_chunk_fn(step, get_head(name).requires_minput)
    _, metrics = chunk(chunked, torch.from_numpy(images),
                       torch.from_numpy(labels))
    assert set(metrics) == {"loss", "loss_id", "loss_mag", "acc1", "acc5",
                            "lr", "feat_norm"}
    assert all(v.shape == (k,) for v in metrics.values())
    want = _single_steps(singles, step1, name, images, labels)
    assert metrics["loss"].tolist() == want
    _assert_same_state(chunked, singles)
    assert int(chunked.count) == chunked.step == k


def _jax_chunk(name, images, labels):
    """The JAX package's scan chunk (loop.py:325-336) of its jnp step: its
    losses, and its initial state's trees as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from face_recognition_models_tpu import config as jcfg
    from face_recognition_models_tpu.train.loop import (
        degrade_images as jdegrade_images)
    from face_recognition_models_tpu.train.optim import (
        get_optimizer as jget_optimizer)
    from face_recognition_models_tpu.train.state import (
        create_train_state as jcreate_train_state)
    from face_recognition_models_tpu.train.step import (
        make_train_step as jmake_train_step)

    cfg = jcfg.TrainConfig(backbone="resnet18", head=name, num_classes=C,
                           batch_size=N, seed=0, use_pallas_head=False,
                           compute_dtype="float32",
                           data=jcfg.DataConfig(image_size=IMAGE))
    head_cfg = jcfg.make_head_config(name, feature_dim=D, num_classes=C)
    tx = jget_optimizer("sgd", LR, momentum=0.9, weight_decay=5e-4)
    backbone, head, state = jcreate_train_state(cfg, head_cfg, tx)
    step_fn = jmake_train_step(backbone, head, head_cfg, tx,
                               use_fused_head=False)

    def body(st, batch):
        im, lb = batch
        if head.requires_minput:
            return step_fn(st, im, lb, jdegrade_images(im))
        return step_fn(st, im, lb)

    _, metrics = jax.jit(lambda st, im, lb: jax.lax.scan(
        body, st, (im, lb)))(state, jnp.asarray(images), jnp.asarray(labels))
    trees = jax.tree.map(np.asarray, jax.device_get(
        (state.params, state.batch_stats, state.head_state)))
    return trees, [float(x) for x in metrics["loss"]]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", HEADS)
def test_chunk_matches_jax_scan(name, k):
    images, labels = _batches(k)
    (params, batch_stats, head_state), want = _jax_chunk(name, images,
                                                         labels)
    sd, kernel_w = from_jax(params, batch_stats)
    backbone = get_backbone("resnet18", embed_dim=D, dtype=torch.float32)
    backbone.load_state_dict(sd, strict=True)
    kernel_w = torch.nn.Parameter(kernel_w)
    state = TrainState(
        backbone=backbone, kernel_w=kernel_w,
        optimizer=get_optimizer("sgd", [*backbone.parameters(), kernel_w],
                                LR, momentum=0.9, weight_decay=5e-4),
        head_state=head_state_from_jax(name, head_state))
    head_cfg = tcfg.make_head_config(name, feature_dim=D, num_classes=C)
    step = make_train_step(get_head(name), head_cfg, device="cpu")
    chunk = make_chunk_fn(step, get_head(name).requires_minput)
    _, metrics = chunk(state, torch.from_numpy(images),
                       torch.from_numpy(labels))
    np.testing.assert_allclose(metrics["loss"].tolist(), want, rtol=5e-4)


@pytest.mark.parametrize("name", STATE_HEADS)
def test_step_keeps_state_addresses(name):
    """A step writes the head state, the step count, the lr, the
    parameters, BatchNorm buffers and momentum in place: a CUDA graph
    captured once reads and writes the same memory on every replay."""
    state, step = _port(name)
    images, labels = _batches(2)
    head_state = [x.data_ptr() for x in state.head_state]
    before = [x.data_ptr() for x in state_tensors(state)]
    _single_steps(state, step, name, images, labels)
    assert [x.data_ptr() for x in state.head_state] == head_state
    assert [x.data_ptr() for x in state_tensors(state)] == before
    assert (state.count.dtype, int(state.count), state.step) == (
        torch.int64, 2, 2)
    assert float(state.lr) == pytest.approx(LR, rel=1e-7)


def _fit(name, k, epochs=2, directory=None, resume=None):
    """fit of `epochs` epochs over 24 synthetic images at batch 8: 3 steps
    an epoch, so K = 2 leaves one leftover step an epoch. With `directory`
    a CheckpointManager there, and `resume` its continue_train."""
    images, labels = synthetic_identities(4, 6, image_size=IMAGE, seed=0)
    cfg = _train_cfg(name, num_classes=4, epochs=epochs, print_freq=1,
                     scan_steps=k, continue_train=resume)
    head_cfg = tcfg.make_head_config(name, feature_dim=D, num_classes=4)
    return loop.fit(cfg, ArrayLoader(images, labels, batch_size=N, seed=0),
                    device="cpu", head_cfg=head_cfg,
                    checkpoint_manager=(None if directory is None else
                                        CheckpointManager(str(directory))))


@pytest.mark.parametrize("name", ("arcface", "vpl_arcface", "qaface",
                                  "elastic_arcface", "adacos"))
def test_fit_scan_steps_equals_single_steps(name, capsys):
    """fit(scan_steps=2) with 3 steps an epoch (one chunk and one leftover
    step per epoch) equals fit(scan_steps=1) bit for bit, as the JAX
    package's test_scan_steps_driver_e2e runs it."""
    chunked = _fit(name, 2)
    # a chunk prints its last step when it crosses a print_freq step, a
    # leftover step its own
    printed = [ln.split(" loss")[0] for ln in
               capsys.readouterr().out.splitlines() if ln.startswith("Epoch")]
    assert printed == ["Epoch: [1/2][2/3]", "Epoch: [1/2][3/3]",
                       "Epoch: [2/2][2/3]", "Epoch: [2/2][3/3]"]
    single = _fit(name, 1)
    assert len(chunked.losses) == 6
    assert chunked.losses == single.losses
    _assert_same_state(chunked.state, single.state)
    assert len(chunked.step_seconds) == 6
    assert chunked.images_per_sec > 0


@pytest.mark.parametrize("name", ("arcface", "qaface"))
def test_resumed_fit_scan_steps_equals_uninterrupted(name, tmp_path):
    """fit(scan_steps=2) for one epoch, then resumed for the next from its
    checkpoint, equals two uninterrupted epochs bit for bit."""
    whole = _fit(name, 2, directory=tmp_path / "whole")
    first = _fit(name, 2, epochs=1, directory=tmp_path / "parts")
    second = _fit(name, 2, epochs=1, directory=tmp_path / "parts",
                  resume="latest")
    assert first.losses + second.losses == whole.losses
    _assert_same_state(second.state, whole.state)
    assert int(second.state.count) == second.state.step == 6


def test_train_cli_scan_steps_with_warmup_cosine(tmp_path, monkeypatch):
    seen = []
    fit = loop.fit

    def recording_fit(cfg, loader, **kw):
        res = fit(cfg, loader, **kw)
        seen.append((cfg, res))
        return res

    monkeypatch.setattr(loop, "fit", recording_fit)
    assert main(["train", "--synthetic", "--device", "cpu",
                 "--synthetic-classes", "4", "--synthetic-per-class", "6",
                 "--batch_size", "8", "--epochs", "2", "--image-size", "16",
                 "--print_freq", "1", "--scan-steps", "2",
                 "--scheduler", "warmup_cosine", "--warmup-epochs", "1",
                 "--working-path", str(tmp_path)]) == 0
    (cfg, res), = seen
    assert cfg.scan_steps == 2
    assert (cfg.schedule.name, cfg.schedule.warmup_epochs) == (
        "warmup_cosine", 1)
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    # epoch 0 warms up from lr 0; epoch 1 takes the cosine's lr0
    assert float(res.state.lr) == pytest.approx(LR, rel=1e-7)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _cuda_fit(name, k, size=32, steps=7):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (steps * 16, size, size, 3), np.uint8)
    labels = rs.randint(0, 100, steps * 16).astype(np.int32)
    cfg = tcfg.TrainConfig(head=name, num_classes=100, batch_size=16,
                           epochs=1, print_freq=100, seed=0, scan_steps=k,
                           use_fused_head=use_fused(name),
                           data=tcfg.DataConfig(image_size=size))
    return loop.fit(cfg, ArrayLoader(images, labels, batch_size=16, seed=0),
                    device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("arcface", "qaface", "elastic_arcface"))
def test_graphed_steps_equal_eager_steps(cuda, name):
    """7 steps with scan_steps=3 (two replays of a CUDA graph of 3 steps and
    one leftover) equal 7 eager steps bit for bit: losses, every state
    tensor, the step generator."""
    graphed = _cuda_fit(name, 3)
    eager = _cuda_fit(name, 1)
    assert graphed.replays == 2
    assert graphed.losses == eager.losses
    _assert_same_state(graphed.state, eager.state)


@pytest.mark.cuda
def test_step_that_waits_for_the_host_is_refused(cuda, monkeypatch):
    """A step that reads a value back to the host cannot be captured:
    `fit` raises with the cause and trains nothing eagerly instead."""
    build = loop.make_train_step

    def syncing(*args, **kwargs):
        step = build(*args, **kwargs)

        def wrapped(state, *batch):
            state, metrics = step(state, *batch)
            metrics["loss"].item()
            return state, metrics
        return wrapped

    monkeypatch.setattr(loop, "make_train_step", syncing)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        _cuda_fit("arcface", 3)
