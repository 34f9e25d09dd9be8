"""The port's checkpoints against the JAX CheckpointManager's semantics, and
resume through the port's `fit` on the CPU.

- The same save sequence through both managers gives the same file names
  (the JAX package's directories, the port's files), the same
  (start_epoch, loss) on restore, the same min_loss deletion, and the same
  behaviour for reset and "nothing to restore". Losses are float32 values,
  which the JAX manager stores exactly.
- A restored state equals the saved one bit for bit; `fit` for 2 epochs
  equals 1 epoch + a resumed epoch bit for bit (weights, BatchNorm
  buffers, momentum, head state, losses) on the CPU.
- A SIGTERM mid-epoch leaves a resumable epoch - 1 checkpoint.
"""

import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu.checkpoint import (
    CheckpointManager as JaxManager,
)
from face_recognition_models_tpu.train.state import TrainState as JaxState
from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_backbone,
)
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
)
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models import resnet as tresnet
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import TrainState
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers, and these small ops slow down many times over when every
    worker's torch also starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_state(seed=0):
    rng = jax.random.PRNGKey(seed)
    return JaxState(step=jnp.int32(seed), params={
        "backbone": {"w": jax.random.normal(rng, (4, 4))},
        "kernel_w": jax.random.normal(rng, (4, 8))},
        batch_stats={"bn": {"mean": jnp.zeros((4,))}}, head_state=None,
        opt_state={"momentum": jnp.ones((4, 4)) * seed}, rng=rng)


def _torch_state(seed=0, head="vpl_arcface"):
    """A small TrainState with every kind of tensor a checkpoint holds:
    parameters, BatchNorm buffers, a head state, momentum."""
    gen = torch.Generator().manual_seed(seed)
    backbone = tresnet.ResNet((1,), tresnet.BasicBlock, embed_dim=8,
                              num_filters=4, dtype=torch.float32)
    tresnet.init_weights(backbone, gen)
    head_cfg = cfg_lib.make_head_config(head, feature_dim=8, num_classes=6)
    h = get_head(head)
    kernel_w = torch.nn.Parameter(h.init_kernel(head_cfg, gen, "cpu"))
    state = TrainState(backbone=backbone, kernel_w=kernel_w,
                       optimizer=get_optimizer(
                           "sgd", [*backbone.parameters(), kernel_w], 0.1),
                       head_state=h.init_state(head_cfg, "cpu"), step=seed)
    images = torch.randn(4, 12, 12, 3, generator=gen)
    loss = backbone(images).square().sum() + kernel_w.square().sum()
    loss.backward()
    state.optimizer.step()
    if state.head_state is not None:
        state.head_state = type(state.head_state)(
            *(torch.rand(x.shape, generator=gen).to(x.dtype)
              for x in state.head_state))
    return state


def _tensors(state):
    out = {f"b.{k}": v for k, v in state.backbone.state_dict().items()}
    out["kernel_w"] = state.kernel_w.detach()
    for i, slot in state.optimizer.state_dict()["state"].items():
        out[f"m.{i}"] = slot["momentum_buffer"]
    for i, x in enumerate(state.head_state or ()):
        out[f"h.{i}"] = x
    return out


def _assert_same_state(got, want):
    a, b = _tensors(got), _tensors(want)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    assert got.step == want.step


def _files(path):
    return sorted(n for n in os.listdir(path) if not n.endswith(".tmp"))


SAVES = [(1, 2.5, True), (1, 2.5, False), (2, 3.0, False), (3, 2.0, True),
         (3, 2.0, False), (4, 2.25, False), (5, 1.5, True), (5, 1.5, False)]


@pytest.mark.parametrize("upto", [3, len(SAVES)])
def test_save_sequence_matches_jax(tmp_path, upto):
    jmgr = JaxManager(str(tmp_path / "jax"), "arcface", async_save=False)
    tmgr = CheckpointManager(str(tmp_path / "port"), "arcface")
    jstate, tstate = _jax_state(), _torch_state()
    for epoch, loss, best in SAVES[:upto]:
        jmgr.save(jstate, epoch, loss, is_best=best)
        tmgr.save(tstate, epoch, loss, is_best=best)
        assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for mode in ("latest", "min_loss"):
        _, jstart, jloss = jmgr.restore(jstate, mode)
        restored, start, loss = tmgr.restore(_torch_state(1), mode)
        assert (start, loss) == (jstart, jloss)
        assert _files(tmp_path / "port") == _files(tmp_path / "jax")
        _assert_same_state(restored, tstate)
    # min_loss deleted every epoch file: 'latest' now finds nothing
    assert jmgr.restore(jstate, "latest")[1:] == (1, float("inf"))
    assert tmgr.restore(_torch_state(1), "latest") == (None, 1, float("inf"))


def test_nothing_to_restore_and_reset_match_jax(tmp_path):
    jmgr = JaxManager(str(tmp_path / "jax"), "arcface", async_save=False)
    tmgr = CheckpointManager(str(tmp_path / "port"), "arcface")
    for mode in ("latest", "min_loss"):
        assert jmgr.restore(_jax_state(), mode) == (None, 1, float("inf"))
        assert tmgr.restore(_torch_state(), mode) == (None, 1, float("inf"))
    # min_loss without a best file keeps the epoch files
    jmgr.save(_jax_state(), 2, 6.0)
    tmgr.save(_torch_state(), 2, 6.0)
    assert jmgr.restore(_jax_state(), "min_loss") == (None, 1, float("inf"))
    assert tmgr.restore(_torch_state(), "min_loss") == (None, 1,
                                                        float("inf"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "epoch_2"]
    jmgr.reset()
    tmgr.reset()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == []
    with pytest.raises(ValueError, match="mode"):
        tmgr.restore(_torch_state(), "best")


@pytest.mark.parametrize("head", ["arcface", "vpl_arcface"])
def test_restore_is_bitwise_and_binds_the_live_parameters(tmp_path, head):
    saved = _torch_state(3, head)
    mgr = CheckpointManager(str(tmp_path), "m")
    torch.manual_seed(11)
    mgr.save(saved, 7, 0.5)
    torch.manual_seed(12)
    fresh = _torch_state(4, head)
    params = [*fresh.backbone.parameters(), fresh.kernel_w]
    restored, start, loss = mgr.restore(fresh, "latest")
    assert restored is fresh and (start, loss) == (8, 0.5)
    _assert_same_state(fresh, saved)
    # the optimizer still steps the live parameters, not copies
    assert [p for g in fresh.optimizer.param_groups
            for p in g["params"]] == params
    # the default generator came back with the state
    torch.manual_seed(11)
    want = torch.rand(3)
    torch.manual_seed(0)
    mgr.restore(_torch_state(4, head), "latest")
    assert torch.equal(torch.rand(3), want)


def test_final_artifacts_and_restore_backbone(tmp_path):
    state = _torch_state(2)
    mgr = CheckpointManager(str(tmp_path / "arcface"), "arcface")
    mgr.save(state, 1, 1.0, is_best=True)
    mgr.save_final(state.backbone.state_dict())
    mgr.save_final({"w": torch.ones(2)}, filename="arcface_final_ema")
    root = str(tmp_path / "arcface")
    for which in ("final", "min_loss"):
        sd = restore_backbone(root, which)
        want = state.backbone.state_dict()
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in sd)
    assert torch.equal(restore_backbone(root, "final_ema")["w"],
                       torch.ones(2))
    with pytest.raises(FileNotFoundError):
        restore_backbone(root, "best_acc")
    with pytest.raises(ValueError, match="which"):
        restore_backbone(root, "latest")


def _fit_setup(tmp_path, head):
    images, labels = synthetic_identities(8, 3, image_size=24, seed=1)
    loader = ArrayLoader(images, labels, batch_size=8, seed=0)

    def run(epochs, resume=None):
        cfg = cfg_lib.TrainConfig(head=head, num_classes=8, batch_size=8,
                                  epochs=epochs, print_freq=100, seed=0,
                                  continue_train=resume)
        mgr = CheckpointManager(str(tmp_path / head), head)
        return loop.fit(cfg, loader, device="cpu", checkpoint_manager=mgr)
    return run


@pytest.mark.parametrize("head", ["arcface", "vpl_arcface"])
def test_fit_resumed_equals_uninterrupted(tmp_path, head):
    run = _fit_setup(tmp_path, head)
    whole = run(2)
    first = run(1)
    assert sorted(os.listdir(tmp_path / head)) == ["epoch_1", "min_loss"]
    second = run(1, "latest")
    assert first.losses + second.losses == whole.losses
    _assert_same_state(second.state, whole.state)
    assert second.min_train_loss == whole.min_train_loss
    assert sorted(os.listdir(tmp_path / head)) == ["epoch_1", "epoch_2",
                                                   "min_loss"]


def test_resume_from_a_nan_loss_takes_the_next_best(tmp_path):
    """A resumed run whose saved epoch loss is not finite starts from an
    infinite best (as the JAX loop does), so its next epoch writes
    min_loss; from a NaN best no loss would ever compare below it."""
    run = _fit_setup(tmp_path, "arcface")
    first = run(1)
    mgr = CheckpointManager(str(tmp_path / "arcface"), "arcface")
    mgr.save(first.state, 1, float("nan"))
    second = run(1, "latest")
    epoch_2 = float(np.mean(second.losses))
    assert second.min_train_loss == epoch_2
    _, start, loss = mgr.restore(second.state, "min_loss")
    assert (start, loss) == (3, epoch_2)


def test_fit_without_manager_is_unchanged(tmp_path):
    run = _fit_setup(tmp_path, "arcface")
    with_mgr = run(2)
    images, labels = synthetic_identities(8, 3, image_size=24, seed=1)
    cfg = cfg_lib.TrainConfig(head="arcface", num_classes=8, batch_size=8,
                              epochs=2, print_freq=100, seed=0)
    plain = loop.fit(cfg, ArrayLoader(images, labels, batch_size=8, seed=0),
                     device="cpu")
    assert plain.losses == with_mgr.losses
    assert plain.min_train_loss == with_mgr.min_train_loss
    assert not plain.preempted
    _assert_same_state(plain.state, with_mgr.state)


class _SigtermLoader(ArrayLoader):
    """Sends SIGTERM to this process before yielding batch 2 of epoch 2."""

    def epoch(self, epoch=0):
        for i, batch in enumerate(super().epoch(epoch)):
            if (epoch, i) == (2, 1):
                signal.raise_signal(signal.SIGTERM)
            yield batch


def test_sigterm_mid_epoch_leaves_a_resumable_checkpoint(tmp_path):
    # the handler is installed only on the main thread; raising SIGTERM
    # anywhere else would end the process
    assert threading.current_thread() is threading.main_thread()
    images, labels = synthetic_identities(8, 3, image_size=24, seed=1)
    loader = _SigtermLoader(images, labels, batch_size=8, seed=0)
    cfg = cfg_lib.TrainConfig(head="arcface", num_classes=8, batch_size=8,
                              epochs=3, print_freq=100, seed=0)
    before = signal.getsignal(signal.SIGTERM)
    mgr = CheckpointManager(str(tmp_path / "arcface"), "arcface")
    res = loop.fit(cfg, loader, device="cpu", checkpoint_manager=mgr)
    assert signal.getsignal(signal.SIGTERM) is before
    assert res.preempted
    # epoch 1's 3 steps and the 2 steps of epoch 2 up to the signal
    assert len(res.losses) == 5 and res.state.step == 5
    assert sorted(os.listdir(tmp_path / "arcface")) == ["epoch_1",
                                                        "min_loss"]
    fresh = _fit_setup(tmp_path, "arcface")
    resumed = loop.fit(
        cfg_lib.TrainConfig(head="arcface", num_classes=8, batch_size=8,
                            epochs=1, print_freq=100, seed=0,
                            continue_train="latest"),
        ArrayLoader(images, labels, batch_size=8, seed=0), device="cpu",
        checkpoint_manager=mgr)
    del fresh
    assert resumed.state.step == 5 + 3
    assert np.isfinite(resumed.losses).all() and not resumed.preempted
    assert sorted(os.listdir(tmp_path / "arcface")) == [
        "epoch_1", "epoch_2", "min_loss"]
