"""The port's periodic verification (evaluation/periodic.py, `fit(hooks=)`,
`train --eval-every / --eval-after`) on the CPU against the JAX package's
PeriodicEvalHook, on the same weights and benchmark; and, on the card
(marked `cuda`), a graphed run with the hook bit for bit equal to the same
run without it.

The two hooks embed with fp32 backbones (the JAX and the port's convs sum
in different orders, ~1e-6 apart), then run the same 10-fold protocol: fold
accuracies and best accuracy equal, thresholds and AUC within 1e-4.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_backbone,
)
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
)
from face_recognition_models_tpu_torch.evaluation.periodic import (
    PeriodicEvalHook,
)
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.train.loop import fit
from face_recognition_models_tpu_torch.train.state import (
    ema_state_dict,
    state_tensors,
)
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

C, PER, IMG, BS = 8, 8, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """<root>/lfw in the pair.list + JPEG layout (the JAX package's
    writer: 12 genuine and 12 impostor pairs)."""
    from face_recognition_models_tpu.data.synthetic import (
        write_pair_benchmark)
    root = tmp_path_factory.mktemp("evaldata")
    write_pair_benchmark(str(root / "lfw"), num_classes=4,
                         pairs_per_kind=12, image_size=IMG)
    return str(root)


class _PortState:
    """What the hook reads of a train state: the backbone and the EMA."""

    def __init__(self, backbone, ema=None):
        self.backbone, self.ema = backbone, ema


def _port_hook(root, benchmarks=("lfw",), **kw):
    kw = {"every": 1, "image_size": IMG, "batch_size": 16, "verbose": False,
          "device": "cpu", **kw}
    return PeriodicEvalHook(get_backbone("resnet18", dtype=torch.float32),
                            root, list(benchmarks), **kw)


@pytest.fixture(scope="module")
def weights():
    """JAX resnet18 fp32 variables (statistics jittered), an EMA of its
    params, and the port's state_dicts of both."""
    import jax
    import jax.numpy as jnp

    from face_recognition_models_tpu.models import get_backbone as jget
    from face_recognition_models_tpu_torch.utils.weights import from_jax

    module = jget("resnet18", dtype=jnp.float32)
    variables = module.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            jnp.zeros((1, IMG, IMG, 3)), train=False)
    host = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa
    rs = np.random.RandomState(1)
    params = host(variables["params"])
    stats = jax.tree.map(
        lambda x: x + rs.uniform(0.1, 0.5, x.shape).astype(np.float32),
        host(variables["batch_stats"]))
    ema = jax.tree.map(
        lambda x: x + rs.normal(0, 0.05, x.shape).astype(np.float32), params)
    return (module, params, stats, ema, from_jax(params, stats)[0],
            from_jax(ema, stats)[0])


def _jax_hook(module, root, **kw):
    from face_recognition_models_tpu.evaluation import (
        PeriodicEvalHook as JHook)
    return JHook(module, root, ["lfw", "missing"], image_size=IMG,
                 batch_size=16, verbose=False, **kw)


def _same_results(got, want):
    assert [e for e, _ in got.history] == [e for e, _ in want.history]
    for (_, g), (_, w) in zip(got.history, want.history):
        assert sorted(g) == sorted(w)
        for bench in w:
            assert g[bench].fold_accuracies == w[bench].fold_accuracies
            np.testing.assert_allclose(g[bench].fold_thresholds,
                                       w[bench].fold_thresholds, atol=1e-4)
            np.testing.assert_allclose(g[bench].fold_aucs,
                                       w[bench].fold_aucs, atol=1e-4)
    assert got.best_acc == want.best_acc
    assert got.best_epoch == want.best_epoch


@pytest.mark.parametrize("use_ema", [False, True])
def test_hook_matches_jax_hook(bench_root, weights, tmp_path, use_ema):
    """Accuracies, best accuracy and the saved <model>_best_acc against the
    JAX hook on the same weights (the EMA's with use_ema); the live trunk
    is left as it was."""
    module, params, stats, ema, sd, ema_sd = weights

    class JState:
        pass

    jstate = JState()
    jstate.params = {"backbone": params}
    jstate.batch_stats = stats
    jstate.ema_params = {"backbone": ema} if use_ema else None
    want = _jax_hook(module, bench_root, every=2, total_epochs=3,
                     use_ema=use_ema)
    live = get_backbone("resnet18", dtype=torch.float32)
    live.load_state_dict(sd)
    live.train()
    names = [n for n, _ in live.named_parameters()]
    port_ema = [ema_sd[n].clone() for n in names] if use_ema else None
    mgr = CheckpointManager(str(tmp_path / "arcface"), "arcface")
    got = _port_hook(bench_root, ["lfw", "missing"], every=2,
                     total_epochs=3, use_ema=use_ema,
                     checkpoint_manager=mgr, model_name="arcface")
    assert list(got._data) == list(want._data) == ["lfw"]
    for epoch in (1, 2, 3):
        want(epoch=epoch, state=jstate, train_loss=0.0)
        got(epoch=epoch, state=_PortState(live, port_ema), train_loss=0.0)
    assert [e for e, _ in got.history] == [2, 3]
    _same_results(got, want)
    assert live.training
    for key, value in sd.items():
        assert torch.equal(live.state_dict()[key], value), key
    saved = restore_backbone(str(tmp_path / "arcface"), "best_acc")
    for key, value in (ema_sd if use_ema else sd).items():
        assert torch.equal(saved[key], value), key


def test_hook_respects_every_and_final(bench_root, weights):
    *_, sd, _ = weights
    live = get_backbone("resnet18", dtype=torch.float32)
    live.load_state_dict(sd)
    hook = _port_hook(bench_root, every=3, total_epochs=7)
    for epoch in range(1, 8):
        hook(epoch=epoch, state=_PortState(live), train_loss=0.0)
    assert [e for e, _ in hook.history] == [3, 6, 7]
    hook_ema = _port_hook(bench_root, total_epochs=1, use_ema=True)
    with pytest.raises(ValueError, match="no EMA"):
        hook_ema(epoch=1, state=_PortState(live), train_loss=0.0)


def test_hook_all_benchmarks_missing(bench_root, capsys):
    with pytest.raises(FileNotFoundError, match="no benchmarks found"):
        _port_hook(bench_root, ["nope_a", "nope_b"])
    assert "skip benchmark nope_a" in capsys.readouterr().out
    with pytest.raises(ValueError, match="every"):
        _port_hook(bench_root, every=0)


def _cfg(scan_steps=1, epochs=2, **kw):
    return tcfg.TrainConfig(
        backbone="resnet18", head="arcface", num_classes=C, batch_size=BS,
        epochs=epochs, seed=0, print_freq=1, scan_steps=scan_steps,
        data=tcfg.DataConfig(image_size=IMG),
        optimizer=tcfg.OptimizerConfig(learning_rate=0.02), **kw)


def _fit(cfg, device, hook=None):
    images, labels = synthetic_identities(C, PER, image_size=IMG, seed=0)
    loader = ArrayLoader(images, labels, batch_size=BS, seed=0)
    return fit(cfg, loader, device=device, hooks=hook)


@pytest.mark.parametrize("scan_steps,model_ema", [(1, 0.0), (2, 0.0),
                                                  (2, 0.9)])
def test_fit_with_hook_equals_fit_without(bench_root, tmp_path, scan_steps,
                                          model_ema):
    """The hook runs at each epoch's end and leaves training bit for bit as
    it was: losses and every state tensor."""
    cfg = _cfg(scan_steps=scan_steps, model_ema=model_ema)
    plain = _fit(cfg, "cpu")
    mgr = CheckpointManager(str(tmp_path / "arcface"), "arcface")
    hook = PeriodicEvalHook(
        get_backbone("resnet18"), bench_root, ["lfw"], every=1,
        image_size=IMG, batch_size=16, total_epochs=cfg.epochs,
        checkpoint_manager=mgr, model_name="arcface",
        use_ema=model_ema > 0, verbose=False, device="cpu")
    hooked = _fit(cfg, "cpu", hook)
    assert [e for e, _ in hook.history] == [1, 2]
    assert hooked.losses == plain.losses
    for x, y in zip(state_tensors(hooked.state), state_tensors(plain.state),
                    strict=True):
        assert torch.equal(x, y)
    assert os.path.isfile(tmp_path / "arcface" / "arcface_best_acc")
    saved = restore_backbone(str(tmp_path / "arcface"), "best_acc")
    if hook.best_epoch == cfg.epochs:
        want = (ema_state_dict(hooked.state) if model_ema
                else hooked.state.backbone.state_dict())
        for key, value in want.items():
            assert torch.equal(saved[key], value), key


def _train(work, *flags):
    return cli(["train", "--synthetic", "--device", "cpu",
                "--synthetic-classes", str(C), "--synthetic-per-class", "2",
                "--batch_size", str(BS), "--epochs", "2", "--image-size",
                str(IMG), "--print_freq", "1", "--working-path", work,
                *flags])


def test_train_cli_eval_every_and_after(bench_root, tmp_path, capsys):
    work = str(tmp_path / "work")
    assert _train(work, "--eval-every", "1", "--eval-after",
                  "--eval-data-path", bench_root, "--benchmarks",
                  "lfw,missing") == 0
    out = capsys.readouterr().out
    assert "[eval-every] epoch 1 lfw:" in out
    assert "[eval-every] epoch 2 lfw:" in out
    assert "skip benchmark missing" in out
    assert "Best verification" in out
    assert "[eval-after] arcface on lfw:" in out
    assert "[eval-after] skip missing" in out
    ckpt = os.path.join(work, "checkpoints")
    assert os.path.isfile(os.path.join(ckpt, "arcface", "arcface_best_acc"))
    assert cli(["eval", "--checkpoint-dir", ckpt, "--eval-data-path",
                bench_root, "--benchmarks", "lfw", "--image-size", str(IMG),
                "--which", "best_acc", "--device", "cpu", "--output-dir",
                str(tmp_path / "results")]) == 0
    assert os.path.isfile(tmp_path / "results" / "accuracy_10fold.csv")


def test_train_cli_eval_flags_without_data_path(tmp_path, capsys):
    work = str(tmp_path / "work")
    assert _train(work, "--eval-every", "1", "--eval-after") == 0
    out = capsys.readouterr().out
    assert "--eval-every: no --eval-data-path given, skipping" in out
    assert "--eval-after: no --eval-data-path given, skipping" in out
    assert not os.path.exists(os.path.join(work, "checkpoints", "arcface",
                                           "arcface_best_acc"))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _array_bench(root):
    """<root>/synth.bin of raw uint8 arrays (no PIL on the card's host):
    per identity a genuine and an impostor pair."""
    images, _ = synthetic_identities(12, 4, image_size=IMG, seed=2)
    bins, issame = [], []
    for i in range(12):
        j = (i + 1) % 12
        bins += [images[4 * i], images[4 * i + 1], images[4 * i + 2],
                 images[4 * j + 3]]
        issame += [True, False]
    with open(os.path.join(root, "synth.bin"), "wb") as f:
        pickle.dump((bins, issame), f)
    return str(root)


@pytest.mark.cuda
def test_graphed_fit_with_hook_equals_fit_without(cuda, tmp_path):
    cfg = dataclasses.replace(_cfg(scan_steps=4, epochs=2),
                              batch_size=BS // 2)
    plain = _fit(cfg, cuda)
    hook = PeriodicEvalHook(get_backbone("resnet18"),
                            _array_bench(tmp_path), ["synth"], every=1,
                            image_size=IMG, batch_size=16,
                            total_epochs=cfg.epochs, verbose=False,
                            device=cuda)
    hooked = _fit(cfg, cuda, hook)
    assert [e for e, _ in hook.history] == [1, 2]
    assert hooked.replays == plain.replays > 0
    assert hooked.losses == plain.losses
    for x, y in zip(state_tensors(hooked.state), state_tensors(plain.state),
                    strict=True):
        assert torch.equal(x, y)
