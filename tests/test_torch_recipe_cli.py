"""The port's `train` command with the rest of the recipe's flags
(--optimizer, --nesterov, --clip-grad-norm, --grad-accum, --model-ema,
--freeze-backbone, --flip, --crop-pad, --color-jitter, --random-erasing and
the five --distill-* flags): the flags reach the run's TrainConfig,
--model-ema writes <model>_final_ema (the EMA parameters with the live
BatchNorm buffers), `eval --which final_ema` reads it, and --distill-dir
trains a student from an earlier run's checkpoint dir. Each run is a few
steps of resnet18 on the CPU (16 synthetic images, batch 8, 32 px) under a
`--working-path` in tmp_path.
"""

import os

import numpy as np
import pytest
import torch

from face_recognition_models_tpu_torch.checkpoint import restore_backbone
from face_recognition_models_tpu_torch.cli.main import main
from face_recognition_models_tpu_torch.data.pairs import save_bin
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities)
from face_recognition_models_tpu_torch.evaluation import batch_eval
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.state import ema_state_dict
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

SIZE = 32
BASE = ["train", "--synthetic", "--device", "cpu", "--synthetic-classes",
        "4", "--synthetic-per-class", "4", "--batch_size", "8",
        "--image-size", str(SIZE), "--print_freq", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def runs(monkeypatch):
    """The (cfg, result) of every `fit` the command runs."""
    seen = []
    fit = loop.fit

    def recording_fit(cfg, loader, **kw):
        res = fit(cfg, loader, **kw)
        seen.append((cfg, res))
        return res

    monkeypatch.setattr(loop, "fit", recording_fit)
    return seen


def test_recipe_flags_reach_the_run_and_write_final_ema(tmp_path, runs,
                                                        monkeypatch):
    work = str(tmp_path)
    assert main(BASE + [
        "--epochs", "1", "--working-path", work, "--learning_rate", "0.01",
        "--optimizer", "3", "--nesterov", "--clip-grad-norm", "5",
        "--grad-accum", "2", "--model-ema", "0.5", "--flip",
        "--crop-pad", "4", "--color-jitter", "0.2",
        "--random-erasing", "0.25"]) == 0
    (cfg, res), = runs
    opt = cfg.optimizer
    assert (opt.name, opt.learning_rate, opt.nesterov,
            opt.clip_grad_norm) == ("adamw", 0.01, True, 5.0)
    assert (cfg.grad_accum, cfg.model_ema, cfg.freeze_backbone) == (
        2, 0.5, False)
    data = cfg.data
    assert (data.horizontal_flip, data.crop_pad, data.color_jitter,
            data.random_erasing) == (True, 4, 0.2, 0.25)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert int(res.state.optimizer.inner.count) == 1

    ckpt = os.path.join(work, "checkpoints", "arcface")
    assert "arcface_final_ema" in os.listdir(ckpt)
    saved = restore_backbone(ckpt, "final_ema")
    want = ema_state_dict(res.state)
    assert saved.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(saved[key], value), key
    final = restore_backbone(ckpt, "final")
    # the EMA parameters, the live BatchNorm buffers
    assert not torch.equal(saved["fc.weight"], final["fc.weight"])
    assert torch.equal(saved["bn1.running_mean"], final["bn1.running_mean"])

    images, _ = synthetic_identities(10, 4, image_size=SIZE, seed=5)
    issame = np.tile([1, 0], 10)
    bench = tmp_path / "bench"
    bench.mkdir()
    save_bin(str(bench / "synth.bin"), images, issame)
    read = []
    restore = batch_eval.restore_backbone

    def recording_restore(directory, which, **kw):
        read.append(which)
        return restore(directory, which, **kw)

    monkeypatch.setattr(batch_eval, "restore_backbone", recording_restore)
    assert main(["eval", "--checkpoint-dir",
                 os.path.join(work, "checkpoints"), "--eval-data-path",
                 str(bench), "--benchmarks", "synth", "--image-size",
                 str(SIZE), "--device", "cpu", "--which", "final_ema",
                 "--output-dir", str(tmp_path / "out")]) == 0
    assert read == ["final_ema"]
    assert os.path.isfile(tmp_path / "out" / "accuracy_10fold.csv")


def test_freeze_backbone_keeps_the_trunk(tmp_path, runs):
    assert main(BASE + ["--epochs", "1", "--working-path", str(tmp_path),
                        "--freeze-backbone", "--optimizer", "lion"]) == 0
    (cfg, res), = runs
    assert cfg.freeze_backbone and cfg.optimizer.name == "lion"
    opt = res.state.optimizer
    for p in res.state.backbone.parameters():
        assert not opt.state[p]["mu"].any()
    assert opt.state[res.state.kernel_w]["mu"].any()


def test_distill_dir_trains_from_an_earlier_run(tmp_path, runs,
                                                monkeypatch):
    teacher_work = str(tmp_path / "teacher")
    assert main(BASE + ["--epochs", "1", "--working-path",
                        teacher_work]) == 0
    loaded = []
    load = loop.load_teacher

    def recording_load(distill, *args):
        module = load(distill, *args)
        loaded.append((distill, module))
        return module

    monkeypatch.setattr(loop, "load_teacher", recording_load)
    teacher_dir = os.path.join(teacher_work, "checkpoints", "arcface")
    for mode in ("cosine", "mse"):
        assert main(BASE + [
            "--epochs", "1", "--working-path", str(tmp_path / mode),
            "--distill-dir", teacher_dir, "--distill-backbone", "resnet18",
            "--distill-weight", "0.5", "--distill-mode", mode,
            "--distill-which", "final"]) == 0
    assert len(runs) == 3 and len(loaded) == 2
    want = restore_backbone(teacher_dir, "final")
    for (cfg, res), (distill, module) in zip(runs[1:], loaded):
        assert distill.checkpoint_dir == teacher_dir
        assert (distill.backbone, distill.weight) == ("resnet18", 0.5)
        assert cfg.distill == distill
        got = module.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    # the teacher's embeddings after 2 steps are large (its running
    # statistics are 2 steps old): the raw mse dwarfs the cosine term
    cosine, mse = runs[1][1].losses, runs[2][1].losses
    assert all(np.isfinite(cosine)) and np.isfinite(mse[0])
    assert mse[0] > cosine[0]


def test_unknown_optimizer_is_refused(tmp_path, capsys):
    assert main(BASE + ["--epochs", "1", "--working-path", str(tmp_path),
                        "--optimizer", "sgdw"]) == 2
    assert "Unknown optimizer name: sgdw" in capsys.readouterr().err
    assert main(BASE + ["--epochs", "1", "--working-path", str(tmp_path),
                        "--optimizer", "9"]) == 2
    assert "Invalid optimizer id: 9" in capsys.readouterr().err
