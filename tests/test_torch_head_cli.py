"""The port's `train` and `list` commands with every head: `--head NAME`
(the 14 heads and the mv_softmax_arc alias) under `--head-path auto`, the
refusal of `--head-path fused` for the two heads without kernels, and
`--lambda_g`, `--bn-dtype` and `--pretrained` reaching the run. Each run is
two steps of resnet18 on the CPU (16 synthetic images, batch 8, 32 px) under
a `--working-path` in tmp_path."""

import os

import pytest
import torch

from face_recognition_models_tpu.models import BACKBONES as JBACKBONES
from face_recognition_models_tpu_torch.cli.main import main
from face_recognition_models_tpu_torch.heads import available_heads
from face_recognition_models_tpu_torch.heads.fused_adapter import FUSED_HEADS
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.train import loop
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

NEW_HEADS = ("sphereface", "cosface", "mv_softmax", "mv_softmax_arc",
             "curricularface", "adaface", "elastic_cosface",
             "elastic_arcface", "magface", "combined_margin",
             "subcenter_arcface", "adacos")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def runs(monkeypatch):
    """The (cfg, head_cfg, result) of every `fit` the command runs."""
    seen = []
    fit = loop.fit

    def recording_fit(cfg, loader, device=None, head_cfg=None, **kw):
        res = fit(cfg, loader, device=device, head_cfg=head_cfg, **kw)
        seen.append((cfg, head_cfg, res))
        return res

    monkeypatch.setattr(loop, "fit", recording_fit)
    return seen


def _train(tmp_path, *extra):
    return main(["train", "--synthetic", "--device", "cpu",
                 "--synthetic-classes", "8", "--synthetic-per-class", "2",
                 "--batch_size", "8", "--epochs", "1", "--image-size", "32",
                 "--print_freq", "1", "--working-path", str(tmp_path),
                 *extra])


@pytest.mark.parametrize("head", NEW_HEADS)
def test_train_each_head_auto(tmp_path, head, runs, capsys):
    assert _train(tmp_path, "--head", head) == 0
    (cfg, head_cfg, res), = runs
    name = "mv_softmax" if head == "mv_softmax_arc" else head
    assert cfg.head == head_cfg.name == name
    assert cfg.use_fused_head == (name in FUSED_HEADS)
    if head == "mv_softmax_arc":
        assert head_cfg.margin_type == "arc"
    assert len(res.losses) == 2
    assert all(torch.isfinite(torch.tensor(res.losses)))
    out = capsys.readouterr().out
    assert f"Training {head} (resnet18, " \
           f"{'fused' if cfg.use_fused_head else 'eager'} head)" in out
    assert out.count("Epoch: [1/1]") == 2
    ckpt = tmp_path / "checkpoints" / head
    assert {"epoch_1", "min_loss", f"{head}_final"} <= set(os.listdir(ckpt))


@pytest.mark.parametrize("head", ["subcenter_arcface", "adacos"])
def test_fused_path_refuses_heads_without_kernels(tmp_path, head, runs,
                                                  capsys):
    assert _train(tmp_path, "--head", head, "--head-path", "fused") == 2
    assert runs == []
    err = capsys.readouterr().err
    assert head in err and "no fused-kernel path" in err


def test_flags_reach_the_run(tmp_path, runs):
    """--lambda_g, --bn-dtype and --pretrained reach the config; the
    trunk's BatchNorms round to bf16; the loss is CE + lambda_g loss_g."""
    trunk = get_backbone("resnet18", embed_dim=1000, dtype=torch.float32)
    path = str(tmp_path / "r18.pth")
    torch.save(trunk.state_dict(), path)
    assert _train(tmp_path, "--head", "magface", "--lambda_g", "0.5",
                  "--bn-dtype", "bfloat16", "--pretrained", path,
                  "--head-path", "eager") == 0
    (cfg, _, res), = runs
    assert (cfg.lambda_g, cfg.bn_dtype, cfg.pretrained_path) == (
        0.5, "bfloat16", path)
    assert cfg.use_fused_head is False
    norms = [m for m in res.state.backbone.modules()
             if type(m).__name__ == "BatchNorm"]
    assert norms and all(m.dtype == torch.bfloat16 for m in norms)


def test_list(capsys):
    assert main(["list"]) == 0
    out = capsys.readouterr().out.splitlines()
    heads = out[0].split(":", 1)[1].strip().split(", ")
    assert heads == available_heads() and len(heads) == 14
    backbones = out[1].split(":", 1)[1].strip().split(", ")
    assert backbones == sorted(JBACKBONES) and len(backbones) == 12
