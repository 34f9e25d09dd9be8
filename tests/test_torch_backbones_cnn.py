"""mobilenet_v2, efficientnet_b0 and resnet50 against the JAX registry's
trunks (the parity tests of tests/torch_backbone_parity.py, which states
the sizes, precisions and tolerances); `--pretrained` for mobilenet_v2,
efficientnet_b0 and iresnet50 against the JAX package's
`load_pretrained_backbone` on seeded torchvision / arcface_torch-layout
files (bit for bit after `from_jax`: both loaders copy fp32 values);
`export --format torch` against the JAX `export_torch_state_dict` bit for
bit, and its refusal for the other trunks; and a resumed efficientnet_b0
`fit` (dropout and stochastic depth drawn from the step generator) bit for
bit equal to an uninterrupted one."""


import numpy as np
import pytest
import torch

import torch_backbone_parity as parity
from torch_backbone_parity import (  # noqa: F401  (fixtures and tests)
    _free_disk,
    cases,
    test_eval_forward_matches_jax,
    test_input_gradient_matches_jax,
    test_parameter_gradients_match_jax,
    test_train_forward_and_statistics_match_jax,
)
from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu.utils.torch_export import (
    export_torch_state_dict,
)
from face_recognition_models_tpu.utils.torch_port import (
    load_pretrained_backbone as jload,
)
from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
)
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.state import state_tensors
from face_recognition_models_tpu_torch.utils.pretrained import (
    load_pretrained_backbone,
)
from face_recognition_models_tpu_torch.utils.weights import from_jax

import jax.numpy as jnp

TRUNKS = ("mobilenet_v2", "efficientnet_b0", "resnet50")
# the file's embedding layer: 1000 ImageNet classes (not loaded), or the
# iresnet's own fc (its embedding, always loaded)
PRETRAINED = {"mobilenet_v2": ("classifier.1", 1000, 64),
              "efficientnet_b0": ("classifier.1", 1000, 64),
              "iresnet50": ("fc", 64, 32)}   # (head, file's width, px)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", TRUNKS)


def _seeded_file_state_dict(name, width, size, seed):
    """A trunk's state_dict in the file layout (the port's own names),
    every weight, BatchNorm scale, shift and statistic random; an iresnet's
    feature BatchNorm scale 1, as arcface_torch freezes it."""
    g = torch.Generator().manual_seed(seed)
    sd = get_backbone(name, embed_dim=width, dtype=torch.float32,
                      image_size=size).state_dict()
    for k, v in sd.items():
        if k == "features.weight":
            continue
        if k.endswith("running_var") or (k.endswith("weight")
                                         and v.ndim == 1):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.dtype.is_floating_point:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = torch.full_like(v, 7)
    return sd


@pytest.mark.parametrize("backbone", sorted(PRETRAINED))
def test_pretrained_matches_the_jax_loader(tmp_path, backbone):
    head, width, size = PRETRAINED[backbone]
    embed = 32 if backbone == "iresnet50" else 48
    if backbone == "iresnet50":
        width = embed
    sd = _seeded_file_state_dict(backbone, width, size, seed=11)
    path = str(tmp_path / f"{backbone}.pth")
    torch.save({"state_dict": sd}, path)

    jmodel = jget_backbone(backbone, embed_dim=embed, dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, size, seed=12)
    want, _ = from_jax(*jload(path, backbone, {"params": params,
                                               "batch_stats": stats}))

    model = get_backbone(backbone, embed_dim=embed, dtype=torch.float32,
                         image_size=size)
    model.load_state_dict(from_jax(params, stats)[0], strict=True)
    load_pretrained_backbone(path, backbone, model)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        if key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], sd[key]), key
            continue
        assert torch.equal(got[key], want[key]), key
        if not key.startswith(head + ".") or backbone == "iresnet50":
            assert torch.equal(got[key], sd[key]), key


def test_pretrained_iresnet_refusals(tmp_path):
    sd = _seeded_file_state_dict("iresnet18", 32, 32, seed=13)
    bad = {**sd, "features.weight": torch.full((32,), 1.5)}
    torch.save(bad, str(tmp_path / "scaled.pth"))
    model = get_backbone("iresnet18", embed_dim=32, image_size=32)
    with pytest.raises(ValueError, match="not frozen at 1"):
        load_pretrained_backbone(str(tmp_path / "scaled.pth"), "iresnet18",
                                 model)
    # a file of another image size: its fc does not fit, and is no
    # classifier to leave out
    torch.save(sd, str(tmp_path / "r.pth"))
    other = get_backbone("iresnet18", embed_dim=32, image_size=48)
    with pytest.raises(ValueError, match="fc.weight"):
        load_pretrained_backbone(str(tmp_path / "r.pth"), "iresnet18", other)


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "efficientnet_b0",
                                      "iresnet50"])
def test_export_format_torch_equals_jax_export(tmp_path, backbone):
    jmodel = jget_backbone(backbone, embed_dim=16, dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, 32, seed=14)
    ckpt = str(tmp_path / "arcface")
    CheckpointManager(ckpt, "arcface").save_final(from_jax(params, stats)[0])
    out = str(tmp_path / "backbone.pth")
    assert cli(["export", "--checkpoint-dir", ckpt, "--backbone", backbone,
                "--embed-dim", "16", "--image-size", "32", "--output", out,
                "--format", "torch"]) == 0
    got = torch.load(out, weights_only=True)
    want = export_torch_state_dict(backbone, params, stats)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == np.asarray(value).dtype, key
        assert np.array_equal(got[key].numpy(), value), key


def test_export_format_torch_refuses_the_other_trunks(tmp_path):
    with pytest.raises(ValueError, match=r"--format torch supports .*"
                       r"got 'vit_t'"):
        cli(["export", "--checkpoint-dir", str(tmp_path), "--backbone",
             "vit_t", "--output", str(tmp_path / "x.pth"), "--format",
             "torch"])


def test_efficientnet_fit_resumed_equals_uninterrupted(tmp_path):
    images, labels = synthetic_identities(8, 3, image_size=32, seed=1)
    loader = ArrayLoader(images, labels, batch_size=8, seed=0)

    def run(epochs, resume=None):
        cfg = cfg_lib.TrainConfig(backbone="efficientnet_b0", num_classes=8,
                                  batch_size=8, epochs=epochs,
                                  print_freq=100, seed=0,
                                  continue_train=resume,
                                  data=cfg_lib.DataConfig(image_size=32))
        mgr = CheckpointManager(str(tmp_path / "e"), "arcface")
        return loop.fit(cfg, loader, device="cpu", checkpoint_manager=mgr)

    whole = run(2)
    first = run(1)
    second = run(1, "latest")
    assert first.losses + second.losses == whole.losses
    for a, b in zip(state_tensors(second.state), state_tensors(whole.state),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(second.state.rng.get_state(),
                       whole.state.rng.get_state())
