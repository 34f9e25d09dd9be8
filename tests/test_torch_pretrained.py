"""`train --pretrained`: the port's `utils/pretrained.load_pretrained_backbone`
against the JAX package's `utils/torch_port.load_pretrained_backbone` on the
same file.

The file is a torchvision-layout resnet18 state_dict written from a seeded
trunk (the port's ResNet uses torchvision's names; built with a 1000-class
`fc`, as torchvision's ImageNet files have, and with random BatchNorm
statistics), saved bare and wrapped under 'state_dict'. After `from_jax`,
the JAX-loaded trunk and the port-loaded one are equal bit for bit (the
loaders copy fp32 values). No download: every weight comes from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu.utils.torch_port import (
    load_pretrained_backbone as jload)
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.train.state import create_train_state
from face_recognition_models_tpu_torch.utils.pretrained import (
    load_pretrained_backbone)
from face_recognition_models_tpu_torch.utils.weights import from_jax
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _torchvision_state_dict(name="resnet18", fc_out=1000, seed=0):
    """A seeded trunk's state_dict in torchvision's layout: weights, BatchNorm
    scales, shifts and running statistics all random."""
    g = torch.Generator().manual_seed(seed)
    model = get_backbone(name, embed_dim=fc_out, dtype=torch.float32)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_var") or (k.endswith("weight")
                                         and v.ndim == 1):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.dtype.is_floating_point:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = torch.full_like(v, 7)
    return sd


def _port_trunk(name="resnet18"):
    model = get_backbone(name, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(1))
    return model


@pytest.mark.parametrize("wrap", [None, "state_dict"])
def test_port_loader_matches_jax_loader(tmp_path, wrap):
    sd = _torchvision_state_dict()
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)

    jbackbone = jget_backbone("resnet18", dtype=jnp.float32)
    variables = jbackbone.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), train=False)
    params, stats = jload(path, "resnet18", variables)
    want, _ = from_jax(params, stats)

    model = _port_trunk()
    own_fc = model.fc.weight.detach().clone()
    load_pretrained_backbone(path, "resnet18", model)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        if key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], sd[key]), key
        elif key.startswith("fc."):
            continue   # a 1000-class fc fits neither 512-d embedding
        else:
            assert torch.equal(got[key], want[key]), key
            assert torch.equal(got[key], sd[key]), key
    assert torch.equal(model.fc.weight, own_fc)


def test_fc_of_the_embedding_width_is_loaded(tmp_path):
    """An fc of the embedding's shape loads, as the JAX port_fc=True does."""
    sd = _torchvision_state_dict(fc_out=512, seed=2)
    path = str(tmp_path / "emb.pth")
    torch.save({"model": sd}, path)
    jbackbone = jget_backbone("resnet18", dtype=jnp.float32)
    variables = jbackbone.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), train=False)
    want, _ = from_jax(*jload(path, "resnet18", variables))
    model = _port_trunk()
    load_pretrained_backbone(path, "resnet18", model)
    for key in ("fc.weight", "fc.bias"):
        assert torch.equal(model.state_dict()[key], want[key])
        assert torch.equal(model.state_dict()[key], sd[key])


def test_resnet50_loads(tmp_path):
    sd = _torchvision_state_dict("resnet50", seed=3)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    model = _port_trunk("resnet50")
    load_pretrained_backbone(path, "resnet50", model)
    got = model.state_dict()
    for key, value in sd.items():
        if not key.startswith("fc."):
            assert torch.equal(got[key], value), key


def test_refusals(tmp_path):
    sd = _torchvision_state_dict()
    path = str(tmp_path / "r18.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match=r"--pretrained supports "
                       r"\['efficientnet_b0', 'iresnet100', 'iresnet18', "
                       r"'iresnet50', 'mobilenet_v2', 'resnet18', "
                       r"'resnet50'\]; got 'vit_t'"):
        load_pretrained_backbone(path, "vit_t", _port_trunk())
    # a resnet18 file into a resnet50 trunk
    with pytest.raises(ValueError, match="does not fit resnet50"):
        load_pretrained_backbone(path, "resnet50", _port_trunk("resnet50"))
    missing = dict(sd)
    missing.pop("layer2.1.bn1.running_var")
    torch.save(missing, str(tmp_path / "missing.pth"))
    with pytest.raises(ValueError, match="layer2.1.bn1.running_var"):
        load_pretrained_backbone(str(tmp_path / "missing.pth"), "resnet18",
                                 _port_trunk())
    extra = {**sd, "layer5.0.conv1.weight": torch.zeros(1)}
    torch.save(extra, str(tmp_path / "extra.pth"))
    with pytest.raises(ValueError, match="layer5.0.conv1.weight"):
        load_pretrained_backbone(str(tmp_path / "extra.pth"), "resnet18",
                                 _port_trunk())


def test_file_without_batch_counters_loads(tmp_path):
    """Older torchvision files carry no num_batches_tracked: the trunk keeps
    its own counters."""
    sd = {k: v for k, v in _torchvision_state_dict().items()
          if not k.endswith("num_batches_tracked")}
    torch.save(sd, str(tmp_path / "old.pth"))
    model = _port_trunk()
    load_pretrained_backbone(str(tmp_path / "old.pth"), "resnet18", model)
    assert int(model.bn1.num_batches_tracked) == 0
    assert torch.equal(model.conv1.weight, sd["conv1.weight"])


@pytest.mark.parametrize("bn_dtype", ["float32", "bfloat16"])
def test_create_train_state_starts_from_the_file(tmp_path, bn_dtype):
    """cfg.pretrained_path: the state's trunk is the file's, the head kernel
    the one a run without it draws, and bn_dtype reaches every BatchNorm."""
    sd = _torchvision_state_dict(seed=4)
    path = str(tmp_path / "r18.pth")
    torch.save(sd, path)
    cfg = tcfg.TrainConfig(num_classes=10, pretrained_path=path,
                           bn_dtype=bn_dtype)
    head_cfg = tcfg.make_head_config("arcface", num_classes=10)
    _, _, state = create_train_state(cfg, head_cfg, torch.device("cpu"))
    _, _, plain = create_train_state(
        tcfg.TrainConfig(num_classes=10), head_cfg, torch.device("cpu"))
    got = state.backbone.state_dict()
    for key, value in sd.items():
        if not key.startswith("fc."):
            assert torch.equal(got[key], value), key
    assert torch.equal(state.kernel_w, plain.kernel_w)
    dtypes = {m.dtype for m in state.backbone.modules()
              if type(m).__name__ == "BatchNorm"}
    assert dtypes == {getattr(torch, bn_dtype)}
    assert isinstance(state.rng, torch.Generator)
    assert torch.equal(state.rng.get_state(),
                       torch.Generator().manual_seed(cfg.seed).get_state())
