"""vit_t, vit_s and vit_b against the JAX registry's trunks (the parity
tests of tests/torch_backbone_parity.py, which states the sizes, precisions
and tolerances), and ViT's activation recomputation (`remat`, on by default
for vit_b as in the JAX package) against the plain forward and backward."""

import pytest
import torch

from torch_backbone_parity import (  # noqa: F401  (fixture and tests)
    cases,
    test_eval_forward_matches_jax,
    test_input_gradient_matches_jax,
    test_parameter_gradients_match_jax,
    test_train_forward_and_statistics_match_jax,
)
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.resnet import init_weights

TRUNKS = ("vit_t", "vit_s", "vit_b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", TRUNKS)


def test_remat_is_the_default_for_vit_b_and_changes_no_number():
    assert get_backbone("vit_b", image_size=16).remat
    assert not get_backbone("vit_s", image_size=16).remat
    plain = get_backbone("vit_t", embed_dim=8, dtype=torch.float32,
                         image_size=16)
    init_weights(plain, torch.Generator().manual_seed(0))
    remat = get_backbone("vit_t", embed_dim=8, dtype=torch.float32,
                         image_size=16)
    remat.load_state_dict(plain.state_dict())
    remat.remat = True
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for model in (plain, remat):
        model.train()
        y = model(x)
        y.square().sum().backward()
        outs.append((y.detach(), [p.grad.clone()
                                  for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
