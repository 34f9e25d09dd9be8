"""iresnet100 and inception_v3 against the JAX registry's trunks (the
parity tests of tests/torch_backbone_parity.py, which states the sizes,
precisions and tolerances), and inception_v3's refusal to train: the JAX
train loop gives a dropout generator only to efficientnet_b0 and
mobilenet_v2 (face_recognition_models_tpu/train/loop.py:169), so a JAX
train step of inception_v3 raises, and the port's `fit` refuses it."""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import torch_backbone_parity as parity
from torch_backbone_parity import (  # noqa: F401  (fixture and tests)
    cases,
    test_eval_forward_matches_jax,
    test_input_gradient_matches_jax,
    test_parameter_gradients_match_jax,
    test_train_forward_and_statistics_match_jax,
)
from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.train.loop import fit

TRUNKS = ("iresnet100", "inception_v3")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", TRUNKS)


def test_inception_v3_is_refused_where_jax_raises():
    jmodel = jget_backbone("inception_v3", embed_dim=8, dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, 80)
    x = jnp.zeros((2, 80, 80, 3))
    # the JAX step's train-mode apply, with no "dropout" generator (the
    # loop's rngs=None for every trunk outside has_dropout)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax.eval_shape(lambda: jmodel.apply(
            {"params": params, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"], rngs=None))
    images = np.zeros((4, 80, 80, 3), np.uint8)
    cfg = cfg_lib.TrainConfig(backbone="inception_v3", num_classes=4,
                              batch_size=4, epochs=1,
                              data=cfg_lib.DataConfig(image_size=80))
    with pytest.raises(ValueError, match=r"inception_v3.*loop\.py:169"):
        fit(cfg, ArrayLoader(images, np.arange(4, dtype=np.int32),
                             batch_size=4), device="cpu")
