"""Partial-FC and the triplet mining on the card (marked `cuda`; they skip
without one, and this file imports no JAX, which the card's machine lacks):

- `fit` with partial_fc 0.1 under scan_steps=2 (replays of a CUDA graph of
  two Partial-FC steps, sampling included) against the same steps one at
  a time: losses, every state tensor (kernel_mom included) and the step
  generator bit for bit;
- `semi_hard_negatives_from_noise` on the card against its CPU result on
  the same distances and noise (negatives and valid equal), the pairwise
  distances and the loss within 1e-6.

On a card:

    python -m pytest --noconftest -m cuda tests/test_torch_partial_fc_cuda.py
"""

import numpy as np
import pytest
import torch

from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.ops import mining
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.state import state_tensors


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _partial_fc_fit(k, steps=5, classes=3000, size=32):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (steps * 16, size, size, 3), np.uint8)
    labels = rs.randint(0, classes, steps * 16).astype(np.int32)
    labels[1] = labels[0]     # a padded positive slot
    cfg = tcfg.TrainConfig(num_classes=classes, batch_size=16, epochs=1,
                           print_freq=100, seed=0, scan_steps=k,
                           partial_fc=0.1,
                           data=tcfg.DataConfig(image_size=size))
    return loop.fit(cfg, ArrayLoader(images, labels, batch_size=16, seed=0),
                    device="cuda")


@pytest.mark.cuda
def test_graphed_partial_fc_steps_equal_eager_steps(cuda):
    graphed = _partial_fc_fit(2)
    eager = _partial_fc_fit(1)
    assert graphed.replays == 2
    assert graphed.losses == eager.losses
    a, b = state_tensors(graphed.state), state_tensors(eager.state)
    assert len(a) == len(b) and graphed.state.kernel_mom is not None
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"tensor {i}"
    assert torch.equal(graphed.state.rng.get_state(),
                       eager.state.rng.get_state())


@pytest.mark.cuda
def test_mining_on_the_card_equals_the_cpu(cuda, monkeypatch):
    rs = np.random.RandomState(3)
    emb = rs.randn(64, 128).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = torch.from_numpy(np.repeat(np.arange(16), 4).astype(np.int32))
    noise = mining.gumbel((64, 64, 64), torch.Generator().manual_seed(1),
                          "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.from_numpy(emb)
    dist = mining.pairwise_sq_distances(cpu)
    dist_card = mining.pairwise_sq_distances(cpu.to(cuda))
    np.testing.assert_allclose(dist_card.cpu().numpy(), dist.numpy(),
                               atol=1e-6)
    want = mining.semi_hard_negatives_from_noise(dist, labels, 0.2, noise)
    got = mining.semi_hard_negatives_from_noise(
        dist.to(cuda), labels.to(cuda), 0.2, noise.to(cuda))
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.negatives.cpu(), want.negatives)
    monkeypatch.setattr(mining, "gumbel",
                        lambda shape, rng, device: noise.to(device))
    loss = mining.semi_hard_triplet_loss(cpu, labels, 0.2)
    loss_card = mining.semi_hard_triplet_loss(cpu.to(cuda), labels.to(cuda),
                                              0.2)
    assert abs(float(loss_card) - float(loss)) <= 1e-6
