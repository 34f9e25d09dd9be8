"""BatchNorm's `bn_dtype` in the port's ResNet against flax's
`BatchNorm(dtype=...)` (the JAX ResNet's `bn_dtype`), on weights carried
over with `utils/weights.from_jax`.

Tolerances:
- bn_dtype=bfloat16 forwards: rtol 2e-2 with atol 2e-2 x the largest
  output. Every BatchNorm output is rounded to bf16 (a relative step of
  2^-8) in both programs after fp32 math whose order differs, and the
  residual adds then run in bf16; a value near a rounding boundary rounds
  one way in one program and the other way in the other, and 10-20 layers
  carry such one-ulp differences forward.
- running statistics after a train forward with bf16 BatchNorm: rtol 2e-2,
  atol 1e-3 (the statistics are fp32 reductions of inputs that went
  through the same bf16 roundings).
- the fp32 default: bitwise equal to the BatchNorm before `bn_dtype`
  existed (its forward is kept in this file as the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from face_recognition_models_tpu.models import resnet as jresnet
from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models import resnet as tresnet
from face_recognition_models_tpu_torch.train.state import create_train_state
from face_recognition_models_tpu_torch.utils.weights import from_jax

BLOCKS = {"basic": (jresnet.BasicBlock, tresnet.BasicBlock),
          "bottleneck": (jresnet.Bottleneck, tresnet.Bottleneck)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers, and these small ops slow down many times over when every
    worker's torch also starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _pair(block, dtype, seed=0, image=32):
    jblock, tblock = BLOCKS[block]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = jresnet.ResNet(stage_sizes=(1, 1), block=jblock, embed_dim=32,
                            num_filters=8, dtype=jdt, bn_dtype=jnp.bfloat16)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, image, image, 3)), train=False)
    params = _host(variables["params"])
    rs = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda x: np.asarray(x) + rs.uniform(0.0, 0.3, x.shape).astype(
            np.float32), _host(variables["batch_stats"]))
    tmodel = tresnet.ResNet((1, 1), tblock, embed_dim=32, num_filters=8,
                            dtype=tdt, bn_dtype=torch.bfloat16)
    tmodel.load_state_dict(from_jax(params, stats)[0], strict=True)
    return jmodel, params, stats, tmodel


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _close(got, want, rtol=2e-2):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=2e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_batchnorm_eval_matches_flax(block, dtype):
    jmodel, params, stats, tmodel = _pair(block, dtype)
    x = _images(4, 32, 1)
    with jax.default_matmul_precision("float32"):
        want = jmodel.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_bf16_batchnorm_train_matches_flax(block):
    jmodel, params, stats, tmodel = _pair(block, "bfloat16", seed=2)
    x = _images(4, 32, 3)
    with jax.default_matmul_precision("float32"):
        want, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    tmodel.train()
    got = tmodel(torch.from_numpy(x))
    _close(got.detach().float().numpy(), want)
    want_sd, _ = from_jax(params, _host(mutated["batch_stats"]))
    got_sd = tmodel.state_dict()
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=2e-2, atol=1e-3, err_msg=k)


def test_bf16_batchnorm_output_and_gradients():
    bn = tresnet.BatchNorm(6, dtype=torch.bfloat16)
    x = torch.randn(4, 6, 5, 5, generator=torch.Generator().manual_seed(0))
    for mode in (bn.train, bn.eval):
        mode()
        y = bn(x.bfloat16().requires_grad_(True))
        assert y.dtype == torch.bfloat16
    bn.train()
    y = bn(x.bfloat16())
    y.float().sum().backward()
    assert bn.weight.grad is not None and bn.weight.grad.dtype == torch.float32


def _parent_forward(self, x):
    """The port's BatchNorm forward before `bn_dtype` (fp32 only)."""
    x = x.to(torch.float32)
    if not self.training:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)
    if self.update_stats:
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=1 - self.momentum)
            self.num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                        self.eps)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_fp32_default_is_bitwise_the_parents(compute, monkeypatch):
    def model():
        m = tresnet.ResNet((1, 1), tresnet.Bottleneck, embed_dim=16,
                           num_filters=8, dtype=compute)
        tresnet.init_weights(m, torch.Generator().manual_seed(5))
        return m

    x = torch.from_numpy(_images(3, 24, 7))
    new = model()
    outs_new = [new.train()(x), new.eval()(x)]
    sd_new = new.state_dict()
    monkeypatch.setattr(tresnet.BatchNorm, "forward", _parent_forward)
    old = model()
    outs_old = [old.train()(x), old.eval()(x)]
    for a, b in zip(outs_new, outs_old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    sd_old = old.state_dict()
    assert all(torch.equal(sd_new[k], sd_old[k]) for k in sd_old)
    ga = torch.autograd.grad(outs_new[0].float().sum(),
                             list(new.parameters()))
    gb = torch.autograd.grad(outs_old[0].float().sum(),
                             list(old.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_bn_dtype_reaches_every_batchnorm():
    cfg = cfg_lib.TrainConfig(bn_dtype="bfloat16", num_classes=4)
    head_cfg = cfg_lib.make_head_config("arcface", num_classes=4)
    backbone, _, _ = create_train_state(cfg, head_cfg, torch.device("cpu"))
    norms = [m for m in backbone.modules() if isinstance(m, tresnet.BatchNorm)]
    assert len(norms) == 20 and all(m.dtype == torch.bfloat16 for m in norms)
    assert all(m.dtype == torch.float32 for m in get_backbone(
        "resnet50").modules() if isinstance(m, tresnet.BatchNorm))
    assert cfg_lib.TrainConfig().bn_dtype == "float32"
