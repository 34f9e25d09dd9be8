"""The port's ResNet against the flax one, on weights carried over with
`utils/weights.from_jax`, in fp32.

Tolerances:
- forward outputs: rtol 2e-3 with atol 2e-4 x the largest output, as in
  tests/test_torch_export.py: fp32 convolutions run through different
  algorithms (XLA CPU vs oneDNN) and sum in different orders through 10-20
  layers;
- BatchNorm running statistics after one train forward: rtol 1e-4, atol 1e-6.
  This catches the biased-variance hazard: nn.BatchNorm2d's unbiased update
  differs by a factor n / (n - 1) = 16 / 15 on the last stage here (a 0.7%
  change of the running variance), while the two programs' fp32 statistics
  agree to ~1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.models import resnet as jresnet
from face_recognition_models_tpu_torch.models import resnet as tresnet
from face_recognition_models_tpu_torch.utils.weights import from_jax

STATS_TOL = dict(rtol=1e-4, atol=1e-6)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _pair(block, seed, image, jitter_stats):
    jblock = {"basic": jresnet.BasicBlock, "bottleneck": jresnet.Bottleneck}
    tblock = {"basic": tresnet.BasicBlock, "bottleneck": tresnet.Bottleneck}
    jmodel = jresnet.ResNet(stage_sizes=(1, 1), block=jblock[block],
                            embed_dim=32, num_filters=8, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, image, image, 3)), train=False)
    params, stats = _host(variables["params"]), _host(variables["batch_stats"])
    if jitter_stats:
        rs = np.random.RandomState(seed)
        stats = jax.tree.map(
            lambda x: x + rs.uniform(0.1, 0.5, x.shape).astype(np.float32),
            stats)
    tmodel = tresnet.ResNet((1, 1), tblock[block], embed_dim=32,
                            num_filters=8, dtype=torch.float32)
    sd, kernel_w = from_jax(params, stats)
    assert kernel_w is None
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, stats, tmodel


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-4 * float(np.abs(want).max()))


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_eval_forward_matches_flax(block):
    jmodel, params, stats, tmodel = _pair(block, 0, 32, jitter_stats=True)
    x = _images(4, 32, 1)
    with jax.default_matmul_precision("float32"):
        want = jmodel.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_train_forward_and_running_stats_match_flax(block):
    jmodel, params, stats, tmodel = _pair(block, 2, 32, jitter_stats=False)
    x = _images(4, 32, 3)
    with jax.default_matmul_precision("float32"):
        want, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    tmodel.train()
    got = tmodel(torch.from_numpy(x))
    _close(got.detach().numpy(), np.asarray(want))

    want_sd, _ = from_jax(params, _host(mutated["batch_stats"]))
    got_sd = tmodel.state_dict()
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, tresnet.BatchNorm)
                                for m in tmodel.modules())
    for k in keys:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   err_msg=k, **STATS_TOL)


def test_biased_variance_is_what_the_stats_check_sees():
    """nn.BatchNorm2d's unbiased running-variance update would fail the
    running-stats tolerance above on this input."""
    x = torch.from_numpy(_images(4, 2, 5)).permute(0, 3, 1, 2)
    ours = tresnet.BatchNorm(3).train()
    ours(x)
    torch_bn = torch.nn.BatchNorm2d(3, momentum=0.1, eps=1e-5).train()
    torch_bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               (0.9 + 0.1 * var).numpy(), **STATS_TOL)
    assert not np.allclose(torch_bn.running_var.numpy(),
                           ours.running_var.numpy(), **STATS_TOL)


def test_resnet18_full_width_eval_matches_flax():
    jmodel = jresnet.resnet18(embed_dim=512, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(4),
                            jnp.zeros((1, 112, 112, 3)), train=False)
    params, stats = _host(variables["params"]), _host(variables["batch_stats"])
    tmodel = tresnet.resnet18(embed_dim=512, dtype=torch.float32)
    tmodel.load_state_dict(from_jax(params, stats)[0], strict=True)
    x = _images(2, 112, 6)
    with jax.default_matmul_precision("float32"):
        want = jmodel.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.shape == (2, 512)
    _close(got.numpy(), np.asarray(want))


def test_nchw_input_rejected():
    model = tresnet.ResNet((1, 1), tresnet.BasicBlock, embed_dim=8,
                           num_filters=8, dtype=torch.float32)
    with pytest.raises(ValueError, match="NHWC"):
        model(torch.zeros(1, 3, 16, 16))
