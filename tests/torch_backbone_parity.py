"""Shared machinery of the backbone parity tests (test_torch_backbones*.py):
a trunk of the JAX registry and its port on the same seeded weights, run
on the same numpy-seeded batch.

The JAX weights are numpy draws on the shapes `init` would make (no JAX
init, whose eager run is the slow part): conv and Dense kernels lecun-
scaled normals, BatchNorm / LayerNorm scales 1 + 0.1 N and shifts 0.1 N,
PReLU slopes 0.25 + 0.05 N, ViT's position embedding 0.02 N, running means
0.1 N and variances U(0.5, 1.5), so eval mode reads moved statistics. The
port carries them over with `utils.weights.from_jax` and
`load_state_dict(strict=True)`, so a JAX leaf the bridge does not use and a
port tensor it does not write both fail.

Two runs of each side, each one jitted JAX function:
- fp32, as the package runs (compute dtype fp32): the eval-mode output;
- fp64 (`jax.enable_x64`, compute and BatchNorm dtype fp64 on the same
  fp32 weights; the port's module in fp64 the same way): the train-mode
  output, the train-mode BatchNorm statistics, and the gradients of
  sum(out * w) for a seeded w with respect to the parameters and the
  input. Train-mode BatchNorm over a small batch divides by batch
  deviations that can be tiny (a channel ReLU nearly silences), and flax
  computes the variance as E[x^2] - E[x]^2 (`use_fast_variance`), so in
  fp32 the two programs' rounding is magnified there: the JAX fp32
  gradient of resnet18's layer4.0.conv1 at 64 px, batch 8, is 12% off its
  fp64 value while the port's fp32 one is within 2e-5. fp64 takes that
  rounding out and compares the graphs and their derivatives. What stays
  fp32 in fp64 mode is fp32 on both sides (the iResNet / ViT feature
  BatchNorm, ViT's attention logits and the token mean).

Sizes: embed_dim 32, batch 4, 32 px; the ResNets, mobilenet_v2 and
efficientnet_b0 at 64 px and inception_v3 at 128 px (its stem needs 75),
so that their last map is 2 x 2, not 1 x 1 (where a train-mode BatchNorm
sees 4 values a channel and a 3 x 3 conv reads only its centre tap); the
depth and the widths are the JAX configs'. The trunks with
dropout (mobilenet_v2, efficientnet_b0, inception_v3) are built with their
dropout and stochastic depth at 0 on both sides; their laws are tested
apart.

Tolerances (`close`: rtol, and an atol of a factor x the largest |value|
of the JAX tensor):
- fp32 eval output: rtol 2e-3, atol 2e-4 x max, the bound of
  tests/test_iresnet.py and tests/test_torch_resnet.py (fp32 convolutions
  through different algorithms, XLA CPU against oneDNN, over 10-100
  layers);
- fp64 train output, input gradient and running statistics: rtol 1e-4,
  atol 1e-4 x max; fp64 parameter gradients: rtol 1e-4 with an atol of
  1e-4 x the largest |value| among all the trunk's parameter gradients,
  since some are zero up to rounding (a shift before a train-mode
  BatchNorm, which takes the batch mean out: ViT's `ln_final` bias, the
  fc bias of iResNet and ViT). The fp32 feature BatchNorm of iResNet and
  ViT sets the bound: flax's E[x^2] - E[x]^2 in fp32 over 4 rows whose
  mean is up to 28 times their spread (vit_t here) leaves a relative
  variance error of 6e-8 x 28^2 = 5e-5; the CNNs without it agree to
  1e-12.
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu_torch.models import efficientnet, inception
from face_recognition_models_tpu_torch.models import mobilenet
from face_recognition_models_tpu_torch.models import (
    get_backbone as tget_backbone,
)
from face_recognition_models_tpu_torch.models.resnet import BatchNorm
from face_recognition_models_tpu_torch.utils.weights import from_jax

EMBED, BATCH = 32, 4
FWD_RTOL, FWD_ATOL_REL = 2e-3, 2e-4
F64_RTOL, F64_ATOL_REL = 1e-4, 1e-4
_NO_DROPOUT = {"mobilenet_v2": dict(dropout_rate=0.0),
               "efficientnet_b0": dict(dropout_rate=0.0,
                                       stochastic_depth=0.0),
               "inception_v3": dict(dropout_rate=0.0)}
_SIZES = {"resnet18": 64, "resnet50": 64, "mobilenet_v2": 64,
          "efficientnet_b0": 64, "inception_v3": 128}


def image_size(name: str) -> int:
    return _SIZES.get(name, 32)


def jax_module(name: str, dtype=jnp.float32):
    module = jget_backbone(name, embed_dim=EMBED, dtype=dtype,
                           bn_dtype=dtype)
    return module.clone(**_NO_DROPOUT.get(name, {}))


def port_module(name: str, dtype=torch.float32):
    kw = dict(embed_dim=EMBED, dtype=dtype, bn_dtype=dtype)
    if name == "mobilenet_v2":
        module = mobilenet.MobileNetV2(**kw, **_NO_DROPOUT[name])
    elif name == "efficientnet_b0":
        module = efficientnet.EfficientNetB0(**kw, **_NO_DROPOUT[name])
    elif name == "inception_v3":
        module = inception.InceptionV3(**kw, **_NO_DROPOUT[name])
    else:
        module = tget_backbone(name, image_size=image_size(name), **kw)
    return module


def _draw(path, shape, rs):
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rs.randn(*shape) / np.sqrt(fan_in)
    if leaf == "scale":
        return 1.0 + 0.1 * rs.randn(*shape)
    if leaf == "bias":
        return 0.1 * rs.randn(*shape)
    if leaf == "alpha":
        return 0.25 + 0.05 * rs.randn(*shape)
    if leaf == "pos_embed":
        return 0.02 * rs.randn(*shape)
    if leaf == "mean":
        return 0.1 * rs.randn(*shape)
    if leaf == "var":
        return rs.uniform(0.5, 1.5, shape)
    raise ValueError(f"no draw for {path}")


def seeded_variables(module, size: int, seed: int = 0):
    """(params, batch_stats) as numpy trees on the shapes of module.init."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)), train=False))
    rs = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: _draw([getattr(k, "key", str(k)) for k in p], a.shape,
                           rs).astype(np.float32),
        dict(shapes))
    return tree["params"], tree.get("batch_stats", {})


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def run_jax(name: str, seed: int = 0) -> dict:
    """The JAX trunk's results (module doc): 'eval' in fp32; 'train',
    'new_stats', 'grad_params', 'grad_x' in fp64."""
    size = image_size(name)
    module = jax_module(name)
    params, stats = seeded_variables(module, size, seed)
    rs = np.random.RandomState(seed + 1)
    x = rs.randn(BATCH, size, size, 3).astype(np.float32)
    w = rs.randn(BATCH, EMBED)
    with jax.default_matmul_precision("float32"):
        eval_out = jax.jit(lambda p, xs: module.apply(
            {"params": p, "batch_stats": stats}, xs, train=False))(
                params, jnp.asarray(x))
    out = {"params": params, "stats": stats, "x": x, "w": w,
           "eval": np.asarray(eval_out)}
    with jax.enable_x64(True):
        module64 = jax_module(name, jnp.float64)

        def loss(p, xs):
            y, mutated = module64.apply({"params": p, "batch_stats": stats},
                                        xs, train=True,
                                        mutable=["batch_stats"])
            return jnp.sum(y * w), (y, mutated["batch_stats"])

        (_, (y, new_stats)), (g_params, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                params, jnp.asarray(x, jnp.float64))
        out.update(train=np.asarray(y), new_stats=_host(new_stats),
                   grad_params=_host(g_params), grad_x=np.asarray(g_x))
    return out


def _port_weights(module, ref):
    sd, _ = from_jax(ref["params"], ref["stats"])
    module.load_state_dict(sd, strict=True)
    return module


def run_port(name: str, ref: dict) -> dict:
    """The port's trunk on the JAX weights and batch: the same results."""
    module = _port_weights(port_module(name), ref)
    module.eval()
    with torch.no_grad():
        eval_out = module(torch.from_numpy(ref["x"])).numpy()
    module = _port_weights(port_module(name, torch.float64), ref).double()
    for m in module.modules():   # the BatchNorms that stay fp32
        if getattr(m, "dtype", None) == torch.float32:
            m.float()
    module.train()
    x = torch.from_numpy(ref["x"]).double().requires_grad_(True)
    kw = ({"rng": torch.Generator().manual_seed(0)}
          if getattr(module, "takes_rng", False) else {})
    y = module(x, **kw)
    (y * torch.from_numpy(ref["w"])).sum().backward()
    grads = {n: p.grad.double().numpy()
             for n, p in module.named_parameters()}
    return {"module": module, "eval": eval_out,
            "train": y.detach().numpy(), "grad_x": x.grad.numpy(),
            "grad_params": grads, "state": module.state_dict()}


def close(got, want, rtol=FWD_RTOL, atol_rel=FWD_ATOL_REL, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()),
        err_msg=err_msg)


def check_running_stats(port: dict, ref: dict) -> int:
    want, _ = from_jax(ref["params"], ref["new_stats"])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    for k in keys:
        close(port["state"][k].double().numpy(), want[k].double().numpy(),
              F64_RTOL, F64_ATOL_REL, err_msg=k)
    return len(keys)


def check_param_grads(port: dict, ref: dict) -> int:
    want, _ = from_jax(ref["grad_params"], ref["stats"])
    names = list(port["grad_params"])
    scale = max(float(np.abs(want[n].numpy()).max()) for n in names)
    for n in names:
        np.testing.assert_allclose(port["grad_params"][n], want[n].numpy(),
                                   rtol=F64_RTOL,
                                   atol=F64_ATOL_REL * scale, err_msg=n)
    return len(names)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Remove what a test wrote (checkpoints, artifacts of 10-300 MB) once
    it has passed: the whole run keeps every tmp_path to its end. A test
    module that writes such files imports it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- the four parity tests; a test module imports them with `cases` and
# parametrizes `name` over its trunks in pytest_generate_tests -------------

@pytest.fixture(scope="module")
def cases():
    """(JAX results, port results) of each trunk, made once a module."""
    made = {}

    def get(name):
        if name not in made:
            ref = run_jax(name)
            made[name] = (ref, run_port(name, ref))
        return made[name]
    return get


def test_eval_forward_matches_jax(cases, name):
    ref, port = cases(name)
    assert port["eval"].shape == (BATCH, EMBED)
    close(port["eval"], ref["eval"])


def test_train_forward_and_statistics_match_jax(cases, name):
    ref, port = cases(name)
    close(port["train"], ref["train"], F64_RTOL, F64_ATOL_REL)
    assert check_running_stats(port, ref) == 2 * sum(
        isinstance(m, BatchNorm) for m in port["module"].modules())


def test_input_gradient_matches_jax(cases, name):
    ref, port = cases(name)
    close(port["grad_x"], ref["grad_x"], F64_RTOL, F64_ATOL_REL)


def test_parameter_gradients_match_jax(cases, name):
    ref, port = cases(name)
    assert check_param_grads(port, ref) == len(
        list(port["module"].parameters()))
