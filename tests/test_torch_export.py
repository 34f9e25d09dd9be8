"""Reverse port (JAX -> torch state_dict): round trips and torch goldens.

Two independent checks per backbone:

1. ROUND TRIP — export a randomly initialized (weights AND BN stats
   jittered) Flax model, then port the exported state_dict back onto a
   model initialized from a DIFFERENT seed via the forward porters in
   utils/torch_port.py, and require exact tree equality with the source.
   Porting onto a different init means any leaf the exporter forgot to
   write shows up as a mismatch — the test cannot pass by omission.

2. TORCH GOLDEN — `load_state_dict(strict=True)` the exported dict into an
   in-test torch graph in the torchvision key layout and compare forward
   activations, proving the key set and every transpose are what torch
   expects (not merely what our own porter reads back).

Together these certify `face export --format torch` as the exact inverse of
`--pretrained` (reference backbones.py:12-26 consumes such state_dicts).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_pretrained_port import _BasicBlock, _TorchResNet  # noqa: E402
from torch_backbone_parity import _free_disk  # noqa: E402,F401


def _init_backbone(name, seed, jitter_stats=True):
    from face_recognition_models_tpu.models import get_backbone

    model = get_backbone(name, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 64, 64, 3)), train=False)
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])
    if jitter_stats:
        # Init gives mean=0/var=1 everywhere; a round trip over trivial
        # stats would not prove the mean/var keys are wired. Jitter them.
        rs = np.random.RandomState(seed)
        stats = jax.tree.map(
            lambda x: np.asarray(x) + rs.uniform(0.1, 0.5, x.shape)
            .astype(np.float32), stats)
    return model, params, stats


def _port_back(name, sd):
    """Forward-port `sd` onto a differently seeded init."""
    from face_recognition_models_tpu.utils.torch_port import (
        _IRESNET_STAGES, _RESNET_STAGES, port_iresnet,
        port_torchvision_efficientnet_b0, port_torchvision_mobilenet_v2,
        port_torchvision_resnet)

    _, params2, stats2 = _init_backbone(name, seed=999, jitter_stats=False)
    variables = {"params": params2, "batch_stats": stats2}
    if name in _RESNET_STAGES:
        return port_torchvision_resnet(sd, variables, _RESNET_STAGES[name],
                                       port_fc=True)
    if name in _IRESNET_STAGES:
        return port_iresnet(sd, variables, _IRESNET_STAGES[name])
    if name == "mobilenet_v2":
        return port_torchvision_mobilenet_v2(sd, variables)
    return port_torchvision_efficientnet_b0(sd, variables)


@pytest.mark.parametrize("name", [
    "resnet18",
    pytest.param("resnet50", marks=pytest.mark.slow),
    # 33 s in the fast suite (--durations round 5): slow-marked with the
    # other heavy variants; resnet18 + iresnet18 keep both porter
    # families covered fast
    pytest.param("mobilenet_v2", marks=pytest.mark.slow),
    pytest.param("efficientnet_b0", marks=pytest.mark.slow),
    "iresnet18",
    pytest.param("iresnet50", marks=pytest.mark.slow),
])
def test_export_roundtrip_exact(name):
    from face_recognition_models_tpu.utils.torch_export import (
        export_torch_state_dict)

    _, params, stats = _init_backbone(name, seed=11)
    sd = export_torch_state_dict(name, params, stats)
    got_params, got_stats = _port_back(name, sd)

    flat_src, _ = jax.tree_util.tree_flatten_with_path(
        {"params": params, "batch_stats": stats})
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        {"params": got_params, "batch_stats": got_stats})[0])
    assert len(flat_src) == len(flat_got)
    for path, src in flat_src:
        np.testing.assert_array_equal(
            np.asarray(src, np.float32), np.asarray(flat_got[path]),
            err_msg=jax.tree_util.keystr(path))


def test_export_loads_strict_and_matches_golden_activations():
    """Exported resnet18 dict must satisfy torch strict loading and drive
    the torchvision-layout graph to the same outputs as the Flax model."""
    from face_recognition_models_tpu.utils.torch_export import (
        export_torch_state_dict)

    jmodel, params, stats = _init_backbone("resnet18", seed=5)
    sd = export_torch_state_dict("resnet18", params, stats)

    tmodel = _TorchResNet(_BasicBlock, (2, 2, 2, 2))
    missing, unexpected = tmodel.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)
    assert not missing and not unexpected
    tmodel.eval()

    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        golden = tmodel(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("float32"):
        out = jmodel.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    np.testing.assert_allclose(np.asarray(out), golden, rtol=2e-3,
                               atol=2e-4 * float(np.abs(golden).max()))


def test_export_unknown_backbone_rejected():
    from face_recognition_models_tpu.utils.torch_export import (
        export_torch_state_dict)

    with pytest.raises(ValueError, match="--format torch supports"):
        export_torch_state_dict("vit_t", {}, {})


@pytest.mark.slow
def test_cli_export_torch(tmp_path):
    """`face export --format torch` end to end over a real checkpoint.
    (37 s — trains + exports through the CLI; slow-marked round 5, the
    in-library round-trip tests above keep the porter fast-covered.)"""
    from face_recognition_models_tpu.cli.main import main

    rc = main(["--platform", "cpu", "train", "--synthetic",
               "--synthetic-classes", "4", "--synthetic-per-class", "4",
               "--image-size", "32", "-bs", "8", "-e", "1",
               "--backbone", "resnet18",
               "--working-path", str(tmp_path)])
    assert rc == 0
    ckpt_dirs = list((tmp_path / "checkpoints").iterdir())
    assert ckpt_dirs, f"no checkpoints under {tmp_path}"
    out = tmp_path / "r18.pth"
    rc = main(["--platform", "cpu", "export",
               "--checkpoint-dir", str(ckpt_dirs[0]),
               "--backbone", "resnet18", "--format", "torch",
               "--output", str(out)])
    assert rc == 0
    sd = torch.load(out, map_location="cpu", weights_only=True)
    tmodel = _TorchResNet(_BasicBlock, (2, 2, 2, 2))
    missing, unexpected = tmodel.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
