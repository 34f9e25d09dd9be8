"""Training the new trunks. Three train steps (the step `fit` runs) of
iresnet18, mobilefacenet and vit_t against the JAX package's train step
from the same weights on the same batches; and the CLI's `train -> eval ->
export -> embed` for each of the three on the CPU (`list` is in
tests/test_torch_head_cli.py).

The port's step takes the fused head (its plain version on the CPU), the
JAX step its jnp head (the two are held together in
tests/test_torch_train_step.py). The trunks run in fp64 on both sides
(`jax.enable_x64`; the weights, the head and the update stay fp32), as in
tests/torch_backbone_parity.py: in fp32, flax's E[x^2] - E[x]^2 batch
variance puts the JAX gradient of some layers 1e-4-1e-1 off its fp64 value
at these batch sizes, and two SGD steps carry that into the loss (5e-4 of
it at the third step). N=16, D=32, C=64, 32 px, SGD lr 0.01 momentum 0.9
wd 5e-4, the seeded weights of tests/torch_backbone_parity.py. Bounds are
those of tests/test_torch_train_step.py: per-step loss 1e-4 relative,
feat_norm rtol 1e-4 (atol 1e-5), final parameters and BatchNorm buffers
rtol 5e-3 atol 2e-3.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_backbone_parity as parity
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)
from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu.train import TrainState as JTrainState
from face_recognition_models_tpu.train import get_optimizer as jget_optimizer
from face_recognition_models_tpu.train import make_train_step as jmake_step
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
    write_identity_tree,
    write_pair_benchmark,
)
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.weights import from_jax

D, C, IMAGE, STEPS, LR = 32, 64, 32, 3, 0.01
# the batch of each trunk's steps
TRUNKS = {"iresnet18": 8, "mobilefacenet": 16, "vit_t": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _port_fp64(name, sd):
    """The port's trunk in fp64 (tests/torch_backbone_parity.py), the
    BatchNorms the model keeps in fp32 left there."""
    backbone = get_backbone(name, embed_dim=D, dtype=torch.float64,
                            bn_dtype=torch.float64, image_size=IMAGE)
    backbone.load_state_dict(sd, strict=True)
    backbone.double()
    for m in backbone.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.float()
    return backbone


@pytest.mark.parametrize("name", TRUNKS)
def test_train_steps_match_jax_step(name):
    n = TRUNKS[name]
    rs = np.random.RandomState(5)
    batches = [(rs.randint(0, 256, (n, IMAGE, IMAGE, 3), np.uint8),
                rs.randint(0, C, n).astype(np.int32)) for _ in range(STEPS)]
    cfg = jcfg.make_head_config("arcface", feature_dim=D, num_classes=C)
    head = jget_head("arcface")
    params, stats = parity.seeded_variables(
        jget_backbone(name, embed_dim=D, dtype=jnp.float32), IMAGE, seed=21)
    kernel_w = np.asarray(head.init_kernel(jax.random.PRNGKey(3), cfg))
    jlosses, jnorms = [], []
    with jax.enable_x64(True):
        module = jget_backbone(name, embed_dim=D, dtype=jnp.float64,
                               bn_dtype=jnp.float64)
        jparams = {"backbone": jax.tree.map(jnp.asarray, params),
                   "kernel_w": jnp.asarray(kernel_w)}
        tx = jget_optimizer("sgd", LR, momentum=0.9, weight_decay=5e-4)
        jstate = JTrainState(step=jnp.int32(0), params=jparams,
                             batch_stats=jax.tree.map(jnp.asarray, stats),
                             head_state=head.init_state(cfg),
                             opt_state=tx.init(jparams),
                             rng=jax.random.PRNGKey(7))
        jstep = jax.jit(jmake_step(module, head, cfg, tx,
                                   use_fused_head=False))
        for images, labels in batches:
            jstate, jm = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels))
            jlosses.append(float(jm["loss"]))
            jnorms.append(float(jm["feat_norm"]))
        jfinal = (_host(jstate.params), _host(jstate.batch_stats))

    sd, tkernel = from_jax({"backbone": params, "kernel_w": kernel_w},
                           stats)
    backbone = _port_fp64(name, sd)
    tkernel = torch.nn.Parameter(tkernel)
    opt = get_optimizer("sgd", [*backbone.parameters(), tkernel], LR,
                        momentum=0.9, weight_decay=5e-4)
    tstate = TrainState(backbone=backbone, kernel_w=tkernel, optimizer=opt)
    tstep = make_train_step(
        get_head("arcface"),
        tcfg.make_head_config("arcface", feature_dim=D, num_classes=C),
        use_fused_head=True, device="cpu")
    for k, (images, labels) in enumerate(batches):
        tstate, tm = tstep(tstate, images, labels)
        lt = float(tm["loss"])
        assert abs(lt - jlosses[k]) <= 1e-4 * max(1.0, abs(jlosses[k])), \
            f"{name} step {k}: port loss {lt:.6f} vs jax {jlosses[k]:.6f}"
        np.testing.assert_allclose(float(tm["feat_norm"]), jnorms[k],
                                   rtol=1e-4, atol=1e-5)
    want, want_kernel = from_jax(*jfinal)
    got = tstate.backbone.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].double().numpy(),
                                   value.numpy(), rtol=5e-3, atol=2e-3,
                                   err_msg=key)
    np.testing.assert_allclose(tstate.kernel_w.detach().numpy(),
                               want_kernel.numpy(), rtol=5e-3, atol=2e-3)


@pytest.mark.parametrize("name", TRUNKS)
def test_cli_train_eval_export_embed(tmp_path, name, capsys):
    work = str(tmp_path / "work")
    assert cli(["train", "--synthetic", "--device", "cpu", "--backbone",
                name, "--synthetic-classes", "4", "--synthetic-per-class",
                "4", "--batch_size", "8", "--epochs", "1", "--image-size",
                str(IMAGE), "--print_freq", "1", "--working-path",
                work]) == 0
    bench = str(tmp_path / "bench")
    write_pair_benchmark(os.path.join(bench, "synth"), num_classes=4,
                         pairs_per_kind=10, image_size=IMAGE, seed=2)
    out_dir = str(tmp_path / "eval")
    assert cli(["eval", "--checkpoint-dir", os.path.join(work,
                                                         "checkpoints"),
                "--backbone", name, "--eval-data-path", bench,
                "--benchmarks", "synth", "--image-size", str(IMAGE),
                "--device", "cpu", "--output-dir", out_dir]) == 0
    with open(os.path.join(out_dir, "accuracy_10fold.csv")) as f:
        assert "synth" in f.read()
    art = str(tmp_path / "model.frte")
    ckpt = os.path.join(work, "checkpoints", "arcface")
    assert cli(["export", "--checkpoint-dir", ckpt, "--backbone", name,
                "--image-size", str(IMAGE), "--output", art, "--device",
                "cpu"]) == 0
    images, labels = synthetic_identities(2, 2, image_size=IMAGE, seed=3)
    write_identity_tree(str(tmp_path / "tree"), images, labels)
    out = str(tmp_path / "emb.npz")
    capsys.readouterr()
    assert cli(["embed", "--input", str(tmp_path / "tree"), "--output", out,
                "--model", art, "--device", "cpu", "--batch-size", "2",
                "--num-workers", "1"]) == 0
    emb = np.load(out)
    assert len(emb["paths"]) == 4
    feats = emb["embeddings"]
    assert feats.shape == (4, 512) and np.isfinite(feats).all()

