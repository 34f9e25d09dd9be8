"""The port's FaceNet triplet path against the JAX package's:

- `PKBatchSampler`'s batches equal JAX's, index for index (identities with
  fewer than K images included), and its refusal;
- the LFW triplet-file parsers on a tmp_path tree, with their errors;
- `PKLoader` (an identity tree) and `PKRecLoader` (a .rec) batches bitwise
  equal to JAX's, PIL backend;
- two triplet steps against JAX's `make_triplet_train_step` with JAX's
  Gumbel draws injected (the tiny ResNet of tests/test_torch_train_step.py
  at 16 px in fp32, D = 16, P = 4 x K = 2): the losses within 1e-4
  relative, the trunk within the recipe tests' rtol 5e-3 / atol 2e-3;
- `train_facenet` (resnet18, 32 px): checkpoints, a resumed run bitwise
  equal to an uninterrupted one, and `<model>_final` read by `eval` and
  `embed` at --embed-dim 128; `facenet --synthetic` through the CLI;
- inception_v3 at 75 px trains through `train_facenet`, its dropout
  drawing from the step generator: two runs from one seed bitwise equal,
  another seed differs.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.data import pipeline as jpipeline
from face_recognition_models_tpu.data import recordio as jrec
from face_recognition_models_tpu.data import triplets as jtriplets
from face_recognition_models_tpu.data.index import (
    ImageFolderIndex as JIndex)
from face_recognition_models_tpu.data.sampler import (
    PKBatchSampler as JSampler)
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu.train.optim import (
    get_optimizer as jget_optimizer)
from face_recognition_models_tpu.triplet import train as jtrain
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data import (
    ImageFolderIndex,
    PKBatchSampler,
    PKLoader,
    PKRecLoader,
    RecordIODataset,
    triplets,
)
from face_recognition_models_tpu_torch.data.recordio import write_recordio
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
    write_identity_tree,
    write_pair_benchmark,
)
from face_recognition_models_tpu_torch.models import dropout
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.ops import mining
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.triplet import train as ttrain
from face_recognition_models_tpu_torch.utils.weights import from_jax
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

MARGIN, LR = 0.2, 0.05
TOL = {"rtol": 5e-3, "atol": 2e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


# --------------------------------------------------------------------------
# Sampling and data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p, k, seed", [(4, 2, 0), (3, 5, 1), (8, 4, 7)])
def test_pk_sampler_matches_jax(p, k, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 20, 90)   # some identities below K images
    got, want = PKBatchSampler(labels, p, k, seed), JSampler(labels, p, k,
                                                             seed)
    assert len(got) == len(want) > 0
    for epoch in (0, 3):
        a, b = list(got.epoch(epoch)), list(want.epoch(epoch))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert len(np.unique(labels[x])) == p and len(x) == p * k


def test_pk_sampler_refuses_too_few_identities():
    with pytest.raises(ValueError, match="needs >= 4 identities, got 3"):
        PKBatchSampler([0, 1, 2, 2], 4, 2)


def _triplet_tree(root):
    ident = root / "lfw_funneled"
    for name in ("a/1.jpg", "a/2.jpg", "b/1.jpg", "c/1.jpg", "c/2.jpg"):
        (ident / name).parent.mkdir(parents=True, exist_ok=True)
        (ident / name).write_bytes(b"x")
    (ident / "pairs.txt").write_text("ignored\n")
    (ident / "set1.txt").write_text("a/1.jpg\na/2.jpg\nb/1.jpg\nc/1.jpg\n\n")
    (ident / "set0.txt").write_text("c/1.jpg\nc/2.jpg\na/1.jpg\nb/1.jpg\n")
    return ident


def test_triplet_files_match_jax(tmp_path):
    ident = _triplet_tree(tmp_path)
    got = triplets.load_lfw_triplets(str(tmp_path))
    assert got == jtriplets.load_lfw_triplets(str(tmp_path))
    assert got[0] == ("c/1.jpg", "c/2.jpg", "a/1.jpg") and len(got) == 4
    assert triplets.load_triplet_file(str(ident), str(ident / "set1.txt")) \
        == jtriplets.load_triplet_file(str(ident), str(ident / "set1.txt"))


def test_triplet_file_errors(tmp_path):
    ident = _triplet_tree(tmp_path)
    (ident / "bad.txt").write_text("a/1.jpg\na/2.jpg\nb/1.jpg\n")
    (ident / "missing.txt").write_text("a/1.jpg\na/2.jpg\nb/1.jpg\nz.jpg\n")
    for mod in (triplets, jtriplets):
        with pytest.raises(ValueError, match="expected 4-line blocks, got 3"):
            mod.load_triplet_file(str(ident), str(ident / "bad.txt"))
        with pytest.raises(FileNotFoundError, match="z.jpg does not exist"):
            mod.load_triplet_file(str(ident), str(ident / "missing.txt"))
        with pytest.raises(FileNotFoundError, match="does not exist"):
            mod.load_lfw_triplets(str(tmp_path / "nowhere"))


def test_pk_loader_matches_jax(tmp_path):
    images, labels = synthetic_identities(6, 5, image_size=24, seed=2)
    write_identity_tree(str(tmp_path), images, labels)
    root = str(tmp_path / "train")
    got = PKLoader(ImageFolderIndex.build(root), 3, 2, image_size=20,
                   seed=4, num_workers=2, backend="pil")
    want = jpipeline.PKLoader(JIndex.build(root), 3, 2, image_size=20,
                              seed=4, num_workers=2, backend="pil")
    assert got.steps_per_epoch() == want.steps_per_epoch() == 2
    for epoch in (0, 1):
        _same_batches(got.epoch(epoch), want.epoch(epoch))


def test_pk_rec_loader_matches_jax(tmp_path):
    import io

    from PIL import Image

    images, labels = synthetic_identities(6, 4, image_size=24, seed=3)
    payloads = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=95)
        payloads.append(buf.getvalue())
    prefix = str(tmp_path / "train")
    write_recordio(prefix, payloads, labels)
    got = PKRecLoader(RecordIODataset.open(prefix), 2, 3, image_size=24,
                      seed=1, num_workers=2, backend="pil")
    want = jrec.PKRecLoader(jrec.RecordIODataset.open(prefix), 2, 3,
                            image_size=24, seed=1, num_workers=2,
                            backend="pil")
    assert got.steps_per_epoch() == want.steps_per_epoch() == 3
    for epoch in (0, 2):
        _same_batches(got.epoch(epoch), want.epoch(epoch))


# --------------------------------------------------------------------------
# The step against JAX
# --------------------------------------------------------------------------


def test_triplet_steps_match_jax(monkeypatch):
    d, size, p, k = 16, 16, 4, 2
    jmodel = JResNet(stage_sizes=(1, 1), block=JBasic, embed_dim=d,
                     num_filters=8, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)), train=False)
    tx = jget_optimizer("sgd", LR, momentum=0.9, weight_decay=5e-4)
    jstate = jtrain.TripletTrainState(
        step=jnp.int32(0), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jtrain.make_triplet_train_step(jmodel, tx, MARGIN))

    host = jax.tree.map(np.asarray, variables)
    sd, _ = from_jax({"backbone": host["params"],
                      "kernel_w": np.zeros((d, 1), np.float32)},
                     host["batch_stats"])
    model = ResNet((1, 1), BasicBlock, embed_dim=d, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(sd)
    state = ttrain.TripletTrainState(
        backbone=model, optimizer=get_optimizer(
            "sgd", model.parameters(), LR, momentum=0.9, weight_decay=5e-4),
        rng=torch.Generator().manual_seed(1))
    step = ttrain.make_triplet_train_step(MARGIN, device="cpu")

    noises = []
    monkeypatch.setattr(mining, "gumbel", lambda *a: noises.pop(0))
    images, labels = synthetic_identities(p, 6, image_size=size, seed=5)
    batches = ttrain._ArrayPKBatches(images, labels, p, k, seed=0)
    for batch_images, batch_labels in list(batches.epoch(0)) * 2:
        mine_key = jax.random.split(jstate.rng, 3)[1]
        noises.append(torch.from_numpy(np.array(
            jax.random.gumbel(mine_key, (p * k,) * 3))))
        jstate, jm = jstep(jstate, batch_images, batch_labels)
        state, m = step(state, batch_images, batch_labels)
        assert int(m["triplets"]) > 0
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert not noises and state.step == 2
    want, _ = from_jax({"backbone": jax.tree.map(np.asarray, jstate.params),
                        "kernel_w": np.zeros((d, 1), np.float32)},
                       jax.tree.map(np.asarray, jstate.batch_stats))
    got = state.backbone.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       err_msg=key, **TOL)


# --------------------------------------------------------------------------
# train_facenet and the CLI
# --------------------------------------------------------------------------


CFG = tcfg.FaceNetConfig(backbone="resnet18", p=4, k=2)


def test_train_facenet_resume_and_final(tmp_path):
    images, labels = synthetic_identities(8, 4, image_size=32, seed=0)

    def run(directory, epochs, resume=False):
        return ttrain.train_facenet(
            CFG, images, labels, epochs=epochs, image_size=32, seed=0,
            verbose=False, checkpoint_dir=str(directory),
            model_name="facenet_resnet18", resume=resume, device="cpu")

    ckpt = tmp_path / "w" / "checkpoints" / "facenet_resnet18"
    whole = run(tmp_path / "a", 2)
    first = run(ckpt, 1)
    second = run(ckpt, 2, resume=True)
    assert second.start_epoch == 2 and len(whole.losses) == 4
    assert first.losses + second.losses == whole.losses
    assert all(t > 0 for t in whole.triplets)
    for x, y in zip(state_tensors_of(second.state),
                    state_tensors_of(whole.state), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(second.state.rng.get_state(),
                       whole.state.rng.get_state())
    assert sorted(os.listdir(ckpt)) == ["epoch_1", "epoch_2",
                                        "facenet_resnet18_final", "min_loss"]

    # the final artifact is what `eval` and `embed` read
    bench = tmp_path / "eval" / "lfw"
    write_pair_benchmark(str(bench), pairs_per_kind=10, image_size=32)
    out = tmp_path / "out"
    assert cli(["eval", "--checkpoint-dir", str(ckpt.parent), "--head",
                "facenet_resnet18", "--backbone", "resnet18", "--embed-dim",
                "128", "--eval-data-path", str(tmp_path / "eval"),
                "--benchmarks", "lfw", "--image-size", "32", "--device",
                "cpu", "--output-dir", str(out)]) == 0
    assert "facenet_resnet18" in (out / "accuracy_10fold.csv").read_text()
    tree = tmp_path / "tree"
    write_identity_tree(str(tree), images[:6], labels[:6])
    npz = tmp_path / "e.npz"
    assert cli(["embed", "--input", str(tree), "--output", str(npz),
                "--checkpoint-dir", str(ckpt), "--backbone", "resnet18",
                "--embed-dim", "128", "--image-size", "32", "--bn-dtype",
                "float32", "--device", "cpu"]) == 0
    emb = np.load(npz)["embeddings"]
    assert emb.shape == (6, 128) and np.isfinite(emb).all()


def state_tensors_of(state):
    """The triplet state's tensors: trunk parameters and buffers, the
    optimizer's slots, the step count."""
    return [*state.backbone.parameters(), *state.backbone.buffers(),
            *state.optimizer.tensors(), state.count]


def test_facenet_cli_synthetic(tmp_path, capsys):
    assert cli(["facenet", "--synthetic", "--synthetic-classes", "8",
                "--synthetic-per-class", "2", "--backbone", "resnet18",
                "--p", "4", "--k", "2", "--epochs", "1", "--image-size",
                "32", "--device", "cpu", "--working-path",
                str(tmp_path)]) == 0
    assert "saved facenet_resnet18_final" in capsys.readouterr().out
    final = torch.load(tmp_path / "checkpoints" / "facenet_resnet18"
                       / "facenet_resnet18_final", weights_only=True)
    assert final["fc.weight"].shape[0] == 128
    assert cli(["facenet", "--device", "cpu"]) == 2


def test_inception_v3_trains_with_dropout_from_the_generator(monkeypatch):
    """The margin-head `fit` refuses inception_v3 (as JAX `fit` fails); the
    triplet path trains it, its Dropout(0.5) drawing from the state's
    generator."""
    images, labels = synthetic_identities(2, 2, image_size=75, seed=1)
    cfg = tcfg.FaceNetConfig(backbone="inception_v3", p=2, k=2)
    drawn = []
    keep_mask = dropout._keep_mask
    monkeypatch.setattr(dropout, "_keep_mask",
                        lambda *a: drawn.append(a[2]) or keep_mask(*a))

    def run(seed):
        return ttrain.train_facenet(cfg, images, labels, image_size=75,
                                    seed=seed, verbose=False, device="cpu",
                                    dtype=torch.float32)

    a, b, c = run(0), run(0), run(1)
    assert drawn and all(g is not None for g in drawn)
    assert a.losses == b.losses and np.isfinite(a.losses).all()
    for x, y in zip(state_tensors_of(a.state), state_tensors_of(b.state)):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(
        a.state.backbone.parameters(), c.state.backbone.parameters()))
