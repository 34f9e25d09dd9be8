"""The port's serving path on the CPU against the JAX package: BatchNorm
folding, the exported artifact, `export --format torch`, `embed_directory`,
`norm_quality`, and the `export` / `embed` CLI with --device cpu.

Tolerances:
- the fold: bitwise (both compute in float64 and round once to float32);
- a folded fp32 model against the unfolded eval forward: rtol 1e-4, atol
  1e-5 (tests/test_serving.py's test_bn_folding_exact);
- an artifact against the live eval step: rtol = atol = 1e-2, folded 2e-2
  (tests/test_serving.py);
- port against JAX forwards on the same fp32 weights: rtol 2e-3, atol 2e-4
  x the largest value (tests/test_torch_resnet.py: the convolutions of
  XLA and oneDNN sum in different orders).
"""

import json
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu.models import resnet as jresnet
from face_recognition_models_tpu.models.folding import (
    fold_resnet_bn as jfold_resnet_bn,
)
from face_recognition_models_tpu.serving import embed as jembed
from face_recognition_models_tpu.train.step import (
    make_eval_step as jmake_eval_step,
)
from face_recognition_models_tpu.utils.torch_export import (
    export_torch_state_dict,
)
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.models import resnet as tresnet
from face_recognition_models_tpu_torch.models.folding import fold_resnet_bn
from face_recognition_models_tpu_torch.serving import embed as tembed
from face_recognition_models_tpu_torch.serving.export import (
    export_embedder,
    load_embedder,
)
from face_recognition_models_tpu_torch.train.step import make_eval_step
from face_recognition_models_tpu_torch.utils.weights import from_jax
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
BLOCKS = {"basic": (jresnet.BasicBlock, tresnet.BasicBlock),
          "bottleneck": (jresnet.Bottleneck, tresnet.Bottleneck)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _tiny(block="basic", dtype=jnp.bfloat16, seed=0):
    """(JAX module, params, batch_stats moved by one train forward, the
    port's module with the same weights)."""
    jblock, tblock = BLOCKS[block]
    jmodel = jresnet.ResNet(stage_sizes=(1, 1, 1, 1), block=jblock,
                            num_filters=8, embed_dim=16, dtype=dtype)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, IMG, IMG, 3)), train=False)
    x = jax.random.normal(jax.random.PRNGKey(seed + 3), (8, IMG, IMG, 3))
    _, mutated = jmodel.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    params, stats = _host(variables["params"]), _host(mutated["batch_stats"])
    tmodel = tresnet.ResNet((1, 1, 1, 1), tblock, embed_dim=16,
                            num_filters=8,
                            dtype=getattr(torch, jnp.dtype(dtype).name))
    tmodel.load_state_dict(from_jax(params, stats)[0])
    return jmodel, params, stats, tmodel.eval()


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, IMG, IMG, 3),
                                               np.uint8)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-4 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, tiny):
    *_, model = tiny
    path = str(tmp_path_factory.mktemp("art") / "embedder.frte")
    header = export_embedder(model, model.state_dict(), path,
                             image_size=IMG, platforms=["cpu"],
                             meta={"backbone": "tiny"})
    return path, header


# --- folding ---------------------------------------------------------------

@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_fold_equals_jax_fold_bitwise(block):
    _, params, stats, model = _tiny(block, jnp.float32)
    want = from_jax(_host(jfold_resnet_bn(params, stats)), {})[0]
    got = fold_resnet_bn(model.state_dict())
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key
    folded = model.clone(folded=True)
    folded.load_state_dict(got, strict=True)


@pytest.mark.parametrize("size", [16, IMG])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_folded_forward_matches_unfolded(block, size):
    """At 16 px the last stage's strided convs see a 1 x 1 input, where
    the CPU repair of models/resnet.Conv2d runs (with the folded bias)."""
    _, _, _, model = _tiny(block, jnp.float32, seed=1)
    folded = model.clone(folded=True)
    folded.load_state_dict(fold_resnet_bn(model.state_dict()))
    assert not any(isinstance(m, tresnet.BatchNorm)
                   for m in folded.modules())
    x = torch.from_numpy(np.random.RandomState(2).randn(
        4, size, size, 3).astype(np.float32))
    with torch.no_grad():
        want = model.eval()(x)
        got = folded.eval()(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="inference-only"):
        folded.train()(x)


# --- the artifact ----------------------------------------------------------

def test_export_load_roundtrip(artifact, tiny):
    jmodel, params, stats, model = tiny
    path, header = artifact
    assert header["embed_dim"] == 16 and header["image_size"] == IMG
    assert header["platforms"] == ["cpu"] and not header["bn_folded"]
    art = load_embedder(path, device="cpu")
    assert art.embed_dim == 16 and art.meta["backbone"] == "tiny"
    images = _images(4)
    got = art.fn(images)
    assert got.dtype == np.float32
    live = make_eval_step(model, device="cpu")(images).numpy()
    np.testing.assert_allclose(got, live, rtol=1e-2, atol=1e-2)


def test_export_matches_jax_on_fp32_weights(tmp_path):
    jmodel, params, stats, model = _tiny("basic", jnp.float32, seed=4)
    path = str(tmp_path / "e.frte")
    export_embedder(model, model.state_dict(), path, image_size=IMG,
                    platforms=["cpu"])
    images = _images(3, seed=5)
    want = np.asarray(jax.jit(jmake_eval_step(jmodel))(params, stats,
                                                       images))
    _close(load_embedder(path, device="cpu").fn(images), want)


def test_export_symbolic_batch(artifact):
    art = load_embedder(artifact[0], device="cpu")
    for b in (1, 3, 8):
        out = art.fn(np.zeros((b, IMG, IMG, 3), np.uint8))
        assert out.shape == (b, 16)


def test_load_rejects_garbage(tmp_path):
    path = tmp_path / "junk.frte"
    path.write_bytes(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        load_embedder(str(path), device="cpu")


def test_export_refuses_an_unknown_platform(tmp_path, tiny):
    *_, model = tiny
    with pytest.raises(ValueError, match="platforms"):
        export_embedder(model, model.state_dict(), str(tmp_path / "e.frte"),
                        image_size=IMG, platforms=["tpu"])


def test_load_refuses_a_device_without_a_program(tmp_path, artifact):
    """An artifact holding only a card program does not load on the CPU:
    the error names the artifact's platforms."""
    with open(artifact[0], "rb") as f:
        magic = f.read(4)
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        rest = f.read()
    header["platforms"] = ["cuda"]
    blob = json.dumps(header).encode()
    path = tmp_path / "cuda_only.frte"
    path.write_bytes(magic + struct.pack("<I", len(blob)) + blob + rest)
    with pytest.raises(ValueError, match=r"\['cuda'\]"):
        load_embedder(str(path), device="cpu")


def test_load_needs_no_model_code(artifact):
    """The artifact loads and runs in a process where the port's models
    package cannot be imported."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["face_recognition_models_tpu_torch.models"] = None
        import numpy as np
        from face_recognition_models_tpu_torch.serving.export import (
            load_embedder)
        art = load_embedder({artifact[0]!r}, device="cpu")
        print(art.fn(np.zeros((3, {IMG}, {IMG}, 3), np.uint8)).shape)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "(3, 16)"


def test_export_folds_bn_for_resnet(tmp_path, tiny):
    *_, model = tiny
    path = str(tmp_path / "folded.frte")
    header = export_embedder(model, model.state_dict(), path,
                             image_size=IMG, platforms=["cpu"],
                             fold_bn="always")
    assert header["bn_folded"] is True
    images = _images(2, seed=6)
    live = make_eval_step(model, device="cpu")(images).numpy()
    np.testing.assert_allclose(load_embedder(path, device="cpu").fn(images),
                               live, rtol=2e-2, atol=2e-2)


# --- export --format torch, and the CLI -----------------------------------

@pytest.fixture(scope="module")
def resnet18_run(tmp_path_factory):
    """A checkpoint dir <root>/arcface holding arcface_final: a JAX
    resnet18 (embed 16) carried over, BatchNorm statistics moved."""
    jmodel = jget_backbone("resnet18", embed_dim=16)
    variables = jmodel.init(jax.random.PRNGKey(7),
                            jnp.zeros((1, IMG, IMG, 3)), train=False)
    x = jax.random.normal(jax.random.PRNGKey(8), (8, IMG, IMG, 3))
    _, mutated = jmodel.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    params, stats = _host(variables["params"]), _host(mutated["batch_stats"])
    root = tmp_path_factory.mktemp("run")
    CheckpointManager(str(root / "arcface"), "arcface").save_final(
        from_jax(params, stats)[0])
    return str(root / "arcface"), params, stats


def test_export_format_torch_equals_jax_export(resnet18_run, tmp_path):
    ckpt, params, stats = resnet18_run
    out = str(tmp_path / "backbone.pth")
    assert cli(["export", "--checkpoint-dir", ckpt, "--backbone",
                "resnet18", "--embed-dim", "16", "--output", out,
                "--format", "torch"]) == 0
    got = torch.load(out, weights_only=True)
    want = export_torch_state_dict("resnet18", params, stats)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == np.asarray(value).dtype, key
        assert np.array_equal(got[key].numpy(), value), key


def test_export_cli_needs_a_final(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    assert cli(["export", "--checkpoint-dir", str(tmp_path / "empty"),
                "--output", str(tmp_path / "x.frte"), "--device",
                "cpu"]) == 1
    assert "no *_final checkpoint" in capsys.readouterr().err


def _write_tree(root, names, seed=0):
    rs = np.random.RandomState(seed)
    for name in names:
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (IMG, IMG, 3), np.uint8)).save(p)


def test_export_and_embed_cli_on_cpu(resnet18_run, tmp_path, capsys):
    ckpt, _, _ = resnet18_run
    art = str(tmp_path / "e.frte")
    assert cli(["export", "--checkpoint-dir", ckpt, "--backbone",
                "resnet18", "--embed-dim", "16", "--image-size", str(IMG),
                "--output", art, "--device", "cpu"]) == 0
    _write_tree(tmp_path / "imgs", ["p/a.png", "q/b.jpg", "c.png"])
    out_art, out_ckpt = str(tmp_path / "art.npz"), str(tmp_path / "ck.npz")
    assert cli(["embed", "--input", str(tmp_path / "imgs"), "--output",
                out_art, "--model", art, "--device", "cpu",
                "--bn-dtype", "float32", "--batch-size", "2",
                "--num-workers", "2"]) == 0
    assert "no effect on exported" in capsys.readouterr().out
    assert cli(["embed", "--input", str(tmp_path / "imgs"), "--output",
                out_ckpt, "--checkpoint-dir", ckpt, "--backbone",
                "resnet18", "--embed-dim", "16", "--image-size", str(IMG),
                "--bn-dtype", "float32", "--device", "cpu",
                "--batch-size", "2", "--num-workers", "2"]) == 0
    a, b = np.load(out_art), np.load(out_ckpt)
    assert list(a["paths"]) == ["c.png", "p/a.png", "q/b.jpg"]
    assert list(b["paths"]) == list(a["paths"])
    assert a["embeddings"].shape == (3, 16)
    np.testing.assert_allclose(np.linalg.norm(a["embeddings"], axis=1), 1.0,
                               rtol=1e-5)
    # the artifact is the fp32-BatchNorm backbone the checkpoint path runs
    np.testing.assert_array_equal(a["embeddings"], b["embeddings"])
    np.testing.assert_array_equal(a["quality"],
                                  tembed.norm_quality(a["norms"]))
    assert cli(["embed", "--input", str(tmp_path / "imgs"), "--output",
                out_art, "--device", "cpu"]) == 2


# --- embed_directory and norm_quality --------------------------------------

@pytest.fixture(scope="module")
def fp32_pair():
    jmodel, params, stats, model = _tiny("basic", jnp.float32, seed=9)
    jstep = jax.jit(jmake_eval_step(jmodel))
    return (lambda im: jstep(params, stats, im),
            make_eval_step(model, device="cpu"))


def test_embed_directory_matches_jax(tmp_path, fp32_pair):
    """Order, the padded last batch (batch 2 over 5 images), norms and
    embeddings against the JAX function on the same tree."""
    jfn, tfn = fp32_pair
    _write_tree(tmp_path / "imgs", ["b/y.jpg", "a/x.jpg", "a/z.png",
                                    "c.jpg", "b/w.jpg"])
    root = str(tmp_path / "imgs")
    want = jembed.embed_directory(jfn, root, image_size=IMG, batch_size=2,
                                  num_workers=2)
    got = tembed.embed_directory(tfn, root, image_size=IMG, batch_size=2,
                                 num_workers=2)
    assert got[1] == want[1] == sorted(want[1]) and len(got[1]) == 5
    assert got[0].shape == (5, 16) and got[2].shape == (5,)
    _close(got[0], want[0])
    _close(got[2], want[2])


def test_embed_directory_rejects_corrupt_image(tmp_path, fp32_pair):
    jfn, tfn = fp32_pair
    _write_tree(tmp_path / "imgs", ["a.jpg", "b.jpg", "c.jpg"])
    (tmp_path / "imgs" / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    for module, fn in ((jembed, jfn), (tembed, tfn)):
        with pytest.raises(ValueError, match="failed to decode"):
            module.embed_directory(fn, str(tmp_path / "imgs"),
                                   image_size=IMG, batch_size=2,
                                   num_workers=2)


def test_norm_quality_matches_jax():
    norms = np.concatenate([[0.0, 10.0, 60.0, 110.0, 500.0],
                            np.random.RandomState(0).uniform(0, 200, 64)])
    got = tembed.norm_quality(norms)
    np.testing.assert_array_equal(got, jembed.norm_quality(norms))
    np.testing.assert_allclose(got[:5], [0.0, 0.0, 0.5, 1.0, 1.0])
