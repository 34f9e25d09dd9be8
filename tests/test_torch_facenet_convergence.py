"""The triplet path's convergence script against the JAX package's: the
verify step on a bridged fp32 resnet18 / 128-d FaceNet trunk within 1e-6 of
the root scripts/facenet_convergence.py's make_embed_fn ->
embed_unique_images -> kfold_verification, one tiny run of the port's
script (8 identities, 32 px, 2 epochs, the CPU) whose JSON line has the
root script's keys, and a `--checkpoint-dir` run whose `<model>_final` is
the trained trunk. The root script imports the JAX package: it is loaded
from its file (it puts scripts/ on sys.path for its own `convergence_run`
import; the path is restored afterwards)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_backbone_parity as parity
from face_recognition_models_tpu.evaluation.batch_eval import (
    make_embed_fn as jmake_embed_fn,
)
from face_recognition_models_tpu.evaluation.verification import (
    embed_unique_images as jembed_unique_images,
)
from face_recognition_models_tpu.evaluation.verification import (
    kfold_verification as jkfold_verification,
)
from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu_torch.checkpoint import restore_backbone
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.scripts import convergence_run
from face_recognition_models_tpu_torch.scripts import facenet_convergence
from face_recognition_models_tpu_torch.utils.weights import from_jax
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the root script's JSON line (scripts/facenet_convergence.py,
# main's print)
JAX_KEYS = ["metric", "backbone", "embed_dim", "classes", "p", "k", "margin",
            "epochs", "lr", "mean_accuracy", "std_accuracy", "mean_auc",
            "final_loss", "images_per_sec", "train_seconds"]
TINY = ["--device", "cpu", "--classes", "8", "--p", "4", "--k", "4",
        "--image-size", "32", "--pairs-per-kind", "20"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jscript():
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_facenet_convergence", os.path.join(ROOT, "scripts",
                                                "facenet_convergence.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def test_verify_matches_jax_on_bridged_weights(jscript):
    classes, per, size, seed = 8, 4, 32, 3
    _, _, held_x, held_y = convergence_run.build_split(classes, 2, per,
                                                       size, seed, 35.0)
    jmodel = jget_backbone("resnet18", embed_dim=128, dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, size, seed=4)
    # the root script's verification, step by step
    emb = jembed_unique_images(jmake_embed_fn(jmodel, params, stats),
                               held_x, batch_size=256)
    pairs = jscript._heldout_pairs(held_y, classes, per, 40, seed)
    sims = np.sum(emb[pairs[:, 0]] * emb[pairs[:, 1]], axis=1)
    want = jkfold_verification(sims, pairs[:, 2])

    model = get_backbone("resnet18", embed_dim=128, dtype=torch.float32)
    model.load_state_dict(from_jax(params, stats)[0], strict=True)
    got = facenet_convergence.verify(model, held_x, held_y, classes, per, 40,
                                     seed, device="cpu")
    for field in ("mean_accuracy", "std_accuracy", "mean_auc"):
        assert abs(getattr(got, field) - getattr(want, field)) <= 1e-6, field


def test_tiny_run_prints_the_jax_keys(capsys):
    assert facenet_convergence.main([*TINY, "--epochs", "2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    assert list(lines[0]) == JAX_KEYS
    assert lines[0]["metric"] == "facenet_synthetic_verification"
    assert lines[0]["epochs"] == 2 and lines[0]["embed_dim"] == 128
    assert 0.0 <= lines[0]["mean_accuracy"] <= 100.0
    assert np.isfinite(lines[0]["final_loss"])


def test_checkpoint_dir_leaves_the_final_trunk(tmp_path):
    args = facenet_convergence.parser().parse_args(
        [*TINY, "--epochs", "1", "--checkpoint-dir", str(tmp_path)])
    result, line = facenet_convergence.run(args)
    assert line["epochs"] == 1
    # 8 identities / P 4: 2 steps an epoch
    assert len(result.losses) == 2 and len(result.triplets) == 2
    assert (tmp_path / "facenet_resnet18_final").is_file()
    final = restore_backbone(str(tmp_path), "final",
                             model_name="facenet_resnet18")
    trained = result.model.state_dict()
    assert sorted(final) == sorted(trained)
    for name, tensor in trained.items():
        assert torch.equal(final[name], tensor.cpu()), name
