"""The convergence run's pieces against the JAX package's: the synthetic
identity tree and pair benchmark byte for byte (each side in its own
directory, file by file), the root script's `build_split` and held-out
pairs bit for bit, `verify` on bridged weights within 1e-6, and one tiny
run of the port's script (8 identities, 32 px, 2 epochs, the CPU) whose
JSON line has the root script's keys. The root scripts/convergence_run.py
imports the JAX package: it is loaded from its file."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_backbone_parity as parity
from face_recognition_models_tpu.data import synthetic as jsynthetic
from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu_torch.data import synthetic
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.scripts import convergence_run
from face_recognition_models_tpu_torch.utils.weights import from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the root script's JSON line without --eval-every / --head-arg
# (scripts/convergence_run.py, run_stage's print)
JAX_KEYS = ["metric", "stage", "head", "backbone", "classes", "batch",
            "epochs", "lr", "optimizer", "scheduler", "partial_fc",
            "bn_dtype", "model_ema", "warm_started", "mean_accuracy",
            "std_accuracy", "mean_auc", "min_train_loss", "train_seconds"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_run", os.path.join(ROOT, "scripts",
                                            "convergence_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_identity_tree_is_byte_equal_to_jax(tmp_path):
    images, labels = synthetic.synthetic_identities(3, 4, image_size=24,
                                                    seed=5, noise=35)
    jimages, jlabels = jsynthetic.synthetic_identities(3, 4, image_size=24,
                                                       seed=5, noise=35)
    assert np.array_equal(images, jimages)
    assert np.array_equal(labels, jlabels)
    synthetic.write_identity_tree(str(tmp_path / "port"), images, labels,
                                  split="train")
    jsynthetic.write_identity_tree(str(tmp_path / "jax"), jimages, jlabels,
                                   split="train")
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 12
    for name in want:
        assert got[name] == want[name], name


def test_pair_benchmark_is_byte_equal_to_jax(tmp_path):
    root = synthetic.write_pair_benchmark(str(tmp_path / "port"),
                                          num_classes=5, pairs_per_kind=7,
                                          image_size=24, seed=9)
    jroot = jsynthetic.write_pair_benchmark(str(tmp_path / "jax"),
                                            num_classes=5, pairs_per_kind=7,
                                            image_size=24, seed=9)
    assert root == str(tmp_path / "port")
    got, want = _files(root), _files(jroot)
    assert sorted(got) == sorted(want) and len(got) == 1 + 4 * 7
    for name in want:
        assert got[name] == want[name], name


def test_split_and_heldout_pairs_are_jax_bitwise(jscript):
    got = convergence_run.build_split(6, 3, 4, 16, seed=2, noise=35.0)
    want = jscript.build_split(6, 3, 4, 16, seed=2, noise=35.0)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pairs = convergence_run._heldout_pairs(got[3], 6, 4, 25, seed=2)
    jpairs = jscript._heldout_pairs(want[3], 6, 4, 25, seed=2)
    assert pairs.dtype == jpairs.dtype and np.array_equal(pairs, jpairs)


def test_verify_matches_jax_on_bridged_weights(jscript):
    classes, per, size = 8, 4, 32
    _, _, held_x, held_y = convergence_run.build_split(classes, 2, per,
                                                       size, 3, 35.0)
    jmodel = jget_backbone("resnet18", embed_dim=16, dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, size, seed=4)
    jres = types.SimpleNamespace(
        backbone=jmodel, state=types.SimpleNamespace(
            ema_params=None, params={"backbone": params},
            batch_stats=stats))
    want = jscript.verify(jres, held_x, held_y, classes, per, 40, 16, 3)
    model = get_backbone("resnet18", embed_dim=16, dtype=torch.float32)
    model.load_state_dict(from_jax(params, stats)[0], strict=True)
    res = types.SimpleNamespace(state=types.SimpleNamespace(
        backbone=model, ema=None))
    got = convergence_run.verify(res, held_x, held_y, classes, per, 40, 16,
                                 3, device="cpu")
    for field in ("mean_accuracy", "std_accuracy", "mean_auc"):
        assert abs(getattr(got, field) - getattr(want, field)) <= 1e-6, field


def test_tiny_run_prints_the_jax_keys(capsys):
    assert convergence_run.main([
        "--device", "cpu", "--classes", "8", "--image-size", "32",
        "--epochs", "2", "--batch", "16", "--train-per-class", "4",
        "--eval-per-class", "4", "--pairs-per-kind", "20",
        "--scan-steps", "2"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    assert list(lines[0]) == JAX_KEYS
    assert lines[0]["stage"] == "train" and lines[0]["epochs"] == 2
    assert 0.0 <= lines[0]["mean_accuracy"] <= 100.0


def test_partial_fc_is_refused():
    """--partial-fc reaches fit, which refuses it with another optimizer
    than sgd (JAX train/loop.py:228-235)."""
    with pytest.raises(ValueError, match="partial_fc requires optimizer"):
        convergence_run.main(["--device", "cpu", "--partial-fc", "0.5",
                              "--optimizer", "adamw", "--classes", "4",
                              "--batch", "8", "--image-size", "16"])
