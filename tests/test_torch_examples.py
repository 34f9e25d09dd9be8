"""The port's walkthroughs (examples/*_torch.py) and its `run.sh` launcher
on the CPU: the production pipeline at its demo size, model validation
against the JAX package's evaluation of the same weights, dataset sanity's
output against the JAX script's, and `run.sh` training through the port's
CLI. The examples are loaded from their files."""

import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_backbone_parity as parity
from face_recognition_models_tpu.evaluation.batch_eval import (
    evaluate_model_on_benchmark as jevaluate_model_on_benchmark,
)
from face_recognition_models_tpu.models import get_backbone as jget_backbone
from face_recognition_models_tpu.train.step import (
    make_eval_step as jmake_eval_step,
)
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch import models
from face_recognition_models_tpu_torch.data import synthetic
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.utils.weights import from_jax
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
RUN_SH = os.path.join(ROOT, "face_recognition_models_tpu_torch", "scripts",
                      "run.sh")
# the served /identify score against the two `embed` outputs' product (the
# serve phase's HTTP-vs-direct bound; micro-batch 4 against batch 32)
TOL_SERVED = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(args, **kw):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_production_pipeline_on_cpu(tmp_path):
    import json

    pipeline = load_example("production_pipeline_torch")
    wd = tmp_path / "demo"
    assert pipeline.main(["--workdir", str(wd), "--device", "cpu"]) == 0
    for name in ("embedder.frte", "gallery.npz", "probes.npz",
                 "checkpoints/arcface/arcface_best_acc",
                 "checkpoints/arcface/arcface_final"):
        assert (wd / name).is_file(), name
    summary = json.loads((wd / "pipeline.json").read_text())
    assert sorted(summary["seconds"]) == sorted(
        ["train", "export", "embed_gallery", "embed_probes", "identify",
         "serve"])
    with np.load(wd / "gallery.npz") as g, np.load(wd / "probes.npz") as p:
        assert g["embeddings"].shape == (8 * 8, 512)
        assert p["embeddings"].shape == (8 * 2, 512)
        gallery = dict(zip((str(x) for x in g["paths"]), g["embeddings"]))
        probes = dict(zip((str(x) for x in p["paths"]), p["embeddings"]))
    top = summary["matches"][0]
    want = float(np.dot(gallery[top["path"]], probes[summary["probe"]]))
    assert abs(top["score"] - want) <= TOL_SERVED
    assert len(summary["matches"]) == 3


def test_validate_model_matches_jax(tmp_path, capsys, monkeypatch):
    size = 32
    bench = synthetic.write_pair_benchmark(str(tmp_path / "bench" / "lfw"),
                                           num_classes=4, pairs_per_kind=12,
                                           image_size=size, seed=2)
    jmodel = jget_backbone("resnet18", dtype=jnp.float32)
    params, stats = parity.seeded_variables(jmodel, size, seed=6)
    eval_step = jax.jit(jmake_eval_step(jmodel))
    want = jevaluate_model_on_benchmark(
        lambda imgs: eval_step(params, stats, imgs), str(tmp_path / "bench"),
        "lfw", size, 256, verbose=False)

    ckpt = tmp_path / "checkpoints" / "arcface"
    model = get_backbone("resnet18", dtype=torch.float32)
    model.load_state_dict(from_jax(params, stats)[0], strict=True)
    CheckpointManager(str(ckpt), "arcface").save_final(model.state_dict())
    validate = load_example("validate_model_torch")
    args = validate.parser().parse_args(
        ["--checkpoint-dir", str(ckpt), "--bench-root", bench + "/",
         "--image-size", str(size), "--device", "cpu"])
    # the JAX side's fp32 trunk; the script builds the registry's (bf16)
    with monkeypatch.context() as patch:
        patch.setattr(models, "get_backbone",
                      functools.partial(get_backbone, dtype=torch.float32))
        got = validate.validate(args)
    assert abs(got.mean_accuracy - want.mean_accuracy) <= 1e-6
    assert abs(got.mean_auc - want.mean_auc) <= 1e-6
    assert 50.0 < want.mean_accuracy < 100.0
    np.testing.assert_allclose(got.fold_thresholds, want.fold_thresholds,
                               rtol=0, atol=1e-6)
    assert ([f"{t:.4f}" for t in got.fold_thresholds]
            == [f"{t:.4f}" for t in want.fold_thresholds])

    # the script's own run: the registry's bf16 trunk, its printed lines
    capsys.readouterr()
    assert validate.main(["--checkpoint-dir", str(ckpt), "--bench-root",
                          bench, "--image-size", str(size),
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("fold thresholds: [")
    assert out[-2].startswith("acc ")


def test_dataset_sanity_output_equals_jax(tmp_path):
    images, labels = synthetic.synthetic_identities(5, 6, image_size=24,
                                                    seed=1, noise=20)
    # a flat identity tree (the layout the pipeline writes), one identity
    # short of 3 images
    tree = str(tmp_path / "tree")
    synthetic.write_identity_tree(tree, images[:-3], labels[:-3], split="")
    bench = synthetic.write_pair_benchmark(str(tmp_path / "lfw"),
                                           num_classes=4, pairs_per_kind=9,
                                           image_size=24, seed=3)
    os.remove(os.path.join(bench, "imgs", "5.jpg"))
    outs = []
    for script in ("dataset_sanity.py", "dataset_sanity_torch.py"):
        proc = _run([sys.executable, os.path.join(EXAMPLES, script),
                     "--dataset-path", tree, "--eval-path", bench])
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[1] == outs[0]
    assert outs[0].splitlines() == [
        "[flat] 5 identities, 27 images; per-identity min=3 max=6",
        "18 pairs (9 pos / 9 neg), 1 missing images, sizes: {(24, 24): 35}"]


def test_run_sh_trains_on_cpu(tmp_path):
    work = tmp_path / "work"
    proc = _run(["bash", RUN_SH, "arcface", "--synthetic",
                 "--synthetic-classes", "4", "--synthetic-per-class", "4",
                 "--image-size", "32", "--batch_size", "8", "--epochs", "1",
                 "--device", "cpu", "--working-path", str(work)])
    assert proc.returncode == 0, proc.stderr
    # the later flags override the launcher's batch 1024 / 200 epochs
    assert "batch 8, epochs 1, sgd lr 0.1" in proc.stdout
    assert (work / "checkpoints" / "arcface" / "arcface_final").is_file()
