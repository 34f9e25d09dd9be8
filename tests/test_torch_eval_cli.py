"""The port's `eval` end to end on the CPU: `train --synthetic` writes a
checkpoint, `eval` reads it and a benchmark tree (the pair.list + JPEG
layout and the insightface .bin form) and writes the CSV tables, whose
numbers must equal the JAX package's kfold_verification on the same
similarities (to rtol 1e-12: the same protocol on the same float64
cosines). Also one CPU run of the embedding benchmark at a small size.
"""

import csv
import io
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from face_recognition_models_tpu.data import pairs as jpairs
from face_recognition_models_tpu.evaluation import batch_eval as jbatch
from face_recognition_models_tpu.evaluation import verification as jver
from face_recognition_models_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_backbone,
)
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
)
from face_recognition_models_tpu_torch.evaluation import batch_eval
from face_recognition_models_tpu_torch.evaluation import (
    device_protocol,
    verification,
)
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.scripts import bench_embed

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers, and these small ops slow down many times over when every
    worker's torch also starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _benchmark(identities=30, seed=3):
    """(images [4 * identities], issame): per identity a genuine pair and
    an impostor pair, as the .bin layout stores them."""
    images, _ = synthetic_identities(identities, 4, image_size=SIZE,
                                     seed=seed)
    rows, issame = [], []
    for i in range(identities):
        j = (i + 1) % identities
        rows += [images[4 * i], images[4 * i + 1], images[4 * i + 2],
                 images[4 * j + 3]]
        issame += [1, 0]
    return np.stack(rows), np.array(issame)


def _write_tree(root, name, images, issame):
    """<root>/<name>/{pair.list, imgs/<id>.jpg} with image ids 100 + row."""
    imgs = os.path.join(root, name, "imgs")
    os.makedirs(imgs)
    for row, arr in enumerate(images):
        Image.fromarray(arr).save(os.path.join(imgs, f"{100 + row}.jpg"),
                                  quality=95)
    with open(os.path.join(root, name, "pair.list"), "w") as f:
        for p, same in enumerate(issame):
            f.write(f"{100 + 2 * p} {101 + 2 * p} {same}\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 1-epoch synthetic run through the train CLI, and a benchmark root
    holding `tree` (pair.list + JPEGs) and `packed.bin`."""
    work = str(tmp_path_factory.mktemp("work"))
    rc = cli(["train", "--synthetic", "--device", "cpu",
              "--synthetic-classes", "8", "--synthetic-per-class", "2",
              "--batch_size", "16", "--epochs", "1", "--image-size",
              str(SIZE), "--print_freq", "1", "--working-path", work])
    assert rc == 0
    bench_root = str(tmp_path_factory.mktemp("bench"))
    images, issame = _benchmark()
    _write_tree(bench_root, "tree", images, issame)
    jpairs.save_bin(os.path.join(bench_root, "packed.bin"), images, issame)
    return work, bench_root


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _port_similarities(work, bench_root, bench, which="final"):
    model = get_backbone("resnet18")
    model.load_state_dict(restore_backbone(
        os.path.join(work, "checkpoints", "arcface"), which))
    pairs, stack, id_to_row = batch_eval.load_benchmark(bench_root, bench,
                                                        SIZE)
    emb = verification.embed_unique_images(
        batch_eval.make_embed_fn(model, device="cpu"), stack, 16)
    return verification.pair_cosine_similarities(emb, pairs, id_to_row), \
        pairs


def test_train_writes_the_checkpoints_eval_reads(trained):
    work, _ = trained
    ckpt = os.path.join(work, "checkpoints", "arcface")
    assert sorted(os.listdir(ckpt)) == ["arcface_final", "epoch_1",
                                        "min_loss"]
    assert os.path.isfile(os.path.join(work, "log", "arcface.txt"))
    with open(os.path.join(work, "log", "arcface.txt")) as f:
        assert "min train loss" in f.read()


@pytest.mark.parametrize("bench", ["tree", "packed"])
def test_load_benchmark_matches_jax(trained, bench):
    _, bench_root = trained
    got = batch_eval.load_benchmark(bench_root, bench, SIZE)
    want = jbatch.load_benchmark(bench_root, bench, SIZE)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("protocol", ["host", "device", "standard"])
def test_eval_cli_tables_match_jax_protocol(trained, tmp_path, protocol):
    work, bench_root = trained
    flags = {"host": [], "device": ["--device-protocol"],
             "standard": ["--standard-protocol"]}[protocol]
    rc = cli(["eval", "--checkpoint-dir", os.path.join(work, "checkpoints"),
              "--eval-data-path", bench_root, "--benchmarks",
              "tree,packed,absent", "--image-size", str(SIZE),
              "--batch-size", "16", "--tpr-far", "1e-1",
              "--output-dir", str(tmp_path), "--device", "cpu"] + flags)
    assert rc == 0
    acc = _read_csv(tmp_path / "accuracy_10fold.csv")
    auc = _read_csv(tmp_path / "auc_10fold.csv")
    assert [r["model"] for r in acc] == [r["model"] for r in auc] == [
        "arcface"]
    assert list(acc[0]) == ["model", "tree", "tree_std", "tree_tpr@far=0.1",
                            "packed", "packed_std", "packed_tpr@far=0.1"]
    jax_fn = (jver.standard_kfold_verification if protocol == "standard"
              else jver.kfold_verification)
    for bench in ("tree", "packed"):
        sims, pairs = _port_similarities(work, bench_root, bench)
        want = jax_fn(sims, pairs[:, 2])
        assert float(acc[0][bench]) == pytest.approx(want.mean_accuracy,
                                                     rel=1e-12)
        assert float(acc[0][bench + "_std"]) == pytest.approx(
            want.std_accuracy, rel=1e-12, abs=1e-12)
        assert float(auc[0][bench]) == pytest.approx(want.mean_auc,
                                                     rel=1e-12)


def test_tables_match_pandas(tmp_path):
    acc = [{"model": "a", "lfw": 99.5, "lfw_std": 0.25},
           {"model": "b", "cfp_fp": 90.125}]
    auc = [{"model": "a", "lfw": 0.999}, {"model": "b"}]
    batch_eval._write_tables(acc, auc, str(tmp_path))
    for rows, name in ((acc, "accuracy_10fold.csv"),
                       (auc, "auc_10fold.csv")):
        buf = io.StringIO()
        pd.DataFrame(rows).to_csv(buf, index=False)
        assert (tmp_path / name).read_text() == buf.getvalue()


def test_eval_min_loss_flip_and_missing_models(trained, tmp_path):
    work, bench_root = trained
    ckpt_root = tmp_path / "ckpts"
    os.makedirs(ckpt_root / "empty")
    os.symlink(os.path.join(work, "checkpoints", "arcface"),
               ckpt_root / "arcface")
    rc = cli(["eval", "--checkpoint-dir", str(ckpt_root), "--eval-data-path",
              bench_root, "--benchmarks", "packed", "--image-size",
              str(SIZE), "--batch-size", "16", "--which", "min_loss",
              "--eval-flip", "--output-dir", str(tmp_path / "out"),
              "--device", "cpu"])
    assert rc == 0
    rows = _read_csv(tmp_path / "out" / "accuracy_10fold.csv")
    assert [r["model"] for r in rows] == ["arcface"]  # 'empty' skipped
    model = get_backbone("resnet18")
    model.load_state_dict(restore_backbone(str(ckpt_root / "arcface"),
                                           "min_loss"))
    pairs, stack, id_to_row = batch_eval.load_benchmark(bench_root, "packed",
                                                        SIZE)
    emb = verification.embed_unique_images(
        batch_eval.make_embed_fn(model, device="cpu"), stack, 16, flip=True)
    sims = verification.pair_cosine_similarities(emb, pairs, id_to_row)
    want = jver.kfold_verification(sims, pairs[:, 2])
    assert float(rows[0]["packed"]) == pytest.approx(want.mean_accuracy,
                                                     rel=1e-12)
    assert cli(["eval", "--checkpoint-dir", str(tmp_path / "nothing"),
                "--eval-data-path", bench_root, "--device", "cpu"]) == 1


def test_eval_skips_a_checkpoint_that_does_not_load(trained, tmp_path,
                                                   capsys):
    """A model dir whose final artifact is another backbone's (resnet50
    weights under `eval --backbone resnet18`) is skipped with a note, as
    the JAX eval skips it; the other model's tables are still written."""
    work, bench_root = trained
    ckpt_root = tmp_path / "ckpts"
    os.makedirs(ckpt_root)
    os.symlink(os.path.join(work, "checkpoints", "arcface"),
               ckpt_root / "arcface")
    CheckpointManager(str(ckpt_root / "other"), "other").save_final(
        get_backbone("resnet50").state_dict())
    rc = cli(["eval", "--checkpoint-dir", str(ckpt_root), "--eval-data-path",
              bench_root, "--benchmarks", "packed", "--image-size",
              str(SIZE), "--batch-size", "16", "--backbone", "resnet18",
              "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0
    assert "[skip] other: could not load checkpoint" in capsys.readouterr().out
    for table in ("accuracy_10fold.csv", "auc_10fold.csv"):
        rows = _read_csv(tmp_path / "out" / table)
        assert [r["model"] for r in rows] == ["arcface"]


def test_entry_points_raise_without_a_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    work, bench_root = trained
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["eval", "--checkpoint-dir", os.path.join(work, "checkpoints"),
             "--eval-data-path", bench_root, "--benchmarks", "packed",
             "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_protocol.kfold_verification_device(np.zeros(20),
                                                  np.arange(20) % 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_embed.bench(backbone="resnet18", batch=2, image_size=SIZE)


def test_bench_embed_on_cpu(capsys):
    res = bench_embed.bench(backbone="resnet18", batch=4, image_size=SIZE,
                            iters=2, replays=1, device="cpu")
    assert res["metric"] == "resnet18_embedding_images_per_sec"
    assert res["value"] > 0 and np.isfinite(res["value"])
    assert res["timing"] == "host_clock" and res["nvidia_smi"] is None
    bench_embed.main(["--backbone", "resnet18", "--batch", "2",
                      "--image-size", str(SIZE), "--iters", "1",
                      "--replays", "1", "--device", "cpu", "--profile"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert '"metric": "resnet18_embedding_images_per_sec"' in lines[0]
    assert '"device_ms_by_category"' in lines[1]


def test_bench_embed_batches_and_bn_dtype_weights():
    a = bench_embed.make_batches(2, 3, 8, 5, torch.device("cpu"))
    b = bench_embed.make_batches(2, 3, 8, 5, torch.device("cpu"))
    assert a.dtype == torch.uint8 and a.shape == (2, 3, 8, 8, 3)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    m16 = bench_embed.build_model("resnet18", "bfloat16", 1, "cpu")
    m32 = bench_embed.build_model("resnet18", "float32", 1, "cpu")
    sd16, sd32 = m16.state_dict(), m32.state_dict()
    assert all(torch.equal(sd16[k], sd32[k]) for k in sd32)
