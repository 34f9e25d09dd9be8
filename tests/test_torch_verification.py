"""The port's verification evaluation against the JAX package and sklearn,
on the same numpy-seeded inputs.

Tolerances:
- folds, ROC thresholds, per-fold thresholds and accuracies: equal. The
  port's numpy folds and ROC curve replace sklearn's and must give its
  exact output; the accuracies are the same count over the same divisor.
- AUC: 1e-12 absolute against sklearn and the JAX host path (a rank sum
  against a trapezoid over the same points, float64).
- the port's device protocol (float64) against its host path: equal
  thresholds and accuracies, AUC to 1e-12; against JAX's device protocol
  (float32): equal thresholds and correct counts on every fold where JAX's
  device path agrees with its own host path, AUC to 1e-6.
- embeddings through a small fp32 ResNet carried by `from_jax`: the raw
  embeddings (before normalising) at tests/test_torch_resnet.py's rtol 2e-3
  with atol 2e-4 x the largest output.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score, roc_curve
from sklearn.model_selection import StratifiedKFold

from face_recognition_models_tpu.data import pairs as jpairs
from face_recognition_models_tpu.evaluation import batch_eval as jbatch
from face_recognition_models_tpu.evaluation import device_protocol as jdev
from face_recognition_models_tpu.evaluation import openset as jopen
from face_recognition_models_tpu.evaluation import verification as jver
from face_recognition_models_tpu.models import resnet as jresnet
from face_recognition_models_tpu_torch.data import pairs as tpairs
from face_recognition_models_tpu_torch.evaluation import batch_eval as tbatch
from face_recognition_models_tpu_torch.evaluation import (
    device_protocol as tdev,
)
from face_recognition_models_tpu_torch.evaluation import openset as topen
from face_recognition_models_tpu_torch.evaluation import verification as tver
from face_recognition_models_tpu_torch.models import resnet as tresnet
from face_recognition_models_tpu_torch.utils.weights import from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers, and these small ops slow down many times over when every
    worker's torch also starts a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scores(p, seed, ties, balanced=True):
    """(float32 cosines, 0/1 labels) of p pairs; ties: rounded to 2
    decimals; unbalanced: about a fifth genuine."""
    rs = np.random.RandomState(seed)
    labels = (rs.randint(0, 2, p) if balanced
              else (rs.rand(p) < 0.2).astype(np.int64))
    sims = 0.3 * labels + 0.25 * rs.randn(p)
    if ties:
        sims = np.round(sims, 2)
    return sims.astype(np.float32), labels


CASES = [(600, 0, False, True), (600, 1, True, True), (6001, 2, True, True),
         (6001, 3, False, True), (997, 4, True, False), (613, 5, False, False)]


@pytest.mark.parametrize("p,seed,ties,balanced", CASES)
def test_folds_match_sklearn(p, seed, ties, balanced):
    sims, labels = _scores(p, seed, ties, balanced)
    for rs_seed in (42, seed):
        want = np.empty(p, np.int64)
        skf = StratifiedKFold(10, shuffle=True, random_state=rs_seed)
        for fold, (_, test) in enumerate(skf.split(sims[:, None], labels)):
            want[test] = fold
        got = tver.stratified_kfold_test_folds(labels, 10, rs_seed)
        np.testing.assert_array_equal(got, want)


def test_folds_encode_classes_by_first_appearance():
    # label 1 appears first: sklearn encodes it as class 0, which changes
    # which RandomState draws each class's fold ids get
    labels = np.array([1, 0] * 7 + [1] * 9)
    want = np.empty(len(labels), np.int64)
    skf = StratifiedKFold(3, shuffle=True, random_state=7)
    for fold, (_, test) in enumerate(skf.split(labels[:, None], labels)):
        want[test] = fold
    np.testing.assert_array_equal(
        tver.stratified_kfold_test_folds(labels, 3, 7), want)
    with pytest.raises(ValueError, match="n_splits"):
        tver.stratified_kfold_test_folds(np.array([0, 1, 1]), 3, 0)


@pytest.mark.parametrize("p,seed,ties,balanced", CASES)
def test_roc_curve_and_auc_match_sklearn(p, seed, ties, balanced):
    sims, labels = _scores(p, seed, ties, balanced)
    for got, want in zip(tver.roc_curve(labels, sims),
                         roc_curve(labels, sims)):
        np.testing.assert_array_equal(got, want)
    assert abs(tver.roc_auc_score(labels, sims)
               - roc_auc_score(labels, sims)) < 1e-12
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn UndefinedMetricWarning
        for got, want in zip(tver.roc_curve(np.ones(5), sims[:5]),
                             roc_curve(np.ones(5), sims[:5])):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="one class"):
        tver.roc_auc_score(np.ones(5), sims[:5])


def _same_result(got, want, auc_tol=1e-12):
    assert got.fold_thresholds == [float(t) for t in want.fold_thresholds]
    np.testing.assert_allclose(got.fold_accuracies, want.fold_accuracies,
                               rtol=1e-12)
    np.testing.assert_allclose(got.fold_aucs, want.fold_aucs, rtol=0,
                               atol=auc_tol)
    assert got.mean_accuracy == pytest.approx(want.mean_accuracy, rel=1e-12)


@pytest.mark.parametrize("p,seed,ties,balanced", CASES)
def test_kfold_matches_jax(p, seed, ties, balanced):
    sims, labels = _scores(p, seed, ties, balanced)
    _same_result(tver.kfold_verification(sims, labels),
                 jver.kfold_verification(sims, labels))
    _same_result(tver.standard_kfold_verification(sims, labels),
                 jver.standard_kfold_verification(sims, labels))


def test_one_class_folds_match_jax():
    """195 genuine / 5 impostor pairs: held-out folds with no impostor make
    sklearn's fpr all NaN and pick the inf threshold."""
    rs = np.random.RandomState(3)
    sims = rs.uniform(-1.0, 1.0, 200).astype(np.float32)
    labels = np.array([1] * 195 + [0] * 5)[rs.permutation(200)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jver.kfold_verification(sims, labels)
    got = tver.kfold_verification(sims, labels)
    assert any(np.isinf(got.fold_thresholds))
    _same_result(got, want)
    dev = tdev.kfold_verification_device(sims, labels, device="cpu")
    assert dev.fold_thresholds == got.fold_thresholds
    assert dev.fold_accuracies == got.fold_accuracies


@pytest.mark.parametrize("p,seed,ties,balanced", CASES)
def test_device_protocol_matches_host_and_jax(p, seed, ties, balanced):
    sims, labels = _scores(p, seed, ties, balanced)
    host = tver.kfold_verification(sims, labels)
    dev = tdev.kfold_verification_device(sims, labels, device="cpu")
    assert dev.fold_thresholds == host.fold_thresholds
    assert dev.fold_accuracies == host.fold_accuracies
    np.testing.assert_allclose(dev.fold_aucs, host.fold_aucs, rtol=0,
                               atol=1e-12)
    # JAX's float32 device path can break an exact tie of Youden's J the
    # other way from its own host path (two thresholds with equal tpr - fpr
    # whose float32 differences round apart); on the folds where it agrees
    # with its host path, the port's must equal it
    jax_dev = jdev.kfold_verification_device(sims, labels)
    jax_host = jver.kfold_verification(sims, labels)
    agree = (np.float32(jax_dev.fold_thresholds)
             == np.float32(jax_host.fold_thresholds))
    assert agree.sum() >= 8
    np.testing.assert_array_equal(
        np.float32(dev.fold_thresholds)[agree],
        np.float32(jax_dev.fold_thresholds)[agree])
    folds = tver.stratified_kfold_test_folds(labels, 10, 42)
    n_test = np.array([(folds != f).sum() for f in range(10)])
    np.testing.assert_array_equal(
        np.round(np.array(dev.fold_accuracies) * n_test / 100)[agree],
        np.round(np.array(jax_dev.fold_accuracies) * n_test / 100)[agree])
    np.testing.assert_allclose(dev.fold_aucs, jax_dev.fold_aucs, rtol=0,
                               atol=1e-6)


def test_device_protocol_keeps_drop_intermediate_points_out():
    """Scores in steps of equal genuine / impostor counts put collinear
    points on the held-out ROC; the device path must drop them as
    roc_curve does before Youden's argmax."""
    rs = np.random.RandomState(11)
    levels = np.repeat(np.linspace(0.9, 0.1, 60), 10)
    labels = np.tile([1, 0], 300)
    sims = (levels + 1e-3 * rs.randint(0, 3, 600)).astype(np.float32)
    host = tver.kfold_verification(sims, labels)
    dev = tdev.kfold_verification_device(sims, labels, device="cpu")
    assert dev.fold_thresholds == host.fold_thresholds
    assert dev.fold_accuracies == host.fold_accuracies


@pytest.mark.parametrize("seed", [0, 1])
def test_tpr_at_far_matches_jax(seed):
    sims, labels = _scores(6001, seed, ties=bool(seed), balanced=True)
    fars = (1e-1, 1e-2, 1e-3, 1e-4, 1.0)
    assert topen.tpr_at_far(sims, labels, fars) == jopen.tpr_at_far(
        sims, labels, fars)
    with pytest.raises(ValueError, match="both"):
        topen.tpr_at_far(sims, np.ones_like(labels))


def test_pair_list_round_trip(tmp_path):
    path = tmp_path / "pair.list"
    path.write_text("1 2 1\n\n3 4 0\nbad line\n5 6 1 extra\n")
    np.testing.assert_array_equal(tpairs.load_pair_list(str(path)),
                                  jpairs.load_pair_list(str(path)))
    good = tmp_path / "good.list"
    good.write_text("a b 1\nc d 0\n")
    assert tpairs.pair_image_names(str(good)) == jpairs.pair_image_names(
        str(good))
    with pytest.raises(ValueError, match="3 elements"):
        tpairs.pair_image_names(str(path))
    root = str(tmp_path)
    assert tpairs.benchmark_paths(root, "lfw") == jpairs.benchmark_paths(
        root, "lfw")
    (tmp_path / "lfw.bin").write_bytes(b"")
    for bench in ("lfw", "lfw.bin", "cfp_fp"):
        assert tpairs.bin_path(root, bench) == jpairs.bin_path(root, bench)


def test_bin_round_trip(tmp_path):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (6, 20, 20, 3), np.uint8)
    issame = np.array([1, 0, 1])
    path = str(tmp_path / "b.bin")
    tpairs.save_bin(path, images, issame)
    jpath = str(tmp_path / "j.bin")
    jpairs.save_bin(jpath, images, issame)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    for size in (20, 16):
        got = tpairs.load_bin(path, size)
        want = jpairs.load_bin(path, size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_bin_of_arrays_loads_without_pil(tmp_path, monkeypatch):
    import builtins
    import pickle

    rs = np.random.RandomState(1)
    arrays = list(rs.randint(0, 256, (4, 12, 12, 3), np.uint8))
    path = str(tmp_path / "a.bin")
    with open(path, "wb") as f:
        pickle.dump((arrays, [True, False]), f)
    want = jpairs.load_bin(path, 12)
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name.split(".")[0] == "PIL":
            raise ImportError("PIL is not installed")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = tpairs.load_bin(path, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ImportError, match="PIL"):
        tpairs.load_bin(path, 10)  # a resize needs PIL


def _jitter(stats, rs):
    """Running statistics moved off (0, 1), not so far that the last
    stage's ReLUs zero whole embeddings."""
    if "mean" in stats:
        return {"mean": np.asarray(stats["mean"]) + rs.uniform(
                    -0.2, 0.2, stats["mean"].shape).astype(np.float32),
                "var": np.asarray(stats["var"]) * rs.uniform(
                    0.5, 2.0, stats["var"].shape).astype(np.float32)}
    return {k: _jitter(v, rs) for k, v in stats.items()}


def _small_resnet(seed):
    jmodel = jresnet.ResNet(stage_sizes=(1, 1), block=jresnet.BasicBlock,
                            embed_dim=16, num_filters=8, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 24, 24, 3)), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _jitter(variables["batch_stats"], np.random.RandomState(seed))
    tmodel = tresnet.ResNet((1, 1), tresnet.BasicBlock, embed_dim=16,
                            num_filters=8, dtype=torch.float32)
    sd, _ = from_jax(params, stats)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, params, stats, tmodel


def _recording(embed_fn, calls):
    def wrapped(images):
        out = embed_fn(images)
        calls.append(np.array(out))
        return out
    return wrapped


@pytest.mark.parametrize("flip", [False, True])
def test_embed_unique_images_matches_jax(flip):
    jmodel, params, stats, tmodel = _small_resnet(0)
    images = np.random.RandomState(2).randint(0, 256, (11, 24, 24, 3),
                                              np.uint8)
    jcalls, tcalls = [], []
    with jax.default_matmul_precision("float32"):
        want = jver.embed_unique_images(
            _recording(jbatch.make_embed_fn(jmodel, params, stats), jcalls),
            images, batch_size=4, flip=flip)
    got = tver.embed_unique_images(
        _recording(tbatch.make_embed_fn(tmodel, device="cpu"), tcalls),
        images, batch_size=4, flip=flip)
    assert len(tcalls) == len(jcalls) == (6 if flip else 3)
    for t, j in zip(tcalls, jcalls):
        assert t.shape == j.shape == (4, 16)
        np.testing.assert_allclose(t, j, rtol=2e-3,
                                   atol=2e-4 * float(np.abs(j).max()))
    assert got.shape == want.shape == (11, 16)
    raw = np.concatenate([a + b for a, b in zip(tcalls[::2], tcalls[1::2])]
                         if flip else tcalls)[:11]
    np.testing.assert_allclose(
        got, raw / np.linalg.norm(raw, axis=1, keepdims=True), rtol=1e-6,
        atol=1e-7)


def test_evaluate_benchmark_matches_jax_on_the_same_embeddings():
    rs = np.random.RandomState(4)
    proj = rs.randn(6 * 6 * 3, 8).astype(np.float32)

    def jax_embed(images):
        return np.asarray(images, np.float32).reshape(len(images), -1) @ proj

    def torch_embed(images):
        return torch.from_numpy(jax_embed(images))

    images_by_id = {i * 3: rs.randint(0, 256, (6, 6, 3), np.uint8)
                    for i in range(40)}
    ids = sorted(images_by_id)
    pairs = np.array([(ids[rs.randint(40)], ids[rs.randint(40)],
                       rs.randint(2)) for _ in range(120)])
    got = tver.evaluate_benchmark(torch_embed, pairs, images_by_id, 16)
    want = jver.evaluate_benchmark(jax_embed, pairs, images_by_id, 16)
    _same_result(got, want)


def test_evaluation_modules_import_no_sklearn_pandas_or_pil():
    import subprocess
    import sys
    code = ("import sys, face_recognition_models_tpu_torch.evaluation."
            "batch_eval, face_recognition_models_tpu_torch.evaluation."
            "device_protocol, face_recognition_models_tpu_torch.cli.main;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sklearn', 'pandas', 'PIL', 'scipy'}))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": repo})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
