"""The port's 1:N identification (evaluation/openset.py) on the CPU against
the JAX package's functions on the same embeddings: CMC and TPIR exactly,
pooled scores within 1e-6 (tests/test_openset.py's bound for the device
path against the host path), `identify_from_npz` and the `identify` CLI
with --min-quality, --pool and --pool-weight. The port scores with
device='cpu' here; by default it scores on the card."""

import numpy as np
import pytest
import torch

from face_recognition_models_tpu.evaluation import openset as jopen
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.evaluation import openset as topen
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _gallery(seed, identities=12, per=3, d=16, noise=0.6, probes=40,
             unknown=0):
    """Identities on random prototypes with `per` noisy gallery images each
    (ids shuffled, not contiguous) and `probes` noisy probes, the first
    `unknown` of them of identities absent from the gallery."""
    rng = np.random.default_rng(seed)
    protos = _unit(rng.normal(size=(identities + unknown, d)))
    gal_ids = rng.permutation(np.repeat(np.arange(identities) * 7, per))
    gal = _unit(protos[gal_ids // 7] + rng.normal(0, noise, (len(gal_ids), d)))
    probe_ids = rng.integers(0, identities, probes) * 7
    probe_ids[:unknown] = 1000 + np.arange(unknown)
    rows = np.where(probe_ids >= 1000, identities + probe_ids - 1000,
                    probe_ids // 7)
    probe = _unit(protos[rows] + rng.normal(0, noise, (probes, d)))
    return gal, gal_ids, probe, probe_ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_per_identity_matches_jax(seed):
    gal, gal_ids, probe, _ = _gallery(seed)
    scores = probe @ gal.T
    got, uniq = topen._best_per_identity(scores, gal_ids)
    want, juniq = jopen._best_per_identity(scores, gal_ids)
    np.testing.assert_array_equal(uniq, juniq)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [4, 7, 256])
@pytest.mark.parametrize("seed", [0, 3])
def test_pooled_scores_device_on_cpu_matches_host(seed, chunk):
    """The chunked device path (padded last chunk, scatter_reduce amax) on
    the CPU against the port's and the JAX package's host pooling."""
    gal, gal_ids, probe, _ = _gallery(seed, probes=11)
    got, uniq = topen.pooled_scores_device(gal, gal_ids, probe, chunk=chunk,
                                           device="cpu")
    want, juniq = jopen._best_per_identity(probe @ gal.T, gal_ids)
    np.testing.assert_array_equal(uniq, juniq)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    jdev, _ = jopen.pooled_scores_device(gal, gal_ids, probe, chunk=chunk)
    np.testing.assert_allclose(got, jdev, atol=1e-6)


@pytest.mark.parametrize("jax_device", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_closed_set_matches_jax(seed, jax_device):
    """Against the JAX package's host product and its device path."""
    gal, gal_ids, probe, probe_ids = _gallery(seed)
    got = topen.closed_set_identification(gal, gal_ids, probe, probe_ids,
                                          ranks=(1, 2, 5), device="cpu")
    want = jopen.closed_set_identification(gal, gal_ids, probe, probe_ids,
                                           ranks=(1, 2, 5),
                                           device=jax_device)
    assert got.cmc == want.cmc
    assert 0.0 < got.cmc[1] < 100.0  # the noise makes some probes miss
    assert str(got) == str(want)


def test_closed_set_rejects_unknown_probe_ids():
    gal, gal_ids, probe, probe_ids = _gallery(0, unknown=2)
    for module in (topen, jopen):
        with pytest.raises(ValueError, match="missing from the gallery"):
            module.closed_set_identification(gal, gal_ids, probe, probe_ids,
                                             device="cpu" if module is topen
                                             else False)


@pytest.mark.parametrize("jax_device", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_open_set_matches_jax(seed, jax_device):
    gal, gal_ids, probe, probe_ids = _gallery(seed, unknown=15)
    fpirs = (0.0, 0.1, 0.5, 1.0)
    got = topen.open_set_identification(gal, gal_ids, probe, probe_ids,
                                        fpirs=fpirs, ranks=(1, 3),
                                        device="cpu")
    want = jopen.open_set_identification(gal, gal_ids, probe, probe_ids,
                                         fpirs=fpirs, ranks=(1, 3),
                                         device=jax_device)
    assert got.cmc == want.cmc
    assert got.tpir_at_fpir == want.tpir_at_fpir
    assert got.thresholds == want.thresholds
    assert str(got) == str(want)


def test_open_set_tie_convention_and_both_populations():
    """An exact tie counts as rank 1 (as in the JAX package), and the
    protocol needs mated and non-mated probes."""
    gal = _unit(np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]))
    gal_ids = np.array([5, 3, 9])
    probe = _unit(np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.2]]))
    probe_ids = np.array([5, 9, 77])
    got = topen.open_set_identification(gal, gal_ids, probe, probe_ids,
                                        fpirs=(0.5,), device="cpu")
    want = jopen.open_set_identification(gal, gal_ids, probe, probe_ids,
                                         fpirs=(0.5,))
    assert got.cmc == want.cmc == {1: 100.0}
    assert got.tpir_at_fpir == want.tpir_at_fpir
    with pytest.raises(ValueError, match="both mated and non-mated"):
        topen.open_set_identification(gal, gal_ids, gal, gal_ids,
                                      device="cpu")


@pytest.mark.parametrize("weighted", [False, True])
def test_pool_templates_matches_jax(weighted):
    rng = np.random.default_rng(7)
    ids = np.array(["b", "a", "b", "c", "a", "b"])
    emb = _unit(rng.normal(size=(6, 8)))
    w = rng.uniform(0.1, 1.0, 6).astype(np.float32) if weighted else None
    got, uniq = topen.pool_templates(emb, ids, w)
    want, juniq = jopen.pool_templates(emb, ids, w)
    assert list(uniq) == list(juniq) == ["a", "b", "c"]
    np.testing.assert_array_equal(got, want)


def _npz(path, emb, ids, quality=None, prefix="g"):
    paths = np.array([f"{prefix}/id{i}/{n}.jpg" for n, i in enumerate(ids)])
    extra = {} if quality is None else {"quality": quality}
    np.savez(path, embeddings=emb, paths=paths, **extra)
    return str(path)


@pytest.fixture()
def archives(tmp_path):
    """A gallery and two probe .npz archives in `embed`'s format, with
    quality scores: `closed` (every probe identity in the gallery) and
    `open` (a third of them absent)."""
    gal, gal_ids, probe, probe_ids = _gallery(8, probes=30)
    rng = np.random.default_rng(9)
    g = _npz(tmp_path / "g.npz", gal, gal_ids,
             rng.uniform(0, 1, len(gal_ids)).astype(np.float32))
    q = rng.uniform(0, 1, len(probe_ids)).astype(np.float32)
    closed = _npz(tmp_path / "closed.npz", probe, probe_ids, q, "p")
    open_ids = probe_ids.copy()
    open_ids[:10] = 999
    opened = _npz(tmp_path / "open.npz", probe, open_ids, q, "p")
    return g, closed, opened


@pytest.mark.parametrize("pool,pool_weight,min_quality", [
    ("none", "none", 0.0), ("none", "none", 0.3), ("probes", "none", 0.0),
    ("gallery", "quality", 0.0), ("both", "quality", 0.2)])
@pytest.mark.parametrize("probes", ["closed", "open"])
def test_identify_from_npz_matches_jax(archives, probes, pool, pool_weight,
                                       min_quality):
    g, closed, opened = archives
    p = closed if probes == "closed" else opened
    kw = dict(ranks=(1, 5), fpirs=(0.1, 0.5), min_quality=min_quality,
              pool=pool, pool_weight=pool_weight)
    got = topen.identify_from_npz(g, p, device="cpu", **kw)
    want = jopen.identify_from_npz(g, p, **kw)
    assert got.cmc == want.cmc
    assert got.tpir_at_fpir == want.tpir_at_fpir
    assert bool(got.tpir_at_fpir) == (probes == "open")
    assert str(got) == str(want)


def test_identify_from_npz_errors(archives, tmp_path):
    g, closed, _ = archives
    with pytest.raises(ValueError, match="removes every"):
        topen.identify_from_npz(g, closed, min_quality=1.01)
    with pytest.raises(ValueError, match="pool must be"):
        topen.identify_from_npz(g, closed, pool="all")
    with pytest.raises(ValueError, match="pool_weight must be"):
        topen.identify_from_npz(g, closed, pool="probes", pool_weight="x")
    bare = _npz(tmp_path / "bare.npz", np.eye(3, dtype=np.float32),
                np.arange(3), prefix="p")
    with pytest.raises(ValueError, match="no 'quality' field"):
        topen.identify_from_npz(g, bare, min_quality=0.5)
    with pytest.raises(ValueError, match="no 'quality' field"):
        topen.identify_from_npz(g, bare, pool="probes",
                                pool_weight="quality")


@pytest.mark.parametrize("flags", [
    [], ["--min-quality", "0.3"], ["--pool", "gallery"],
    ["--pool", "both", "--pool-weight", "quality"]])
def test_identify_cli_matches_jax(archives, flags, capsys):
    g, closed, opened = archives
    for probes in (closed, opened):
        assert cli(["identify", "--gallery", g, "--probes", probes,
                    "--ranks", "1,5", "--fpir", "1e-1,5e-1",
                    "--device", "cpu"] + flags) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        opts = dict(zip(flags[::2], flags[1::2]))
        want = jopen.identify_from_npz(
            g, probes, ranks=(1, 5), fpirs=(0.1, 0.5),
            min_quality=float(opts.get("--min-quality", 0.0)),
            pool=opts.get("--pool", "none"),
            pool_weight=opts.get("--pool-weight", "none"))
        assert out == str(want)


def test_identify_scores_on_the_card_by_default(archives):
    """Without a device the scoring goes to the card, and fails without
    one, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    g, closed, _ = archives
    gal, gal_ids, probe, probe_ids = _gallery(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topen.closed_set_identification(gal, gal_ids, probe, probe_ids)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topen.identify_from_npz(g, closed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli(["identify", "--gallery", g, "--probes", closed])
