"""The port's identity-tree index and JPEG loader against the JAX package's
on the same seeded trees (written with PIL at 16-32 px under tmp_path):

- `ImageFolderIndex` (build, concat, the one `random.Random` shuffle) gives
  the JAX samples exactly;
- `Loader` gives the JAX loader's batches bitwise, with the PIL and the
  native backends, sharded or not, and with a corrupt file resampled by the
  same law (`random.Random(seed * 1000003 + epoch)`);
- the JAX package's own data tests, case by case where the port has the
  module (tests/test_data.py);
- the native decoder's build (the git-ignored build/native/, no
  -march=native), its refusal with the build error, and the committed
  JPEG fixture that chip_smoke.py decodes on the card.

The native-decoder cases skip only where `is_available()` is False.
"""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from face_recognition_models_tpu.data import ImageFolderIndex as JIndex
from face_recognition_models_tpu.data import Loader as JLoader
from face_recognition_models_tpu.data.synthetic import (
    synthetic_identities,
    write_identity_tree,
)
from face_recognition_models_tpu.native import is_available as jax_native
from face_recognition_models_tpu_torch.data import (
    ArrayLoader,
    ImageFolderIndex,
    Loader,
)
from face_recognition_models_tpu_torch.data.index import index_tree
from face_recognition_models_tpu_torch.data.pipeline import (
    _decode_image,
    prefetched,
)
from face_recognition_models_tpu_torch.native import fastdecode
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "jpeg_fixture")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def native():
    if not fastdecode.is_available():
        pytest.skip(f"native decoder unavailable: {fastdecode.build_error()}")
    if not jax_native():
        pytest.skip("the JAX package's native decoder is unavailable")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("casia")
    images, labels = synthetic_identities(num_classes=5, per_class=6,
                                          image_size=32, seed=0)
    write_identity_tree(str(root), images, labels, split="train")
    write_identity_tree(str(root), images[::2], labels[::2], split="valid")
    return str(root)


def _copy(tree, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    return str(root)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)
        assert ia.dtype == ib.dtype == np.uint8
        assert la.dtype == lb.dtype == np.int32


# --- the index -------------------------------------------------------------

def test_index_build(tree):
    idx = ImageFolderIndex.build(tree, split="train")
    assert len(idx) == 30
    assert idx.num_identities == 5
    assert set(idx.labels()) == set(range(5))


def test_index_missing_dir_raises(tree):
    with pytest.raises(FileNotFoundError):
        ImageFolderIndex.build(tree, split="nope")


def test_index_concat(tree):
    a = ImageFolderIndex.build(tree, split="train")
    b = ImageFolderIndex.build(tree, split="valid")
    both = ImageFolderIndex.concat([a, b])
    assert len(both) == len(a) + len(b)
    assert both.num_identities == 5
    with pytest.raises(ValueError, match="zero"):
        ImageFolderIndex.concat([])


@pytest.mark.parametrize("split", ["train", "valid"])
@pytest.mark.parametrize("shuffle_seed", [0, 3, None])
def test_index_matches_jax(tree, split, shuffle_seed):
    got = ImageFolderIndex.build(tree, split=split, shuffle_seed=shuffle_seed)
    want = JIndex.build(tree, split=split, shuffle_seed=shuffle_seed)
    assert got.samples == want.samples
    assert got.identities == want.identities
    assert got.class_to_idx == want.class_to_idx
    assert got.idx_to_class == want.idx_to_class
    assert got.absolute_paths() == want.absolute_paths()
    assert got.labels() == want.labels()


def test_index_concat_matches_jax(tree):
    got = ImageFolderIndex.concat([ImageFolderIndex.build(tree, split=s)
                                   for s in ("train", "valid")])
    want = JIndex.concat([JIndex.build(tree, split=s)
                          for s in ("train", "valid")])
    assert got.samples == want.samples
    assert got.absolute_paths() == want.absolute_paths()


def test_index_tree_layouts(tree, tmp_path):
    """`train` and `pack` read <P>/CASIA-WebFace/{train,valid} (concat),
    <P>/CASIA-WebFace/<id>/ and a bare <P>/<id>/ tree."""
    casia = tmp_path / "a" / "CASIA-WebFace"
    shutil.copytree(tree, casia)
    want = JIndex.concat([JIndex.build(str(casia), split=s)
                          for s in ("train", "valid")])
    assert index_tree(str(tmp_path / "a")).samples == want.samples
    bare = os.path.join(tree, "train")
    assert index_tree(bare).samples == JIndex.build(bare).samples
    flat = tmp_path / "b" / "CASIA-WebFace"
    shutil.copytree(bare, flat)
    assert (index_tree(str(tmp_path / "b")).samples
            == JIndex.build(str(flat)).samples)


# --- the loader ------------------------------------------------------------

def test_loader_batches(tree):
    idx = ImageFolderIndex.build(tree, split="train")
    loader = Loader(idx, batch_size=8, image_size=32, num_workers=2, seed=1)
    assert loader.steps_per_epoch() == 3
    batches = list(loader.epoch(0))
    assert len(batches) == 3
    for images, labels in batches:
        assert images.shape == (8, 32, 32, 3) and images.dtype == np.uint8
        assert labels.shape == (8,) and labels.dtype == np.int32
    b0 = list(loader.epoch(0))[0][1]
    b1 = list(loader.epoch(1))[0][1]
    assert not np.array_equal(b0, b1)


@pytest.mark.parametrize("size", [32, 24])
@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_pil_loader_matches_jax(tree, size, shard):
    idx, jidx = (ImageFolderIndex.build(tree, split="train"),
                 JIndex.build(tree, split="train"))
    for epoch in (0, 3):
        got = Loader(idx, batch_size=4, image_size=size, num_workers=2,
                     seed=5, backend="pil", shard=shard,
                     drop_remainder=False)
        want = JLoader(jidx, batch_size=4, image_size=size, num_workers=2,
                       seed=5, backend="pil", shard=shard,
                       drop_remainder=False)
        assert got.backend == want.backend == "pil"
        assert got.steps_per_epoch() == want.steps_per_epoch()
        _same_batches(got.epoch(epoch), want.epoch(epoch))


@pytest.mark.parametrize("shard", [None, (0, 3)])
def test_native_loader_matches_jax(native, tree, shard):
    """Both packages' decoders run the same C++ on the same libjpeg; at the
    source size (no resample) their batches are bitwise equal."""
    idx, jidx = (ImageFolderIndex.build(tree, split="valid"),
                 JIndex.build(tree, split="valid"))
    got = Loader(idx, batch_size=4, image_size=32, num_workers=2, seed=2,
                 backend="native", shard=shard)
    want = JLoader(jidx, batch_size=4, image_size=32, num_workers=2, seed=2,
                   backend="native", shard=shard)
    assert got.backend == want.backend == "native"
    _same_batches(got.epoch(1), want.epoch(1))
    auto = Loader(idx, batch_size=4, image_size=32, seed=2)
    assert auto.backend == "native"


def test_loader_corrupt_image_resampled(tree, tmp_path):
    """A corrupt file must not shrink the batch (static shapes): it is
    resampled and counted."""
    idx = ImageFolderIndex.build(_copy(tree, tmp_path), split="train")
    victim = os.path.join(idx.root, idx.samples[0][0])
    with open(victim, "wb") as f:
        f.write(b"not a jpeg")
    loader = Loader(idx, batch_size=30, image_size=32, num_workers=2,
                    shuffle=False)
    images, labels = next(loader.epoch(0))
    assert images.shape[0] == 30
    assert loader.skipped_images >= 1


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_corrupt_resample_law_matches_jax(tree, tmp_path, backend):
    """One corrupt file, replaced by the index the (seed, epoch) stream
    draws first: the same replacement, batch and count as the JAX
    loader's."""
    if backend == "native" and not (fastdecode.is_available()
                                    and jax_native()):
        pytest.skip(f"native decoder unavailable: {fastdecode.build_error()}")
    root = _copy(tree, tmp_path)
    idx, jidx = (ImageFolderIndex.build(root, split="train"),
                 JIndex.build(root, split="train"))
    with open(os.path.join(idx.root, idx.samples[4][0]), "wb") as f:
        f.write(b"corrupt")
    got = Loader(idx, batch_size=10, image_size=32, num_workers=2, seed=7,
                 backend=backend, shuffle=False)
    want = JLoader(jidx, batch_size=10, image_size=32, num_workers=2, seed=7,
                   backend=backend, shuffle=False)
    _same_batches(got.epoch(2), want.epoch(2))
    assert got.skipped_images == want.skipped_images == 1


def test_native_decoder_matches_loader_contract(native, tree):
    """Native and PIL backends: the same shapes and labels, pixels close
    (the same libjpeg DCT; PIL may round differently)."""
    idx = ImageFolderIndex.build(tree, split="train")
    nat = Loader(idx, batch_size=8, image_size=32, backend="native",
                 shuffle=False)
    pil = Loader(idx, batch_size=8, image_size=32, backend="pil",
                 shuffle=False)
    assert nat.backend == "native" and pil.backend == "pil"
    (im_n, lb_n), (im_p, lb_p) = next(nat.epoch(0)), next(pil.epoch(0))
    np.testing.assert_array_equal(lb_n, lb_p)
    assert im_n.shape == im_p.shape == (8, 32, 32, 3)
    assert np.abs(im_n.astype(int) - im_p.astype(int)).mean() < 2.0


def test_native_decoder_corrupt_resample(native, tree, tmp_path):
    idx = ImageFolderIndex.build(_copy(tree, tmp_path), split="train")
    with open(os.path.join(idx.root, idx.samples[2][0]), "wb") as f:
        f.write(b"corrupt")
    loader = Loader(idx, batch_size=len(idx), image_size=32,
                    backend="native", shuffle=False)
    images, labels = next(loader.epoch(0))
    assert images.shape[0] == len(idx)
    assert loader.skipped_images >= 1


def test_loader_sharding_partitions_epoch(tmp_path):
    """shard=(rank, count): one agreed shuffle, disjoint slices, and every
    rank yields exactly n // count samples."""
    images, labels = synthetic_identities(5, 5, image_size=8, seed=0)
    write_identity_tree(str(tmp_path), images, labels, split="train")
    index = ImageFolderIndex.build(str(tmp_path), split="train")
    n = len(index)  # 25: not divisible by 3 ranks
    seen, steps = [], set()
    for rank in range(3):
        loader = Loader(index, batch_size=4, image_size=8, num_workers=1,
                        seed=5, shard=(rank, 3), drop_remainder=False)
        steps.add(loader.steps_per_epoch())
        got = []
        for _imgs, lbs in loader.epoch(2):
            got.extend(int(x) for x in lbs)
        seen.append(got)
    assert len(steps) == 1
    assert [len(s) for s in seen] == [n // 3] * 3
    with pytest.raises(ValueError, match="bad shard"):
        Loader(index, batch_size=4, image_size=8, shard=(3, 3))


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_loader_all_corrupt_raises(tree, tmp_path, backend):
    """When no resample decodes, the loader fails loudly instead of
    training labels on black images."""
    if backend == "native" and not fastdecode.is_available():
        pytest.skip(f"native decoder unavailable: {fastdecode.build_error()}")
    root = tmp_path / "allbad"
    shutil.copytree(tree, root)
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "wb") as fh:
                fh.write(b"corrupt")
    loader = Loader(ImageFolderIndex.build(str(root), split="train"),
                    batch_size=4, image_size=16, backend=backend,
                    num_workers=2)
    with pytest.raises(RuntimeError, match="corrupt"):
        for _ in loader.epoch(0):
            pass


def test_loader_rejects_an_unknown_backend(tree):
    idx = ImageFolderIndex.build(tree, split="train")
    with pytest.raises(ValueError, match="unknown backend"):
        Loader(idx, batch_size=4, backend="turbo")


def test_array_loader():
    images, labels = synthetic_identities(3, 4, image_size=16)
    loader = ArrayLoader(images, labels, batch_size=4, seed=0)
    assert loader.steps_per_epoch() == 3
    for im, lb in loader.epoch(0):
        assert im.shape == (4, 16, 16, 3)


def test_prefetched_surfaces_errors_and_stops_early():
    def failing():
        yield 1
        raise ValueError("decode failed")

    it = prefetched(failing, 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)

    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = prefetched(endless, 2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
    assert len(made) <= 3 + 2 + 2


# --- the native decoder ----------------------------------------------------

def test_native_library_is_built_in_the_ignored_build_dir(native):
    path = fastdecode.library_path()
    assert path.parent == fastdecode.BUILD_DIR
    assert fastdecode.BUILD_DIR.relative_to(REPO).parts == ("build", "native")
    assert path.name.startswith("libfastdecode-") and path.exists()
    assert not any("march" in f for f in fastdecode.CXX_FLAGS)
    assert fastdecode.build_error() is None


def test_native_backend_refuses_with_the_build_error(tree, monkeypatch):
    monkeypatch.setattr(fastdecode, "_lib", None)
    monkeypatch.setattr(fastdecode, "_build_error", "g++ failed: no jpeglib")
    assert not fastdecode.is_available()
    assert fastdecode.build_error() == "g++ failed: no jpeglib"
    idx = ImageFolderIndex.build(tree, split="train")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed: no jpeglib"):
        Loader(idx, batch_size=4, backend="native")
    assert Loader(idx, batch_size=4).backend == "pil"
    with pytest.raises(RuntimeError, match="unavailable"):
        fastdecode.decode_batch([], 8)


def test_decode_batch_rejects_a_bad_out_buffer(native):
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        fastdecode.decode_batch(["x.jpg"], 8,
                                out=np.empty((1, 8, 8, 3), np.float32))


def test_jpeg_fixture(native):
    """The committed fixture (tests/data/make_jpeg_fixture.py) that
    chip_smoke.py decodes on the card: PIL gives the committed .npy
    exactly, the native decoder within the mean abs diff of 2.0 that the
    JAX test allows between the two."""
    names = sorted(f for f in os.listdir(FIXTURE) if f.endswith(".jpg"))
    want = np.load(os.path.join(FIXTURE, "pil_112.npy"))
    assert len(names) == len(want) >= 4
    paths = [os.path.join(FIXTURE, f) for f in names]
    pil = np.stack([_decode_image(p, 112) for p in paths])
    np.testing.assert_array_equal(pil, want)
    got, status = fastdecode.decode_batch(paths, 112, n_threads=2)
    assert not status.any()
    assert np.abs(got.astype(int) - want.astype(int)).mean() < 2.0
