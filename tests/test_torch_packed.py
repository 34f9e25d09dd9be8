"""The port's packed datasets (`pack` -> PackedLoader) against the JAX
package's, on small seeded JPEG trees under tmp_path:

- the format byte for byte: a pack written by either package opens in the
  other, with the same images, labels and identities;
- `PackedLoader` gives the JAX PackedLoader's batches bitwise, and the JPEG
  Loader's batches of the tree it was packed from (same seed, epoch and
  shard);
- the truncated-pack and version refusals, the producer's exception;
- `pack_from_loader` over any loader with the two fields it reads (the
  wrapper chip_smoke.py packs seeded arrays with);
- the CLI: `pack` writes what `pack_dataset` writes, `train --dataset-path`
  on a tree and on its pack (--device cpu) gives equal, finite losses, and
  the refusals of the JAX CLI (no dataset, too many identities).
The JAX package's tests/test_packed.py, case by case.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from face_recognition_models_tpu.data import ImageFolderIndex as JIndex
from face_recognition_models_tpu.data import packed as jpacked
from face_recognition_models_tpu.data.synthetic import (
    synthetic_identities,
    write_identity_tree,
)
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data import (
    ArrayLoader,
    ImageFolderIndex,
    Loader,
)
from face_recognition_models_tpu_torch.data.packed import (
    PackedDataset,
    PackedLoader,
    is_packed_dir,
    pack_dataset,
    pack_from_loader,
)
from face_recognition_models_tpu_torch.data.pipeline import _decode_image


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def packed_pair(tmp_path_factory):
    """(tree root, port pack, JAX pack) over a small synthetic JPEG tree."""
    root = tmp_path_factory.mktemp("casia")
    images, labels = synthetic_identities(num_classes=4, per_class=8,
                                          image_size=32, seed=3)
    write_identity_tree(str(root), images, labels, split="train")
    out = str(tmp_path_factory.mktemp("pack"))
    pack_dataset(ImageFolderIndex.build(str(root), split="train"), out,
                 image_size=32, num_workers=2)
    jout = str(tmp_path_factory.mktemp("jpack"))
    jpacked.pack_dataset(JIndex.build(str(root), split="train"), jout,
                         image_size=32, num_workers=2)
    return str(root), out, jout


def test_pack_roundtrip_matches_decoded_files(packed_pair):
    root, out, _ = packed_pair
    index = ImageFolderIndex.build(root, split="train")
    assert is_packed_dir(out)
    ds = PackedDataset.open(out)
    assert len(ds) == len(index) == 32
    assert ds.image_size == 32
    assert ds.num_identities == 4
    # sample i of the pack is the decode of sample i of the index
    for i in (0, 7, 31):
        ref = _decode_image(index.absolute_paths()[i], 32)
        np.testing.assert_array_equal(ds.images[i], ref)
        assert ds.labels[i] == index.labels()[i]


def test_pack_files_equal_the_jax_pack(packed_pair):
    _, out, jout = packed_pair
    for name in ("images.u8", "labels.npy"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(jout, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out, "meta.json")) as a, \
            open(os.path.join(jout, "meta.json")) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_pack_opens_in_either_package(packed_pair, writer):
    _, out, jout = packed_pair
    path = out if writer == "port" else jout
    got, want = PackedDataset.open(path), jpacked.PackedDataset.open(path)
    np.testing.assert_array_equal(np.asarray(got.images),
                                  np.asarray(want.images))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.int32
    assert (got.image_size, got.identities) == (want.image_size,
                                                want.identities)


def test_packed_loader_matches_jpeg_loader(packed_pair):
    """Same (seed, epoch, shard) => byte-identical batches vs Loader."""
    root, out, _ = packed_pair
    index = ImageFolderIndex.build(root, split="train")
    ds = PackedDataset.open(out)
    for shard in (None, (1, 2)):
        jpeg = Loader(index, batch_size=8, image_size=32, num_workers=2,
                      seed=5, shard=shard)
        packed = PackedLoader(ds, batch_size=8, seed=5, shard=shard)
        assert packed.steps_per_epoch() == jpeg.steps_per_epoch()
        pairs = list(zip(packed.epoch(2), jpeg.epoch(2)))
        assert len(pairs) == jpeg.steps_per_epoch()
        for (pi, pl), (ji, jl) in pairs:
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("shard", [None, (0, 3), (2, 3)])
@pytest.mark.parametrize("drop", [True, False])
def test_packed_loader_matches_jax(packed_pair, shard, drop):
    _, out, _ = packed_pair
    got = PackedLoader(PackedDataset.open(out), batch_size=5, seed=4,
                       shard=shard, drop_remainder=drop)
    want = jpacked.PackedLoader(jpacked.PackedDataset.open(out),
                                batch_size=5, seed=4, shard=shard,
                                drop_remainder=drop)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    for epoch in (0, 1):
        pairs = list(zip(got.epoch(epoch), want.epoch(epoch)))
        assert len(pairs) == want.steps_per_epoch()
        for (gi, gl), (wi, wl) in pairs:
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_packed_loader_epoch_reshuffles(packed_pair):
    _, out, _ = packed_pair
    loader = PackedLoader(PackedDataset.open(out), batch_size=16, seed=0)
    l0 = np.concatenate([lb for _, lb in loader.epoch(0)])
    l1 = np.concatenate([lb for _, lb in loader.epoch(1)])
    assert not np.array_equal(l0, l1)
    assert sorted(l0) == sorted(l1)
    with pytest.raises(ValueError, match="bad shard"):
        PackedLoader(PackedDataset.open(out), batch_size=4, shard=(2, 2))


def test_packed_loader_producer_error_surfaces(packed_pair):
    _, out, _ = packed_pair
    ds = PackedDataset.open(out)

    class Broken:
        shape = ds.images.shape

        def __getitem__(self, idx):
            raise OSError("read failed (synthetic)")

    ds.images = Broken()
    with pytest.raises(OSError, match="read failed"):
        list(PackedLoader(ds, batch_size=4, seed=0).epoch(0))


def test_packed_version_check(packed_pair, tmp_path):
    _, out, _ = packed_pair
    bad = tmp_path / "bad_pack"
    shutil.copytree(out, bad)
    with open(bad / "meta.json") as f:
        meta = json.load(f)
    meta["format_version"] = 999
    with open(bad / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format"):
        PackedDataset.open(str(bad))
    with pytest.raises(FileNotFoundError, match="not a packed"):
        PackedDataset.open(str(tmp_path))


def test_truncated_pack_rejected(packed_pair, tmp_path):
    _, out, _ = packed_pair
    bad = tmp_path / "trunc_pack"
    shutil.copytree(out, bad)
    with open(bad / "images.u8", "r+b") as f:
        f.truncate(100)
    with pytest.raises(ValueError, match="truncated or corrupt"):
        PackedDataset.open(str(bad))


class _PackableArrays(ArrayLoader):
    """An ArrayLoader with the two fields pack_from_loader reads (as
    chip_smoke.py packs its seeded arrays): one unshuffled full pass."""

    def __init__(self, images, labels, batch_size):
        super().__init__(images, labels, batch_size, shuffle=False,
                         drop_remainder=False)
        self.dataset = images
        self.skipped_images = 0


def test_pack_from_loader_over_arrays(tmp_path):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (23, 16, 16, 3), np.uint8)
    labels = rs.randint(0, 5, 23).astype(np.int32)
    meta = pack_from_loader(_PackableArrays(images, labels, 8),
                            [str(i) for i in range(5)], str(tmp_path), 16)
    assert meta["num_samples"] == 23 and meta["skipped_images"] == 0
    got = PackedLoader(PackedDataset.open(str(tmp_path)), batch_size=4,
                       seed=1)
    want = ArrayLoader(images, labels, batch_size=4, seed=1)
    for (gi, gl), (wi, wl) in zip(got.epoch(3), want.epoch(3)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    # a pass shorter than the loader's length is refused
    short = _PackableArrays(images, labels, 8)
    short.dataset = np.zeros((30,))
    with pytest.raises(RuntimeError, match="packed 23 of 30"):
        pack_from_loader(short, ["0"], str(tmp_path / "short"), 16)


# --- the CLI ---------------------------------------------------------------

def _losses(text):
    return [float(x) for x in re.findall(r"\] loss (\S+)", text)]


def _train(path, work, *extra):
    return cli(["train", "--dataset-path", path, "--device", "cpu",
                "--working-path", str(work), "--batch_size", "8",
                "--epochs", "1", "--num-classes", "4", "--image-size", "16",
                "--num-workers", "2", "--print_freq", "1", *extra])


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("small")
    images, labels = synthetic_identities(num_classes=4, per_class=6,
                                          image_size=16, seed=1)
    write_identity_tree(str(root / "CASIA-WebFace"), images, labels,
                        split="train")
    return str(root)


def test_cli_pack_then_train_equals_the_tree(small_tree, tmp_path, capsys):
    """`pack` writes pack_dataset's pack; `train` on the tree and on its
    pack sees the same batches, so its losses are equal."""
    pack_dir = str(tmp_path / "pack")
    assert cli(["pack", "--dataset-path", small_tree, "--output", pack_dir,
                "--image-size", "16", "--num-workers", "2"]) == 0
    assert is_packed_dir(pack_dir)
    want = str(tmp_path / "want")
    jpacked.pack_dataset(JIndex.build(os.path.join(small_tree,
                                                   "CASIA-WebFace"),
                                      split="train"), want, image_size=16)
    for name in ("images.u8", "labels.npy"):
        with open(os.path.join(pack_dir, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name
    capsys.readouterr()
    assert _train(small_tree, tmp_path / "w_tree") == 0
    tree_losses = _losses(capsys.readouterr().out)
    assert _train(pack_dir, tmp_path / "w_pack") == 0
    pack_losses = _losses(capsys.readouterr().out)
    assert len(tree_losses) == 3 and np.all(np.isfinite(tree_losses))
    assert pack_losses == tree_losses


def test_cli_pack_image_size_overrides(small_tree, tmp_path, capsys):
    pack_dir = str(tmp_path / "pack")
    assert cli(["pack", "--dataset-path", small_tree, "--output", pack_dir,
                "--image-size", "16", "--num-workers", "2"]) == 0
    capsys.readouterr()
    assert _train(pack_dir, tmp_path / "w", "--image-size", "24") == 0
    out = capsys.readouterr().out
    assert "[pack] image size 16 overrides --image-size 24" in out
    assert np.all(np.isfinite(_losses(out)))


def test_cli_train_refusals(small_tree, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DATASET_PATH", raising=False)
    assert cli(["train", "--device", "cpu",
                "--working-path", str(tmp_path / "w")]) == 2
    assert capsys.readouterr().err.strip() == (
        "error: --dataset-path required (or --synthetic)")
    pack_dir = str(tmp_path / "pack")
    assert cli(["pack", "--dataset-path", small_tree, "--output", pack_dir,
                "--image-size", "16"]) == 0
    assert _train(pack_dir, tmp_path / "w", "--num-classes", "3") == 2
    assert ("error: pack has 4 identities > --num-classes 3"
            in capsys.readouterr().err)


def test_bench_input_on_cpu():
    """The input benchmark's path at a small size: a pack and the arrays
    in turns through `fit`, every run's losses bitwise equal."""
    from face_recognition_models_tpu_torch.scripts import bench_input

    res = bench_input.bench(pairs=2, steps=2, batch=4, image_size=16,
                            num_classes=4, device="cpu")
    assert res["order"] == ["packed", "array", "array", "packed"]
    assert res["losses_bitwise_equal"] and res["nvidia_smi"] is None
    for name in ("packed", "array"):
        assert len(res["runs"][name]) == 2
        stats = res["summary"][name]["img_per_s"]
        assert 0 < stats["q1"] <= stats["median"] <= stats["q3"]
