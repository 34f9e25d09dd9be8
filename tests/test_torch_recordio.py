"""The port's RecordIO support (train.rec / train.idx) against the JAX
package's, on small seeded `.rec` files written under tmp_path:

- `write_recordio` writes the JAX writer's bytes; `read_idx`, the
  pandas-free `_read_idx_arrays` (numpy's reader, with the tolerant loop
  for odd files), `read_record`, the header scan and `RecordIODataset`
  give the JAX arrays;
- `RecLoader` gives the JAX RecLoader's batches bitwise (PIL and native
  backends, sharded or not), and resamples a corrupt record by the same
  law;
- `train --dataset-path <.rec>` on the CPU gives finite losses, and `pack`
  from a `.rec` writes the pack `pack_from_loader` writes.
The JAX package's tests/test_recordio.py, case by case where the port has
the module (the `.bin` cases are in tests/test_torch_verification.py and
PKRecLoader belongs to the triplet path).
"""

import io
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from face_recognition_models_tpu.data import recordio as jrec
from face_recognition_models_tpu.native import is_available as jax_native
from face_recognition_models_tpu_torch.cli.main import main as cli
from face_recognition_models_tpu_torch.data import recordio as trec
from face_recognition_models_tpu_torch.data.packed import (
    PackedDataset,
    pack_from_loader,
)
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.recordio import (
    RecLoader,
    RecordIODataset,
    is_recordio,
    read_idx,
    read_record,
    resolve_prefix,
    write_recordio,
)
from face_recognition_models_tpu_torch.native import fastdecode
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _native_or_skip():
    if not fastdecode.is_available():
        pytest.skip(f"native decoder unavailable: {fastdecode.build_error()}")
    if not jax_native():
        pytest.skip("the JAX package's native decoder is unavailable")


def _jpeg_bytes(arr, quality=95):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _synthetic_rec(tmp_path, n_ident=5, per_ident=4, size=24, seed=0,
                   insightface_layout=True, name="train", noise=False):
    """Flat gray images (a label's level survives JPEG within +-2), or with
    `noise` seeded textures whose decode depends on every coefficient."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(n_ident), per_ident)
    images = np.stack([
        np.full((size, size, 3), 20 + 10 * int(lab), np.uint8)
        for lab in labels])
    if noise:
        images = np.clip(images + rng.randint(0, 60, images.shape), 0,
                         255).astype(np.uint8)
    # shuffled write order: the insightface writer groups by identity
    perm = rng.permutation(len(labels))
    payloads = [_jpeg_bytes(images[i]) for i in perm]
    prefix = str(tmp_path / name)
    write_recordio(prefix, payloads, labels[perm],
                   insightface_layout=insightface_layout)
    return prefix, images, labels


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (ia, la), (ib, lb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


def test_write_read_roundtrip_record_level(tmp_path):
    prefix, images, labels = _synthetic_rec(tmp_path)
    idx = read_idx(prefix + ".idx")
    with open(prefix + ".rec", "rb") as f:
        buf = f.read()
    # key 0 meta record: label = (ident_start, ident_end)
    lab0, payload0 = read_record(buf, idx[0])
    n = len(labels)
    assert payload0 == b""
    assert int(lab0[0]) == n + 1  # images occupy keys 1..n
    assert int(lab0[1]) == n + 1 + 5  # five identity records
    for key in range(1, n + 1):
        lab, payload = read_record(buf, idx[key])
        with Image.open(io.BytesIO(payload)) as im:
            arr = np.asarray(im.convert("RGB"))
        assert abs(int(arr.mean()) - (20 + 10 * int(lab[0]))) <= 2
    spans = []
    for key in range(n + 1, n + 6):
        lab, _ = read_record(buf, idx[key])
        spans.append((int(lab[0]), int(lab[1])))
    assert spans[0][0] == 1 and spans[-1][1] == n + 1
    assert all(spans[i][1] == spans[i + 1][0] for i in range(4))


@pytest.mark.parametrize("layout", [True, False])
def test_written_files_equal_the_jax_writer(tmp_path, layout):
    prefix, _, _ = _synthetic_rec(tmp_path, insightface_layout=layout)
    rs = np.random.RandomState(0)
    labels = np.repeat(np.arange(5), 4)[rs.permutation(20)]
    payloads = [_jpeg_bytes(np.full((24, 24, 3), 20 + 10 * int(lab),
                                    np.uint8)) for lab in labels]
    jprefix = str(tmp_path / "jax")
    jrec.write_recordio(jprefix, payloads, labels,
                        insightface_layout=layout)
    for ext in (".rec", ".idx"):
        with open(prefix + ext, "rb") as a, open(jprefix + ext, "rb") as b:
            assert a.read() == b.read(), ext


@pytest.mark.parametrize("layout", [True, False])
def test_dataset_open_labels_and_count(tmp_path, layout):
    prefix, images, labels = _synthetic_rec(tmp_path,
                                            insightface_layout=layout)
    ds = RecordIODataset.open(prefix)
    assert len(ds) == len(labels)
    assert ds.num_identities == 5
    assert sorted(np.asarray(ds.labels).tolist()) == sorted(labels.tolist())


@pytest.mark.parametrize("layout", [True, False])
def test_dataset_matches_jax(tmp_path, layout):
    prefix, _, _ = _synthetic_rec(tmp_path, insightface_layout=layout)
    got, want = RecordIODataset.open(prefix), jrec.RecordIODataset.open(
        prefix)
    for field in ("keys", "offsets", "labels", "payload_offsets",
                  "payload_lengths"):
        a, b = getattr(got, field), getattr(want, field)
        np.testing.assert_array_equal(a, b, err_msg=field)
        assert a.dtype == b.dtype, field
    assert (got.num_identities, got.identities) == (want.num_identities,
                                                    want.identities)


def _write_idx(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


@pytest.mark.parametrize("text", [
    "0\t0\n1\t40\n2\t96\n",                  # canonical
    "2\t96\n0\t0\n1\t40\n",                  # unsorted keys
    "0\t0\n\n1\t40\n2\t96\n\n",              # blank lines
    "0 0\n1  40\n2\t96\n",                   # other whitespace
    "0\t0\n1\n1\t40\n2\t96\n",               # a short line
    "0\t0\t7\n1\t40\t8\n",                   # extra columns
])
def test_read_idx_arrays_without_pandas_matches_jax(tmp_path, text):
    path = _write_idx(tmp_path / "train.idx", text)
    got, want = trec._read_idx_arrays(path), jrec._read_idx_arrays(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64
    assert read_idx(path) == jrec.read_idx(path)


def test_read_idx_arrays_of_a_written_set_match_jax(tmp_path, monkeypatch):
    """With no pandas importable, as on the card's machine."""
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=7, per_ident=9)
    want = jrec._read_idx_arrays(prefix + ".idx")
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    assert len(RecordIODataset.open(prefix)) == 63
    got = trec._read_idx_arrays(prefix + ".idx")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_empty_idx_raises(tmp_path):
    path = _write_idx(tmp_path / "train.idx", "")
    with pytest.raises(ValueError, match="no entries"):
        trec._read_idx_arrays(path)


def test_resolve_prefix_forms(tmp_path):
    prefix, _, _ = _synthetic_rec(tmp_path)
    for p in (prefix, prefix + ".rec", prefix + ".idx", str(tmp_path)):
        assert resolve_prefix(p) == prefix, p
        assert is_recordio(p)
    assert resolve_prefix(str(tmp_path / "nope")) is None


def test_recloader_matches_folder_loader_law(tmp_path):
    """RecLoader follows the Loader contract: static uint8 batches,
    (seed, epoch)-deterministic order, labels consistent with pixels."""
    prefix, images, labels = _synthetic_rec(tmp_path, n_ident=4,
                                            per_ident=5, size=16)
    ds = RecordIODataset.open(prefix)
    loader = RecLoader(ds, batch_size=4, image_size=16, seed=3,
                       num_workers=2)
    assert loader.steps_per_epoch() == 5
    seen = 0
    for imgs, labs in loader.epoch(1):
        assert imgs.shape == (4, 16, 16, 3) and imgs.dtype == np.uint8
        assert labs.dtype == np.int32
        for img, lab in zip(imgs, labs):
            assert abs(int(img.mean()) - (20 + 10 * int(lab))) <= 2
        seen += len(labs)
    assert seen == 20
    a = [lb.copy() for _, lb in RecLoader(ds, 4, image_size=16,
                                          seed=3).epoch(1)]
    b = [lb.copy() for _, lb in RecLoader(ds, 4, image_size=16,
                                          seed=3).epoch(1)]
    assert all((x == y).all() for x, y in zip(a, b))
    c = [lb.copy() for _, lb in RecLoader(ds, 4, image_size=16,
                                          seed=3).epoch(2)]
    assert not all((x == y).all() for x, y in zip(a, c))


@pytest.mark.parametrize("shard", [None, (1, 2)])
@pytest.mark.parametrize("backend,size", [("pil", 24), ("pil", 16),
                                          ("native", 24)])
def test_recloader_matches_jax(tmp_path, backend, size, shard):
    """Bitwise the JAX RecLoader's batches. The native backend at the
    source size: both packages run the same C++ there, while a resample's
    float rounding may differ between their compile flags."""
    if backend == "native":
        _native_or_skip()
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=5, per_ident=5,
                                  noise=True)
    got = RecLoader(RecordIODataset.open(prefix), batch_size=4,
                    image_size=size, seed=6, num_workers=2, backend=backend,
                    shard=shard, drop_remainder=False)
    want = jrec.RecLoader(jrec.RecordIODataset.open(prefix), batch_size=4,
                          image_size=size, seed=6, num_workers=2,
                          backend=backend, shard=shard, drop_remainder=False)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    for epoch in (0, 2):
        _same_batches(got.epoch(epoch), want.epoch(epoch))


def test_recloader_shard_partition(tmp_path):
    """shard=(r, k) slices one agreed global order, disjoint + complete."""
    prefix, _, labels = _synthetic_rec(tmp_path, n_ident=3, per_ident=8,
                                       size=16)
    ds = RecordIODataset.open(prefix)
    full = RecLoader(ds, batch_size=24, image_size=16, seed=7,
                     drop_remainder=False)
    (all_imgs, all_labs), = list(full.epoch(0))
    parts = []
    for r in range(2):
        sh = RecLoader(ds, batch_size=12, image_size=16, seed=7,
                       drop_remainder=False, shard=(r, 2))
        parts.extend(sh.epoch(0))
    got = np.concatenate([p[1] for p in parts])
    assert sorted(got.tolist()) == sorted(all_labs.tolist())
    sh0 = np.concatenate([lb for _, lb in RecLoader(
        ds, 12, image_size=16, seed=7, drop_remainder=False,
        shard=(0, 2)).epoch(0)])
    assert (sh0 == all_labs[0::2]).all()


def test_recloader_uneven_shards_agree_on_steps(tmp_path):
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=5, per_ident=5,
                                  size=16)  # 25 items, 2 ranks -> 13/12
    ds = RecordIODataset.open(prefix)
    for drop in (True, False):
        loaders = [RecLoader(ds, batch_size=4, image_size=16, seed=7,
                             drop_remainder=drop, shard=(r, 2))
                   for r in range(2)]
        steps = {ld.steps_per_epoch() for ld in loaders}
        assert len(steps) == 1, f"ranks disagree on steps: {steps}"
        shapes = [[labs.shape for _, labs in ld.epoch(0)]
                  for ld in loaders]
        assert shapes[0] == shapes[1]
        assert len(shapes[0]) == steps.pop()


def test_recloader_producer_error_surfaces(tmp_path):
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=3, per_ident=4,
                                  size=16)
    loader = RecLoader(RecordIODataset.open(prefix), batch_size=4,
                       image_size=16, seed=0)

    def boom(*a, **kw):
        raise ValueError("bad RecordIO magic (synthetic)")

    loader._load_batch = boom
    with pytest.raises(ValueError, match="bad RecordIO magic"):
        list(loader.epoch(0))


def _corrupt_rec(tmp_path):
    labels = np.repeat(np.arange(2), 4)
    images = np.stack([np.full((16, 16, 3), 30 + 40 * int(lab), np.uint8)
                       for lab in labels])
    payloads = [_jpeg_bytes(im) for im in images]
    payloads[3] = payloads[3][:10]  # a truncated record
    prefix = str(tmp_path / "train")
    write_recordio(prefix, payloads, labels)
    return prefix


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_recloader_corrupt_record_resampled(tmp_path, backend):
    """A truncated payload is resampled, not dropped; the resample law is
    the JAX loader's (the same batch and count)."""
    if backend == "native":
        _native_or_skip()
    prefix = _corrupt_rec(tmp_path)
    loader = RecLoader(RecordIODataset.open(prefix), batch_size=8,
                       image_size=16, shuffle=False, seed=0, num_workers=1,
                       backend=backend)
    want = jrec.RecLoader(jrec.RecordIODataset.open(prefix), batch_size=8,
                          image_size=16, shuffle=False, seed=0,
                          num_workers=1, backend=backend)
    batches = list(loader.epoch(0))
    _same_batches(batches, want.epoch(0))
    assert loader.skipped_images == want.skipped_images >= 1
    (imgs, labs), = batches
    assert imgs.shape == (8, 16, 16, 3)
    for img, lab in zip(imgs, labs):
        assert abs(int(img.mean()) - (30 + 40 * int(lab))) <= 2


def test_recloader_all_corrupt_raises(tmp_path):
    payloads = [b"\xff\xd8 not a jpeg"] * 4
    prefix = str(tmp_path / "train")
    write_recordio(prefix, payloads, [0, 0, 1, 1])
    loader = RecLoader(RecordIODataset.open(prefix), batch_size=4,
                       image_size=16, backend="pil", num_workers=1)
    with pytest.raises(RuntimeError, match="corrupt"):
        list(loader.epoch(0))


def test_native_backend_refuses_with_the_build_error(tmp_path, monkeypatch):
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=2, per_ident=2)
    monkeypatch.setattr(fastdecode, "_lib", None)
    monkeypatch.setattr(fastdecode, "_build_error", "g++ failed: no jpeglib")
    ds = RecordIODataset.open(prefix)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed: no jpeglib"):
        RecLoader(ds, batch_size=2, backend="native")
    assert RecLoader(ds, batch_size=2).backend == "pil"
    with pytest.raises(ValueError, match="unknown backend"):
        RecLoader(ds, batch_size=2, backend="turbo")


def test_pack_from_recordio_matches_arrayloader(tmp_path):
    """A pack from a .rec holds the arrays that built it (label-wise;
    pixels within JPEG error)."""
    prefix, images, labels = _synthetic_rec(tmp_path, n_ident=3,
                                            per_ident=4, size=16)
    ds = RecordIODataset.open(prefix)
    loader = RecLoader(ds, batch_size=5, image_size=16, shuffle=False,
                       drop_remainder=False, num_workers=1)
    out = str(tmp_path / "pack")
    meta = pack_from_loader(loader, ds.identities, out, 16)
    assert meta["num_samples"] == 12
    packed = PackedDataset.open(out)
    ref = ArrayLoader(images, labels, batch_size=12, shuffle=False)
    (_, ref_labs), = list(ref.epoch(0))
    assert (sorted(np.asarray(packed.labels).tolist())
            == sorted(ref_labs.tolist()))
    for row in range(12):
        img, lab = packed.images[row], int(packed.labels[row])
        assert abs(int(np.asarray(img).mean()) - (20 + 10 * lab)) <= 2


def test_native_and_pil_backends_agree(tmp_path):
    """The C++ mem decoder and PIL give the same pixels off the same .rec
    at the source size."""
    _native_or_skip()
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=3, per_ident=4, size=16)
    ds = RecordIODataset.open(prefix)
    a = RecLoader(ds, batch_size=12, image_size=16, shuffle=False,
                  drop_remainder=False, backend="native")
    b = RecLoader(ds, batch_size=12, image_size=16, shuffle=False,
                  drop_remainder=False, backend="pil")
    (ia, la), = list(a.epoch(0))
    (ib, lb), = list(b.epoch(0))
    assert (la == lb).all()
    np.testing.assert_array_equal(ia, ib)


def test_decode_batch_mem_guards():
    if not fastdecode.is_available():
        pytest.skip(f"native decoder unavailable: {fastdecode.build_error()}")
    blob = np.zeros((100,), np.uint8)
    with pytest.raises(ValueError, match="beyond blob end"):
        fastdecode.decode_batch_mem(blob, np.asarray([90]),
                                    np.asarray([20]), 8)
    with pytest.raises(ValueError, match="negative"):
        fastdecode.decode_batch_mem(blob, np.asarray([-1]), np.asarray([5]),
                                    8)
    with pytest.raises(ValueError, match="1-D uint8"):
        fastdecode.decode_batch_mem(blob.astype(np.int16), np.asarray([0]),
                                    np.asarray([5]), 8)
    # zero-length and garbage ranges fail per slot, not fatally
    _, status = fastdecode.decode_batch_mem(blob, np.asarray([0, 10]),
                                            np.asarray([0, 50]), 8)
    assert (status != 0).all()


def test_cli_train_and_pack_from_a_rec(tmp_path, capsys):
    prefix, _, _ = _synthetic_rec(tmp_path, n_ident=4, per_ident=6, size=16,
                                  noise=True)
    assert cli(["train", "--dataset-path", prefix + ".rec", "--device",
                "cpu", "--working-path", str(tmp_path / "w"),
                "--batch_size", "8", "--epochs", "1", "--num-classes", "4",
                "--image-size", "16", "--num-workers", "2",
                "--print_freq", "1"]) == 0
    losses = [float(x) for x in
              re.findall(r"\tLoss (\S+) \(", capsys.readouterr().out)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert cli(["train", "--dataset-path", str(tmp_path), "--device", "cpu",
                "--working-path", str(tmp_path / "w"), "--num-classes",
                "3"]) == 2
    assert ("error: rec has 4 identities > --num-classes 3"
            in capsys.readouterr().err)
    out = str(tmp_path / "pack")
    assert cli(["pack", "--dataset-path", prefix, "--output", out,
                "--image-size", "16", "--num-workers", "2"]) == 0
    want = str(tmp_path / "want")
    ds = RecordIODataset.open(prefix)
    pack_from_loader(RecLoader(ds, batch_size=len(ds), image_size=16,
                               shuffle=False, drop_remainder=False),
                     ds.identities, want, 16)
    for name in ("images.u8", "labels.npy"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name
