"""The port's offline alignment (face_recognition_models_tpu_torch/data/
preprocess.py and the `preprocess` subcommand) against the JAX package's
preprocess_dataset, on the CPU.

The weights are a seeded facenet_pytorch-layout directory (pnet.pt /
rnet.pt / onet.pt from the port's MTCNN.init_random) whose three
face-probability layers get a bias of (-20, +20): with random weights the
default thresholds (0.5, 0.7, 0.7) otherwise reject every candidate, and
at +-20 the softmax is exactly 1.0 in fp32 on both sides, so every window
passes and ties break alike. Both packages run on the same tree: in crop
mode the same files, byte for byte. The warp's output moves with the
landmarks, which the two packages' O-Nets give about 3e-5 px apart (other
conv and matmul orders); that flips the rounding of ~16 of a crop's
37,632 values by 1. So warp mode is compared byte for byte on `exact`
weights, whose box-regression and landmark layers have zero weights (each
output is its bias, exactly, on both sides; the landmark bias puts the
five points where a face's would be), and on the random weights its
lossless PNG outputs within 1 grey level.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from face_recognition_models_tpu.data import preprocess as jpre
from face_recognition_models_tpu_torch.cli.main import main as cli_main
from face_recognition_models_tpu_torch.data import preprocess as tpre
from face_recognition_models_tpu_torch.detection.mtcnn import MTCNN
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

_FACE_LAYERS = {"pnet": "conv4_1", "rnet": "dense5_1", "onet": "dense6_1"}
_EXACT_LAYERS = ("pnet.conv4_2", "rnet.dense5_2", "onet.dense6_2",
                 "onet.dense6_3")
# landmarks as fractions of the box: the ArcFace template's x then y / 112
_LANDMARK_BIAS = [0.34, 0.66, 0.5, 0.37, 0.63, 0.46, 0.46, 0.64, 0.82, 0.82]


def _weights_dir(path, exact):
    sds = MTCNN.init_random(torch.Generator().manual_seed(3))
    for net, sd in sds.items():
        sd[f"{_FACE_LAYERS[net]}.bias"] = torch.tensor([-20.0, 20.0])
    if exact:
        for name in _EXACT_LAYERS:
            net, layer = name.split(".")
            sds[net][f"{layer}.weight"].zero_()
            sds[net][f"{layer}.bias"].zero_()
        sds["onet"]["dense6_3.bias"] = torch.tensor(_LANDMARK_BIAS)
    for net, sd in sds.items():
        torch.save(sd, os.path.join(path, f"{net}.pt"))
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _weights_dir(tmp_path_factory.mktemp("mtcnn_weights"), False)


@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    return _weights_dir(tmp_path_factory.mktemp("mtcnn_exact"), True)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """Two identities of seeded noise photos (JPEG and PNG), one photo too
    small for the pyramid (no face: copied), and a non-image file."""
    root = tmp_path_factory.mktemp("raw")
    rs = np.random.RandomState(0)
    for ident in ("id_0", "id_1"):
        os.makedirs(root / ident)
        for k, (h, w) in enumerate(((64, 56), (56, 72))):
            img = rs.randint(0, 256, (h, w, 3), np.uint8)
            ext = ".jpg" if k == 0 else ".png"
            Image.fromarray(img).save(root / ident / f"img_{k}{ext}")
    Image.fromarray(rs.randint(0, 256, (10, 9, 3), np.uint8)).save(
        root / "id_1" / "tiny.png")
    (root / "id_0" / "notes.txt").write_text("not an image")
    return str(root)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# (mode, weights fixture) of the byte-for-byte cases
RUNS = [("crop", "weights"), ("warp", "exact")]


@pytest.fixture(scope="module")
def jax_trees(weights, exact, raw_tree, tmp_path_factory):
    """{(mode, weights): (stats, output dir)} of the JAX
    preprocess_dataset, each run once."""
    dirs = {"weights": weights, "exact": exact}
    out = {}
    for mode, which in RUNS + [("warp", "weights")]:
        dst = str(tmp_path_factory.mktemp(f"jax_{mode}_{which}"))
        stats = jpre.preprocess_dataset(raw_tree, dst, image_size=112,
                                        mtcnn_weights=dirs[which],
                                        align_mode=mode)
        out[mode, which] = (stats, dst)
    return out


@pytest.mark.parametrize("mode,which", RUNS)
def test_preprocess_dataset_matches_jax(jax_trees, request, raw_tree,
                                        tmp_path, mode, which):
    stats = tpre.preprocess_dataset(
        raw_tree, str(tmp_path), image_size=112,
        mtcnn_weights=request.getfixturevalue(which), align_mode=mode,
        device="cpu")
    jstats, jdir = jax_trees[mode, which]
    jtree = _tree(jdir)
    assert stats == jstats
    assert stats == {"aligned": 4, "copied": 1, "fallback": False}
    tree = _tree(tmp_path)
    assert sorted(tree) == sorted(jtree)
    assert "id_0/notes.txt" not in tree
    for name, data in tree.items():
        assert data == jtree[name], name
    with Image.open(tmp_path / "id_0" / "img_0.jpg") as im:
        assert im.size == (112, 112)
    with open(os.path.join(raw_tree, "id_1", "tiny.png"), "rb") as f:
        assert tree["id_1/tiny.png"] == f.read()


def test_warp_on_random_regression_within_one_grey_level(
        jax_trees, weights, raw_tree, tmp_path):
    stats = tpre.preprocess_dataset(raw_tree, str(tmp_path), image_size=112,
                                    mtcnn_weights=weights, align_mode="warp",
                                    device="cpu")
    jstats, jdir = jax_trees["warp", "weights"]
    assert stats == jstats
    assert sorted(_tree(tmp_path)) == sorted(_tree(jdir))
    for ident in ("id_0", "id_1"):
        got = np.asarray(Image.open(tmp_path / ident / "img_1.png"), int)
        want = np.asarray(Image.open(os.path.join(jdir, ident, "img_1.png")),
                          int)
        assert got.shape == want.shape == (112, 112, 3)
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() < 0.01


def test_no_weights_fallback_is_loud_and_matches_jax(raw_tree, tmp_path,
                                                     capsys):
    stats = tpre.preprocess_dataset(raw_tree, str(tmp_path / "port"),
                                    image_size=32, device="cpu")
    assert stats == {"aligned": 5, "copied": 0, "fallback": True}
    assert "NO face detection" in capsys.readouterr().out
    jstats = jpre.preprocess_dataset(raw_tree, str(tmp_path / "jax"),
                                     image_size=32)
    assert jstats == stats
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    with Image.open(tmp_path / "port" / "id_1" / "img_1.png") as im:
        assert im.size == (32, 32)


def test_build_detector_modes_and_device(weights):
    det = tpre.build_detector(112, weights, device="cpu")
    assert isinstance(det, MTCNN) and det.device.type == "cpu"
    assert det.thresholds == (0.5, 0.7, 0.7) and det.factor == 0.709
    warp = tpre.build_detector(96, weights, align_mode="warp", device="cpu")
    assert warp.image_size == 96
    with pytest.raises(ValueError, match="align_mode"):
        tpre.build_detector(112, weights, align_mode="affine")
    # no weights and no facenet_pytorch: no detector
    assert tpre.build_detector(112, None, device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpre.build_detector(112, weights)


def test_preprocess_cli_matches_jax(jax_trees, exact, raw_tree, tmp_path,
                                    capsys):
    rc = cli_main(["preprocess", "--input", raw_tree, "--output",
                   str(tmp_path), "--mtcnn-weights", exact,
                   "--align-mode", "warp", "--device", "cpu"])
    assert rc == 0
    assert "preprocess done: {'aligned': 4, 'copied': 1, 'fallback': " \
           "False}" in capsys.readouterr().out
    assert _tree(tmp_path) == _tree(jax_trees["warp", "exact"][1])
