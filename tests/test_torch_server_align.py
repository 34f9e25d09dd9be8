"""`serve` with a detector (serving/server.py's `detector`, `serve --align`)
on the CPU: the cases of the JAX package's tests/test_server.py for the
detect + align path (a stub detector: /detect, aligned /embed, the no-face
centre-crop fallback with `aligned: false`, 409 and no `aligned` key
without a detector), then the port's MTCNN behind the service against the
JAX cascade, and `serve --align` from the command line.

Bounds: an HTTP embedding within atol 2e-3 of the direct embedding of the
same pixels (the JAX test's); /detect's rounded boxes and landmarks (2
decimals) within 0.011 and probs (4 decimals) within 1e-4 of the JAX
MTCNN's on the same photo and weights.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from face_recognition_models_tpu.detection import mtcnn as jm
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.data.preprocess import build_detector
from face_recognition_models_tpu_torch.detection.mtcnn import MTCNN
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.serving import server as tserver
from face_recognition_models_tpu_torch.serving.server import (
    EmbedService,
    make_server,
)
from face_recognition_models_tpu_torch.train.step import make_eval_step

from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32


def _model():
    model = get_backbone("resnet18", embed_dim=32)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


@pytest.fixture(scope="module")
def embed_fn():
    step = make_eval_step(_model(), device="cpu")
    return lambda im: step(im).numpy()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded facenet_pytorch-layout weights directory whose face
    probability layers get a (-20, +20) bias: every window passes the
    default thresholds (random weights otherwise find no face)."""
    d = tmp_path_factory.mktemp("mtcnn")
    sds = MTCNN.init_random(torch.Generator().manual_seed(5))
    for net, layer in (("pnet", "conv4_1"), ("rnet", "dense5_1"),
                       ("onet", "dense6_1")):
        sds[net][f"{layer}.bias"] = torch.tensor([-20.0, 20.0])
    for net, sd in sds.items():
        torch.save(sd, os.path.join(d, f"{net}.pt"))
    return str(d)


def _jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


class _StubDetector:
    """The build_detector contract: extract = the photo's top-left
    IMG x IMG corner."""

    def __init__(self, find=True):
        self.find = find

    def detect(self, img):
        if not self.find:
            return (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0, 5, 2)))
        return (np.asarray([[2.0, 3.0, 2.0 + IMG, 3.0 + IMG]]),
                np.asarray([0.97]),
                np.asarray([[[float(i), float(i + 1)] for i in range(5)]]))

    def extract(self, img):
        if not self.find:
            return None
        return np.asarray(img)[:IMG, :IMG]


@pytest.fixture()
def served_with(embed_fn):
    """served_with(detector) -> (service, url); every one closed after."""
    started = []

    def start(detector):
        svc = EmbedService(embed_fn, IMG, batch_size=4, max_wait_ms=1.0,
                           detector=detector)
        srv = make_server(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        started.append((svc, srv))
        return svc, f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for svc, srv in started:
        srv.shutdown()
        srv.server_close()
        svc.close()


def _unit(embed_fn, img):
    direct = np.asarray(embed_fn(img[None]), np.float32)[0]
    return direct / np.linalg.norm(direct)


def test_http_detect_and_aligned_embed(served_with, embed_fn):
    _, url = served_with(_StubDetector(find=True))
    photo = np.random.RandomState(3).randint(0, 256, (2 * IMG, 2 * IMG, 3),
                                             dtype=np.uint8)
    det = _post(url + "/detect", _jpeg(photo))
    assert det["boxes"] == [[2.0, 3.0, 2.0 + IMG, 3.0 + IMG]]
    assert det["probs"] == [0.97]
    assert np.asarray(det["landmarks"]).shape == (1, 5, 2)

    out = _post(url + "/embed", _png(photo))
    assert out["aligned"] is True
    np.testing.assert_allclose(np.asarray(out["embedding"], np.float32),
                               _unit(embed_fn, photo[:IMG, :IMG]), atol=2e-3)
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["align"] is True


def test_align_no_face_falls_back_center_crop(served_with, embed_fn):
    _, url = served_with(_StubDetector(find=False))
    photo = np.random.RandomState(4).randint(0, 256, (3 * IMG, 2 * IMG, 3),
                                             dtype=np.uint8)
    out = _post(url + "/embed", _png(photo))
    assert out["aligned"] is False
    # the documented fallback: centre square crop, resized to IMG
    s = 2 * IMG
    crop = photo[(3 * IMG - s) // 2:(3 * IMG + s) // 2, :s]
    crop = np.asarray(Image.fromarray(crop).resize((IMG, IMG)), np.uint8)
    np.testing.assert_allclose(np.asarray(out["embedding"], np.float32),
                               _unit(embed_fn, crop), atol=2e-3)


def test_detect_without_detector_409_and_no_aligned_key(served_with):
    _, url = served_with(None)
    zeros = _png(np.zeros((IMG, IMG, 3), np.uint8))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/detect", zeros)
    assert e.value.code == 409
    assert "--align" in json.loads(e.value.read())["error"]
    out = _post(url + "/embed", zeros)
    assert "aligned" not in out   # pre-aligned mode: no alignment claim


def test_identify_carries_aligned(served_with, embed_fn, tmp_path):
    rs = np.random.RandomState(6)
    photo = rs.randint(0, 256, (2 * IMG, 2 * IMG, 3), dtype=np.uint8)
    gallery = np.stack([_unit(embed_fn, photo[:IMG, :IMG]),
                        _unit(embed_fn, rs.randint(0, 256, (IMG, IMG, 3),
                                                   dtype=np.uint8))])
    np.savez(tmp_path / "g.npz", embeddings=gallery,
             paths=np.asarray(["id0/a.png", "id1/b.png"]))
    svc = EmbedService(embed_fn, IMG, batch_size=2, max_wait_ms=1.0,
                       gallery_path=str(tmp_path / "g.npz"),
                       detector=_StubDetector(find=True))
    try:
        out = svc.identify_bytes(_png(photo), top_k=2)
    finally:
        svc.close()
    assert out["aligned"] is True
    assert out["matches"][0]["path"] == "id0/a.png"
    assert out["matches"][0]["score"] > 0.999


def test_mtcnn_behind_the_service_matches_jax(served_with, embed_fn,
                                              weights):
    """The port's cascade (build_detector on the CPU) behind /detect and
    /embed against the JAX MTCNN on the same photo and weights."""
    photo = np.random.RandomState(7).randint(0, 256, (72, 60, 3),
                                             dtype=np.uint8)
    det = build_detector(IMG, weights, device="cpu")
    _, url = served_with(det)
    got = _post(url + "/detect", _png(photo))
    jdet = jm.MTCNN(jax.tree.map(np.asarray,
                                 jm.load_facenet_pytorch_weights(weights)),
                    image_size=IMG)
    boxes, probs, landmarks = jdet.detect(photo)
    assert len(boxes) > 0
    assert np.asarray(got["boxes"]).shape == boxes.shape
    np.testing.assert_allclose(got["boxes"], boxes, atol=0.011)
    np.testing.assert_allclose(got["probs"], probs, atol=1e-4)
    np.testing.assert_allclose(got["landmarks"], landmarks, atol=0.011)

    out = _post(url + "/embed", _png(photo))
    assert out["aligned"] is True
    face = jdet.extract(photo)
    np.testing.assert_array_equal(det.extract(photo), face)
    np.testing.assert_allclose(np.asarray(out["embedding"], np.float32),
                               _unit(embed_fn, face), atol=2e-3)


class _Interrupted:
    """make_server's stand-in: serve_forever returns at once, as after a
    SIGINT."""

    server_address = ("127.0.0.1", 0)

    def serve_forever(self):
        raise KeyboardInterrupt

    def server_close(self):
        pass


@pytest.mark.parametrize("with_weights", [True, False])
def test_run_serve_cli_align(monkeypatch, tmp_path, weights, capsys,
                             with_weights):
    """run_serve_cli(align=True) builds the detector on the service's
    device, or warns and serves without one when no weights are found."""
    CheckpointManager(str(tmp_path / "arcface"), "arcface").save_final(
        _model().state_dict())
    services = []

    def fake_server(service, host, port):
        services.append(service)
        return _Interrupted()

    monkeypatch.setattr(tserver, "make_server", fake_server)
    rc = tserver.run_serve_cli(
        checkpoint_dir=str(tmp_path / "arcface"), backbone="resnet18",
        image_size=IMG, bn_dtype="float32", embed_dim=32, micro_batch=2,
        align=True, mtcnn_weights=weights if with_weights else None,
        align_mode="warp", device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    svc, = services
    if with_weights:
        assert svc.detector.image_size == IMG
        assert svc.detector._detector.device.type == "cpu"
        assert "align on" in out and "WARNING" not in out
    else:
        assert svc.detector is None
        assert "WARNING: --align requested but no MTCNN weights" in out
        assert "align off" in out


def test_serve_cli_align_on_cpu(tmp_path, weights):
    """`serve --align --mtcnn-weights DIR --device cpu --port 0` answers
    /healthz with align on and /detect, and exits 0 on SIGINT."""
    CheckpointManager(str(tmp_path / "arcface"), "arcface").save_final(
        _model().state_dict())
    proc = subprocess.Popen(
        [sys.executable, "-m", "face_recognition_models_tpu_torch.cli",
         "serve", "--checkpoint-dir", str(tmp_path / "arcface"),
         "--backbone", "resnet18", "--embed-dim", "32", "--image-size",
         str(IMG), "--bn-dtype", "float32", "--device", "cpu", "--port",
         "0", "--micro-batch", "2", "--align", "--mtcnn-weights", weights],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"serving on (http://[\d.]+:\d+)", line)
        assert m, line + proc.stderr.read() if proc.poll() else line
        assert "align on" in line
        url = m.group(1)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["align"] is True
        photo = np.random.RandomState(8).randint(0, 256, (64, 64, 3),
                                                 np.uint8)
        det = _post(url + "/detect", _png(photo))
        assert len(det["boxes"]) == len(det["probs"]) > 0
        assert _post(url + "/embed", _png(photo))["aligned"] is True
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
