"""The port's `serve` (serving/server.py) on the CPU: the cases of the JAX
package's tests/test_server.py other than detection and alignment (those
are in tests/test_torch_server_align.py), plus one `serve` CLI run in a
subprocess.

The HTTP embedding of a PNG is held to the direct embedding of the same
pixels within atol 2e-3, as in the JAX test (a padded micro-batch against
a batch of one).
"""

import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from face_recognition_models_tpu.serving import server as jserver
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.serving.server import (
    EmbedService,
    MicroBatcher,
    make_server,
)
from face_recognition_models_tpu_torch.train.step import make_eval_step
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test run shares the cores among several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- MicroBatcher (no model: a deterministic fake embed) -------------------

def _fake_embed(images):
    """[B,S,S,3] u8 -> [B,4] f32: per-channel means + a constant."""
    b = images.shape[0]
    f = images.reshape(b, -1, 3).mean(axis=1)
    return np.concatenate([f, np.full((b, 1), 7.0)], axis=1)


@pytest.mark.parametrize("module", ["port", "jax"])
def test_microbatcher_correct_and_coalesces(module):
    cls = MicroBatcher if module == "port" else jserver.MicroBatcher
    mb = cls(_fake_embed, batch_size=4, max_wait_ms=200.0)
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (IMG, IMG, 3), dtype=np.uint8)
            for _ in range(8)]
    results = [None] * 8

    def work(i):
        results[i] = mb.submit(imgs[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for i in range(8):
        np.testing.assert_allclose(results[i],
                                   _fake_embed(imgs[i][None])[0], rtol=1e-6)
    st = mb.stats()
    assert st["images"] == 8 and st["batch_size"] == 4
    # 8 concurrent requests into batches of 4 with a 200 ms window
    # coalesce: fewer batches than images
    assert st["batches"] < 8 and st["max_coalesced"] >= 2
    mb.close()


def test_microbatcher_error_propagates_and_recovers():
    calls = {"n": 0}

    def flaky(images):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return _fake_embed(images)

    mb = MicroBatcher(flaky, batch_size=2, max_wait_ms=1.0)
    img = np.zeros((IMG, IMG, 3), np.uint8)
    with pytest.raises(RuntimeError, match="boom"):
        mb.submit(img)
    # the worker survives a failed batch
    np.testing.assert_allclose(mb.submit(img), _fake_embed(img[None])[0])
    mb.close()


def test_microbatcher_rejects_bad_batch_size():
    with pytest.raises(ValueError, match="batch_size"):
        MicroBatcher(_fake_embed, batch_size=0)


def test_microbatcher_bad_shape_errors_batch_not_worker():
    """A mis-shaped submit errors its own batch's waiters and leaves the
    worker alive for later well-formed requests."""
    mb = MicroBatcher(_fake_embed, batch_size=4, max_wait_ms=5.0)
    try:
        slots = [{"event": threading.Event(), "result": None,
                  "error": None} for _ in range(2)]
        mb._flush([(np.zeros((7, 7), np.uint8), slots[0]),
                   (np.zeros((IMG, IMG, 3), np.uint8), slots[1])])
        for s in slots:
            assert s["event"].is_set() and s["error"] is not None
        out = mb.submit(np.zeros((IMG, IMG, 3), np.uint8), timeout=10)
        assert np.isfinite(out).all()
    finally:
        mb.close()


# --- HTTP service over a random-weight resnet18 ----------------------------

def _model():
    model = get_backbone("resnet18", embed_dim=32)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


@pytest.fixture(scope="module")
def embed_fn():
    step = make_eval_step(_model(), device="cpu")
    return lambda im: step(im).numpy()


def _start(service):
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def served(embed_fn):
    service = EmbedService(embed_fn, IMG, batch_size=4, max_wait_ms=2.0)
    server, url = _start(service)
    yield url, service
    server.shutdown()
    server.server_close()
    service.close()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")  # lossless round trip
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _status(url, data):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, data)
    return e.value.code


def test_http_embed_matches_direct(served, embed_fn):
    url, _ = served
    img = np.random.RandomState(1).randint(0, 256, (IMG, IMG, 3), np.uint8)
    out = _post(url + "/embed", _png(img))
    emb = np.asarray(out["embedding"], np.float32)
    assert abs(np.linalg.norm(emb) - 1.0) < 1e-4
    assert 0.0 <= out["quality"] <= 1.0 and out["norm"] > 0
    assert "aligned" not in out  # pre-aligned inputs: no alignment claim
    direct = np.asarray(embed_fn(img[None]), np.float32)[0]
    np.testing.assert_allclose(out["norm"], np.linalg.norm(direct),
                               rtol=1e-3)
    direct = direct / np.linalg.norm(direct)
    np.testing.assert_allclose(emb, direct, atol=2e-3)


def test_http_healthz_and_errors(served):
    url, _ = served
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["align"] is False
    assert h["embed_dim"] == 32 and h["image_size"] == IMG
    assert h["gallery_size"] == 0 and h["batch_size"] == 4
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404
    zeros = _png(np.zeros((IMG, IMG, 3), np.uint8))
    assert _status(url + "/embed", b"not an image") == 400
    assert _status(url + "/identify", zeros) == 409   # no gallery
    assert _status(url + "/detect", zeros) == 409     # no detector
    assert _status(url + "/nope", b"") == 404
    assert _status(url + "/embed", b"") == 400
    req = urllib.request.Request(url + "/embed", data=b"x", method="POST")
    req.add_header("Content-Length", str(1 << 40))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 413
    assert _status(url + "/identify?top_k=-1", zeros) in (400, 409)


def test_chunked_transfer_encoding_rejected_explicitly(served):
    url, _ = served
    host, port = url.replace("http://", "").split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /embed HTTP/1.1\r\nHost: test\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n"
                  b"4\r\nabcd\r\n0\r\n\r\n")
        resp = b""
        s.settimeout(5.0)
        try:
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                resp += chunk
        except socket.timeout:
            pass
    text = resp.decode("utf-8", "replace")
    assert " 411 " in text.splitlines()[0]
    assert "chunked" in text


def test_http_identify_with_gallery(embed_fn, tmp_path):
    imgs = np.random.RandomState(2).randint(0, 256, (3, IMG, IMG, 3),
                                            np.uint8)
    emb = np.asarray(embed_fn(np.concatenate(
        [imgs, np.zeros((1, IMG, IMG, 3), np.uint8)])), np.float32)[:3]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    gal = tmp_path / "gallery.npz"
    np.savez(gal, embeddings=emb,
             paths=np.asarray([f"id{i}/img.png" for i in range(3)]))
    svc = EmbedService(embed_fn, IMG, batch_size=4, max_wait_ms=1.0,
                       gallery_path=str(gal))
    srv, url = _start(svc)
    try:
        out = _post(url + "/identify?top_k=2", _png(imgs[1]))
        assert len(out["matches"]) == 2
        assert out["matches"][0]["path"] == "id1/img.png"
        assert out["matches"][0]["score"] > 0.99
        assert out["matches"][0]["score"] >= out["matches"][1]["score"]
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["gallery_size"] == 3
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    np.savez(tmp_path / "bad.npz", embeddings=np.zeros((2, 7), np.float32),
             paths=np.asarray(["a", "b"]))
    with pytest.raises(ValueError, match="dim"):
        EmbedService(embed_fn, IMG, batch_size=4,
                     gallery_path=str(tmp_path / "bad.npz"))


def test_serve_cli_on_cpu(tmp_path):
    """`serve --device cpu --port 0` from a checkpoint dir answers /healthz
    and /embed, and exits 0 on SIGINT."""
    model = _model()
    CheckpointManager(str(tmp_path / "arcface"), "arcface").save_final(
        model.state_dict())
    proc = subprocess.Popen(
        [sys.executable, "-m", "face_recognition_models_tpu_torch.cli",
         "serve", "--checkpoint-dir", str(tmp_path / "arcface"),
         "--backbone", "resnet18", "--embed-dim", "32", "--image-size",
         str(IMG), "--bn-dtype", "float32", "--device", "cpu", "--port",
         "0", "--micro-batch", "2"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"serving on (http://[\d.]+:\d+)", line)
        assert m, line + proc.stderr.read() if proc.poll() else line
        url = m.group(1)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["embed_dim"] == 32 and h["batch_size"] == 2
        img = np.random.RandomState(3).randint(0, 256, (IMG, IMG, 3),
                                               np.uint8)
        out = _post(url + "/embed", _png(img))
        step = make_eval_step(model, device="cpu")
        direct = step(img[None]).numpy()[0]
        np.testing.assert_allclose(np.asarray(out["embedding"]),
                                   direct / np.linalg.norm(direct),
                                   atol=2e-3)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
