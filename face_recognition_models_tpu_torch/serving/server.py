"""`serve`: an online embedding and identification HTTP service. Port of
face_recognition_models_tpu/serving/server.py.

A long-lived process holds the model (and optionally a gallery) and answers
per-image requests. Concurrent requests are coalesced into one micro-batch
of a fixed size, padded and never reshaped, so the model runs at one batch
shape, which the service warms up at startup rather than at the first
request.

Endpoints (JSON out):
  GET  /healthz            liveness + model and batcher stats
  POST /embed              body = JPEG/PNG bytes -> {embedding, norm, quality}
  POST /identify[?top_k=K] body = image bytes -> adds the top-K gallery
                           matches
  POST /detect             body = a photo -> {boxes, probs, landmarks} of
                           every face (409 without a detector)
The gallery is an `embed` .npz (L2-normalised rows + paths). With a
detector (`serve --align`, data/preprocess.build_detector) requests carry
whole photos: /embed and /identify embed the best face, detected and
aligned, and answer `aligned: true`, or a centre crop with `aligned: false`
when no face is found; without one, inputs are taken as aligned faces
(resized only) and the answers have no `aligned` key.

Python standard library only (ThreadingHTTPServer); the model is the
`embed_fn` of serving/embed.load_embed_fn (an artifact or a checkpoint),
which returns host arrays.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from face_recognition_models_tpu_torch.serving.embed import norm_quality


class MicroBatcher:
    """Coalesce concurrent embed requests into fixed-size batches.

    `embed_fn(uint8 [B,S,S,3]) -> host float [B,D]` runs on one worker
    thread (the card runs one batch at a time anyway); a batch's result is
    on the host before its waiters are released. submit() blocks the
    calling request thread until its row is ready. The batch is padded to
    exactly `batch_size`.
    """

    _SHUTDOWN = object()

    def __init__(self, embed_fn: Callable, batch_size: int = 8,
                 max_wait_ms: float = 5.0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1 (got {batch_size})")
        self.embed_fn = embed_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.batches = 0
        self.images = 0
        self.max_coalesced = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, image: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Embed one uint8 [S,S,3] image; returns the raw [D] embedding."""
        slot = {"event": threading.Event(), "result": None, "error": None}
        self._q.put((image, slot))
        if not slot["event"].wait(timeout):
            raise TimeoutError("embed request timed out")
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def close(self):
        self._q.put(self._SHUTDOWN)
        self._worker.join(timeout=10)

    # -- worker ------------------------------------------------------------
    def _run(self):
        while True:
            item = self._q.get()
            if item is self._SHUTDOWN:
                return
            items = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._SHUTDOWN:
                    self._flush(items)
                    return
                items.append(nxt)
            self._flush(items)

    def _flush(self, items):
        try:
            # stack, pad and run inside the try: a mis-shaped submit or a
            # failed batch on the card fails THAT batch's waiters, and the
            # worker thread lives on for every later request
            imgs = np.stack([im for im, _ in items])
            pad = self.batch_size - len(items)
            if pad:
                imgs = np.concatenate(
                    [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
            emb = np.asarray(self.embed_fn(imgs), np.float32)
            for row, (_, slot) in enumerate(items):
                slot["result"] = emb[row]
                slot["event"].set()
        except Exception as e:  # propagate to every waiter, keep serving
            for _, slot in items:
                slot["error"] = e
                slot["event"].set()
        with self._lock:
            self.batches += 1
            self.images += len(items)
            self.max_coalesced = max(self.max_coalesced, len(items))

    def stats(self) -> dict:
        with self._lock:
            return {"batches": self.batches, "images": self.images,
                    "max_coalesced": self.max_coalesced,
                    "batch_size": self.batch_size}


class EmbedService:
    """Model + optional gallery behind the HTTP handlers (also usable
    directly in-process)."""

    def __init__(self, embed_fn: Callable, image_size: int,
                 batch_size: int = 8, max_wait_ms: float = 5.0,
                 gallery_path: Optional[str] = None,
                 detector=None):
        """`detector`: an optional detect / extract object
        (data/preprocess.build_detector); requests then carry full photos
        and the service detects and aligns before embedding. Without it,
        inputs are taken as aligned (resized only)."""
        self.image_size = int(image_size)
        self.detector = detector
        # warm up at startup, at the exact serving shape
        probe = np.zeros((batch_size, image_size, image_size, 3), np.uint8)
        self.embed_dim = int(np.asarray(embed_fn(probe)).shape[-1])
        self.batcher = MicroBatcher(embed_fn, batch_size, max_wait_ms)
        self.gallery_emb = None
        self.gallery_paths = None
        if gallery_path:
            with np.load(gallery_path, allow_pickle=False) as z:
                self.gallery_emb = np.asarray(z["embeddings"], np.float32)
                self.gallery_paths = [str(p) for p in z["paths"]]
            if self.gallery_emb.shape[1] != self.embed_dim:
                raise ValueError(
                    f"gallery dim {self.gallery_emb.shape[1]} != model "
                    f"embed dim {self.embed_dim}")

    def decode(self, data: bytes, full: bool = False) -> np.ndarray:
        """Image bytes -> uint8 [H, W, 3] (PIL): resized to the model's
        size, or the whole photo with `full`."""
        from PIL import Image
        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB")
            if not full and im.size != (self.image_size, self.image_size):
                im = im.resize((self.image_size, self.image_size))
            return np.asarray(im, np.uint8)

    def _align(self, data: bytes):
        """(aligned uint8 [S, S, 3], aligned?: bool or None). With a
        detector, the best face of the full photo; no face -> a centre
        crop resized to the model's size, flagged False in the answer (the
        offline preprocess's fallback). Without one, (decode(data), None)."""
        if self.detector is None:
            return self.decode(data), None
        img = self.decode(data, full=True)
        face = self.detector.extract(img)
        if face is not None:
            return np.asarray(face, np.uint8), True
        h, w = img.shape[:2]
        s = min(h, w)
        top, left = (h - s) // 2, (w - s) // 2
        crop = img[top:top + s, left:left + s]
        from PIL import Image
        crop = np.asarray(Image.fromarray(crop).resize(
            (self.image_size, self.image_size)), np.uint8)
        return crop, False

    def embed_bytes(self, data: bytes) -> dict:
        img, aligned = self._align(data)
        raw = self.batcher.submit(img)
        norm = float(np.linalg.norm(raw))
        unit = raw / max(norm, 1e-12)
        out = {"embedding": [float(x) for x in unit],
               "norm": norm,
               "quality": float(norm_quality(np.asarray([norm]))[0])}
        if aligned is not None:
            out["aligned"] = aligned
        return out

    def detect_bytes(self, data: bytes) -> dict:
        """All faces in a full photo: boxes, probs, 5-point landmarks."""
        if self.detector is None:
            raise LookupError("no detector loaded (start with --align)")
        img = self.decode(data, full=True)
        boxes, probs, landmarks = self.detector.detect(img)
        return {"boxes": np.asarray(boxes).round(2).tolist(),
                "probs": np.asarray(probs).round(4).tolist(),
                "landmarks": np.asarray(landmarks).round(2).tolist()}

    def identify_bytes(self, data: bytes, top_k: int = 5) -> dict:
        if self.gallery_emb is None:
            raise LookupError("no gallery loaded (start with --gallery)")
        if int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1 (got {top_k})")
        out = self.embed_bytes(data)
        scores = self.gallery_emb @ np.asarray(out["embedding"], np.float32)
        k = min(int(top_k), len(scores))
        top = np.argsort(-scores)[:k]
        out["matches"] = [{"path": self.gallery_paths[i],
                           "score": float(scores[i])} for i in top]
        return out

    def health(self) -> dict:
        return {"status": "ok", "image_size": self.image_size,
                "embed_dim": self.embed_dim,
                "align": self.detector is not None,
                "gallery_size": (0 if self.gallery_emb is None
                                 else len(self.gallery_emb)),
                **self.batcher.stats()}

    def close(self):
        self.batcher.close()


class _Handler(BaseHTTPRequestHandler):
    service: EmbedService  # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if urlparse(self.path).path == "/healthz":
            return self._json(200, self.service.health())
        self._json(404, {"error": f"unknown path {self.path}"})

    MAX_BODY = 64 * 1024 * 1024  # one photo, not a DoS vector

    def do_POST(self):
        parsed = urlparse(self.path)
        try:
            if parsed.path not in ("/embed", "/identify", "/detect"):
                # answering without reading the body would desync a
                # keep-alive connection (the next parse starts mid-body)
                self.close_connection = True
                return self._json(404,
                                  {"error": f"unknown path {parsed.path}"})
            if "chunked" in self.headers.get(
                    "Transfer-Encoding", "").lower():
                # a chunked body is never read, so the connection cannot
                # be reused; say why rather than blame Content-Length
                self.close_connection = True
                return self._json(411, {
                    "error": "chunked transfer encoding is not supported; "
                             "send Content-Length"})
            length = int(self.headers.get("Content-Length", 0))
            # never rfile.read(-1): under keep-alive it blocks until the
            # client closes, pinning this handler thread
            if length <= 0 or length > self.MAX_BODY:
                self.close_connection = True  # unread body: don't reuse
                return self._json(413 if length > 0 else 400, {
                    "error": f"Content-Length must be in (0, "
                             f"{self.MAX_BODY}] (got {length})"})
            data = self.rfile.read(length)
            if parsed.path == "/embed":
                return self._json(200, self.service.embed_bytes(data))
            if parsed.path == "/identify":
                q = parse_qs(parsed.query)
                top_k = int(q.get("top_k", ["5"])[0])
                return self._json(200,
                                  self.service.identify_bytes(data, top_k))
            return self._json(200, self.service.detect_bytes(data))
        except LookupError as e:
            self._json(409, {"error": str(e)})
        except Exception as e:
            self._json(400, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: EmbedService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = any free port); the caller runs serve_forever() and
    shutdown()."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def run_serve_cli(model_path: Optional[str] = None,
                  checkpoint_dir: Optional[str] = None,
                  backbone: str = "resnet50", which: str = "final",
                  image_size: int = 112, host: str = "127.0.0.1",
                  port: int = 8000, micro_batch: int = 8,
                  max_wait_ms: float = 5.0,
                  gallery: Optional[str] = None,
                  align: bool = False,
                  mtcnn_weights: Optional[str] = None,
                  align_mode: str = "crop",
                  bn_dtype: str = "bfloat16", embed_dim: int = 512,
                  device=None) -> int:
    """Load the model as `embed` does (and with `align` the detector, on
    the same device), then serve until interrupted."""
    from face_recognition_models_tpu_torch.serving.embed import load_embed_fn
    try:
        embed_fn, image_size = load_embed_fn(
            model_path, checkpoint_dir, backbone, which, image_size,
            bn_dtype, embed_dim=embed_dim, device=device)
    except ValueError as e:
        print(f"error: {e}")
        return 2

    detector = None
    if align:
        from face_recognition_models_tpu_torch.data.preprocess import (
            build_detector)
        detector = build_detector(image_size, weights_dir=mtcnn_weights,
                                  align_mode=align_mode, device=device)
        if detector is None:
            print("WARNING: --align requested but no MTCNN weights are "
                  "available — serving WITHOUT detection (inputs treated "
                  "as pre-aligned; /detect disabled). Provide "
                  "--mtcnn-weights <dir with pnet.pt/rnet.pt/onet.pt> or "
                  "install facenet_pytorch.", flush=True)
    service = EmbedService(embed_fn, image_size, micro_batch, max_wait_ms,
                           gallery_path=gallery, detector=detector)
    server = make_server(service, host, port)
    h = service.health()
    print(f"serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]} — {h['embed_dim']}-d embeddings, "
          f"micro-batch {micro_batch} (wait {max_wait_ms} ms), "
          f"align {'on' if h['align'] else 'off'}, "
          f"gallery {h['gallery_size']} images", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0
