"""MTCNN face detection: the P-Net / R-Net / O-Net cascade. Port of
face_recognition_models_tpu/detection/mtcnn.py.

The reference delegates detection and alignment to facenet_pytorch's MTCNN
(image_size=112, thresholds [0.5, 0.7, 0.7], factor 0.709,
post_process=False, crop + resize of the selected box). Here:

- the three CNNs are nn.Modules in NCHW with facenet_pytorch's layer names
  (`conv1`, `prelu1`, ..., `conv4_1`, `dense4`, `dense6_3`), so its
  published pnet.pt / rnet.pt / onet.pt state_dicts load with
  `load_state_dict` (`load_facenet_pytorch_weights`): per-channel PReLU,
  ceil-mode max pooling, dense inputs flattened in (W, H, C) order;
- the image pyramid (an antialiased bilinear resize, as jax.image.resize
  scales down) and the nets run on the detector's device, the card unless
  the caller asks for the CPU; the convolutions run with TF32 off, because
  the thresholds decide on their outputs, and with cuDNN's benchmark off,
  because every pyramid scale and every crop count is a new shape;
- box generation at stride 2 / cell 12, NMS, box regression, square-ify
  and the per-box crops stay host numpy, as in the JAX package: the crop
  shapes depend on the data.

Conventions follow facenet_pytorch where they are observable: pixel
normalisation (x - 127.5) * 0.0078125, per-scale NMS 0.5 then cross-scale
0.7, and `detect -> largest-probability box -> crop + resize` for the
aligned output.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.utils.device import resolve_device


def _flatten_whc(x: torch.Tensor) -> torch.Tensor:
    """facenet_pytorch flattens dense inputs in (W, H, C) order."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net: fully convolutional, 12x12 receptive field, stride 2.
    forward: NCHW -> (prob [N, 2, h, w], reg [N, 4, h, w])."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.prelu1(self.conv1(x))
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return torch.softmax(self.conv4_1(x), dim=1), self.conv4_2(x)


class RNet(nn.Module):
    """Refine net over 24x24 crops: NCHW -> (prob [N, 2], reg [N, 4])."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = self.prelu1(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self.prelu2(self.conv2(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_flatten_whc(x)))
        return torch.softmax(self.dense5_1(x), dim=1), self.dense5_2(x)


class ONet(nn.Module):
    """Output net over 48x48 crops, with 5 landmarks: NCHW -> (prob [N, 2],
    reg [N, 4], landmarks [N, 10] as x1..x5, y1..y5)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = self.prelu1(self.conv1(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self.prelu2(self.conv2(x))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(x))
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(_flatten_whc(x)))
        return (torch.softmax(self.dense6_1(x), dim=1), self.dense6_2(x),
                self.dense6_3(x))


NETS = {"pnet": PNet, "rnet": RNet, "onet": ONet}


def load_facenet_pytorch_weights(directory: str) -> Dict[str, Dict]:
    """The pnet.pt / rnet.pt / onet.pt state_dicts in `directory` (the files
    shipped in the facenet_pytorch package's data/ directory), as
    {'pnet': ..., 'rnet': ..., 'onet': ...}."""
    return {name: torch.load(os.path.join(directory, f"{name}.pt"),
                             map_location="cpu", weights_only=True)
            for name in NETS}


# ---------------------------------------------------------------------------
# Pipeline helpers (numpy, host)
# ---------------------------------------------------------------------------


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float,
         mode: str = "union") -> np.ndarray:
    """Greedy NMS; returns kept indices (descending score)."""
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + 1)
                 * np.maximum(0.0, yy2 - yy1 + 1))
        if mode == "min":
            iou = inter / np.minimum(area[i], area[order[1:]])
        else:
            iou = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int64)


def _square(boxes: np.ndarray) -> np.ndarray:
    """Expand boxes to squares around their centers (rerec)."""
    out = boxes.copy()
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out[:, 0] = boxes[:, 0] + 0.5 * (w - side)
    out[:, 1] = boxes[:, 1] + 0.5 * (h - side)
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _regress(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
    h = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
    out = boxes.copy()
    out[:, :4] = boxes[:, :4] + reg * np.concatenate([w, h, w, h], axis=1)
    return out


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weight matrix replicating jax.image.resize 'bilinear'
    (triangle kernel, antialiased on downscale, edge-normalised)."""
    scale = out_size / in_size
    sample = (np.arange(out_size) + 0.5) / scale - 0.5
    kscale = min(scale, 1.0)
    x = (sample[:, None] - np.arange(in_size)[None, :]) * kscale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=1, keepdims=True)
    return np.where(total > 0, w / total, 0.0).astype(np.float32)


def _np_bilinear_resize(patch: np.ndarray, size: int) -> np.ndarray:
    """Host bilinear resize with jax.image.resize's 'bilinear' weights: two
    small matmuls a box, whose shapes depend on the data."""
    wh = _resize_weights(patch.shape[0], size)
    ww = _resize_weights(patch.shape[1], size)
    return np.einsum("oi,ijc,pj->opc", wh, patch, ww, optimize=True)


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int
                 ) -> np.ndarray:
    """Crop float boxes (clamped, zero-padded) and bilinear-resize."""
    h, w = img.shape[:2]
    out = np.zeros((len(boxes), size, size, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:, :4]):
        ix1, iy1 = int(round(x1)), int(round(y1))
        ix2, iy2 = int(round(x2)) + 1, int(round(y2)) + 1
        sx1, sy1 = max(ix1, 0), max(iy1, 0)
        sx2, sy2 = min(ix2, w), min(iy2, h)
        if sx2 <= sx1 or sy2 <= sy1:
            continue
        patch = np.zeros((iy2 - iy1, ix2 - ix1, 3), np.float32)
        patch[sy1 - iy1:sy2 - iy1, sx1 - ix1:sx2 - ix1] = \
            img[sy1:sy2, sx1:sx2]
        out[i] = _np_bilinear_resize(patch, size)
    return out


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32) - 127.5) * 0.0078125


def pyramid_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """An NCHW image resized to `size` as jax.image.resize 'bilinear' does
    it: half-pixel centres, a triangle kernel widened by the scale when it
    shrinks (antialias), edge-normalised."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


# ---------------------------------------------------------------------------
# The detector
# ---------------------------------------------------------------------------


class MTCNN:
    """P/R/O-Net cascade with facenet_pytorch-compatible knobs.

    state_dicts: {'pnet': ..., 'rnet': ..., 'onet': ...} in facenet_pytorch's
    layout (`load_facenet_pytorch_weights`, `init_random`, or
    utils/weights.mtcnn_from_jax). The nets run on `device`, the card
    unless 'cpu' is asked for. `detect` may be called from several threads:
    one call runs at a time.
    """

    def __init__(self, state_dicts: Dict[str, Dict], image_size: int = 112,
                 min_face_size: int = 20,
                 thresholds: Tuple[float, float, float] = (0.5, 0.7, 0.7),
                 factor: float = 0.709, device=None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.min_face_size = min_face_size
        self.thresholds = thresholds
        self.factor = factor
        self._lock = threading.Lock()
        for name, net in NETS.items():
            module = net()
            module.load_state_dict(state_dicts[name])
            setattr(self, name, module.to(self.device).eval())
        if self.device.type == "cuda":
            # the dense layers' products stay IEEE fp32 (no TF32)
            torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def init_random(generator: torch.Generator) -> Dict[str, Dict]:
        """Randomly initialised state_dicts (flax's initialisers, drawn from
        `generator`), for pipeline tests: no detection quality without real
        weights."""
        out = {}
        for name, net in NETS.items():
            module = net()
            init_weights(module, generator)
            out[name] = module.state_dict()
        return out

    # ------------------------------------------------------------------
    def _scales(self, h: int, w: int) -> List[float]:
        m = 12.0 / self.min_face_size
        min_side = min(h, w) * m
        scales, s = [], m
        while min_side >= 12:
            scales.append(s)
            s *= self.factor
            min_side *= self.factor
        return scales

    @torch.no_grad()
    def _pnet_maps(self, norm: np.ndarray, scales: List[float]):
        """[(prob [h, w], reg [h, w, 4])] on the host, one a scale: the
        normalised image goes to the device once, and each scale's resize
        and P-Net run there before the maps are read back."""
        x = torch.from_numpy(norm).to(self.device).permute(2, 0, 1)[None]
        h, w = norm.shape[:2]
        outs = []
        for scale in scales:
            size = (int(math.ceil(h * scale)), int(math.ceil(w * scale)))
            prob, reg = self.pnet(pyramid_resize(x, size))
            outs.append((prob[0, 1], reg[0].permute(1, 2, 0)))
        return [(p.cpu().numpy(), r.cpu().numpy()) for p, r in outs]

    @torch.no_grad()
    def _run(self, net: nn.Module, crops: np.ndarray):
        """`net` on host NHWC crops, its outputs back on the host."""
        x = torch.from_numpy(crops).to(self.device).permute(0, 3, 1, 2)
        return [y.cpu().numpy() for y in net(x)]

    def detect(self, image: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Detect faces in a uint8/float [H, W, 3] image.

        Returns (boxes [K, 4], probs [K], landmarks [K, 5, 2]); empty
        arrays when nothing survives the cascade.
        """
        with self._lock, torch.no_grad(), \
                torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return self._detect(np.asarray(image))

    def _detect(self, img: np.ndarray):
        h, w = img.shape[:2]
        empty = (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0, 5, 2)))

        # ---- stage 1: P-Net over the pyramid --------------------------
        all_boxes = []
        scales = self._scales(h, w)
        for scale, (prob, reg) in zip(
                scales, self._pnet_maps(_normalize(img), scales)):
            ys, xs = np.where(prob >= self.thresholds[0])
            if len(ys) == 0:
                continue
            scores = prob[ys, xs]
            r = reg[ys, xs]                        # [k, 4]
            # stride 2, cell 12, map back to original coordinates
            x1 = np.round((xs * 2 + 1) / scale)
            y1 = np.round((ys * 2 + 1) / scale)
            x2 = np.round((xs * 2 + 12) / scale)
            y2 = np.round((ys * 2 + 12) / scale)
            boxes = np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)
            keep = _nms(boxes, scores, 0.5)
            all_boxes.append(np.concatenate(
                [boxes[keep], scores[keep, None], r[keep]], axis=1))
        if not all_boxes:
            return empty
        boxes = np.concatenate(all_boxes)
        keep = _nms(boxes[:, :4], boxes[:, 4], 0.7)
        boxes = boxes[keep]
        boxes = _square(_regress(boxes[:, :4], boxes[:, 5:9]))

        # ---- stage 2: R-Net -------------------------------------------
        crops = _normalize(_crop_resize(img.astype(np.float32), boxes, 24))
        prob, reg = self._run(self.rnet, crops)
        prob = prob[:, 1]
        keep = prob >= self.thresholds[1]
        if not keep.any():
            return empty
        boxes, prob, reg = boxes[keep], prob[keep], reg[keep]
        keep = _nms(boxes, prob, 0.7)
        boxes = _square(_regress(boxes[keep], reg[keep]))
        prob = prob[keep]

        # ---- stage 3: O-Net -------------------------------------------
        crops = _normalize(_crop_resize(img.astype(np.float32), boxes, 48))
        oprob, reg, lmk = self._run(self.onet, crops)
        oprob = oprob[:, 1]
        keep = oprob >= self.thresholds[2]
        if not keep.any():
            return empty
        boxes, oprob, reg, lmk = boxes[keep], oprob[keep], reg[keep], lmk[keep]
        # landmarks are relative to the (pre-regression) box
        bw = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
        bh = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
        pts_x = boxes[:, 0:1] + lmk[:, 0:5] * bw
        pts_y = boxes[:, 1:2] + lmk[:, 5:10] * bh
        boxes = _regress(boxes, reg)
        keep = _nms(boxes, oprob, 0.7, mode="min")
        boxes, oprob = boxes[keep], oprob[keep]
        landmarks = np.stack([pts_x[keep], pts_y[keep]], axis=2)
        return boxes, oprob, landmarks

    def extract(self, image: np.ndarray) -> Optional[np.ndarray]:
        """The reference's usage: the highest-probability face, cropped
        and resized to image_size. uint8 [S, S, 3] or None."""
        boxes, probs, _ = self.detect(image)
        if len(boxes) == 0:
            return None
        best = boxes[int(np.argmax(probs))]
        crop = _crop_resize(np.asarray(image, np.float32), best[None],
                            self.image_size)[0]
        return np.clip(np.round(crop), 0, 255).astype(np.uint8)
