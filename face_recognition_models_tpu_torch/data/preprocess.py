"""Offline face alignment (dataset preparation). Port of
face_recognition_models_tpu/data/preprocess.py.

The reference's preprocess.py: walk a raw dataset tree, detect and align
each face with MTCNN (image_size=112, thresholds [0.5, 0.7, 0.7], factor
0.709, post_process=False), save the aligned images under the same names,
and copy the original when no face is found.

Detection backends, in order of preference:
1. the port's MTCNN cascade (detection/mtcnn.py) with the weights of a
   facenet_pytorch pnet.pt / rnet.pt / onet.pt directory
   (`preprocess --mtcnn-weights <dir>`, or found in an installed
   facenet_pytorch package), on the caller's device;
2. facenet_pytorch's own MTCNN when that package is installed, on the
   caller's device;
3. a LOUD fallback: square centre crop + resize, NO face detection. The
   function prints a warning and reports fallback=True. Pre-aligned
   datasets pass through unchanged either way.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from face_recognition_models_tpu_torch.utils.device import resolve_device

_IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def _find_facenet_pytorch_weights() -> Optional[str]:
    try:
        import facenet_pytorch
    except ImportError:
        return None
    d = os.path.join(os.path.dirname(facenet_pytorch.__file__), "data")
    if all(os.path.exists(os.path.join(d, f))
           for f in ("pnet.pt", "rnet.pt", "onet.pt")):
        return d
    return None


class _FacenetPytorchAdapter:
    """facenet_pytorch's MTCNN behind the cascade's detect / extract
    contract (detection/mtcnn.py), for hosts that have the package but no
    extracted weight files."""

    def __init__(self, det, image_size: int):
        self._det = det
        self.image_size = image_size

    def detect(self, image):
        boxes, probs, landmarks = self._det.detect(np.asarray(image),
                                                   landmarks=True)
        if boxes is None:
            return (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0, 5, 2)))
        return (np.asarray(boxes, np.float32),
                np.asarray(probs, np.float32),
                np.asarray(landmarks, np.float32))

    def extract(self, image):
        face = self._det(image)
        if face is None:
            return None
        return face.permute(1, 2, 0).byte().numpy()


def build_detector(image_size: int, weights_dir: Optional[str] = None,
                   align_mode: str = "crop", device=None):
    """An object with `.detect(img) -> (boxes, probs, landmarks)` and
    `.extract(img) -> Optional[uint8 [S, S, 3]]`: the port's cascade when
    weights are found, else a facenet_pytorch adapter, else None. Shared
    by offline preprocessing and `serve --align`. Either runs on `device`,
    the card unless 'cpu' is asked for.

    align_mode selects what `.extract` does with the best face: 'crop'
    (default) crops and resizes the detected box, the reference's
    behaviour; 'warp' similarity-warps the 5 landmarks onto the ArcFace
    template (detection/align.py), the insightface recipe."""
    if align_mode not in ("crop", "warp"):
        raise ValueError(f"align_mode must be 'crop' or 'warp', "
                         f"got {align_mode!r}")
    det = _build_raw_detector(image_size, weights_dir, device)
    if det is not None and align_mode == "warp":
        from face_recognition_models_tpu_torch.detection.align import (
            WarpAligner)
        det = WarpAligner(det, image_size)
    return det


def _build_raw_detector(image_size: int, weights_dir: Optional[str] = None,
                        device=None):
    weights_dir = weights_dir or _find_facenet_pytorch_weights()
    if weights_dir is not None:
        from face_recognition_models_tpu_torch.detection import (
            MTCNN,
            load_facenet_pytorch_weights,
        )
        return MTCNN(load_facenet_pytorch_weights(weights_dir),
                     image_size=image_size, min_face_size=20,
                     thresholds=(0.5, 0.7, 0.7), factor=0.709,
                     device=device)
    try:
        from facenet_pytorch import MTCNN as FacenetMTCNN
    except ImportError:
        return None
    det = FacenetMTCNN(image_size=image_size, margin=0, min_face_size=20,
                       thresholds=[0.5, 0.7, 0.7], factor=0.709,
                       post_process=False, device=resolve_device(device))
    return _FacenetPytorchAdapter(det, image_size)


def _build_mtcnn(image_size: int, weights_dir: Optional[str] = None,
                 align_mode: str = "crop", device=None):
    """The extract-callable form of build_detector (None when there is no
    detector)."""
    det = build_detector(image_size, weights_dir, align_mode=align_mode,
                         device=device)
    if det is None:
        return None
    return lambda im: det.extract(np.asarray(im))


def _center_crop_resize(im, size: int):
    w, h = im.size
    s = min(w, h)
    left, top = (w - s) // 2, (h - s) // 2
    return im.crop((left, top, left + s, top + s)).resize((size, size))


def preprocess_dataset(original_path: str, aligned_path: str,
                       image_size: int = 112,
                       mtcnn_weights: Optional[str] = None,
                       align_mode: str = "crop", device=None) -> dict:
    """Align every image under original_path into aligned_path (the same
    tree), detecting on `device` (the card unless 'cpu' is asked for).

    Returns counters: {'aligned': n, 'copied': n, 'fallback': bool}.
    """
    from PIL import Image

    mtcnn = _build_mtcnn(image_size, weights_dir=mtcnn_weights,
                         align_mode=align_mode, device=device)
    if mtcnn is None:
        print("WARNING: no MTCNN weights available — falling back to "
              "center-crop+resize (NO face detection). Provide "
              "--mtcnn-weights <dir with pnet.pt/rnet.pt/onet.pt> or "
              "install facenet_pytorch. Pre-aligned data is unaffected.")

    os.makedirs(aligned_path, exist_ok=True)
    stats = {"aligned": 0, "copied": 0, "fallback": mtcnn is None}
    for root, _dirs, files in os.walk(original_path):
        rel = os.path.relpath(root, original_path)
        new_root = os.path.join(aligned_path, rel)
        os.makedirs(new_root, exist_ok=True)
        for name in files:
            if not name.lower().endswith(_IMAGE_EXTS):
                continue
            src = os.path.join(root, name)
            dst = os.path.join(new_root, name)
            with Image.open(src) as im:
                im = im.convert("RGB")
                if mtcnn is not None:
                    face = mtcnn(im)  # uint8 [S, S, 3] or None
                    if face is not None:
                        Image.fromarray(face).save(dst)
                        stats["aligned"] += 1
                    else:
                        shutil.copy(src, dst)  # no face: keep the original
                        stats["copied"] += 1
                else:
                    _center_crop_resize(im, image_size).save(dst)
                    stats["aligned"] += 1
    return stats
