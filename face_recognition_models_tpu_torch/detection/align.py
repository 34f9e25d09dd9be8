"""Landmark-based face alignment (5-point similarity-transform warp). Port
of face_recognition_models_tpu/detection/align.py.

The reference aligns by cropping the detected box and resizing. The
insightface / ArcFace data recipe instead warps each face so its five MTCNN
landmarks land on a canonical template: the least-squares similarity
transform landmark -> template (Umeyama 1991, eq. 34-43), then a bilinear
inverse warp. This module is that path as an opt-in alignment mode
(`preprocess --align-mode warp`, `serve --align --align-mode warp`); the
default stays `crop`, the reference's. Everything here is host numpy, as
in the JAX package: alignment is per-image glue around the detector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Canonical 5-point destination template for a 112x112 ArcFace crop
# (left eye, right eye, nose tip, left mouth corner, right mouth corner),
# the de-facto-standard constants of the public ArcFace data pipeline.
# Coordinates are (x, y) pixels in the 112x112 output frame.
ARCFACE_TEMPLATE_112 = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def template_for(image_size: int) -> np.ndarray:
    """The 5-point template scaled to an `image_size` square output."""
    return ARCFACE_TEMPLATE_112 * (float(image_size) / 112.0)


class DegenerateLandmarksError(ValueError):
    """Landmarks with ~zero variance (coincident points): no similarity
    transform exists. Alignment callers treat this as 'no usable face'."""


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (rotation + uniform scale +
    translation) mapping `src` [K, 2] onto `dst` [K, 2].

    Closed form per Umeyama, "Least-squares estimation of transformation
    parameters between two point patterns" (IEEE TPAMI 1991): SVD of the
    cross-covariance with a determinant-sign correction so the estimate
    stays a proper rotation (no reflection). Returns the 2x3 matrix M
    with dst ~ M @ [src, 1]^T.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 2:
        raise ValueError(
            f"expected matching [K, 2] point sets, got {src.shape} vs "
            f"{dst.shape}")

    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cs, cd = src - mu_s, dst - mu_d
    var_s = (cs ** 2).sum() / len(src)
    # coincident source landmarks have no defined similarity transform:
    # fail loudly instead of dividing by ~0 into a NaN-filled warp
    if var_s <= 1e-8 * max(1.0, float(np.abs(src).max()) ** 2):
        raise DegenerateLandmarksError(
            "degenerate source landmarks (zero variance): cannot estimate "
            "a similarity transform")
    cov = cd.T @ cs / len(src)                       # [2, 2]

    u, s, vt = np.linalg.svd(cov)
    d = np.ones(2)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        d[-1] = -1.0
    rot = u @ np.diag(d) @ vt
    scale = (s * d).sum() / var_s
    t = mu_d - scale * rot @ mu_s

    out = np.empty((2, 3), np.float64)
    out[:, :2] = scale * rot
    out[:, 2] = t
    return out


def _invert_similarity(m: np.ndarray) -> np.ndarray:
    """Inverse of a 2x3 similarity/affine matrix, as 2x3."""
    a = np.linalg.inv(m[:, :2])
    out = np.empty((2, 3), np.float64)
    out[:, :2] = a
    out[:, 2] = -a @ m[:, 2]
    return out


def warp_affine(img: np.ndarray, m: np.ndarray, out_size: int) -> np.ndarray:
    """Bilinear inverse-warp of `img` [H, W, C] by the forward 2x3 map `m`
    (source -> output coordinates) into an [S, S, C] float32 canvas.
    Out-of-bounds samples are zero (a zero border)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    inv = _invert_similarity(np.asarray(m, np.float64))

    xs, ys = np.meshgrid(np.arange(out_size, dtype=np.float64),
                         np.arange(out_size, dtype=np.float64))
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(valid[..., None], vals, 0.0)

    top = sample(y0, x0) * (1 - fx) + sample(y0, x0 + 1) * fx
    bot = sample(y0 + 1, x0) * (1 - fx) + sample(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def norm_crop(img: np.ndarray, landmarks: np.ndarray,
              image_size: int = 112) -> np.ndarray:
    """Align one face: warp `img` so `landmarks` [5, 2] (x, y) land on the
    ArcFace template, returning a uint8 [image_size, image_size, 3] crop."""
    landmarks = np.asarray(landmarks, np.float64)
    if landmarks.shape != (5, 2):
        raise ValueError(f"expected [5, 2] landmarks, got {landmarks.shape}")
    m = umeyama(landmarks, template_for(image_size))
    out = warp_affine(img, m, image_size)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def extract_aligned(detector, image: np.ndarray,
                    image_size: Optional[int] = None
                    ) -> Optional[np.ndarray]:
    """Highest-probability face of `image`, similarity-warped to the
    template. `detector` is any `.detect(img) -> (boxes, probs,
    landmarks)` backend (the cascade or the facenet_pytorch adapter).
    Returns uint8 [S, S, 3], or None when nothing is found."""
    boxes, probs, landmarks = detector.detect(np.asarray(image))
    if len(boxes) == 0:
        return None
    best = int(np.argmax(probs))
    size = int(image_size or getattr(detector, "image_size", 112))
    try:
        return norm_crop(np.asarray(image), landmarks[best], size)
    except DegenerateLandmarksError:
        # a collapsed landmark set is a junk detection, not a face: report
        # "nothing usable" so callers take their no-face fallback
        return None


class WarpAligner:
    """A detector proxy whose `.extract` uses the similarity warp instead
    of the reference's box crop; `.detect` passes through unchanged. Lets
    `preprocess` and `serve` switch alignment modes without knowing which
    detection backend is underneath."""

    def __init__(self, detector, image_size: Optional[int] = None):
        self._detector = detector
        self.image_size = int(
            image_size or getattr(detector, "image_size", 112))

    def detect(self, image):
        return self._detector.detect(image)

    def extract(self, image):
        return extract_aligned(self._detector, image, self.image_size)
