"""The port's landmark alignment (face_recognition_models_tpu_torch/
detection/align.py) against the JAX package's, on the same numpy inputs.
Both are host numpy in float64 / float32, so every output is compared for
equality; the degenerate-landmark case raises the port's
DegenerateLandmarksError (a ValueError) and extract_aligned then reports
no face."""

import numpy as np
import pytest

from face_recognition_models_tpu.detection import align as ja
from face_recognition_models_tpu_torch.detection import align as ta


def _similarity(scale, theta, tx, ty):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[scale * c, -scale * s, tx],
                     [scale * s, scale * c, ty]], np.float64)


def _apply(m, pts):
    return pts @ m[:, :2].T + m[:, 2]


def test_template_matches_jax():
    np.testing.assert_array_equal(ta.ARCFACE_TEMPLATE_112,
                                  ja.ARCFACE_TEMPLATE_112)
    for size in (96, 112, 224):
        np.testing.assert_array_equal(ta.template_for(size),
                                      ja.template_for(size))


@pytest.mark.parametrize("reflect", [False, True])
def test_umeyama_matches_jax(reflect):
    rs = np.random.RandomState(1 + reflect)
    for _ in range(10):
        src = rs.uniform(0, 100, (5, 2))
        dst = _apply(_similarity(rs.uniform(0.5, 2), rs.uniform(-3, 3),
                                 *rs.uniform(-20, 20, 2)), src)
        dst += rs.normal(0, 2.0, dst.shape)
        if reflect:   # the determinant-sign correction's branch
            dst[:, 0] = -dst[:, 0]
        got = ta.umeyama(src, dst)
        np.testing.assert_array_equal(got, ja.umeyama(src, dst))
        assert np.linalg.det(got[:, :2]) > 0


def test_umeyama_refusals():
    with pytest.raises(ValueError):
        ta.umeyama(np.zeros((5, 2)), np.zeros((4, 2)))
    with pytest.raises(ValueError):
        ta.umeyama(np.zeros((5, 3)), np.zeros((5, 3)))
    same = np.full((5, 2), 40.0)
    with pytest.raises(ta.DegenerateLandmarksError):
        ta.umeyama(same, ta.ARCFACE_TEMPLATE_112)
    assert issubclass(ta.DegenerateLandmarksError, ValueError)


def test_warp_affine_matches_jax():
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (90, 70, 3)).astype(np.float32)
    for m in (_similarity(1.0, 0.0, 0.0, 0.0),
              _similarity(1.3, 0.4, -12.0, 7.5),
              _similarity(0.7, -2.0, 80.0, 100.0)):
        got = ta.warp_affine(img, m, 64)
        assert got.dtype == np.float32 and got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, ja.warp_affine(img, m, 64))


def test_norm_crop_matches_jax():
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (160, 140, 3), dtype=np.uint8)
    lmk = _apply(_similarity(1.2, 0.3, 10.0, 20.0),
                 ta.template_for(112).astype(np.float64))
    for size in (112, 96):
        got = ta.norm_crop(img, lmk, size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, ja.norm_crop(img, lmk, size))
    # landmarks already on the template: the identity warp
    img112 = rs.randint(0, 256, (112, 112, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        ta.norm_crop(img112, ta.ARCFACE_TEMPLATE_112), img112)
    with pytest.raises(ValueError, match="landmarks"):
        ta.norm_crop(img, np.zeros((4, 2)))


class _Detector:
    """The detect contract: two faces, the second the more probable."""

    image_size = 112

    def __init__(self, landmarks):
        self.landmarks = landmarks

    def detect(self, img):
        return (np.zeros((2, 4)), np.asarray([0.6, 0.9]),
                np.stack([self.landmarks + 3.0, self.landmarks]))


class _Empty:
    image_size = 112

    def detect(self, img):
        return np.zeros((0, 4)), np.zeros((0,)), np.zeros((0, 5, 2))


def test_extract_aligned_and_warp_aligner_match_jax():
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (150, 130, 3), dtype=np.uint8)
    lmk = _apply(_similarity(0.9, -0.2, 15.0, 12.0),
                 ta.template_for(112).astype(np.float64))
    det = _Detector(lmk)
    got = ta.extract_aligned(det, img)
    np.testing.assert_array_equal(got, ja.extract_aligned(det, img))
    np.testing.assert_array_equal(got, ta.norm_crop(img, lmk, 112))
    np.testing.assert_array_equal(ta.extract_aligned(det, img, 96),
                                  ja.extract_aligned(det, img, 96))
    aligner = ta.WarpAligner(det, 96)
    assert aligner.image_size == 96
    np.testing.assert_array_equal(aligner.extract(img),
                                  ja.WarpAligner(det, 96).extract(img))
    boxes, probs, lms = aligner.detect(img)
    np.testing.assert_array_equal(lms[1], lmk)
    assert ta.WarpAligner(det).image_size == 112
    assert ta.extract_aligned(_Empty(), img) is None


def test_degenerate_landmarks_report_no_face():
    img = np.zeros((64, 64, 3), np.uint8)
    det = _Detector(np.full((5, 2), 30.0))
    assert ta.extract_aligned(det, img) is None
    assert ja.extract_aligned(det, img) is None
    assert ta.WarpAligner(det).extract(img) is None
