"""The port's MTCNN cascade (face_recognition_models_tpu_torch/detection/
mtcnn.py) against the JAX package's, on the CPU.

The same weights cross from the JAX param trees through
utils/weights.mtcnn_from_jax, or load in both packages from one seeded
facenet_pytorch-layout .pt directory. Tolerances:
- each net's outputs at rtol 1e-5 / atol 1e-5 (fp32 convs and products on
  both sides);
- the pyramid resize against jax.image.resize 'bilinear' at every scale
  of the tested images, atol 5e-6 (the normalised image is in [-1, 1];
  the two sum their taps in other orders);
- NMS, square and regress equal;
- `detect` on the three cases of tests/test_mtcnn.py's numpy oracle: the
  same box count, boxes within 1e-3, probs within 1e-5, landmarks within
  1e-3 (that test's bounds); `extract` equal byte for byte.
Each JAX `detect` (1.6-4.9 s cold here) runs once, in a module fixture.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu.detection import mtcnn as jm
from face_recognition_models_tpu_torch.detection import mtcnn as tm
from face_recognition_models_tpu_torch.utils.weights import mtcnn_from_jax
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

# (seed, image shape, thresholds) of tests/test_mtcnn.py's oracle test
CASES = [(0, (160, 120), (0.35, 0.25, 0.25)),
         (1, (96, 144), (0.45, 0.3, 0.3)),
         (2, (128, 128), (0.35, 0.99, 0.99))]


def _jax_params(seed):
    return jax.tree.map(np.asarray,
                        jm.MTCNN.init_random(jax.random.PRNGKey(seed)))


def _image(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape + (3,),
                                               np.uint8)


@pytest.fixture(scope="module")
def detections():
    """{seed: (JAX (boxes, probs, landmarks, extract), the port's)}."""
    out = {}
    for seed, shape, th in CASES:
        params = _jax_params(seed)
        img = _image(seed, shape)
        jd = jm.MTCNN(params, image_size=112, thresholds=th)
        td = tm.MTCNN(mtcnn_from_jax(params), image_size=112, thresholds=th,
                      device="cpu")
        out[seed] = ((*jd.detect(img), jd.extract(img)),
                     (*td.detect(img), td.extract(img)))
    return out


def _net_outputs(net, params, x_nhwc):
    """(JAX outputs, port outputs) of one net on the same NHWC input, both
    as NHWC-shaped numpy arrays."""
    jnet = {"pnet": jm.PNet, "rnet": jm.RNet, "onet": jm.ONet}[net]()
    want = jnet.apply({"params": params[net]}, jnp.asarray(x_nhwc))
    module = tm.NETS[net]()
    module.load_state_dict(mtcnn_from_jax(params)[net])
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    if net == "pnet":
        got = [g.permute(0, 2, 3, 1) for g in got]
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("net,size", [("pnet", (50, 40)), ("pnet", (12, 12)),
                                      ("rnet", (24, 24)),
                                      ("onet", (48, 48))])
def test_net_matches_jax(net, size):
    params = _jax_params(3)
    x = np.random.RandomState(4).uniform(-1, 1, (2, *size, 3)).astype(
        np.float32)
    want, got = _net_outputs(net, params, x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_ceil_mode_pool_output_shapes():
    """P-Net over 51 x 41: the ceil-mode pool keeps the partial window of an
    odd side (49 -> 25, not 24), so 21 x 16 come out where floor pooling
    would give (in - 12) // 2 + 1 = 20 x 15."""
    params = mtcnn_from_jax(_jax_params(0))
    net = tm.PNet()
    net.load_state_dict(params["pnet"])
    prob, reg = net(torch.zeros(2, 3, 51, 41))
    assert prob.shape == (2, 2, 21, 16) and reg.shape == (2, 4, 21, 16)
    np.testing.assert_allclose(prob.sum(1).detach().numpy(), 1.0, rtol=1e-5)


def _scales_of(shape):
    det = tm.MTCNN(mtcnn_from_jax(_jax_params(0)), device="cpu")
    return det._scales(*shape)


@pytest.mark.parametrize("shape", [s for _, s, _ in CASES] + [(250, 250)])
def test_pyramid_resize_matches_jax_resize(shape):
    img = _image(7, shape)
    norm = jm._normalize(img)
    x = torch.from_numpy(norm).permute(2, 0, 1)[None]
    scales = _scales_of(shape)
    assert len(scales) >= 4
    h, w = shape
    for scale in scales:
        sh, sw = int(np.ceil(h * scale)), int(np.ceil(w * scale))
        want = np.asarray(jax.image.resize(jnp.asarray(norm), (sh, sw, 3),
                                           "bilinear"))
        got = tm.pyramid_resize(x, (sh, sw))[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6,
                                   err_msg=f"scale {scale}")


def test_nms_square_regress_match_jax():
    rs = np.random.RandomState(5)
    xy = rs.uniform(0, 100, (60, 2))
    wh = rs.uniform(5, 40, (60, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rs.uniform(0, 1, 60).astype(np.float32)
    for thresh, mode in ((0.5, "union"), (0.7, "union"), (0.7, "min")):
        np.testing.assert_array_equal(tm._nms(boxes, scores, thresh, mode),
                                      jm._nms(boxes, scores, thresh, mode))
    np.testing.assert_array_equal(tm._square(boxes), jm._square(boxes))
    reg = rs.uniform(-0.2, 0.2, (60, 4)).astype(np.float32)
    np.testing.assert_array_equal(tm._regress(boxes, reg),
                                  jm._regress(boxes, reg))
    patch = rs.uniform(0, 255, (37, 29, 3)).astype(np.float32)
    np.testing.assert_array_equal(tm._np_bilinear_resize(patch, 24),
                                  jm._np_bilinear_resize(patch, 24))


def test_facenet_pytorch_weights_load_in_both_packages(tmp_path):
    """One seeded facenet_pytorch-layout directory (pnet.pt / rnet.pt /
    onet.pt): both packages' load_facenet_pytorch_weights give nets with
    equal outputs, and the port's state_dicts are the files'."""
    sds = tm.MTCNN.init_random(torch.Generator().manual_seed(11))
    for name, sd in sds.items():
        torch.save(sd, os.path.join(tmp_path, f"{name}.pt"))
    jparams = jax.tree.map(np.asarray,
                           jm.load_facenet_pytorch_weights(str(tmp_path)))
    tsds = tm.load_facenet_pytorch_weights(str(tmp_path))
    for name, sd in sds.items():
        assert tsds[name].keys() == sd.keys()
        for k, v in sd.items():
            torch.testing.assert_close(tsds[name][k], v, rtol=0, atol=0)
    x = np.random.RandomState(6).uniform(-1, 1, (2, 48, 48, 3)).astype(
        np.float32)
    for net, size in (("pnet", 30), ("rnet", 24), ("onet", 48)):
        want, got = _net_outputs(net, jparams, x[:, :size, :size])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [c[0] for c in CASES])
def test_detect_matches_jax(detections, seed):
    (jb, jp, jl, _), (tb, tp, tl, _) = detections[seed]
    assert tb.shape == jb.shape, f"box count {tb.shape} vs JAX {jb.shape}"
    assert tp.shape == jp.shape and tl.shape == jl.shape
    np.testing.assert_allclose(tb, jb, atol=1e-3)
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    if seed == 2:   # R/O gates kill everything
        assert len(tb) == 0
    else:
        assert len(tb) > 0


@pytest.mark.parametrize("seed", [c[0] for c in CASES])
def test_extract_matches_jax(detections, seed):
    (*_, want), (*_, got) = detections[seed]
    if want is None:
        assert got is None
        return
    assert got.dtype == np.uint8 and got.shape == (112, 112, 3)
    np.testing.assert_array_equal(got, want)


def test_init_random_is_seeded_and_device_defaults_to_the_card():
    a = tm.MTCNN.init_random(torch.Generator().manual_seed(1))
    b = tm.MTCNN.init_random(torch.Generator().manual_seed(1))
    c = tm.MTCNN.init_random(torch.Generator().manual_seed(2))
    assert all(torch.equal(a["onet"][k], b["onet"][k]) for k in a["onet"])
    assert not torch.equal(a["onet"]["dense5.weight"],
                           c["onet"]["dense5.weight"])
    assert float(a["pnet"]["prelu1.weight"][0]) == 0.25
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.MTCNN(a)
