"""The port's implicit-GEMM 3x3 conv (`ops/conv3x3.py`) against the JAX
package's Pallas kernel in interpret mode, and its benchmark entry point.

Inputs are made with numpy from a seed and handed to both; the port's side
runs the plain version, which is what its wrapper computes on CPU tensors.
The shapes and tolerances are those of tests/test_conv3x3.py: fp32 at
rtol = atol = 1e-5 (fp32 sums of up to 9 x 16 terms in different orders),
bf16 at 2e-2 (both accumulate in fp32; the outputs are rounded to bf16 and
may land one bf16 ulp apart).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_recognition_models_tpu.ops.conv3x3 import conv3x3_same as jconv
from face_recognition_models_tpu_torch.ops import conv3x3 as tconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "n,h,w,c,co,bn",
    [
        (4, 7, 7, 16, 24, 2),    # multi-image block
        (4, 14, 14, 8, 8, 4),    # whole batch in one block
        (2, 5, 9, 4, 12, 1),     # non-square, single-image block
        (6, 4, 4, 8, 8, 3),      # n not a power of two
    ],
)
def test_conv3x3_matches_jax(n, h, w, c, co, bn):
    rs = np.random.RandomState(0)
    x = rs.randn(n, h, w, c).astype(np.float32)
    k = (0.1 * rs.randn(3, 3, c, co)).astype(np.float32)
    want = jconv(jnp.asarray(x), jnp.asarray(k), block_n=bn, interpret=True)
    got = tconv.conv3x3_same(torch.tensor(x), torch.tensor(k), block_n=bn)
    assert got.dtype == torch.float32 and got.shape == (n, h, w, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_conv3x3_bf16_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 7, 32).astype(np.float32)
    k = (0.1 * rs.randn(3, 3, 32, 16)).astype(np.float32)
    want = jconv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                 block_n=2, interpret=True)
    got = tconv.conv3x3_same(torch.tensor(x).bfloat16(),
                             torch.tensor(k).bfloat16(), block_n=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_conv3x3_casts_the_kernel_to_x_dtype():
    """An fp32 kernel with bf16 x is rounded to bf16 first, as in JAX."""
    rs = np.random.RandomState(2)
    x = torch.tensor(rs.randn(2, 5, 5, 8).astype(np.float32)).bfloat16()
    k = torch.tensor((0.1 * rs.randn(3, 3, 8, 8)).astype(np.float32))
    a = tconv.conv3x3_same(x, k, block_n=2)
    b = tconv.conv3x3_same(x, k.bfloat16(), block_n=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_conv3x3_plain_matches_conv2d():
    """The plain version is the SAME cross-correlation of F.conv2d."""
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(3, 6, 5, 4).astype(np.float32))
    k = torch.tensor((0.1 * rs.randn(3, 3, 4, 6)).astype(np.float32))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      k.permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(tconv.conv3x3_same_plain(x, k),
                               want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_conv3x3_rejects_bad_shapes():
    x = torch.zeros(4, 7, 7, 8)
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, torch.zeros(5, 5, 8, 8))
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, torch.zeros(3, 3, 4, 8), block_n=4)  # kc != c
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, torch.zeros(3, 3, 8, 8), block_n=3)
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, torch.zeros(3, 3, 8, 8))  # default block_n 16


def test_conv3x3_wrapper_launches_nothing_on_cpu():
    tconv.reset_launch_counts()
    tconv.conv3x3_same(torch.zeros(2, 3, 3, 4), torch.zeros(3, 3, 4, 4),
                       block_n=2)
    assert tconv.launch_counts == {"conv3x3_same": 0,
                                   "conv3x3_same_ragged": 0,
                                   "conv3x3_same_f32": 0}


@pytest.mark.parametrize("dtype,c,co,want", [
    (torch.bfloat16, 256, 256, "conv3x3_same"),
    (torch.bfloat16, 40, 24, "conv3x3_same"),
    (torch.bfloat16, 12, 16, "conv3x3_same_ragged"),
    (torch.bfloat16, 16, 12, "conv3x3_same_ragged"),
    (torch.float32, 256, 256, "conv3x3_same_f32"),
    (torch.float32, 12, 12, "conv3x3_same_f32")])
def test_conv3x3_route_is_chosen_by_shape(dtype, c, co, want):
    """bf16 takes the 16-byte route when C and C_out are multiples of 8, the
    ragged route otherwise; fp32 has one kernel."""
    assert tconv.route(dtype, c, co) == want


def test_bench_module_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m",
         "face_recognition_models_tpu_torch.scripts.bench_conv3x3",
         "--device", "cpu", "--batch", "2", "--shape", "4,8", "--iters", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert out["metric"] == "conv3x3" and out["path"] == "kernel"
    assert out["shape"] == [2, 4, 4, 8, 8] and out["block_n"] == 2
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert out["ms"] > 0 and out["tflops"] > 0
