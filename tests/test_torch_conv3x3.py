"""The port's implicit-GEMM 3x3 conv (`ops/conv3x3.py`) against the JAX
package's Pallas kernel in interpret mode, and its benchmark entry point.

Inputs are made with numpy from a seed and handed to both; the port's side
runs the plain version, which is what its wrapper computes on CPU tensors.
The shapes and tolerances are those of tests/test_conv3x3.py: fp32 at
rtol = atol = 1e-5 (fp32 sums of up to 9 x 16 terms in different orders),
bf16 at 2e-2 (both accumulate in fp32; the outputs are rounded to bf16 and
may land one bf16 ulp apart).

The fp32 route on the card computes each product as three tf32 products
(3xTF32, csrc/conv3x3.cu). Its arithmetic is emulated here in torch: the
split through int32 bit operations, the stage-wise sums of the kernel, and
the tensor cores' fp32 accumulation taken either to nearest or toward zero.
It is held to the JAX function at the same tolerances, and at 1e-4 (the
card's tolerance for 2,304-deep sums) at C = C_out = 256.
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
                                   "conv3x3_same_f32": 0,
                                   "conv3x3_same_f32_ragged": 0}


@pytest.mark.parametrize("dtype,c,co,want", [
    (torch.bfloat16, 256, 256, "conv3x3_same"),
    (torch.bfloat16, 40, 24, "conv3x3_same"),
    (torch.bfloat16, 12, 16, "conv3x3_same_ragged"),
    (torch.bfloat16, 16, 12, "conv3x3_same_ragged"),
    (torch.float32, 256, 256, "conv3x3_same_f32"),
    (torch.float32, 12, 12, "conv3x3_same_f32"),
    (torch.float32, 40, 136, "conv3x3_same_f32"),
    (torch.float32, 8, 4, "conv3x3_same_f32"),
    (torch.float32, 6, 8, "conv3x3_same_f32_ragged"),
    (torch.float32, 8, 10, "conv3x3_same_f32_ragged"),
    (torch.float32, 6, 10, "conv3x3_same_f32_ragged")])
def test_conv3x3_route_is_chosen_by_shape(dtype, c, co, want):
    """bf16 takes the 16-byte route when C and C_out are multiples of 8, the
    ragged route otherwise; fp32 takes the 3xTF32 route when they are
    multiples of 4 (16-byte fp32 copies), the IEEE ragged route otherwise."""
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


# ---- the 3xTF32 route's arithmetic (csrc/conv3x3.cu, conv3x3_same_f32) ----

STAGE = 32   # input channels a stage of the kernel sums before its fp32 add
KSTEP = 8    # the depth of one tf32 wgmma


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 `v` rounded to tf32 as cvt.rna.tf32.f32 rounds: to nearest, ties
    away from zero. On the int32 bits: add half of the 13 bits that tf32
    drops to the magnitude, then clear them."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(v: torch.Tensor):
    """(big, small): big = tf32(v), small = tf32(v - big)."""
    big = _tf32(v)
    return big, _tf32(v - big)


def _to_fp32(v: torch.Tensor, toward_zero: bool) -> torch.Tensor:
    """float64 `v` rounded to fp32, to nearest or toward zero."""
    f = v.to(torch.float32)
    if toward_zero:
        over = f.double().abs() > v.abs()
        f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def _tf32x3_conv(x, k, toward_zero, stage=STAGE):
    """The fp32 route's sums on the CPU. Per tap and per `stage` input
    channels (zero-padded past C), each k step of KSTEP adds its three
    products a_small.b_big, a_big.b_small, a_big.b_big to a fresh fp32
    partial, summed exactly (float64; the products of tf32 values are exact)
    and rounded to fp32 after each product, as one wgmma does; the partial
    is then added to the running sum with an IEEE fp32 add. `stage` =
    9 * C gives one accumulator over the whole of K instead."""
    n, h, w, c = x.shape
    co = k.shape[3]
    cp = -(-c // STAGE) * STAGE
    xp = torch.nn.functional.pad(x, (0, cp - c, 1, 1, 1, 1))
    kp = torch.nn.functional.pad(k, (0, 0, 0, cp - c))
    cols = torch.cat([xp[:, 1 + a:1 + a + h, 1 + b:1 + b + w, :]
                      .reshape(-1, cp) for a, b in tconv._TAPS], 1)
    xb, xs = (t.double() for t in _split(cols))
    wb, ws = (t.double() for t in _split(kp.reshape(9 * cp, co)))
    acc = torch.zeros(cols.shape[0], co, dtype=torch.float32)
    part = torch.zeros_like(acc)
    for k0 in range(0, 9 * cp, KSTEP):
        ks = slice(k0, k0 + KSTEP)
        for a, b in ((xs, wb), (xb, ws), (xb, wb)):
            part = _to_fp32(part.double() + a[:, ks] @ b[ks], toward_zero)
        if (k0 + KSTEP) % stage == 0:
            acc, part = acc + part, torch.zeros_like(part)
    return (acc + part).reshape(n, h, w, co)


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
def test_tf32_split_is_exact_to_2_pow_22(scale):
    """big + small gives a normal fp32 x back to within 2^-22 of |x|; both
    parts are tf32 (their 13 low bits 0) and big is x to within half a tf32
    ulp, 2^-11 of |x|."""
    rs = np.random.RandomState(4)
    x = torch.tensor((scale * rs.randn(4096)).astype(np.float32))
    x[:4] = torch.tensor([1.0, -1.0, 0.0, 1.0 + 2.0 ** -11])  # a tie: away
    big, small = _split(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(big[3]) == 1.0 + 2.0 ** -10
    xd = x.double()
    assert bool(((big.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((big.double() + small.double() - xd).abs()
                 <= 2.0 ** -22 * xd.abs()).all())


@pytest.mark.parametrize("toward_zero", [False, True],
                         ids=["nearest", "toward_zero"])
@pytest.mark.parametrize(
    "n,h,w,c,co,bn,tol",
    [
        (4, 7, 7, 16, 24, 2, 1e-5),      # the JAX test shapes
        (4, 14, 14, 8, 8, 4, 1e-5),
        (2, 5, 9, 4, 12, 1, 1e-5),
        (6, 4, 4, 8, 8, 3, 1e-5),
        (2, 6, 6, 256, 256, 2, 1e-4),    # 2,304-deep sums
    ],
)
def test_tf32x3_conv_matches_jax(n, h, w, c, co, bn, tol, toward_zero):
    rs = np.random.RandomState(0)
    x = rs.randn(n, h, w, c).astype(np.float32)
    k = (0.1 * rs.randn(3, 3, c, co)).astype(np.float32)
    want = jconv(jnp.asarray(x), jnp.asarray(k), block_n=bn, interpret=True)
    got = _tf32x3_conv(torch.tensor(x), torch.tensor(k), toward_zero)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_tf32x3_stage_sums_keep_a_truncating_accumulator_in_tolerance():
    """Why the kernel adds each stage's partial into its own fp32 sums: if
    the tensor cores' fp32 accumulation truncated, one accumulator carried
    over all 9 * C = 648 terms of the card tests' widest fp32 case would
    leave rtol = atol = 1e-5, while 32-channel stages stay inside it."""
    rs = np.random.RandomState(5)
    x = torch.tensor(rs.randn(16, 7, 7, 72).astype(np.float32))
    k = torch.tensor((0.1 * rs.randn(3, 3, 72, 40)).astype(np.float32))
    want = tconv.conv3x3_same_plain(x, k)

    def worst(got):
        return float(((got - want).abs() / (1e-5 + 1e-5 * want.abs())).max())

    assert worst(_tf32x3_conv(x, k, toward_zero=True)) < 1.0
    assert worst(_tf32x3_conv(x, k, toward_zero=True, stage=9 * 96)) > 1.0
