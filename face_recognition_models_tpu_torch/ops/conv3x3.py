"""3x3, stride 1, SAME-padded NHWC convolution as an implicit GEMM.

Port of face_recognition_models_tpu/ops/conv3x3.py. Over the flattened rows
r = n*H*W + h*W + w,

    y[r] = sum_{a, b in {-1, 0, 1}} x[n, h + a, w + b] @ K[a + 1, b + 1]

with x taken as zero outside the image. On CUDA tensors a kernel of
`csrc/conv3x3.cu` runs, chosen by dtype and shape alone:

- bf16 with C and C_out multiples of 8: `conv3x3_same_bf16`, 128 x 128
  tiles of y staged with 16-byte `cp.async` copies and multiplied with
  `wgmma` on the tensor cores;
- bf16 at any other width: `conv3x3_same_bf16_ragged` (64 x 64 tiles,
  synchronous staging, wmma);
- fp32 with C and C_out multiples of 4: `conv3x3_same_f32`, fp32 accuracy
  on the tensor cores as 3xTF32 (a pre-pass splits the weight into tf32
  big and small parts in a workspace allocated here, then 128 x 128 tiles
  of y on `wgmma`, three tf32 products for each fp32 one);
- fp32 at any other width: `conv3x3_same_f32_ragged`, IEEE fp32 on the
  CUDA cores.

On CPU tensors `conv3x3_same_plain` runs, which is also the reference the
card is checked against. There is no fallback from the card to the plain
code, nor from one route to another. As in the JAX package, no model uses
it: the trunks' convolutions are cuDNN's, and this op is reached through its
benchmark, `python -m face_recognition_models_tpu_torch.scripts.bench_conv3x3`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Launches per route since the last reset_launch_counts(); bumped only where
# the wrapper launches a kernel. "conv3x3_same" is the bf16 16-byte route,
# "conv3x3_same_f32" the fp32 one.
_ROUTES = {"conv3x3_same": "conv3x3_same_bf16",
           "conv3x3_same_ragged": "conv3x3_same_bf16_ragged",
           "conv3x3_same_f32": "conv3x3_same_f32",
           "conv3x3_same_f32_ragged": "conv3x3_same_f32_ragged"}
# the 16-byte routes: their kernels copy x (bf16: and w9) 16 bytes at a time
_ALIGNED = ("conv3x3_same", "conv3x3_same_f32")
launch_counts = {key: 0 for key in _ROUTES}
_TAPS = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_shapes(x, kernel, block_n):
    """The JAX function's contract: NHWC x, HWIO [3, 3, C, C_out] kernel,
    N divisible by block_n."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [N, H, W, C], got {tuple(x.shape)}")
    n, _, _, c = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, c):
        raise ValueError(f"need [3, 3, {c}, *] kernel, got "
                         f"{tuple(kernel.shape)}")
    if n % block_n:
        raise ValueError(f"batch {n} must divide by block_n {block_n}")


def conv3x3_same_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The formula above as 9 shifted fp32 matmuls over a zero-padded NHWC
    copy of x; the kernel is cast to x.dtype first, the sum to x.dtype last."""
    _, h, w, _ = x.shape
    k = kernel.to(x.dtype).to(torch.float32)
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    y = None
    for a, b in _TAPS:
        tap = xp[:, 1 + a:1 + a + h, 1 + b:1 + b + w, :] @ k[a + 1, b + 1]
        y = tap if y is None else y + tap
    return y.to(x.dtype)


def _lib():
    from face_recognition_models_tpu_torch.ops import _build

    lib = _build.load("conv3x3")
    if not getattr(lib, "_typed", False):
        for name in _ROUTES.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p] * (2 if name == "conv3x3_same_f32" else 1)
            fn.restype = ctypes.c_int
        lib.conv3x3_f32_workspace.argtypes = [ctypes.c_int] * 2
        lib.conv3x3_f32_workspace.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def route(dtype, c: int, co: int) -> str:
    """The launch_counts key of the kernel that runs x of `dtype` with C
    input and C_out output channels on the card."""
    if dtype == torch.float32:
        return "conv3x3_same_f32" if c % 4 == 0 and co % 4 == 0 else \
            "conv3x3_same_f32_ragged"
    return "conv3x3_same" if c % 8 == 0 and co % 8 == 0 else \
        "conv3x3_same_ragged"


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor, *,
                 block_n: int = 16) -> torch.Tensor:
    """3x3, stride 1, SAME padding, NHWC conv. `x` [N, H, W, C] (bf16 or
    fp32 on the card; bf16 is the benchmarked case), `kernel` [3, 3, C,
    C_out], cast to x.dtype; fp32 accumulation, output [N, H, W, C_out] in
    x.dtype.

    `block_n` is the JAX function's images-per-block and stays part of the
    contract (N must divide by it, else ValueError); the CUDA kernel tiles
    the flattened rows as it likes and does not otherwise read it.
    """
    _check_shapes(x, kernel, block_n)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same: expected CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv3x3_same: x must be bfloat16 or float32 on "
                         f"the card, got {x.dtype}")
    if kernel.device != x.device:
        raise ValueError(f"conv3x3_same: kernel must be on {x.device}")
    return _launch(route(x.dtype, x.shape[3], kernel.shape[3]), x, kernel)


def _launch(name: str, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One launch of route `name` (a launch_counts key) on CUDA tensors that
    conv3x3_same has checked. Its caller names the route: conv3x3_same by
    shape, a measurement by choice."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    x = x.contiguous()
    w9 = kernel.to(x.dtype).reshape(9, c, co).contiguous()
    if name in _ALIGNED:  # 16-byte copies: a view may start unaligned
        x, w9 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w9))
    y = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    if y.numel():
        with torch.cuda.device(x.device):
            lib = _lib()
            args = [x.data_ptr(), w9.data_ptr(), y.data_ptr(), n, h, w, c, co]
            if name == "conv3x3_same_f32":  # w_big, w_small: see the source
                work = torch.empty(lib.conv3x3_f32_workspace(c, co),
                                   dtype=torch.float32, device=x.device)
                args.append(work.data_ptr())
            err = getattr(lib, _ROUTES[name])(
                *args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"conv3x3_same: CUDA error {err} at launch")
        launch_counts[name] += 1
    return y
