"""Benchmark the implicit-GEMM 3x3 conv (ops/conv3x3.py, csrc/conv3x3.cu)
against cuDNN's convolution, one shape per process:

    for s in 28,128 14,256 7,512; do
      for p in kernel cudnn; do
        python -m face_recognition_models_tpu_torch.scripts.bench_conv3x3 \\
            --shape $s --path $p; done; done

`--path cudnn` is `F.conv2d` on channels-last tensors (TF32 off), the
yardstick. Each iteration's input is the previous output renormalised, so
the chain neither explodes nor goes denormal. The conv alone is timed with
CUDA events around it in every iteration (the renormalisation is not in
`ms`; `chain_ms` is the whole iteration), and the best of N_REPS chains is
kept. Prints one JSON line with the card's name and power limit. With
`--device cpu` it runs the plain version and times with the host clock.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
import torch.nn.functional as F

from face_recognition_models_tpu_torch.ops import conv3x3
from face_recognition_models_tpu_torch.utils.device import (nvidia_smi,
                                                            resolve_device)

N_REPS = 5


def conv_fn(path, k, block_n):
    """x -> y of `path` with the HWIO kernel k; cuDNN's weight is laid out
    once, here."""
    if path == "kernel":
        return lambda x: conv3x3.conv3x3_same(x, k, block_n=block_n)
    # HWIO -> OIHW in channels-last memory, as cuDNN takes NHWC data
    w = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda x: F.conv2d(x.permute(0, 3, 1, 2), w,
                              padding=1).permute(0, 2, 3, 1)


def bench(shape: str = "7,512", batch: int = 512, path: str = "kernel",
          iters: int = 20, dtype: str = "bfloat16", block_n: int = 0,
          device=None, seed: int = 0) -> dict:
    """Time `path` at spatial size H = W and channels C = C_out given by
    `shape` ("H,C"); returns the JSON line's fields."""
    dev = resolve_device(device)
    h, c = (int(v) for v in shape.split(","))
    n, co = batch, c
    dt = getattr(torch, dtype)
    block_n = block_n or math.gcd(n, 16)
    g = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn(n, h, h, c, device=dev, generator=g).to(dt)
    k = (0.05 * torch.randn(3, 3, c, co, device=dev, generator=g)).to(dt)
    conv = conv_fn(path, k, block_n)
    cuda = dev.type == "cuda"

    def chain():
        """(conv seconds, iteration seconds) summed over one chain."""
        x = x0
        conv_s, total_s = 0.0, 0.0
        for _ in range(iters):
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                y = conv(x)
                ev[1].record()
                x = y * torch.rsqrt(y.float().pow(2).mean() + 1e-6).to(dt)
                ev[2].record()
                torch.cuda.synchronize()
                conv_s += ev[0].elapsed_time(ev[1]) / 1e3
                total_s += ev[0].elapsed_time(ev[2]) / 1e3
            else:
                t0 = time.perf_counter()
                y = conv(x)
                t1 = time.perf_counter()
                x = y * torch.rsqrt(y.float().pow(2).mean() + 1e-6).to(dt)
                conv_s += t1 - t0
                total_s += time.perf_counter() - t0
        if not bool(torch.isfinite(x.float()).all()):
            raise RuntimeError("conv3x3 benchmark: the chain went non-finite")
        return conv_s / iters, total_s / iters

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        chain()  # warm-up (and the kernel's build on first use)
        best = min((chain() for _ in range(N_REPS)), key=lambda t: t[0])
    flops = 2 * n * h * h * 9 * c * co
    return {"metric": "conv3x3", "path": path, "shape": [n, h, h, c, co],
            "dtype": dtype, "block_n": block_n, "iters": iters,
            "device": dev.type,
            "name": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "nvidia_smi": nvidia_smi() if cuda else None,
            "ms": best[0] * 1e3, "chain_ms": best[1] * 1e3,
            "tflops": flops / best[0] / 1e12}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="7,512",
                    help="H,C: spatial size and channels (C_out = C)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--path", choices=["kernel", "cudnn"], default="kernel")
    ap.add_argument("--block-n", type=int, default=0,
                    help="images per block of the JAX contract "
                         "(0 = gcd(batch, 16)); N must divide by it")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' runs the plain "
                         "version")
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.shape, args.batch, args.path, args.iters,
                           args.dtype, args.block_n, args.device)),
          flush=True)


if __name__ == "__main__":
    main()
