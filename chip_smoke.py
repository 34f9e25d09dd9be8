#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit
and no result line:

1. device  - the card's name and power limit (nvidia-smi).
2. build   - nvcc builds every kernel source of the port (sm_90a), all at
             once, into the git-ignored build/ directory.
3. kernels - each CUDA kernel against its plain PyTorch version: at the
             training shape (N=512, D=512, C=10,575), at N=24 / C=100 in all
             three margin modes with an out-of-range label, and the backward
             at N=4,096; the memory-blended (_mem) kernels at N=24 / C=100
             with lam mixing 0, 0.15 and 1, and at the training shape with
             lam and memory from a VPL state after one step, and with a dense
             lam (0.15 on every class, as after ~100 VPL steps). The same for
             the bf16 tensor-core kernels (_bf16, mm_dtype=torch.bfloat16),
             plus N=40 / D=72 / C=300 (D not a multiple of 16). The split
             fp32 and bf16 fwd and bwd_dx also at shapes of several class
             ranges (N=1, N not a multiple of 32, a ragged last range, D=72,
             a last range holding only a target column), and the fp32 and
             bf16 bwd_dw at shapes of several row ranges (N=600 and 520, a
             ragged last range): each range's partials and the combine
             kernels against their plain versions, and two launches of
             every entry bitwise equal. Times (CUDA events, after warm-up)
             of the kernel, its plain version and the eager library head
             (the median of 5 repeats, with their spread), beside the
             bound.
4. conv    - the implicit-GEMM 3x3 conv against its plain version at small
             fp32 and bf16 shapes on each route (the 16-byte routes and the
             ragged ones are chosen by width: bf16 wgmma or wmma, fp32
             3xTF32 wgmma or IEEE FMA), then at the ResNet-50 stage shapes
             of its benchmark (b512 bf16: 28x28x128, 14x14x256, 7x7x512),
             timed beside its plain version and cuDNN's channels-last conv;
             and the fp32 route at b512 14x14x256 beside cuDNN's fp32 conv
             (TF32 off).
5. train   - the port's `fit` at full width (resnet18, C=10,575, batch 512,
             112 px, bf16), 5 steps each of the ArcFace, VPL-ArcFace and
             QAFace heads. Each path's launch counters must equal the steps
             and the other kernels' stay 0; VPL must have active memory
             classes from step 1. Then one step from the same state through
             the kernels and through the eager head (ArcFace, VPL-ArcFace),
             and QAFace's BatchNorm buffers after a step with its degraded
             view against a step without it.
5b. heads  - 3 full-width `fit` steps of each of the eleven other heads
             (sphereface, cosface, mv_softmax, curricularface, adaface,
             elastic_cosface, elastic_arcface, magface, combined_margin on
             the kernels, launched once a step; subcenter_arcface and adacos
             on the eager head, launching none), then one step through the
             kernels against one through the eager head for each fused
             head, and each head's forward + backward device ms (kernels
             and eager) at N=512, D=512, C=10,575.
5c. pretrained - a seeded torchvision-layout resnet18 state_dict (1000-class
             fc) saved and loaded (seconds), then 2 ArcFace steps of `fit`
             from it with bf16 BatchNorm: the trunk equals the file before
             step 1.
5d. scan   - step batching (`train --scan-steps`): for each of ArcFace,
             VPL-ArcFace, QAFace, sphereface, curricularface, adaface,
             adacos (eager head) and elastic_arcface, 10 full-width `fit`
             steps with scan_steps=4 (two replays of a CUDA graph of 4
             steps, then two leftover eager steps) against the same 10
             steps one at a time from the same seeded state and batches:
             losses, every state tensor (parameters, BatchNorm and momentum
             buffers, head state, step count, lr) and the step generator
             bit for bit; each replay runs 4 launches of each of the head's
             kernels. Then `scripts/bench_steps` (eager against K = 4 and
             8, 3 alternating pairs of 64 steps: ms/step after the first
             chunk, img/s, peak GB, capture seconds) and the profiler's
             host and device ms/step and idle share of each path.
6. head_bf16 - one forward and backward through the public
             `fused_margin_ce` and `fused_margin_ce_mem` with
             mm_dtype=torch.bfloat16 at the training shape: one launch of
             each bf16 kernel and none of the fp32 ones; the loss within 5%
             of the fp32 loss.
7. conv3x3_bench - the conv's benchmark entry point
             (`scripts/bench_conv3x3.bench`) on the card at 14x14x256, b512,
             in bf16 and in fp32: the kernel path and the cuDNN path.
8. conv_f32 - the fp32 routes at b512 14x14x256: two launches of the
             3xTF32 route bitwise equal, its pre-pass and main kernel timed
             apart by torch.profiler, the plain version's time, and the
             ragged IEEE kernel (launched by name) against the plain version
             and timed. After the train phases, as device_times.
9. device_times - at the training shape, a device-only time (`device_ms`:
             the calls queued behind a spin kernel) of each bf16 kernel and
             of the eager bf16 backward, and the bf16 dx and dw entries'
             launches timed apart by torch.profiler.
10. checkpoint - `fit` at full width (resnet18, C=10,575, b512, 112 px,
             ArcFace, fused head) on 256 synthetic identities x 4 images,
             with a CheckpointManager in a temporary directory: run A
             takes 2 epochs x 2 steps; run B 1 epoch, then a new `fit`
             with continue_train='latest' for epoch 2, both in PyTorch's
             default (not deterministic) mode. Run B's losses, kernel_w,
             backbone tensors and momentum buffers must equal run A's bit
             for bit. A state restored into a fresh one
             equals the saved one bit for bit, channels-last weights
             included; keep-3 rotation and min_loss resume (the epoch files
             go). File sizes, save and restore seconds.
11. eval   - run A's <model>_final through `restore_backbone`, on a
             synthetic LFW-size benchmark (6,000 pairs, half genuine, over
             12,000 `synthetic_identities` images, a .bin of uint8 arrays):
             its embeddings equal the live state's bit for bit; the `eval`
             CLI at batch 256 with the host and the device protocol and
             --tpr-far 1e-2,1e-3: equal fold thresholds and accuracies, AUC
             within 1e-12, mean AUC >= 0.9; the embedding img/s.
12. bench_embed - the headline workload (`scripts/bench_embed.bench`:
             ResNet-50, b512, 112 px, bf16 BatchNorm, 20 batches in a CUDA
             graph) and the same with fp32 BatchNorm, one eager step's
             device time by category (torch.profiler), and the bf16-BN
             embeddings against the fp32-BN ones of the same weights and
             batch: the least row cosine >= 0.99.

The line before the last is {"kernels": [...]} (each kernel's launches from
the phase that runs its entry point: train, head_bf16, conv3x3_bench; the
fp32 head kernels' and the _mem kernels' add the scan phase's graphed
ArcFace and VPL-ArcFace runs, whose replays the host's counters do not see:
the launches one replay captured times the replays, plus the real ones),
the last {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import pickle
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet) for the bound: fp32 outside
# the tensor cores, dense bf16 and tf32 on the tensor cores, and HBM3
# bandwidth. The fp32 conv's 16-byte route takes three tf32 products for
# each fp32 one (3xTF32).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 494.7e12
TF32X3_PRODUCTS = 3
PEAK_BYTES = 3.35e12
N_MAIN, D_MAIN, C_MAIN = 512, 512, 10575
TRAIN_STEPS = 5
LIB_REPEATS = 5   # repeats of the library head's timing; the median counts
CONV_SHAPES = ((28, 128), (14, 256), (7, 512))   # (H = W, C = C_out) at b512
CONV_MAIN = (14, 256)   # the benchmark phase's shape, and the kernels line's
# (lam source, margin mode, clamp, case) of the timed training-shape cases,
# all in the identity mode (fused_head.MODE_IDENTITY = 0): ArcFace-like, a
# VPL state after one step, and a dense lam
TIMED_CASES = ((None, 0, None, "N512_D512_C10575_identity"),
               ("vpl", 0, 1e-7, "N512_D512_C10575_vpl_mem"),
               ("dense", 0, 1e-7, "N512_D512_C10575_vpl_mem_dense"))
# (fused head, case): the training shape with the row scalars of a head in
# each margin mode the other heads bring (fused_head.MODE_MV = 1,
# MODE_CURRICULAR = 2, and MODE_IDENTITY with a per-row norm scale)
MODE_CASES = (("mv_softmax", "N512_D512_C10575_mv"),
              ("curricularface", "N512_D512_C10575_curricular"),
              ("sphereface", "N512_D512_C10575_identity_normscale"))
# the heads beyond ArcFace, VPL-ArcFace and QAFace, and their steps of fit
NEW_HEADS = ("sphereface", "cosface", "mv_softmax", "curricularface",
             "adaface", "elastic_cosface", "elastic_arcface", "magface",
             "combined_margin", "subcenter_arcface", "adacos")
HEAD_STEPS = 3
# the scan phase: each head's SCAN_STEPS steps with scan_steps=SCAN_K (two
# graphed chunks and two leftover eager steps) against the same steps one at
# a time; then bench_steps' eager against graphed runs of the ArcFace recipe
SCAN_HEADS = ("arcface", "vpl_arcface", "qaface", "sphereface",
              "curricularface", "adaface", "adacos", "elastic_arcface")
SCAN_K = 4
SCAN_STEPS = 10
SCAN_BENCH = {"pairs": 3, "scans": (4, 8), "steps": 64}
HEAD_TIMED_CALLS = 5   # calls a head's device_ms reading averages
SOURCE = "face_recognition_models_tpu_torch/csrc/fused_head.cu"
CONV_SOURCE = "face_recognition_models_tpu_torch/csrc/conv3x3.cu"
REPLACES = {
    "fused_ce_fwd": "face_recognition_models_tpu/ops/fused_head.py:95",
    "fused_ce_bwd_dx": "face_recognition_models_tpu/ops/fused_head.py:315",
    "fused_ce_bwd_dw": "face_recognition_models_tpu/ops/fused_head.py:315",
    # the has_mem=True bodies of the same Pallas kernels
    "fused_ce_fwd_mem": "face_recognition_models_tpu/ops/fused_head.py:122",
    "fused_ce_bwd_dx_mem":
        "face_recognition_models_tpu/ops/fused_head.py:395",
    "fused_ce_bwd_dw_mem":
        "face_recognition_models_tpu/ops/fused_head.py:401",
    # mm_dtype=bfloat16: the casts before each product of the same kernels
    "fused_ce_fwd_bf16": "face_recognition_models_tpu/ops/fused_head.py:119",
    "fused_ce_bwd_dx_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:242",
    "fused_ce_bwd_dw_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:307",
    "fused_ce_fwd_mem_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:123",
    "fused_ce_bwd_dx_mem_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:237",
    "fused_ce_bwd_dw_mem_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:305",
    "conv3x3_same": "face_recognition_models_tpu/ops/conv3x3.py:42",
    # the same Pallas kernel with fp32 x
    "conv3x3_same_f32": "face_recognition_models_tpu/ops/conv3x3.py:42",
}
PLAIN_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dw")
MEM_KERNELS = ("fused_ce_fwd_mem", "fused_ce_bwd_dx_mem",
               "fused_ce_bwd_dw_mem")
BF16_KERNELS = tuple(k + "_bf16" for k in PLAIN_KERNELS + MEM_KERNELS)
# kernel vs plain, both IEEE fp32 on the card: the sums run in different
# orders (10^4 exp terms, 512-deep dot products), a few ulps apart.
TOL_STATS = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD_RTOL = 1e-3     # plus an atol of 1e-5 x the output's largest value
TOLERANCE = {"lse_target_logit": TOL_STATS,
             "gradients": {"rtol": TOL_GRAD_RTOL, "atol": "1e-5 x max|plain|"},
             "higher": "differs by at most 1 per row"}
# bf16 products: dcos is rounded to bf16 after an fp32 computation whose
# order differs between kernel and plain version, so a dcos within that
# difference of a rounding boundary rounds one way in one and the other way
# in the other, moving one term of dx or dw by one bf16 ulp (2^-7 of it).
# The gradient atol adds one ulp of each element's largest product term.
BF16_ULP = 2.0 ** -7
TOLERANCE_BF16 = {**TOLERANCE, "gradients": {
    "rtol": TOL_GRAD_RTOL,
    "atol": "1e-5 x max|plain| + 2^-7 x the element's largest product term"}}
# the conv, rtol = atol: fp32 sums in different orders; bf16 outputs a bf16
# ulp or two apart (0.03 at |y| of 4-8)
TOL_CONV = {"float32": 1e-5, "bfloat16": 2e-2}
# the fp32 conv at b512 14x14x256: each output sums 2,304 fp32 products of
# |y| ~ 2.4 in another order than the plain version's 9 matmuls
TOL_CONV_DEEP = 1e-4
# (n, h, w, c, co, dtype) of the small conv cases. The bf16 16-byte route
# at M not a multiple of the 128-row tile, C_out of 24 and 40, C of 40 and
# 72 and two C_out tiles; the bf16 ragged route at C = 12 and C_out = 12;
# the fp32 3xTF32 route at the same kinds of shape (M = 135 with C = 40 and
# C_out = 136, C_out = 4) and the fp32 ragged route at C = 6, C_out = 10.
CONV_SMALL = ((4, 7, 7, 16, 24, "float32"), (2, 5, 9, 4, 12, "float32"),
              (6, 4, 4, 8, 8, "float32"), (16, 7, 7, 72, 40, "float32"),
              (2, 7, 7, 32, 16, "bfloat16"), (8, 14, 14, 40, 24, "bfloat16"),
              (3, 5, 9, 40, 24, "bfloat16"), (8, 14, 14, 72, 40, "bfloat16"),
              (1, 12, 12, 136, 136, "bfloat16"),
              (4, 7, 7, 12, 16, "bfloat16"), (2, 6, 6, 16, 12, "bfloat16"),
              (3, 5, 9, 40, 136, "float32"), (2, 7, 7, 8, 4, "float32"),
              (2, 6, 6, 6, 10, "float32"), (4, 7, 7, 12, 10, "float32"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def close(name, got, want, rtol, atol):
    """Max abs error of `got` against `want`; raises past atol + rtol x
    |want| (atol a number or a tensor of `want`'s shape)."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        big = float(atol.max()) if hasattr(atol, "max") else atol
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance, max abs err "
            f"{float(err.max()):.3e} (rtol {rtol}, atol up to {big:.3e})")
    return float(err.max())


def close_grad(name, got, want, term=None):
    """The gradient tolerance; `term` (bf16 products only) is each element's
    largest product term, of which one bf16 ulp is allowed on top."""
    atol = 1e-5 * float(want.abs().max())
    if term is not None:
        atol = atol + BF16_ULP * term
    return close(name, got, want, TOL_GRAD_RTOL, atol)


def close_higher(name, got, want):
    # `higher` counts cos > tcos; a cosine within rounding of the target's
    # can flip between two summation orders. Allow a flip of 1 per row.
    diff = (got - want).abs()
    if float(diff.max()) > 1:
        raise AssertionError(f"{name}: higher differs by {float(diff.max())}")
    return int((diff > 0).sum())


def cuda_ms(fn, warmup=3, iters=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per ms on this card (its clock
    under a spin), from CUDA events around one long spin."""
    import torch

    cycles = 50_000_000
    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, warmup=3, iters=20, tries=3):
    """The card's time per call of `fn`, without the host's launch gaps: a
    spin kernel (torch.cuda._sleep) is queued ahead of the start event and
    the `iters` calls behind it, so the card runs them back to back. The
    reading counts only if the start event is still pending once the host
    has queued the last call (start.query() False); otherwise the spin is
    made 4x longer and the run repeated, and after `tries` runs it raises.
    Inputs under 50 MB stay warm in L2 between the calls, as in cuda_ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin_ms = 4.0 * host_ms + 2.0
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_ms *= 4.0
    raise AssertionError(f"device_ms: the card reached the calls before the "
                         f"host had queued them ({tries} spins, the last "
                         f"{spin_ms / 4.0:.1f} ms)")


def launch_ms(fn, iters=20, kernel=r"fused_ce_\w+"):
    """{kernel: device ms per call of `fn`} from a torch.profiler trace of
    `iters` calls (kernels named by the match of the regex `kernel` in
    their name in the trace)."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(kernel, e.key)
        us = getattr(e, "device_time_total", None)
        if found and us:
            out[found.group(0)] = us / iters / 1e3
    return out


def make_inputs(n, d, c, mode, seed, oor_label=False, mem=None):
    """Row-normalised xn, column-normalised wn and ArcFace-like row scalars
    on the card, from a seeded generator. mem="mixed" adds a random memn and
    lam mixing 0, 0.15 and 1; mem="dense" a random memn and lam = 0.15 on
    every class (VPL after ~100 steps at b512); mem="vpl" the memn and lam
    of a VPL-ArcFace state after one step on random features."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.ops.normalize import l2_normalize

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    xn = l2_normalize(torch.randn(n, d, device=dev, generator=g), dim=1)
    wn = l2_normalize(torch.randn(d, c, device=dev, generator=g), dim=0)
    labels = torch.randint(0, c, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    tcos = (xn * wn[:, labels.long()].T).sum(1)
    if oor_label:
        labels[n // 2] = c + 7
    t = torch.cos(torch.acos(tcos.clamp(-1, 1)) + 0.5)
    scale = torch.full((n,), 64.0, device=dev)
    if mode == fh.MODE_IDENTITY:
        ab = torch.zeros(n, 2, device=dev)
    else:
        ab = torch.stack([tcos - 0.2, torch.full_like(tcos, 1.12)], 1)
    g_lse = torch.full((n,), 1.0 / n, device=dev)
    g_t = torch.full((n,), -1.0 / n, device=dev)
    x = dict(xn=xn, wn=wn, labels=labels, t=t, tcos=tcos, scale=scale,
             ab=ab.contiguous(), g_lse=g_lse, g_t=g_t)
    if mem in ("mixed", "dense"):
        x["memn"] = l2_normalize(torch.randn(d, c, device=dev, generator=g),
                                 dim=0)
        pick = torch.randint(0, 3, (c,), device=dev, generator=g)
        x["lam"] = (torch.tensor([0.0, 0.15, 1.0], device=dev)[pick]
                    if mem == "mixed" else torch.full((c,), 0.15, device=dev))
    elif mem == "vpl":
        from face_recognition_models_tpu_torch import config as cfg_lib
        from face_recognition_models_tpu_torch.heads import get_head
        from face_recognition_models_tpu_torch.heads import margins

        cfg = cfg_lib.VPLArcFaceConfig(feature_dim=d, num_classes=c)
        state = get_head("vpl_arcface").init_state(cfg, dev)
        feats = 10.0 * torch.randn(n, d, device=dev, generator=g)
        mem_, life, _ = margins._class_mean_update(
            feats, labels, labels >= 0, state.mem, state.life, cfg.delta)
        x["memn"] = l2_normalize(mem_, dim=1).T.contiguous()
        x["lam"] = cfg.lamda * (life > 0).to(torch.float32)
    return x


def kernel_fns(mem, bf16=False):
    """(names, [(kernel, plain) for fwd, bwd_dx, bwd_dw]) of the plain or
    the memory-blended family, with fp32 or (bf16) bf16 products."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    if mem:
        names, fns = MEM_KERNELS, [
            (fh.fused_ce_fwd_mem, fh.fused_margin_ce_mem_plain),
            (fh.fused_ce_bwd_dx_mem, fh.fused_ce_bwd_dx_mem_plain),
            (fh.fused_ce_bwd_dw_mem, fh.fused_ce_bwd_dw_mem_plain)]
    else:
        names, fns = PLAIN_KERNELS, [
            (fh.fused_ce_fwd, fh.fused_margin_ce_plain),
            (fh.fused_ce_bwd_dx, fh.fused_ce_bwd_dx_plain),
            (fh.fused_ce_bwd_dw, fh.fused_ce_bwd_dw_plain)]
    if not bf16:
        return names, fns
    bf = functools.partial
    return tuple(k + "_bf16" for k in names), [
        (bf(k, mm_dtype=torch.bfloat16), bf(p, mm_dtype=torch.bfloat16))
        for k, p in fns]


def kernel_args(x, mode, clamp_eps, lse=None):
    """Positional arguments of (fwd, bwd_dx, bwd_dw) on inputs `x`."""
    head = (x["xn"], x["wn"], *((x["memn"], x["lam"]) if "memn" in x
                                else ()), x["labels"], x["t"])
    fwd = (*head, x["tcos"], x["scale"], x["ab"], mode, clamp_eps)
    bwd = (*head, x["scale"], x["ab"], lse, x["g_lse"])
    return fwd, (*bwd, x["g_t"], mode, clamp_eps), (*bwd, mode, clamp_eps)


def bf16_terms(x, mode, clamp_eps, lse):
    """(dx, dw) of each element's largest product term with bf16 operands:
    max |dcos| of the row (column) times max |wn or memn| (|xn|) of the
    other factor."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    dcos, _, _ = fh._dcos_plain(x["xn"], x["wn"], x["labels"], x["t"],
                                x["scale"], x["ab"], lse, x["g_lse"], mode,
                                clamp_eps, x.get("memn"), x.get("lam"),
                                torch.bfloat16)
    dcos = dcos.abs()
    w = x["wn"].abs().amax(1)
    if "memn" in x:
        w = torch.maximum(w, x["memn"].abs().amax(1))
    return (dcos.amax(1)[:, None] * w[None, :],
            x["xn"].abs().amax(0)[:, None] * dcos.amax(0)[None, :])


def past_fp32_tol(got, want):
    """Elements of a gradient outside the fp32 tolerance: those that needed
    the bf16 ulp allowance."""
    err = (got - want).abs()
    return int((err > TOL_GRAD_RTOL * want.abs()
                + 1e-5 * float(want.abs().max())).sum())


def same(name, *pairs):
    """Two launches on the same inputs must give bitwise-equal outputs."""
    import torch

    for a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches differ")


def check_case(x, mode, clamp_eps, bf16=False):
    """Each kernel against its plain version on inputs `x` (the _mem family
    when `x` holds memn, the bf16 products with `bf16`); returns (max abs
    err per kernel, number of rows where `higher` differs, and with `bf16`
    {"dx": n, "dw": n} elements that needed the ulp allowance). Every
    kernel runs twice and must agree bitwise."""
    names, fns = kernel_fns("memn" in x, bf16)
    fwd_args, _, _ = kernel_args(x, mode, clamp_eps)
    out = fns[0][0](*fwd_args)
    same(names[0], *zip(out, fns[0][0](*fwd_args)))
    ref = fns[0][1](*fwd_args)
    errs = {names[0]: max(
        close("lse", out.lse, ref.lse, **TOL_STATS),
        close("target_logit", out.target_logit, ref.target_logit,
              **TOL_STATS))}
    flips = close_higher("higher", out.higher, ref.higher)
    _, dx_args, dw_args = kernel_args(x, mode, clamp_eps, ref.lse)
    dx_term, dw_term = (bf16_terms(x, mode, clamp_eps, ref.lse) if bf16
                        else (None, None))
    dx, dt, dscale = fns[1][0](*dx_args)
    same(names[1], *zip((dx, dt, dscale), fns[1][0](*dx_args)))
    rdx, rdt, rdscale = fns[1][1](*dx_args)
    errs[names[1]] = max(close_grad("dx", dx, rdx, dx_term),
                         close_grad("dt", dt, rdt),
                         close_grad("dscale", dscale, rdscale))
    dw = fns[2][0](*dw_args)
    same(names[2], (dw, fns[2][0](*dw_args)))
    rdw = fns[2][1](*dw_args)
    errs[names[2]] = close_grad("dw", dw, rdw, dw_term)
    ulp = ({"dx": past_fp32_tol(dx, rdx), "dw": past_fp32_tol(dw, rdw)}
           if bf16 else {})
    if "lam" in x and bool((x["lam"] == 1).any()):
        # a column fully replaced by its memory takes no dw
        if float(dw[:, x["lam"] == 1].abs().max()) != 0.0:
            raise AssertionError("dw is not 0 in lam = 1 columns")
    return errs, flips, ulp


def check_split(x, mode, clamp_eps):
    """The split fp32 fwd, bwd_dx and bwd_dw (the _mem ones when `x` holds
    memn) on inputs `x`: each class range's (bwd_dw: row range's) partials
    from the kernel's workspace (bwd_dw of one range: dw itself) against
    fused_ce_*_partials_plain, and the combine kernels, on the plain
    partials, against their plain versions. Returns ({check: max abs err},
    {"fwd": ranges, "bwd_dx": ranges, "bwd_dw": ranges})."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    mem = ((x["memn"], x["lam"]) if "memn" in x else ())
    kw = dict(memn=x["memn"], lam=x["lam"]) if mem else {}
    sfx, which = ("_mem", 3) if mem else ("", 0)
    (n, d), c = x["xn"].shape, x["wn"].shape[1]
    splits, cols = fh.split_plan(n, c)
    plan = dict(splits=splits, range_cols=cols)
    ranges = {"fwd": splits}
    fwd = (x["labels"], x["t"], x["tcos"], x["scale"], x["ab"], mode,
           clamp_eps)
    ws = []
    fh._fwd("fused_ce_fwd" + sfx, which, x["xn"], x["wn"], mem, *fwd,
            torch.float32, ws)
    got = ws[0].view(splits, 3, n)
    want = fh.fused_ce_fwd_partials_plain(x["xn"], x["wn"], *fwd, **plan,
                                          **kw)
    errs = {"fwd_partials": close("m, l", got[:, :2], want[:, :2],
                                  **TOL_STATS)}
    close_higher("range higher", got[:, 2], want[:, 2])
    comb = fh.fused_ce_fwd_combine(want, x["t"], x["scale"])
    ref = fh.fused_ce_fwd_combine_plain(want, x["t"], x["scale"])
    errs["fwd_combine"] = max(
        close("combined lse", comb.lse, ref.lse, **TOL_STATS),
        close("combined target_logit", comb.target_logit, ref.target_logit,
              **TOL_STATS))
    close_higher("combined higher", comb.higher, ref.higher)
    bwd = (x["labels"], x["t"], x["scale"], x["ab"], ref.lse, x["g_lse"])
    splits, cols = fh.split_plan(n, c, dx=True)
    plan = dict(splits=splits, range_cols=cols)
    ranges["bwd_dx"] = splits
    ws = []
    fh._bwd_dx("fused_ce_bwd_dx" + sfx, which + 1, x["xn"], x["wn"], mem,
               *bwd, x["g_t"], mode, clamp_eps, torch.float32, ws)
    got_dx, got_rows = fh.dx_workspace_views(ws[0], splits, n, d)
    want_dx, want_rows = fh.fused_ce_bwd_dx_partials_plain(
        x["xn"], x["wn"], *bwd, mode, clamp_eps, **plan, **kw)
    errs["dx_partials"] = max(close_grad("dx partials", got_dx, want_dx),
                              close_grad("dt, dscale partials", got_rows,
                                         want_rows))
    comb = fh.fused_ce_bwd_dx_combine(want_dx, want_rows, x["t"],
                                      x["scale"], x["g_t"])
    ref = fh.fused_ce_bwd_dx_combine_plain(want_dx, want_rows, x["t"],
                                           x["scale"], x["g_t"])
    errs["dx_combine"] = max(close_grad("combined " + k, a, b) for k, a, b
                             in zip(("dx", "dt", "dscale"), comb, ref))
    splits, rows = fh.dw_split_plan(n, c)
    ranges["bwd_dw"] = splits
    ws = []
    dw = fh._bwd_dw("fused_ce_bwd_dw" + sfx, which + 2, x["xn"], x["wn"], mem,
                    *bwd, mode, clamp_eps, torch.float32, ws)
    got = ws[0].view(splits, d, c) if splits > 1 else dw[None]
    want = fh.fused_ce_bwd_dw_partials_plain(x["xn"], x["wn"], *bwd, mode,
                                             clamp_eps, splits=splits,
                                             range_rows=rows, **kw)
    errs["dw_partials"] = close_grad("dw partials", got, want)
    errs["dw_combine"] = close_grad("combined dw",
                                    fh.fused_ce_bwd_dw_combine(want),
                                    fh.fused_ce_bwd_dw_combine_plain(want))
    return errs, ranges


def check_split_bf16(x, mode, clamp_eps):
    """The split bf16 fwd, bwd_dx and bwd_dw (the _mem ones when `x` holds
    memn) on inputs `x`: each class range's (bwd_dw: row range's) partials
    from the front of the kernel's workspace (bwd_dw of one range: dw
    itself) against fused_ce_*_partials_plain with bf16 products, and the dx
    and dw combine kernels on the plain partials against their plain
    versions. Returns ({check: max abs err}, {"fwd_bf16": ranges,
    "bwd_dx_bf16": ranges, "bwd_dw_bf16": ranges})."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    mem = ((x["memn"], x["lam"]) if "memn" in x else ())
    kw = dict(memn=x["memn"], lam=x["lam"]) if mem else {}
    sfx, which = ("_mem", 3) if mem else ("", 0)
    (n, d), c = x["xn"].shape, x["wn"].shape[1]
    bf = torch.bfloat16
    splits, cols = fh.split_plan(n, c, mm_dtype=bf)
    ranges = {"fwd_bf16": splits}
    fwd = (x["labels"], x["t"], x["tcos"], x["scale"], x["ab"], mode,
           clamp_eps)
    ws = []
    fh._fwd("fused_ce_fwd" + sfx, which, x["xn"], x["wn"], mem, *fwd, bf, ws)
    got = ws[0][:splits * 3 * n].view(splits, 3, n)
    want = fh.fused_ce_fwd_partials_plain(x["xn"], x["wn"], *fwd,
                                          splits=splits, range_cols=cols,
                                          mm_dtype=bf, **kw)
    errs = {"fwd_bf16_partials": close("bf16 m, l", got[:, :2], want[:, :2],
                                       **TOL_STATS)}
    close_higher("bf16 range higher", got[:, 2], want[:, 2])
    lse = fh.fused_ce_fwd_combine_plain(want, x["t"], x["scale"]).lse
    bwd = (x["labels"], x["t"], x["scale"], x["ab"], lse, x["g_lse"])
    splits, cols = fh.split_plan(n, c, dx=True, mm_dtype=bf)
    ranges["bwd_dx_bf16"] = splits
    ws = []
    fh._bwd_dx("fused_ce_bwd_dx" + sfx, which + 1, x["xn"], x["wn"], mem,
               *bwd, x["g_t"], mode, clamp_eps, bf, ws)
    got_dx, got_rows = fh.dx_workspace_views(ws[0], splits, n, d)
    want_dx, want_rows = fh.fused_ce_bwd_dx_partials_plain(
        x["xn"], x["wn"], *bwd, mode, clamp_eps, splits=splits,
        range_cols=cols, mm_dtype=bf, **kw)
    dx_term, dw_term = bf16_terms(x, mode, clamp_eps, lse)
    errs["dx_bf16_partials"] = max(
        close_grad("bf16 dx partials", got_dx, want_dx, dx_term),
        close_grad("bf16 dt, dscale partials", got_rows, want_rows))
    comb = fh.fused_ce_bwd_dx_combine(want_dx, want_rows, x["t"], x["scale"],
                                      x["g_t"])
    ref = fh.fused_ce_bwd_dx_combine_plain(want_dx, want_rows, x["t"],
                                           x["scale"], x["g_t"])
    errs["dx_bf16_combine"] = max(
        close_grad("bf16 combined " + k, a, b) for k, a, b
        in zip(("dx", "dt", "dscale"), comb, ref))
    splits, rows = fh.dw_split_plan(n, c, mm_dtype=bf, mem=bool(mem))
    ranges["bwd_dw_bf16"] = splits
    ws = []
    dw = fh._bwd_dw("fused_ce_bwd_dw" + sfx, which + 2, x["xn"], x["wn"], mem,
                    *bwd, mode, clamp_eps, bf, ws)
    got = (ws[0][:splits * d * c].view(splits, d, c) if splits > 1
           else dw[None])
    want = fh.fused_ce_bwd_dw_partials_plain(
        x["xn"], x["wn"], *bwd, mode, clamp_eps, splits=splits,
        range_rows=rows, mm_dtype=bf, **kw)
    # each range's largest product term is at most the whole sum's
    errs["dw_bf16_partials"] = close_grad("bf16 dw partials", got, want,
                                          dw_term)
    errs["dw_bf16_combine"] = close_grad(
        "bf16 combined dw", fh.fused_ce_bwd_dw_combine(want),
        fh.fused_ce_bwd_dw_combine_plain(want))
    return errs, ranges


def eager_head(x, clamp_eps=None, bf16=False, mode=0):
    """(xn, wn, forward) of the eager head on inputs `x`: forward() returns
    the mean loss through torch.matmul + the margin `mode`'s non-target
    map (fused_head._h: none in the identity mode) + the margin select +
    F.cross_entropy, with xn and wn as leaves of its graph. With memn in
    `x`, the eager VPL head: two torch.matmul + the blend (+ the clamp)
    before the select. With `bf16`, each torch.matmul takes bf16 operands
    (cast in the timed region, as the kernels cast as they stage) and its
    bf16 result is taken on in fp32."""
    import torch
    import torch.nn.functional as F

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    xn = x["xn"].clone().requires_grad_(True)
    wn = x["wn"].clone().requires_grad_(True)
    labels = x["labels"].long()
    onehot = F.one_hot(labels, wn.shape[1]).bool()

    def mm(a, b):
        if not bf16:
            return torch.matmul(a, b)
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()

    def forward():
        cos = mm(xn, wn)
        if "memn" in x:
            cos = (1.0 - x["lam"]) * cos + x["lam"] * mm(xn, x["memn"])
        if clamp_eps is not None:
            cos = cos.clamp(-1.0 + clamp_eps, 1.0 - clamp_eps)
        cos = fh._h(mode, cos, x["ab"][:, :1], x["ab"][:, 1:])
        logits = x["scale"][:, None] * torch.where(onehot, x["t"][:, None],
                                                   cos)
        return F.cross_entropy(logits, labels)

    return xn, wn, forward


def library_bwd_device_ms(x, clamp_eps=None, bf16=False):
    """device_ms of the eager head's whole backward (eager_head): one
    forward's graph, kept, taken back 20 times by torch.autograd.grad."""
    import torch

    xn, wn, forward = eager_head(x, clamp_eps, bf16)
    loss = forward()
    return device_ms(lambda: torch.autograd.grad(loss, (xn, wn),
                                                 retain_graph=True))


def library_head_ms(x, clamp_eps=None, bf16=False, mode=0):
    """The eager head (eager_head) as the yardstick, forward and backward
    timed apart (CUDA events). Each is timed LIB_REPEATS times over 20
    iterations; returns (forward ms, backward ms, spread), the times the
    medians of the repeats, the spread their [min, max]."""
    import torch

    _, _, forward = eager_head(x, clamp_eps, bf16, mode)
    fwd = [cuda_ms(forward) for _ in range(LIB_REPEATS)]
    for _ in range(3):
        forward().backward()
    torch.cuda.synchronize()
    iters = 20
    bwd = []
    for _ in range(LIB_REPEATS):
        total = 0.0
        for _ in range(iters):
            loss = forward()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss.backward()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        bwd.append(total / iters)
    spread = {"fwd_ms": [min(fwd), max(fwd)], "bwd_ms": [min(bwd), max(bwd)],
              "repeats": LIB_REPEATS}
    return float(np.median(fwd)), float(np.median(bwd)), spread


def bound_rows(x, names, errs, ms, library, peak=PEAK_FP32_FLOPS):
    """The `kernels` line entries of one family at the shape of `x`, with
    the bound from this run's inputs: inputs read once, outputs written once,
    and the products these inputs need at `peak` FLOP/s. With the memory
    blend a column with lam = 0 needs no memory product and one with lam = 1
    no weight product, so the products are counted over the columns that
    need them."""
    n, d = x["xn"].shape
    c = x["wn"].shape[1]
    product = 2.0 * n * d * c
    row = 4 * n
    if "memn" in x:
        fw = float((x["lam"] != 1).float().mean())   # share needing wn
        fm = float((x["lam"] != 0).float().mean())   # share needing memn
        w_bytes = 4 * d * c * (fw + fm) + 4 * c
    else:
        fw, fm = 1.0, 0.0
        w_bytes = 4 * d * c
    cos = product * (fw + fm)
    bytes_ = [4 * n * d + w_bytes + 7 * row + 3 * row,
              4 * n * d + w_bytes + 9 * row + 4 * n * d + 2 * row,
              4 * n * d + w_bytes + 8 * row + 4 * d * c]
    # fwd: cos; bwd_dx: cos again, then dx through the same products;
    # bwd_dw: cos again, then dw through the weight share only
    flops = [cos, 2 * cos, cos + product * fw]
    rows = []
    for k, name in enumerate(names):
        t_ops = flops[k] / peak * 1e3
        t_bytes = bytes_[k] / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[k]})
    return rows


def family_calls(x, mode, clamp_eps, bf16=False):
    """[(name, kernel call, plain call)] of one family on inputs `x`."""
    names, fns = kernel_fns("memn" in x, bf16)
    fwd_args, _, _ = kernel_args(x, mode, clamp_eps)
    lse = fns[0][1](*fwd_args).lse
    args = kernel_args(x, mode, clamp_eps, lse)
    return [(name, functools.partial(kernel, *a), functools.partial(plain, *a))
            for name, (kernel, plain), a in zip(names, fns, args)]


def time_family(x, mode, clamp_eps, bf16=False):
    """{name: (kernel ms, plain ms)} of one family on inputs `x`."""
    return {name: (cuda_ms(kernel), cuda_ms(plain)) for name, kernel, plain
            in family_calls(x, mode, clamp_eps, bf16)}


def head_inputs(name, seed):
    """(inputs of the fp32 family at the training shape, mode, clamp) with
    the row scalars (t, tcos, scale, ab) that the fused head `name`
    (heads/fused_adapter._row_params, from its initial state) gives random
    features of norm ~22 and the head's own kernel initialisation."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads import fused_adapter as fa
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.ops.normalize import (
        feature_norms, l2_normalize)

    dev = "cuda"
    cfg = cfg_lib.make_head_config(name, feature_dim=D_MAIN,
                                   num_classes=C_MAIN)
    head = get_head(name)
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(N_MAIN, D_MAIN, device=dev, generator=g)
    labels = torch.randint(0, C_MAIN, (N_MAIN,), device=dev, generator=g,
                           dtype=torch.int32)
    kernel = head.init_kernel(cfg, torch.Generator().manual_seed(seed), dev)
    xn = l2_normalize(feats, dim=1)
    wn = l2_normalize(kernel, dim=0).contiguous()
    tcos = (xn * wn[:, labels.long()].T).sum(1)
    rp = fa._row_params(cfg, tcos, feature_norms(feats),
                        head.init_state(cfg, dev))
    x = dict(xn=xn, wn=wn, labels=labels, t=rp.t.contiguous(),
             tcos=rp.tcos.contiguous(), scale=rp.scale.contiguous(),
             ab=rp.ab.contiguous(),
             g_lse=torch.full((N_MAIN,), 1.0 / N_MAIN, device=dev),
             g_t=torch.full((N_MAIN,), -1.0 / N_MAIN, device=dev))
    return x, rp.mode, rp.clamp_eps


def check_mode_cases():
    """The fp32 family at MODE_CASES against the plain versions (bitwise
    repeat, split partials and combine), timed beside the plain versions,
    the eager library head in the same mode and the bound."""
    import torch

    for name, case in MODE_CASES:
        x, mode, eps = head_inputs(name, seed=17)
        errs, flips, _ = check_case(x, mode, eps)
        split, splits = check_split(x, mode, eps)
        ms = time_family(x, mode, eps)
        lib_fwd, lib_bwd, lib_spread = library_head_ms(x, eps, mode=mode)
        fam = bound_rows(x, PLAIN_KERNELS, errs, ms,
                         (lib_fwd, lib_bwd, lib_bwd))
        emit({"phase": "kernels", "case": case, "head": name, "mode": mode,
              "clamp_eps": eps, "splits": splits,
              "scale_range": [float(x["scale"].min()),
                              float(x["scale"].max())],
              "max_abs_err": {**errs, **split}, "higher_flips": flips,
              "bitwise_repeat": True, "tolerance": TOLERANCE,
              "kernel_ms": {r["name"]: r["ms"] for r in fam},
              "plain_ms": {r["name"]: r["plain_ms"] for r in fam},
              "library_ms": {"head_fwd": lib_fwd, "head_bwd": lib_bwd},
              "library_spread": lib_spread,
              "bound_ms": {r["name"]: r["bound_ms"] for r in fam},
              "bound_by": {r["name"]: r["bound_by"] for r in fam},
              "ok": True})
        del x
        torch.cuda.empty_cache()


def phase_kernels():
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    fh.reset_launch_counts()
    # small shapes: every mode, an out-of-range label, C not a tile multiple;
    # the _mem family with lam mixing 0, 0.15 and 1; fp32 and bf16 products,
    # and the bf16 kernels at a D that is not a multiple of 16
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        tol = TOLERANCE_BF16 if bf16 else TOLERANCE
        for mem in (None, "mixed"):
            msfx = "_mem" if mem else ""
            for mode, eps in ((fh.MODE_IDENTITY, None), (fh.MODE_MV, 1e-7),
                              (fh.MODE_CURRICULAR, 0.0)):
                x = make_inputs(24, 64, 100, mode,
                                seed=mode + (10 if mem else 0),
                                oor_label=True, mem=mem)
                errs, flips, ulp = check_case(x, mode, eps, bf16)
                emit({"phase": "kernels",
                      "case": f"N24_D64_C100_mode{mode}{msfx}{sfx}",
                      "max_abs_err": errs, "higher_flips": flips,
                      **({"bf16_ulp_elems": ulp} if bf16 else {}),
                      "tolerance": tol, "ok": True})
            if bf16:
                x = make_inputs(40, 72, 300, fh.MODE_MV, seed=21,
                                oor_label=True, mem=mem)
                errs, flips, ulp = check_case(x, fh.MODE_MV, 1e-7, bf16)
                emit({"phase": "kernels",
                      "case": f"N40_D72_C300_mode1{msfx}{sfx}",
                      "max_abs_err": errs, "higher_flips": flips,
                      "bf16_ulp_elems": ulp, "tolerance": tol, "ok": True})
    # the split fp32 fwd and bwd_dx over several class ranges: N = 1, N
    # not a multiple of the 32-row tile, ragged last ranges, D = 72, and a
    # last range of one column that is row 0's target; bwd_dw over 3 row
    # ranges of 256-row tiles, the last ragged, at N = 600 and 520; the
    # split bf16 fwd and bwd_dx (128-wide class tiles) and the bf16 bwd_dw
    # (ranges of 32-row tiles, 16 with the blend) over the same shapes
    for mem in (None, "mixed"):
        msfx = "_mem" if mem else ""
        for n, d, c, last in ((1, 64, 300, False), (40, 72, 300, False),
                              (70, 512, 2000, False), (1, 64, 257, True),
                              (600, 72, 300, False),
                              (520, 512, 1000, False)):
            x = make_inputs(n, d, c, fh.MODE_MV, seed=n + c, mem=mem)
            if last:
                x["labels"][0] = c - 1
            errs, flips, _ = check_case(x, fh.MODE_MV, 1e-7)
            split, splits = check_split(x, fh.MODE_MV, 1e-7)
            case = (f"N{n}_D{d}_C{c}_mode1{msfx}_split"
                    + ("_last_target" if last else ""))
            emit({"phase": "kernels", "case": case,
                  "splits": splits, "max_abs_err": {**errs, **split},
                  "higher_flips": flips, "bitwise_repeat": True,
                  "tolerance": TOLERANCE, "ok": True})
            errs, flips, ulp = check_case(x, fh.MODE_MV, 1e-7, bf16=True)
            split, splits = check_split_bf16(x, fh.MODE_MV, 1e-7)
            emit({"phase": "kernels", "case": case + "_bf16",
                  "splits": splits,
                  "max_abs_err": {**errs, **split},
                  "higher_flips": flips, "bf16_ulp_elems": ulp,
                  "bitwise_repeat": True, "tolerance": TOLERANCE_BF16,
                  "ok": True})
    # backward where the JAX package switches to its two-kernel form (K3)
    x = make_inputs(4096, D_MAIN, C_MAIN, fh.MODE_IDENTITY, seed=11)
    errs, flips, _ = check_case(x, fh.MODE_IDENTITY, None)
    split, splits = check_split(x, fh.MODE_IDENTITY, None)
    ms = time_family(x, fh.MODE_IDENTITY, None)
    _, lib_bwd, lib_spread = library_head_ms(x)
    k3 = bound_rows(x, PLAIN_KERNELS, errs, ms, (None, lib_bwd, lib_bwd))
    emit({"phase": "kernels", "case": "N4096_D512_C10575_identity",
          "splits": splits, "max_abs_err": {**errs, **split},
          "higher_flips": flips, "bitwise_repeat": True,
          "tolerance": TOLERANCE,
          "kernel_ms": {r["name"]: r["ms"] for r in k3[1:]},
          "plain_ms": {r["name"]: r["plain_ms"] for r in k3[1:]},
          "library_ms": {"head_bwd": lib_bwd},
          "library_spread": lib_spread,
          "bound_ms": {r["name"]: r["bound_ms"] for r in k3[1:]},
          "ok": True})
    del x
    torch.cuda.empty_cache()
    # the training shape, with times: ArcFace's kernels, then the _mem
    # kernels with the memory and lam of a VPL state after one step; each
    # with fp32 and with bf16 products (the library head then with bf16
    # torch.matmul, the bound at the bf16 tensor-core peak); then the _mem
    # kernels at a dense lam, the work of a VPL run past ~100 steps
    rows = []
    for mem, mode, eps, case in TIMED_CASES:
        x = make_inputs(N_MAIN, D_MAIN, C_MAIN, mode, seed=7, mem=mem)
        for bf16 in (False, True):
            names, _ = kernel_fns(mem, bf16)
            errs, flips, ulp = check_case(x, mode, eps, bf16)
            split = dict(zip(("split", "splits"),
                             (check_split_bf16 if bf16 else check_split)(
                                 x, mode, eps)))
            ms = time_family(x, mode, eps, bf16)
            lib_fwd, lib_bwd, lib_spread = library_head_ms(x, eps, bf16)
            fam = bound_rows(x, names, errs, ms, (lib_fwd, lib_bwd, lib_bwd),
                             PEAK_BF16_TC_FLOPS if bf16 else PEAK_FP32_FLOPS)
            extra = ({"active_classes": int((x["lam"] > 0).sum())} if mem
                     else {})
            if split:
                extra["splits"] = split["splits"]
                errs = {**errs, **split["split"]}
            emit({"phase": "kernels", "case": case + ("_bf16" if bf16
                                                      else ""), **extra,
                  "max_abs_err": errs, "higher_flips": flips,
                  "bitwise_repeat": True,
                  **({"bf16_ulp_elems": ulp} if bf16 else {}),
                  "tolerance": TOLERANCE_BF16 if bf16 else TOLERANCE,
                  "kernel_ms": {r["name"]: r["ms"] for r in fam},
                  "plain_ms": {r["name"]: r["plain_ms"] for r in fam},
                  "library_ms": {"head_fwd": lib_fwd, "head_bwd": lib_bwd},
                  "library_spread": lib_spread,
                  "bound_ms": {r["name"]: r["bound_ms"] for r in fam},
                  "ok": True})
            if mem != "dense":
                rows += fam
        del x
        torch.cuda.empty_cache()
    check_mode_cases()
    return rows


def phase_device_times():
    """device_ms of the bf16 kernels and of the eager bf16 backward at the
    training shape, on the cases that phase_kernels times, with the bf16
    dx and dw entries' per-launch device ms (pre-pass, split kernel, and
    the combine where it runs). It
    runs after the train phases: these timers leave the caching allocator
    in another state, and the train phases' peak memory is read after the
    same allocations as before they existed. Returns {kernel: device_ms}
    of the cases of the kernels line (not the dense lam)."""
    import torch

    out = {}
    for mem, mode, eps, case in TIMED_CASES:
        x = make_inputs(N_MAIN, D_MAIN, C_MAIN, mode, seed=7, mem=mem)
        calls = family_calls(x, mode, eps, bf16=True)
        dev = {name: device_ms(kernel) for name, kernel, _ in calls}
        emit({"phase": "device_times", "case": case + "_bf16",
              "device_ms": dev,
              "library_device_ms": {
                  "head_bwd": library_bwd_device_ms(x, eps, bf16=True)},
              "dx_launch_ms": launch_ms(calls[1][1]),
              "dw_launch_ms": launch_ms(calls[2][1]), "ok": True})
        if mem != "dense":
            out.update(dev)
        del x, calls
        torch.cuda.empty_cache()
    return out


def conv_case(n, h, w, c, co, dtype, seed):
    """(x, kernel) on the card: x ~ N(0, 1), kernel ~ 0.05 N(0, 1)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w, c, device="cuda", generator=g).to(dtype)
    k = 0.05 * torch.randn(3, 3, c, co, device="cuda", generator=g)
    return x, k.to(dtype)


def conv_routes(x, k):
    """One launch of the conv on (x, k): its output and the route counted."""
    from face_recognition_models_tpu_torch.ops import conv3x3

    conv3x3.reset_launch_counts()
    y = conv3x3.conv3x3_same(x, k, block_n=x.shape[0])
    launched = [r for r, v in conv3x3.launch_counts.items() for _ in range(v)]
    want = conv3x3.route(x.dtype, x.shape[3], k.shape[3])
    if launched != [want]:
        raise AssertionError(f"conv3x3: launched {launched}, not [{want}]")
    return y, want


def phase_conv():
    """The conv against its plain version: small fp32 and bf16 shapes on
    each route, then the ResNet-50 stage shapes at b512 bf16, timed beside
    its plain version and cuDNN's channels-last conv (TF32 off), the
    library yardstick, and the fp32 route at b512 14x14x256 beside cuDNN's
    fp32 conv (the rest of its checks in phase_conv_f32). Returns the
    kernels line entries at CONV_MAIN, bf16 and fp32."""
    import torch

    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.scripts import bench_conv3x3

    for i, (n, h, w, c, co, dname) in enumerate(CONV_SMALL):
        dtype = getattr(torch, dname)
        x, k = conv_case(n, h, w, c, co, dtype, seed=i)
        tol = TOL_CONV[dname]
        y, route = conv_routes(x, k)
        err = close("conv3x3", y.float(),
                    conv3x3.conv3x3_same_plain(x, k).float(), tol, tol)
        emit({"phase": "conv", "case": f"N{n}_H{h}_W{w}_C{c}_Co{co}_{dname}",
              "route": route, "max_abs_err": err,
              "tolerance": {"rtol": tol, "atol": tol}, "ok": True})
    row = None
    for h, c in CONV_SHAPES:
        n = 512
        x, k = conv_case(n, h, h, c, c, torch.bfloat16, seed=h)
        y, route = conv_routes(x, k)
        err = close("conv3x3", y.float(),
                    conv3x3.conv3x3_same_plain(x, k).float(),
                    TOL_CONV["bfloat16"], TOL_CONV["bfloat16"])
        del y
        ms = cuda_ms(lambda: conv3x3.conv3x3_same(x, k))
        plain_ms = cuda_ms(lambda: conv3x3.conv3x3_same_plain(x, k))
        cudnn = bench_conv3x3.conv_fn("cudnn", k, 16)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = cuda_ms(lambda: cudnn(x))
        flops = 2.0 * n * h * h * 9 * c * c
        bytes_ = 2.0 * (2 * n * h * h * c + 9 * c * c)
        t_ops = flops / PEAK_BF16_TC_FLOPS * 1e3
        t_bytes = bytes_ / PEAK_BYTES * 1e3
        emit({"phase": "conv", "case": f"N{n}_H{h}_C{c}_bf16", "route": route,
              "max_abs_err": err,
              "tolerance": {"rtol": TOL_CONV["bfloat16"],
                            "atol": TOL_CONV["bfloat16"]},
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": max(t_ops, t_bytes), "kernel_tflops":
              flops / ms / 1e9, "library_tflops": flops / lib_ms / 1e9,
              "ok": True})
        if (h, c) == CONV_MAIN:
            row = {"name": "conv3x3_same", "route": "cuda",
                   "source": CONV_SOURCE,
                   "replaces": REPLACES["conv3x3_same"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": lib_ms}
        del x, k
        torch.cuda.empty_cache()
    # the fp32 route at the benchmark's shape, against cuDNN's fp32 conv
    # (TF32 off); 2,304-deep fp32 sums in different orders: TOL_CONV_DEEP.
    # Its other checks and timers run after the train phases
    # (phase_conv_f32): the train phases' peak memory depends on what the
    # phases before them leave in the caching allocator.
    h, c = CONV_MAIN
    n = 512
    x, k = conv_case(n, h, h, c, c, torch.float32, seed=h)
    y, route = conv_routes(x, k)
    err = close("conv3x3 fp32", y, conv3x3.conv3x3_same_plain(x, k),
                TOL_CONV_DEEP, TOL_CONV_DEEP)
    del y
    ms = cuda_ms(lambda: conv3x3.conv3x3_same(x, k))
    cudnn = bench_conv3x3.conv_fn("cudnn", k, 16)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = cuda_ms(lambda: cudnn(x))
    flops = 2.0 * n * h * h * 9 * c * c
    t_ops = TF32X3_PRODUCTS * flops / PEAK_TF32_TC_FLOPS * 1e3
    t_bytes = 4.0 * (2 * n * h * h * c + 9 * c * c) / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    emit({"phase": "conv", "case": f"N{n}_H{h}_C{c}_float32", "route": route,
          "max_abs_err": err,
          "tolerance": {"rtol": TOL_CONV_DEEP, "atol": TOL_CONV_DEEP},
          "kernel_ms": ms, "library_ms": lib_ms, "bound_ms": bound,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "bound_share": bound / ms,
          "kernel_tflops": flops / ms / 1e9,
          "library_tflops": flops / lib_ms / 1e9, "ok": True})
    del x, k
    torch.cuda.empty_cache()
    return [row, {"name": "conv3x3_same_f32", "route": "cuda",
                  "source": CONV_SOURCE,
                  "replaces": REPLACES["conv3x3_same_f32"], "launches": 0,
                  "max_abs_err": err, "ms": ms, "plain_ms": None,
                  "bound_ms": bound,
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "library_ms": lib_ms}]


def phase_conv_f32():
    """The fp32 routes at CONV_MAIN, b512, after the train phases: two
    launches of the 3xTF32 route bitwise equal, its pre-pass and main kernel
    timed apart (torch.profiler), the plain version's time, and the ragged
    IEEE kernel, launched by name at the same shape, against the plain
    version (TOL_CONV_DEEP) and timed beside its CUDA-core bound. Returns
    the plain version's ms for the kernels line."""
    import torch

    from face_recognition_models_tpu_torch.ops import conv3x3

    h, c = CONV_MAIN
    n = 512
    x, k = conv_case(n, h, h, c, c, torch.float32, seed=h)
    same("conv3x3 fp32", (conv3x3.conv3x3_same(x, k),
                          conv3x3.conv3x3_same(x, k)))
    plain = conv3x3.conv3x3_same_plain(x, k)
    ragged = conv3x3._launch("conv3x3_same_f32_ragged", x, k)
    err = close("conv3x3 fp32 ragged", ragged, plain, TOL_CONV_DEEP,
                TOL_CONV_DEEP)
    del ragged, plain
    ragged_ms = cuda_ms(
        lambda: conv3x3._launch("conv3x3_same_f32_ragged", x, k))
    plain_ms = cuda_ms(lambda: conv3x3.conv3x3_same_plain(x, k))
    parts_ms = launch_ms(lambda: conv3x3.conv3x3_same(x, k),
                         kernel=r"conv3x3_\w+")
    flops = 2.0 * n * h * h * 9 * c * c
    t_simt = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4.0 * (2 * n * h * h * c + 9 * c * c) / PEAK_BYTES * 1e3
    emit({"phase": "conv_f32", "case": f"N{n}_H{h}_C{c}_float32",
          "launch_ms": parts_ms, "plain_ms": plain_ms,
          "bound_fp32_simt_ms": t_simt, "ragged_max_abs_err": err,
          "ragged_ms": ragged_ms,
          "ragged_bound_share": max(t_simt, t_bytes) / ragged_ms,
          "tolerance": {"rtol": TOL_CONV_DEEP, "atol": TOL_CONV_DEEP},
          "ok": True})
    del x, k
    torch.cuda.empty_cache()
    return plain_ms


def train_batches(steps, bs, size, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (steps * bs, size, size, 3), np.uint8)
    labels = rs.randint(0, C_MAIN, steps * bs).astype(np.int32)
    return images, labels


@contextlib.contextmanager
def observe_steps(after=None, before=None):
    """Run `before(state)` before and `after(state)` after every train step
    that `fit` takes (by wrapping the loop's `make_train_step`); the step
    itself is as is."""
    from face_recognition_models_tpu_torch.train import loop

    build = loop.make_train_step

    def make(*args, **kwargs):
        step = build(*args, **kwargs)

        def observed(state, *batch):
            if before is not None:
                before(state)
            out = step(state, *batch)
            if after is not None:
                after(out[0])
            return out
        return observed

    loop.make_train_step = make
    try:
        yield
    finally:
        loop.make_train_step = build


def train_phase(head_name, kernels, steps=TRAIN_STEPS, phase="train",
                **cfg_kw):
    """`steps` full-width steps of resnet18 + `head_name` through the port's
    `fit` (TrainConfig fields in `cfg_kw`). The counters of `kernels` must
    equal the steps and all others stay 0. Returns (fit result, the step's
    batch, launch counts)."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    bs, size = 512, 112
    cfg = cfg_lib.TrainConfig(head=head_name, num_classes=C_MAIN,
                              batch_size=bs, epochs=1, print_freq=1, seed=0,
                              **cfg_kw)
    images, labels = train_batches(steps, bs, size)
    loader = ArrayLoader(images, labels, batch_size=bs, seed=0)
    active = []

    def count_active(state):
        if hasattr(state.head_state, "life"):
            active.append(int((state.head_state.life > 0).sum()))

    torch.cuda.reset_peak_memory_stats()
    fh.reset_launch_counts()
    with observe_steps(count_active):
        res = fit(cfg, loader, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{head_name}: non-finite loss: {res.losses}")
    if len(res.losses) != steps:
        raise AssertionError(f"{head_name}: {len(res.losses)} steps run")
    for name, count in launches.items():
        want = steps if name in kernels else 0
        if count != want:
            raise AssertionError(f"{head_name}: {name} launched {count} "
                                 f"times in {steps} steps, not {want}")
    if head_name == "vpl_arcface" and not (
            len(active) == steps and min(active) > 0):
        raise AssertionError(f"vpl_arcface: active classes {active}: the "
                             "memory blend was not exercised")
    # print_freq=1 reads the loss every step, so each step time includes
    # the wait for the card; step 1 carries cuDNN's first-call set-up
    ms_step = 1e3 * float(np.mean(res.step_seconds[1:]))
    extra = {"active_classes": active} if active else {}
    emit({"phase": phase, "backbone": "resnet18", "head": head_name,
          "num_classes": C_MAIN, "batch": bs, "image_size": size,
          "dtype": cfg.compute_dtype, "bn_dtype": cfg.bn_dtype,
          "use_fused_head": cfg.use_fused_head, "losses": res.losses,
          **extra,
          "step_ms": [1e3 * s for s in res.step_seconds],
          "ms_per_step_after_1": ms_step, "img_per_s_after_1": bs / ms_step
          * 1e3, "max_memory_allocated": peak, "launches": launches,
          "ok": True})
    return res, (images[:bs], labels[:bs]), launches


def train_vs_eager(res, batch):
    """One step from the same state through the kernels and the eager head."""
    import torch

    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.train.state import (
        restore, snapshot)
    from face_recognition_models_tpu_torch.train.step import (
        make_eval_step, make_train_step)

    state, head_cfg = res.state, res.head_cfg
    saved = snapshot(state)
    head = get_head(head_cfg.name)
    out = {}
    for path, fused in (("kernel", True), ("eager", False)):
        restore(state, saved)
        step = make_train_step(head, head_cfg, use_fused_head=fused,
                               device="cuda")
        _, metrics = step(state, *batch)
        out[path] = (float(metrics["loss"]), state.kernel_w.detach().clone())
    loss_err = abs(out["kernel"][0] - out["eager"][0])
    # same backbone, same batch: the heads differ only in fp32 summation
    # order, and kernel_w moves by lr * grad, so the updated weights agree
    # far inside 1e-6 of values ~2e-2
    if loss_err > 1e-4 * abs(out["eager"][0]):
        raise AssertionError(f"{head_cfg.name}: loss kernel "
                             f"{out['kernel'][0]} vs eager {out['eager'][0]}")
    w_err = close("kernel_w", out["kernel"][1], out["eager"][1], 1e-5, 1e-6)
    emb = make_eval_step(state.backbone, device="cuda")(batch[0][:2])
    if emb.shape != (2, head_cfg.feature_dim) or not bool(
            torch.isfinite(emb).all()):
        raise AssertionError(f"embeddings {tuple(emb.shape)} not finite")
    emit({"phase": "train_vs_eager", "head": head_cfg.name,
          "loss_kernel": out["kernel"][0], "loss_eager": out["eager"][0],
          "loss_abs_err": loss_err, "kernel_w_max_abs_err": w_err,
          "embed_shape": list(emb.shape), "ok": True})


def qaface_bn_check(res, batch):
    """QAFace's degraded view runs in train mode but must move no BatchNorm
    buffer: after one step with it the buffers equal those after one step
    without it (the first forward is the same computation in both)."""
    import torch

    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.train.loop import degrade_images
    from face_recognition_models_tpu_torch.train.state import (
        restore, snapshot)
    from face_recognition_models_tpu_torch.train.step import make_train_step

    state, head_cfg = res.state, res.head_cfg
    saved = snapshot(state)
    step = make_train_step(get_head("qaface"), head_cfg, device="cuda")
    images = torch.as_tensor(batch[0]).cuda()
    buffers = {}
    for path, view in (("with_view", degrade_images(images)),
                       ("without_view", None)):
        restore(state, saved)
        step(state, images, batch[1], view)
        buffers[path] = {k: v.clone() for k, v in
                         state.backbone.state_dict().items()
                         if "running" in k or "num_batches" in k}
    err = 0.0
    for key, got in buffers["with_view"].items():
        want = buffers["without_view"][key]
        if got.dtype == torch.long:
            if not torch.equal(got, want):
                raise AssertionError(f"qaface: {key} {got} vs {want}")
            continue
        # the same forward twice on one card: equal but for the atomics of
        # a reduction, far below the 0.1 x (batch statistic) a second update
        # would add
        err = max(err, close(key, got, want, 1e-5, 1e-6))
    emit({"phase": "qaface_bn_buffers", "buffers": len(buffers["with_view"]),
          "max_abs_err": err, "ok": True})


def phase_train():
    """Returns {kernel: launches on its own path's run}."""
    res, batch, arc = train_phase("arcface", PLAIN_KERNELS)
    train_vs_eager(res, batch)
    del res
    res, batch, vpl = train_phase("vpl_arcface", MEM_KERNELS)
    train_vs_eager(res, batch)
    del res
    res, batch, _ = train_phase("qaface", MEM_KERNELS)
    qaface_bn_check(res, batch)
    return {**{k: arc[k] for k in PLAIN_KERNELS},
            **{k: vpl[k] for k in MEM_KERNELS}}


def head_device_ms(name):
    """{path: device ms} (device_ms over HEAD_TIMED_CALLS calls) of one
    forward + backward of head `name` at N=512,
    D=512, C=10,575 on random features (norm ~22) and the head's own kernel
    initialisation, from its initial state: through the kernels
    (fused_apply, where the head has them) and through the eager head
    (head.apply + the CE), each with the loss_g term; plus the memory each
    holds at its peak above what was allocated before it (MB)."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        fused_apply, fused_supported)
    from face_recognition_models_tpu_torch.train.losses import (
        mean_cross_entropy)

    dev = "cuda"
    cfg = cfg_lib.make_head_config(name, feature_dim=D_MAIN,
                                   num_classes=C_MAIN)
    head = get_head(name)
    g = torch.Generator(device=dev).manual_seed(3)
    feats = torch.randn(N_MAIN, D_MAIN, device=dev,
                        generator=g).requires_grad_(True)
    labels = torch.randint(0, C_MAIN, (N_MAIN,), device=dev, generator=g)
    kernel = head.init_kernel(cfg, torch.Generator().manual_seed(3),
                              dev).requires_grad_(True)
    state = head.init_state(cfg, dev)
    rng = torch.Generator(device=dev).manual_seed(4)

    def fused():
        out = fused_apply(cfg, kernel, feats, labels, state, rng=rng)
        torch.autograd.grad(out.loss_id + out.loss_g, (feats, kernel))

    def eager():
        out = head.apply(cfg, kernel, feats, labels, state, rng=rng)
        loss = mean_cross_entropy(out.logits, labels) + out.loss_g
        torch.autograd.grad(loss, (feats, kernel))

    out = {}
    paths = (("fused", fused), ("eager", eager)) if fused_supported(name) \
        else (("eager", eager),)
    for path, fn in paths:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"{path}_peak_mb"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 20
        # 5 calls: a forward + backward is 60-120 launches, and the card's
        # launch queue (about a thousand) must hold all the calls queued
        # behind the spin
        out[f"{path}_ms"] = device_ms(fn, warmup=2, iters=HEAD_TIMED_CALLS)
    return out


def phase_heads():
    """Each of NEW_HEADS at full width: HEAD_STEPS steps of `fit` on the
    path `train --head-path auto` gives it (K1 / K2 once a step for the
    fused heads, no kernel for the eager two), one step through the kernels
    against one through the eager head for each fused head, and the head's
    own forward + backward device ms on both paths. Returns {head:
    launches}."""
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        use_fused)

    out = {}
    for name in NEW_HEADS:
        fused = use_fused(name)
        res, batch, launches = train_phase(
            name, PLAIN_KERNELS if fused else (), steps=HEAD_STEPS,
            phase="heads", use_fused_head=fused)
        if fused:
            train_vs_eager(res, batch)
        del res
        emit({"phase": "heads_head_ms", "head": name,
              "N": N_MAIN, "D": D_MAIN, "C": C_MAIN, **head_device_ms(name),
              "ok": True})
        out[name] = launches
    return out


def torchvision_state_dict(seed):
    """A seeded resnet18 state_dict in torchvision's layout (the port's
    names) with a 1000-class fc and random BatchNorm statistics."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone

    g = torch.Generator().manual_seed(seed)
    sd = get_backbone("resnet18", embed_dim=1000,
                      dtype=torch.float32).state_dict()
    for k, v in sd.items():
        if k.endswith("running_var") or (k.endswith("weight")
                                         and v.ndim == 1):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.dtype.is_floating_point:
            sd[k] = 0.05 * torch.randn(v.shape, generator=g)
    return sd


def phase_pretrained(root):
    """`train --pretrained` with `--bn-dtype bfloat16`: a seeded
    torchvision-layout resnet18 state_dict saved under `root`, its load
    timed on the host, then 2 full-width ArcFace steps of `fit` from it
    with bf16 BatchNorm. Before step 1 the trunk equals the file (every key
    but the 1000-class fc) bit for bit and every BatchNorm rounds to
    bf16."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.utils.pretrained import (
        load_pretrained_backbone)

    sd = torchvision_state_dict(seed=5)
    path = os.path.join(root, "resnet18_torchvision.pth")
    torch.save(sd, path)
    trunk = get_backbone("resnet18")
    t0 = time.perf_counter()
    load_pretrained_backbone(path, "resnet18", trunk)
    load_s = time.perf_counter() - t0
    del trunk
    checked = []

    def trunk_is_file(state):
        if checked:
            return
        got = state.backbone.state_dict()
        for key, value in sd.items():
            if not key.startswith("fc.") and not torch.equal(
                    got[key].cpu(), value):
                raise AssertionError(f"pretrained: {key} differs from the "
                                     "file before step 1")
        dtypes = {m.dtype for m in state.backbone.modules()
                  if type(m).__name__ == "BatchNorm"}
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"pretrained: BatchNorm dtypes {dtypes}")
        checked.append(len(sd))

    with observe_steps(before=trunk_is_file):
        res, _, launches = train_phase(
            "arcface", PLAIN_KERNELS, steps=2, phase="pretrained_train",
            pretrained_path=path, bn_dtype="bfloat16")
    if not checked:
        raise AssertionError("pretrained: no step ran")
    emit({"phase": "pretrained", "file_bytes": os.path.getsize(path),
          "load_seconds": load_s, "keys_checked": checked[0],
          "losses": res.losses, "launches": launches, "ok": True})


def scan_fit(name, k, images, labels):
    """One epoch of full-width steps of head `name` over the arrays through
    `fit` with scan_steps=k, on the path `train --head-path auto` gives the
    head. Returns (result, {kernel: real launches})."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        use_fused)
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    bs = 512
    cfg = cfg_lib.TrainConfig(head=name, num_classes=C_MAIN, batch_size=bs,
                              epochs=1, print_freq=10 ** 9, seed=0,
                              scan_steps=k, use_fused_head=use_fused(name))
    fh.reset_launch_counts()
    res = fit(cfg, ArrayLoader(images, labels, batch_size=bs, seed=0),
              device="cuda")
    torch.cuda.synchronize()
    return res, dict(fh.launch_counts)


def same_state(name, got, want):
    """Raise unless two train states are equal bit for bit: every tensor a
    step changes (train.state.state_tensors: parameters, BatchNorm buffers,
    kernel_w, momentum buffers, head state, the step count and lr), the
    host step and the step generator's state."""
    import torch

    from face_recognition_models_tpu_torch.train.state import state_tensors

    a, b = state_tensors(got), state_tensors(want)
    bad = [i for i, (x, y) in enumerate(zip(a, b, strict=True))
           if x.dtype != y.dtype or not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} of {len(a)} state tensors "
                             f"differ (first {bad[:5]})")
    if got.step != want.step:
        raise AssertionError(f"{name}: step {got.step} vs {want.step}")
    if got.rng is not None and not torch.equal(got.rng.get_state(),
                                               want.rng.get_state()):
        raise AssertionError(f"{name}: the step generators' states differ")
    return len(a)


def phase_scan():
    """Step batching (`train --scan-steps`): for each of SCAN_HEADS,
    SCAN_STEPS full-width steps with scan_steps=SCAN_K against the same
    steps one at a time, from the same seeded state and batches: losses and
    the whole state bit for bit. The graph's kernel launches are counted by
    its replays: a replay runs SCAN_K launches of each of the head's
    kernels, which the host's counters never see. Then bench_steps' eager
    against graphed runs of the ArcFace recipe and the profiler's host and
    device ms/step and idle share of each path. Returns {kernel: launches}
    of the ArcFace (fp32 kernels) and VPL-ArcFace (_mem kernels) graphed
    runs, replays included."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        use_fused)
    from face_recognition_models_tpu_torch.scripts import bench_steps
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi
    from face_recognition_models_tpu_torch.utils.profiling import (
        profile_train_step)

    images, labels = train_batches(SCAN_STEPS, 512, 112)
    chunks = SCAN_STEPS // SCAN_K
    out = {}
    for name in SCAN_HEADS:
        eager, eager_launches = scan_fit(name, 1, images, labels)
        graphed, real = scan_fit(name, SCAN_K, images, labels)
        # the real launches: SCAN_K warm-up steps before the capture (then
        # undone) and the leftover steps; the replays run the rest
        launches = {k: v + graphed.replay_launches.get(k, 0)
                    * graphed.replays for k, v in real.items()}
        kernels = (() if not use_fused(name) else
                   MEM_KERNELS if name in ("vpl_arcface", "qaface")
                   else PLAIN_KERNELS)
        want_replay = {k: SCAN_K for k in kernels}
        if graphed.replays != chunks or graphed.replay_launches != \
                want_replay:
            raise AssertionError(
                f"scan {name}: {graphed.replays} replays of "
                f"{graphed.replay_launches}, not {chunks} of {want_replay}")
        for k, v in launches.items():
            want = SCAN_STEPS + SCAN_K if k in kernels else 0
            if v != want or eager_launches[k] != (
                    SCAN_STEPS if k in kernels else 0):
                raise AssertionError(f"scan {name}: {k} launched {v} times "
                                     f"(eager {eager_launches[k]})")
        if graphed.losses != eager.losses:
            raise AssertionError(f"scan {name}: losses {graphed.losses} vs "
                                 f"eager {eager.losses}")
        tensors = same_state(f"scan {name}", graphed.state, eager.state)
        emit({"phase": "scan", "head": name, "steps": SCAN_STEPS,
              "scan_steps": SCAN_K, "replays": graphed.replays,
              "capture_seconds": graphed.capture_seconds,
              "replay_launches": graphed.replay_launches,
              "launches": launches, "losses": graphed.losses,
              "bitwise_losses": True, "bitwise_state_tensors": tensors,
              "bitwise_generator": graphed.state.rng is not None,
              "ok": True})
        if name == "arcface":
            out.update({k: launches[k] for k in PLAIN_KERNELS})
        if name == "vpl_arcface":
            out.update({k: launches[k] for k in MEM_KERNELS})
        del eager, graphed
        torch.cuda.empty_cache()

    smi = nvidia_smi()
    res = bench_steps.bench(device="cuda", **SCAN_BENCH)
    for k, summary in res["summary"].items():
        emit({"phase": "scan_bench", "scan_steps": int(k),
              "ms_per_step_after_first_chunk":
                  summary["ms_per_step_after_first_chunk"],
              "img_per_s_after_first_chunk":
                  summary["img_per_s_after_first_chunk"],
              "img_per_s": summary["img_per_s"],
              "peak_gb": summary["peak_gb"],
              "capture_seconds": summary["capture_seconds"],
              "runs": res["runs"][k], "nvidia_smi": smi, "ok": True})
    for k in (1, *SCAN_BENCH["scans"]):
        prof = profile_train_step(cfg_lib.TrainConfig(
            num_classes=C_MAIN, scan_steps=k), device="cuda")
        emit({"phase": "scan_profile", "scan_steps": k,
              "host_ms_per_step": prof["ms_per_step"],
              "device_ms_per_step": prof["device_ms_per_step"],
              "idle_share": prof["idle_share"],
              "by_category_ms": prof["by_category_ms"],
              "capture_seconds": prof.get("capture_seconds"),
              "nvidia_smi": smi, "ok": True})
        torch.cuda.empty_cache()
    return out


def phase_head_bf16():
    """One forward and backward through the public fused_margin_ce and
    fused_margin_ce_mem with mm_dtype=torch.bfloat16 at the training shape
    (ArcFace-like margin, scale 64; the _mem family with a VPL state after
    one step). Returns {kernel: launches}."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    cases = []
    for mem, eps in ((None, None), ("vpl", 1e-7)):
        x = make_inputs(N_MAIN, D_MAIN, C_MAIN, fh.MODE_IDENTITY, seed=13,
                        mem=mem)
        cases.append((x, eps))
    fh.reset_launch_counts()
    out = []
    for x, eps in cases:
        xn = x["xn"].clone().requires_grad_(True)
        wn = x["wn"].clone().requires_grad_(True)
        mem = (x["memn"], x["lam"]) if "memn" in x else ()
        fn = fh.fused_margin_ce_mem if mem else fh.fused_margin_ce
        res = fn(xn, wn, *mem, x["labels"], x["t"], x["tcos"], x["scale"],
                 x["ab"], fh.MODE_IDENTITY, eps, mm_dtype=torch.bfloat16)
        loss = (res.lse - res.target_logit).mean()
        loss.backward()
        out.append((x, eps, loss.detach(), xn.grad, wn.grad))
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    for name, count in launches.items():
        want = 1 if name in BF16_KERNELS else 0
        if count != want:
            raise AssertionError(f"head_bf16: {name} launched {count} times, "
                                 f"not {want}")
    losses = {}
    for x, eps, loss16, gx, gw in out:
        family = "mem" if "memn" in x else "plain"
        if not (bool(torch.isfinite(gx).all())
                and bool(torch.isfinite(gw).all())):
            raise AssertionError(f"head_bf16 {family}: non-finite gradient")
        mem = (x["memn"], x["lam"]) if "memn" in x else ()
        plain = (fh.fused_margin_ce_mem_plain if mem
                 else fh.fused_margin_ce_plain)
        ref = plain(x["xn"], x["wn"], *mem, x["labels"], x["t"], x["tcos"],
                    x["scale"], x["ab"], fh.MODE_IDENTITY, eps)
        loss32 = float((ref.lse - ref.target_logit).mean())
        rel = abs(float(loss16) - loss32) / abs(loss32)
        # the JAX package's contract for the option (its
        # test_bf16_matmul_variant_close): within 5% of the fp32 loss
        if not rel < 0.05:
            raise AssertionError(f"head_bf16 {family}: loss {float(loss16)} "
                                 f"vs fp32 {loss32}")
        losses[family] = {"bf16": float(loss16), "fp32": loss32,
                          "rel_diff": rel}
    emit({"phase": "head_bf16", "losses": losses, "launches": launches,
          "ok": True})
    return {k: launches[k] for k in BF16_KERNELS}


def phase_conv_bench():
    """The conv's benchmark entry point on the card at CONV_MAIN, b512, in
    bf16 and in fp32: the kernel path, whose launches are counted and must
    all be of the dtype's 16-byte route, and the cuDNN path. Returns
    {route: launches}."""
    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.scripts import bench_conv3x3

    shape = ",".join(map(str, CONV_MAIN))
    iters = 10
    want = (1 + bench_conv3x3.N_REPS) * iters
    launches = {}
    for dtype, key in (("bfloat16", "conv3x3_same"),
                       ("float32", "conv3x3_same_f32")):
        conv3x3.reset_launch_counts()
        res = bench_conv3x3.bench(shape, 512, "kernel", iters, dtype=dtype,
                                  device="cuda")
        counts = dict(conv3x3.launch_counts)
        if counts != {r: want * (r == key) for r in counts}:
            raise AssertionError(f"conv3x3_bench {dtype}: launches {counts}, "
                                 f"not {want} of {key}")
        launches[key] = counts[key]
        lib = bench_conv3x3.bench(shape, 512, "cudnn", iters, dtype=dtype,
                                  device="cuda")
        for r in (res, lib):
            if not (r["ms"] > 0 and math.isfinite(r["tflops"])):
                raise AssertionError(f"conv3x3_bench: {r}")
            emit({"phase": "conv3x3_bench", **r, "ok": True})
    return launches


def state_tensors(state):
    """{name: tensor} of everything a resumed run must carry over bit for
    bit: backbone parameters and buffers, kernel_w, momentum buffers."""
    out = {f"backbone.{k}": v for k, v in state.backbone.state_dict().items()}
    out["kernel_w"] = state.kernel_w.detach()
    for i, slot in state.optimizer.state_dict()["state"].items():
        out[f"momentum.{i}"] = slot["momentum_buffer"]
    return out


def same_tensors(name, got, want, layout=False):
    """Raise unless `got` and `want` hold equal tensors bit for bit; with
    `layout`, the backbone's tensors must have the same strides too (the
    card's channels-last weights). Momentum buffers may come back in
    another layout; their values must still be equal."""
    if got.keys() != want.keys():
        raise AssertionError(f"{name}: tensors {sorted(got)} vs "
                             f"{sorted(want)}")
    import torch

    for key in want:
        a, b = got[key], want[key]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{name}: {key} differs")
        if (layout and key.startswith("backbone.")
                and got[key].stride() != want[key].stride()):
            raise AssertionError(f"{name}: {key} strides {got[key].stride()}"
                                 f" vs {want[key].stride()}")


def phase_checkpoint(root):
    """Checkpoints and resume at full width under `root` (run A's files
    stay there for phase_eval). Returns run A's fit result."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.state import (
        create_train_state)

    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)

    bs, size, steps = 512, 112, 2
    # identity-structured data (256 identities x 4 images): the eval phase
    # verifies this model on other identities; 4 steps at lr 0.1 on uniform
    # noise with random labels collapse the embeddings instead
    images, labels = synthetic_identities(steps * bs // 4, 4,
                                          image_size=size, seed=1)
    loader = ArrayLoader(images, labels, batch_size=bs, seed=0)

    def config(epochs, resume=None):
        return cfg_lib.TrainConfig(head="arcface", num_classes=C_MAIN,
                                   batch_size=bs, epochs=epochs,
                                   print_freq=100, seed=0,
                                   continue_train=resume)

    def run(directory, epochs, resume=None):
        mgr = CheckpointManager(directory, "arcface")
        res = fit(config(epochs, resume), loader, device="cuda",
                  checkpoint_manager=mgr)
        torch.cuda.synchronize()
        return res, mgr

    dir_a = os.path.join(root, "a", "arcface")
    dir_b = os.path.join(root, "b", "arcface")
    # two runs compared bit for bit, in PyTorch's default mode
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("checkpoint: deterministic mode is on")
    a, mgr_a = run(dir_a, 2)
    b1, mgr_b = run(dir_b, 1)
    b2, _ = run(dir_b, 1, "latest")
    mgr_a.save_final(a.state.backbone.state_dict())
    if b1.losses + b2.losses != a.losses:
        raise AssertionError(f"checkpoint: resumed losses {b1.losses} + "
                             f"{b2.losses} vs {a.losses}")
    same_tensors("resumed run", state_tensors(b2.state),
                 state_tensors(a.state))

    # one save and one restore timed; the restored state bit for bit
    head_cfg = cfg_lib.make_head_config("arcface", num_classes=C_MAIN)
    epoch_loss = float(np.mean(a.losses[steps:]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr_a.save(a.state, 2, epoch_loss)
    save_s = time.perf_counter() - t0
    _, _, fresh = create_train_state(config(1), head_cfg,
                                     torch.device("cuda"))
    t0 = time.perf_counter()
    restored, start, loss = mgr_a.restore(fresh, "latest")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if (start, loss) != (3, epoch_loss) or restored.step != a.state.step:
        raise AssertionError(f"checkpoint: restore gave epoch {start}, "
                             f"loss {loss}, step {restored.step}")
    same_tensors("restored state", state_tensors(restored),
                 state_tensors(a.state), layout=True)
    sizes = {name: os.path.getsize(os.path.join(dir_a, name))
             for name in sorted(os.listdir(dir_a))}

    # keep-3 rotation, then min_loss resume deletes the epoch files
    for epoch in (3, 4, 5):
        mgr_b.save(b2.state, epoch, 1e9)
    kept = sorted(n for n in os.listdir(dir_b) if n.startswith("epoch_"))
    if kept != ["epoch_3", "epoch_4", "epoch_5"]:
        raise AssertionError(f"checkpoint: rotation kept {kept}")
    best = min(np.mean(a.losses[:steps]), np.mean(a.losses[steps:]))
    _, start, loss = mgr_b.restore(fresh, "min_loss")
    left = sorted(os.listdir(dir_b))
    if loss != best or any(n.startswith("epoch_") for n in left):
        raise AssertionError(f"checkpoint: min_loss resume gave loss {loss} "
                             f"(best {best}), left {left}")
    emit({"phase": "checkpoint", "backbone": "resnet18", "head": "arcface",
          "num_classes": C_MAIN, "batch": bs, "steps_per_epoch": steps,
          "losses": a.losses, "bytes": sizes, "save_seconds": save_s,
          "restore_seconds": restore_s, "min_loss_start_epoch": start,
          "ok": True})
    return a


@contextlib.contextmanager
def recorded(module, name):
    """Record the return value of every call of module.name."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def synthetic_benchmark(path, identities=3000, size=112):
    """A .bin of uint8 arrays in the insightface layout: for each identity
    one genuine pair (its images 0 and 1) and one impostor pair (its image
    2 and the next identity's image 3): 2 x identities pairs."""
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)

    images, _ = synthetic_identities(identities, 4, image_size=size, seed=2)
    bins, issame = [], []
    for i in range(identities):
        j = (i + 1) % identities
        bins += [images[4 * i], images[4 * i + 1],
                 images[4 * i + 2], images[4 * j + 3]]
        issame += [True, False]
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f, protocol=pickle.HIGHEST_PROTOCOL)


def phase_eval(root, run_a):
    """Run A's final artifact through restore_backbone and the `eval` CLI
    on a synthetic LFW-size benchmark (see the module docstring)."""
    import torch

    from face_recognition_models_tpu_torch.checkpoint import restore_backbone
    from face_recognition_models_tpu_torch.cli.main import main as cli_main
    from face_recognition_models_tpu_torch.data.pairs import load_bin
    from face_recognition_models_tpu_torch.evaluation import batch_eval
    from face_recognition_models_tpu_torch.evaluation.verification import (
        embed_unique_images)
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device

    bench_dir = os.path.join(root, "benchmarks")
    os.makedirs(bench_dir)
    synthetic_benchmark(os.path.join(bench_dir, "synth_lfw.bin"))
    stack, pairs = load_bin(os.path.join(bench_dir, "synth_lfw.bin"))
    model = get_backbone("resnet18")
    model.load_state_dict(restore_backbone(os.path.join(root, "a", "arcface"),
                                           "final"))
    model = to_device(model, torch.device("cuda"))
    live = embed_unique_images(
        batch_eval.make_embed_fn(run_a.state.backbone, device="cuda"),
        stack, 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = embed_unique_images(batch_eval.make_embed_fn(model, device="cuda"),
                              stack, 256)
    embed_s = time.perf_counter() - t0
    if not np.array_equal(emb, live):
        raise AssertionError("eval: restored embeddings differ from the live "
                             f"state's by {np.abs(emb - live).max()}")
    results, rates = {}, {}
    for protocol, flag in (("host", []), ("device", ["--device-protocol"])):
        out_dir = os.path.join(root, "eval_" + protocol)
        with recorded(batch_eval, "evaluate_model_on_benchmark") as calls:
            rc = cli_main(["eval", "--checkpoint-dir",
                           os.path.join(root, "a"), "--eval-data-path",
                           bench_dir, "--benchmarks", "synth_lfw",
                           "--batch-size", "256", "--tpr-far", "1e-2,1e-3",
                           "--output-dir", out_dir] + flag)
        tables = [os.path.join(out_dir, f) for f in
                  ("accuracy_10fold.csv", "auc_10fold.csv")]
        if rc != 0 or len(calls) != 1 or not all(map(os.path.isfile,
                                                     tables)):
            raise AssertionError(f"eval {protocol}: rc {rc}, {len(calls)} "
                                 f"benchmark runs, tables {tables}")
        results[protocol], rates[protocol] = calls[0]
    host, dev = results["host"], results["device"]
    auc_err = float(np.max(np.abs(np.subtract(host.fold_aucs,
                                              dev.fold_aucs))))
    if (host.fold_thresholds != dev.fold_thresholds
            or host.fold_accuracies != dev.fold_accuracies
            or auc_err > 1e-12 or rates["host"] != rates["device"]):
        raise AssertionError(f"eval: host {host} vs device {dev} "
                             f"(auc err {auc_err})")
    if not host.mean_auc >= 0.9:
        raise AssertionError(f"eval: mean AUC {host.mean_auc} below 0.9")
    emit({"phase": "eval", "backbone": "resnet18", "pairs": len(pairs),
          "images": len(stack), "batch": 256,
          "mean_accuracy": host.mean_accuracy, "std_accuracy":
          host.std_accuracy, "mean_auc": host.mean_auc,
          "fold_thresholds": host.fold_thresholds,
          "auc_host_vs_device_max_abs_err": auc_err,
          "tpr_at_far": {f"{k:g}": v for k, v in rates["host"].items()},
          "embed_img_per_s": len(stack) / embed_s, "ok": True})


def fit_arcface(loader, steps_label):
    """`fit` of the full-width ArcFace recipe over `loader` for one epoch,
    in PyTorch's default mode, the loss read only at the epoch's end (so
    the host runs ahead of the card as in a real run). Returns the result
    and {kernel: launches} of the run."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"{steps_label}: deterministic mode is on")
    cfg = cfg_lib.TrainConfig(head="arcface", num_classes=C_MAIN,
                              batch_size=loader.batch_size, epochs=1,
                              print_freq=10_000, seed=0)
    fh.reset_launch_counts()
    res = fit(cfg, loader, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    steps = len(res.losses)
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{steps_label}: non-finite loss {res.losses}")
    for name, count in launches.items():
        want = steps if name in PLAIN_KERNELS else 0
        if count != want:
            raise AssertionError(f"{steps_label}: {name} launched {count} "
                                 f"times in {steps} steps, not {want}")
    return res, launches


def phase_gather():
    """The target-column gather's backward (`heads.base.take_columns`)
    at the training shape: bitwise repeats where labels repeat, against
    index_select's backward (float atomics) and the one-hot product, and
    each one's device ms; then two default-mode runs of 3 full-width
    ArcFace steps on the same batches must be bitwise equal."""
    import torch

    from face_recognition_models_tpu_torch.heads.base import (
        one_hot, take_columns)

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the one-hot product
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(D_MAIN, C_MAIN, device=cuda, generator=g)
    idx = torch.randint(0, C_MAIN, (N_MAIN,), device=cuda, generator=g)
    grad = torch.randn(D_MAIN, N_MAIN, device=cuda, generator=g)
    repeated = N_MAIN - int(torch.unique(idx).numel())
    w.requires_grad_()

    def index_select_bwd():
        return torch.autograd.grad(w.index_select(1, idx), w, grad)[0]

    def take_columns_bwd():
        return torch.autograd.grad(take_columns(w, idx), w, grad)[0]

    def one_hot_bwd():
        return grad @ one_hot(idx, C_MAIN)

    got = take_columns_bwd()
    if not torch.equal(got, take_columns_bwd()):
        raise AssertionError("gather: take_columns' backward did not repeat")
    err = max(close("gather vs index_select", got, index_select_bwd(),
                    1e-6, 1e-6),
              close("gather vs one-hot", got, one_hot_bwd(), 1e-6, 1e-6))
    ms = {name: device_ms(fn) for name, fn in (
        ("take_columns", take_columns_bwd),
        ("index_select", index_select_bwd), ("one_hot", one_hot_bwd))}

    bs, steps = N_MAIN, 3
    images, labels = train_batches(steps, bs, 112, seed=2)
    dup = [bs - len(np.unique(labels[i * bs:(i + 1) * bs]))
           for i in range(steps)]
    if min(dup) == 0:
        raise AssertionError(f"gather: no repeated label in a batch: {dup}")
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader

    runs = []
    for _ in range(2):
        res, _ = fit_arcface(ArrayLoader(images, labels, batch_size=bs,
                                         seed=0), "gather")
        runs.append((res.losses, state_tensors(res.state)))
        del res
    if runs[0][0] != runs[1][0]:
        raise AssertionError(f"gather: losses {runs[0][0]} vs {runs[1][0]}")
    same_tensors("gather: the second default-mode run", runs[1][1],
                 runs[0][1])
    emit({"phase": "gather", "shape": [N_MAIN, D_MAIN, C_MAIN],
          "repeated_labels": repeated, "max_abs_err": err,
          "backward_device_ms": ms, "chosen": "take_columns",
          "train_steps": steps, "repeated_labels_per_batch": dup,
          "losses": runs[0][0], "bitwise_equal_runs": True, "ok": True})


class PackableArrays:
    """An ArrayLoader's one unshuffled full pass, with the two fields
    `pack_from_loader` reads (`dataset` for the length and
    `skipped_images`), so seeded arrays pack with no decoder."""

    def __init__(self, images, labels, batch_size):
        from face_recognition_models_tpu_torch.data.pipeline import (
            ArrayLoader)

        self.loader = ArrayLoader(images, labels, batch_size, shuffle=False,
                                  drop_remainder=False)
        self.dataset = images
        self.skipped_images = 0

    def epoch(self, epoch=0):
        return self.loader.epoch(epoch)


def phase_train_packed():
    """This slice's path: the ArcFace phase's seeded batches (20 steps at
    b512, 112 px) packed with `pack_from_loader`, then the full-width
    `fit` from `PackedLoader` and from `ArrayLoader` over the same arrays
    with the same seed: bitwise equal losses. Pack write GB/s, PackedLoader
    batches/s on the host alone, img/s and host ms/step of both runs, and
    each run once more under torch.profiler: device ms/step, idle share
    and the host-to-device copy's device ms."""
    import torch

    from face_recognition_models_tpu_torch.data.packed import (
        PackedDataset, PackedLoader, pack_from_loader)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.utils.profiling import summarize

    steps, bs, size = 20, N_MAIN, 112
    images, labels = train_batches(steps, bs, size)
    out = {"phase": "train_packed", "steps": steps, "batch": bs,
           "image_size": size, "num_classes": C_MAIN}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        meta = pack_from_loader(PackableArrays(images, labels, bs),
                                [str(c) for c in range(C_MAIN)], root, size)
        write_s = time.perf_counter() - t0
        ds = PackedDataset.open(root)
        if not (np.array_equal(np.asarray(ds.images), images)
                and np.array_equal(ds.labels, labels)):
            raise AssertionError("train_packed: the pack differs from the "
                                 "arrays it was written from")
        t0 = time.perf_counter()
        batches = sum(1 for _ in PackedLoader(ds, bs, seed=0).epoch(1))
        read_s = time.perf_counter() - t0
        runs = {}
        for name, make in (
                ("packed", lambda: PackedLoader(ds, batch_size=bs, seed=0)),
                ("array", lambda: ArrayLoader(images, labels, batch_size=bs,
                                              seed=0))):
            res, launches = fit_arcface(make(), f"train_packed {name}")
            runs[name] = {
                "losses": res.losses, "img_per_s": res.images_per_sec,
                "host_ms_per_step_after_1":
                    1e3 * float(np.mean(res.step_seconds[1:])),
                "launches": launches}
            del res
            # the same run again under the profiler, for its device times
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res, _ = fit_arcface(make(), f"train_packed {name}")
                wall_ms = 1e3 * (time.perf_counter() - t0)
            if res.losses != runs[name]["losses"]:
                raise AssertionError(f"train_packed {name}: the profiled "
                                     "run's losses differ")
            runs[name]["profiler"] = {k: v for k, v in summarize(
                prof, steps, wall_ms).items() if k != "top_kernels"}
            del res, prof
    if runs["packed"]["losses"] != runs["array"]["losses"]:
        raise AssertionError("train_packed: losses from the pack "
                             f"{runs['packed']['losses']} vs the arrays "
                             f"{runs['array']['losses']}")
    emit({**out, "pack_bytes": int(meta["num_samples"]) * size * size * 3,
          "pack_write_seconds": write_s,
          "pack_write_gb_per_s": images.nbytes / write_s / 1e9,
          "packed_loader_batches": batches,
          "packed_loader_batches_per_s": batches / read_s,
          "runs": runs, "losses_bitwise_equal": True, "ok": True})
    return runs["packed"]["launches"]


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "jpeg_fixture")
DECODE_MAD = 2.0   # mean abs diff vs PIL, the JAX test's bound


def phase_decode():
    """Whether the port's native JPEG decoder builds here; if it does, the
    committed fixture decoded at 112 px against PIL's decode of it (the
    committed .npy) and `decode_batch`'s img/s at b512 (the fixture tiled)
    with 8 threads. A failed build is reported and does not fail the
    smoke (the pack path needs no decoder); a wrong decode does."""
    from face_recognition_models_tpu_torch.native import fastdecode

    t0 = time.perf_counter()
    if not fastdecode.is_available():
        emit({"phase": "decode", "native_builds": False,
              "build_error": fastdecode.build_error(), "ok": True})
        return
    build_s = time.perf_counter() - t0
    paths = sorted(os.path.join(FIXTURE, f) for f in os.listdir(FIXTURE)
                   if f.endswith(".jpg"))
    want = np.load(os.path.join(FIXTURE, "pil_112.npy"))
    got, status = fastdecode.decode_batch(paths, 112, n_threads=8)
    mad = float(np.abs(got.astype(np.int32) - want.astype(np.int32)).mean())
    if status.any() or not mad < DECODE_MAD:
        raise AssertionError(f"decode: status {status.tolist()}, mean abs "
                             f"diff {mad} vs PIL (bound {DECODE_MAD})")
    batch = (paths * (-(-N_MAIN // len(paths))))[:N_MAIN]
    out = np.empty((N_MAIN, 112, 112, 3), np.uint8)
    fastdecode.decode_batch(batch, 112, out=out, n_threads=8)
    seconds = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, status = fastdecode.decode_batch(batch, 112, out=out, n_threads=8)
        seconds.append(time.perf_counter() - t0)
        if status.any():
            raise AssertionError("decode: a tiled fixture image failed")
    emit({"phase": "decode", "native_builds": True, "build_seconds": build_s,
          "library": fastdecode.library_path().name, "images": len(paths),
          "source_size": 250, "mean_abs_diff_vs_pil": mad,
          "tolerance": DECODE_MAD, "batch": N_MAIN, "threads": 8,
          "img_per_s": N_MAIN / float(np.median(seconds)),
          "seconds": seconds, "ok": True})


def phase_bench_embed():
    """The headline workload at full size, its device split, and bf16 vs
    fp32 BatchNorm on the same weights and batch."""
    import torch
    import torch.nn.functional as F

    from face_recognition_models_tpu_torch.scripts import bench_embed
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    res = bench_embed.bench(device="cuda")
    res32 = bench_embed.bench(bn_dtype="float32", device="cuda")
    for r in (res, res32):
        if not (r["value"] > 0 and math.isfinite(r["value"])):
            raise AssertionError(f"bench_embed: {r}")
    cuda = torch.device("cuda")
    images = bench_embed.make_batches(1, 512, 112, 0, cuda)[0]
    split, emb = {}, {}
    for bn in ("bfloat16", "float32"):
        step = make_eval_step(bench_embed.build_model("resnet50", bn, 0, cuda),
                              device=cuda)
        split[bn] = bench_embed.device_split(step, images)
        emb[bn] = step(images)
    cos = F.cosine_similarity(emb["bfloat16"], emb["float32"], dim=1)
    min_cos = float(cos.min())
    if not min_cos >= 0.99:
        raise AssertionError(f"bench_embed: bf16-BN vs fp32-BN least cosine "
                             f"{min_cos}")
    emit({"phase": "bench_embed", **res,
          "fp32_bn": {k: res32[k] for k in ("value", "ms_per_batch")},
          "device_ms_by_category": split,
          "min_cosine_bf16_vs_fp32_bn": min_cos,
          "mean_cosine_bf16_vs_fp32_bn": float(cos.mean()), "ok": True})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from face_recognition_models_tpu_torch.ops import _build
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "entry function" in ln or "registers" in ln
                        or "spill" in ln or "wgmma" in ln]
                    for k, v in reports.items()}})

    rows = phase_kernels()
    rows += phase_conv()
    launches = phase_train()
    phase_heads()
    with tempfile.TemporaryDirectory() as root:
        phase_pretrained(root)
    for name, count in phase_scan().items():
        launches[name] += count
    launches.update(phase_head_bf16())
    launches.update(phase_conv_bench())
    f32_plain_ms = phase_conv_f32()
    device = phase_device_times()
    phase_gather()
    with tempfile.TemporaryDirectory() as root:
        run_a = phase_checkpoint(root)
        phase_eval(root, run_a)
        del run_a
    torch.cuda.empty_cache()
    phase_train_packed()
    phase_decode()
    torch.cuda.empty_cache()
    phase_bench_embed()
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] == "conv3x3_same_f32":
            r["plain_ms"] = f32_plain_ms
        if r["name"] in device:
            r["device_ms"] = device[r["name"]]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
