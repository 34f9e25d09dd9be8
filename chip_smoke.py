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
             at N=4,096. Times (CUDA events, after warm-up) of the kernel, its
             plain version and the eager library head, beside the bound.
4. train   - the port's `fit`: resnet18 + ArcFace, C=10,575, batch 512,
             112 px, bf16, 5 steps; the launch counters must equal the steps.
             Then one step from the same state through the kernels and
             through the eager head, compared.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet) for the bound: fp32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
N_MAIN, D_MAIN, C_MAIN = 512, 512, 10575
TRAIN_STEPS = 5
SOURCE = "face_recognition_models_tpu_torch/csrc/fused_head.cu"
REPLACES = {
    "fused_ce_fwd": "face_recognition_models_tpu/ops/fused_head.py:95",
    "fused_ce_bwd_dx": "face_recognition_models_tpu/ops/fused_head.py:315",
    "fused_ce_bwd_dw": "face_recognition_models_tpu/ops/fused_head.py:315",
}
# kernel vs plain, both IEEE fp32 on the card: the sums run in different
# orders (10^4 exp terms, 512-deep dot products), a few ulps apart.
TOL_STATS = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD_RTOL = 1e-3     # plus an atol of 1e-5 x the output's largest value
TOLERANCE = {"lse_target_logit": TOL_STATS,
             "gradients": {"rtol": TOL_GRAD_RTOL, "atol": "1e-5 x max|plain|"},
             "higher": "differs by at most 1 per row"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance, max abs err "
            f"{float(err.max()):.3e} (rtol {rtol}, atol {atol:.3e})")
    return float(err.max())


def close_grad(name, got, want):
    return close(name, got, want, TOL_GRAD_RTOL,
                 1e-5 * float(want.abs().max()))


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


def make_inputs(n, d, c, mode, seed, oor_label=False):
    """Row-normalised xn, column-normalised wn and ArcFace-like row scalars
    on the card, from a seeded generator."""
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
    return dict(xn=xn, wn=wn, labels=labels, t=t, tcos=tcos, scale=scale,
                ab=ab.contiguous(), g_lse=g_lse, g_t=g_t)


def check_case(x, mode, clamp_eps):
    """Each kernel against its plain version on inputs `x`; returns
    (max abs err per kernel, number of rows where `higher` differs)."""
    from face_recognition_models_tpu_torch.ops import fused_head as fh

    rows = (x["labels"], x["t"])
    out = fh.fused_ce_fwd(x["xn"], x["wn"], *rows, x["tcos"], x["scale"],
                          x["ab"], mode, clamp_eps)
    ref = fh.fused_margin_ce_plain(x["xn"], x["wn"], *rows, x["tcos"],
                                   x["scale"], x["ab"], mode, clamp_eps)
    errs = {"fused_ce_fwd": max(
        close("lse", out.lse, ref.lse, **TOL_STATS),
        close("target_logit", out.target_logit, ref.target_logit,
              **TOL_STATS))}
    flips = close_higher("higher", out.higher, ref.higher)
    args = (x["xn"], x["wn"], *rows, x["scale"], x["ab"], ref.lse,
            x["g_lse"])
    dx, dt, dscale = fh.fused_ce_bwd_dx(*args, x["g_t"], mode, clamp_eps)
    rdx, rdt, rdscale = fh.fused_ce_bwd_dx_plain(*args, x["g_t"], mode,
                                                 clamp_eps)
    errs["fused_ce_bwd_dx"] = max(close_grad("dx", dx, rdx),
                                  close_grad("dt", dt, rdt),
                                  close_grad("dscale", dscale, rdscale))
    dw = fh.fused_ce_bwd_dw(*args, mode, clamp_eps)
    errs["fused_ce_bwd_dw"] = close_grad(
        "dw", dw, fh.fused_ce_bwd_dw_plain(*args, mode, clamp_eps))
    return errs, flips


def library_head_ms(x):
    """The eager head as the yardstick: torch.matmul + the margin select +
    F.cross_entropy, forward and backward timed apart (CUDA events)."""
    import torch
    import torch.nn.functional as F

    xn = x["xn"].clone().requires_grad_(True)
    wn = x["wn"].clone().requires_grad_(True)
    labels = x["labels"].long()
    onehot = F.one_hot(labels, wn.shape[1]).bool()

    def forward():
        cos = torch.matmul(xn, wn)
        logits = x["scale"][:, None] * torch.where(onehot, x["t"][:, None],
                                                   cos)
        return F.cross_entropy(logits, labels)

    fwd_ms = cuda_ms(forward)
    for _ in range(3):
        forward().backward()
    torch.cuda.synchronize()
    total = 0.0
    iters = 20
    for _ in range(iters):
        loss = forward()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss.backward()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return fwd_ms, total / iters


def phase_kernels():
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    fh.reset_launch_counts()
    # small shapes: every mode, an out-of-range label, C not a tile multiple
    for mode, eps in ((fh.MODE_IDENTITY, None), (fh.MODE_MV, 1e-7),
                      (fh.MODE_CURRICULAR, 0.0)):
        errs, flips = check_case(make_inputs(24, 64, 100, mode, seed=mode,
                                             oor_label=True), mode, eps)
        emit({"phase": "kernels", "case": f"N24_D64_C100_mode{mode}",
              "max_abs_err": errs, "higher_flips": flips, "tolerance": TOLERANCE,
              "ok": True})
    # backward where the JAX package switches to its two-kernel form
    x = make_inputs(4096, D_MAIN, C_MAIN, fh.MODE_IDENTITY, seed=11)
    errs, flips = check_case(x, fh.MODE_IDENTITY, None)
    emit({"phase": "kernels", "case": "N4096_D512_C10575_identity",
          "max_abs_err": errs, "higher_flips": flips, "tolerance": TOLERANCE,
              "ok": True})
    del x
    # the training shape, with times
    x = make_inputs(N_MAIN, D_MAIN, C_MAIN, fh.MODE_IDENTITY, seed=7)
    errs, flips = check_case(x, fh.MODE_IDENTITY, None)
    m = fh.MODE_IDENTITY
    fwd_args = (x["xn"], x["wn"], x["labels"], x["t"], x["tcos"], x["scale"],
                x["ab"], m, None)
    lse = fh.fused_margin_ce_plain(*fwd_args).lse
    bwd = (x["xn"], x["wn"], x["labels"], x["t"], x["scale"], x["ab"], lse,
           x["g_lse"])
    ms = {
        "fused_ce_fwd": (cuda_ms(lambda: fh.fused_ce_fwd(*fwd_args)),
                         cuda_ms(lambda: fh.fused_margin_ce_plain(*fwd_args))),
        "fused_ce_bwd_dx": (
            cuda_ms(lambda: fh.fused_ce_bwd_dx(*bwd, x["g_t"], m, None)),
            cuda_ms(lambda: fh.fused_ce_bwd_dx_plain(*bwd, x["g_t"], m,
                                                     None))),
        "fused_ce_bwd_dw": (
            cuda_ms(lambda: fh.fused_ce_bwd_dw(*bwd, m, None)),
            cuda_ms(lambda: fh.fused_ce_bwd_dw_plain(*bwd, m, None))),
    }
    lib_fwd, lib_bwd = library_head_ms(x)
    n, d, c = N_MAIN, D_MAIN, C_MAIN
    product = 2.0 * n * d * c
    # bytes each function must move: inputs read once, outputs written once
    row = 4 * n
    bytes_ = {"fused_ce_fwd": 4 * (n * d + d * c) + 7 * row + 3 * row,
              "fused_ce_bwd_dx": 4 * (n * d + d * c) + 9 * row
              + 4 * n * d + 2 * row,
              "fused_ce_bwd_dw": 4 * (n * d + d * c) + 8 * row + 4 * d * c}
    # operations: fwd one product; each backward kernel two (cos, then its
    # own gradient product)
    flops = {"fused_ce_fwd": product, "fused_ce_bwd_dx": 2 * product,
             "fused_ce_bwd_dw": 2 * product}
    library = {"fused_ce_fwd": lib_fwd, "fused_ce_bwd_dx": lib_bwd,
               "fused_ce_bwd_dw": lib_bwd}
    rows = []
    for name in ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dw"):
        t_ops = flops[name] / PEAK_FP32_FLOPS * 1e3
        t_bytes = bytes_[name] / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name]})
    emit({"phase": "kernels", "case": "N512_D512_C10575_identity",
          "max_abs_err": errs, "higher_flips": flips, "tolerance": TOLERANCE,
          "kernel_ms": {r["name"]: r["ms"] for r in rows},
          "plain_ms": {r["name"]: r["plain_ms"] for r in rows},
          "library_ms": {"head_fwd": lib_fwd, "head_bwd": lib_bwd},
          "bound_ms": {r["name"]: r["bound_ms"] for r in rows}, "ok": True})
    torch.cuda.empty_cache()
    return rows


def phase_train():
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.step import (
        make_eval_step, make_train_step)

    bs, size = 512, 112
    cfg = cfg_lib.TrainConfig(num_classes=C_MAIN, batch_size=bs, epochs=1,
                              print_freq=1, seed=0)
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (TRAIN_STEPS * bs, size, size, 3), np.uint8)
    labels = rs.randint(0, C_MAIN, TRAIN_STEPS * bs).astype(np.int32)
    loader = ArrayLoader(images, labels, batch_size=bs, seed=0)

    torch.cuda.reset_peak_memory_stats()
    fh.reset_launch_counts()
    res = fit(cfg, loader, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if len(res.losses) != TRAIN_STEPS:
        raise AssertionError(f"{len(res.losses)} steps run")
    for name, count in launches.items():
        if count != TRAIN_STEPS:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{TRAIN_STEPS} steps")
    # print_freq=1 reads the loss every step, so each step time includes
    # the wait for the card; step 1 carries cuDNN's first-call set-up
    ms_step = 1e3 * float(np.mean(res.step_seconds[1:]))
    emit({"phase": "train", "backbone": "resnet18", "head": "arcface",
          "num_classes": C_MAIN, "batch": bs, "image_size": size,
          "dtype": cfg.compute_dtype, "losses": res.losses,
          "step_ms": [1e3 * s for s in res.step_seconds],
          "ms_per_step_after_1": ms_step, "img_per_s_after_1": bs / ms_step
          * 1e3, "max_memory_allocated": peak, "launches": launches,
          "ok": True})

    # one step from the same state through the kernels and the eager head
    state, head_cfg = res.state, res.head_cfg
    saved = (copy.deepcopy(state.backbone.state_dict()),
             state.kernel_w.detach().clone(),
             copy.deepcopy(state.optimizer.state_dict()), state.step)
    batch = (images[:bs], labels[:bs])
    head = get_head("arcface")
    out = {}
    for path, fused in (("kernel", True), ("eager", False)):
        state.backbone.load_state_dict(saved[0])
        with torch.no_grad():
            state.kernel_w.copy_(saved[1])
        state.optimizer.load_state_dict(copy.deepcopy(saved[2]))
        state.step = saved[3]
        step = make_train_step(head, head_cfg, use_fused_head=fused,
                               device="cuda")
        _, metrics = step(state, *batch)
        out[path] = (float(metrics["loss"]), state.kernel_w.detach().clone())
    loss_err = abs(out["kernel"][0] - out["eager"][0])
    # same backbone, same batch: the heads differ only in fp32 summation
    # order, and kernel_w moves by lr * grad, so the updated weights agree
    # far inside 1e-6 of values ~2e-2
    if loss_err > 1e-4 * abs(out["eager"][0]):
        raise AssertionError(f"loss kernel {out['kernel'][0]} vs eager "
                             f"{out['eager'][0]}")
    w_err = close("kernel_w", out["kernel"][1], out["eager"][1], 1e-5, 1e-6)
    emb = make_eval_step(state.backbone, device="cuda")(images[:2])
    if emb.shape != (2, head_cfg.feature_dim) or not bool(
            torch.isfinite(emb).all()):
        raise AssertionError(f"embeddings {tuple(emb.shape)} not finite")
    emit({"phase": "train_vs_eager", "loss_kernel": out["kernel"][0],
          "loss_eager": out["eager"][0], "loss_abs_err": loss_err,
          "kernel_w_max_abs_err": w_err, "embed_shape": list(emb.shape),
          "ok": True})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from face_recognition_models_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in reports.items()}})

    rows = phase_kernels()
    launches = phase_train()
    for r in rows:
        r["launches"] = launches[r["name"]]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
