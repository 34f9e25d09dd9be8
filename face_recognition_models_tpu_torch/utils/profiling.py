"""Where a train step's device time goes, from a torch.profiler trace.

    python -m face_recognition_models_tpu_torch.utils.profiling [--head NAME]
        [--bn-dtype bfloat16] [--scan-steps K] [--bn-casts]

Runs the default recipe (resnet18 + fused ArcFace, or the head named on the
path `train --head-path auto` gives it, C=10,575, batch 512, 112 px, bf16
convs, fp32 or bf16 BatchNorm) on the card: 3 warm-up steps, then 24
profiled steps; QAFace's steps get the degraded view `fit` gives them, and
each batch goes to the card through `fit`'s pinned staging. With
`--scan-steps K` the steps run as `fit` runs them under `scan_steps`: K
steps per replay of a CUDA graph (train/graphed.py), 3 warm-up chunks (the
first captures) and ceil(24 / K) profiled ones. The window starts with
nothing queued on the card, so its first batch (chunk) costs the card the
host's time to stage it; 24 steps keep that share small. Prints one JSON line: host
ms/step over the profiled steps, device kernel ms/step by category, the
device's idle share (1 - kernel time / wall time; kernels of one stream do
not overlap), the host-to-device copies' device ms/step and the top kernels
by device time.

`--bn-casts` prints instead the host time, from the profiler's CPU time, of
the dtype casts of BatchNorm's forward (models/resnet.py) over the calls one
train step makes: the cast of its input to float32, and the `x.float()` and
`.to(self.dtype)` calls that, with bn_dtype float32, copy nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.heads.fused_adapter import use_fused
from face_recognition_models_tpu_torch.models.resnet import BatchNorm
from face_recognition_models_tpu_torch.train.graphed import (
    ChunkRunner,
    make_chunk_fn,
)
from face_recognition_models_tpu_torch.train.loop import (
    HostStaging,
    degrade_images,
)
from face_recognition_models_tpu_torch.train.state import create_train_state
from face_recognition_models_tpu_torch.train.step import make_train_step
from face_recognition_models_tpu_torch.utils.device import resolve_device

# kernel-name fragments -> category, first match wins
_CATEGORIES = (
    ("fused_ce", "head_kernels"),
    ("batchnorm", "batch_norm"), ("batch_norm", "batch_norm"),
    ("welford", "bn_running_stats"),
    ("conv", "conv"), ("xmma", "conv"), ("implicit", "conv"),
    ("cudnn", "conv"), ("wgrad", "conv"), ("dgrad", "conv"),
    ("multi_tensor", "optimizer"), ("foreach", "optimizer"),
    ("gemm", "gemm"), ("max_pool", "pool"), ("memcpy", "memcpy"),
    ("elementwise", "elementwise"), ("reduce_kernel", "reduce"),
)


def _category(name: str) -> str:
    low = name.lower()
    for frag, cat in _CATEGORIES:
        if frag in low:
            return cat
    return "other"


def _recipe(cfg: cfg_lib.TrainConfig, device):
    """(head, state, train step, one seeded uint8 batch) of `cfg`."""
    head_cfg = cfg_lib.make_head_config(cfg.head, num_classes=cfg.num_classes)
    _, head, state = create_train_state(cfg, head_cfg, device)
    train_step = make_train_step(head, head_cfg,
                                 use_fused_head=cfg.use_fused_head,
                                 device=device)
    rs = np.random.RandomState(cfg.seed)
    size = cfg.data.image_size
    images = rs.randint(0, 256, (cfg.batch_size, size, size, 3), np.uint8)
    labels = rs.randint(0, cfg.num_classes, cfg.batch_size).astype(np.int32)
    return head, state, train_step, images, labels


def profile_train_step(cfg: cfg_lib.TrainConfig, device=None,
                       warmup: int = 3, steps: int = 24) -> dict:
    device = resolve_device(device)
    head, state, train_step, images, labels = _recipe(cfg, device)
    k = max(1, cfg.scan_steps)
    stage = HostStaging(device, buffers=2 * k)
    runner = None
    if k > 1:
        # as `fit` runs a chunk: K batches staged into the graph's slots,
        # then one replay
        runner = ChunkRunner(make_chunk_fn(train_step, head.requires_minput),
                             k, device)

        def run():
            runner.fill(stage, [(images, labels)] * k)
            runner.run(state)
    else:
        def run():
            # as `fit` runs it: the batch staged to the device, then the step
            staged, lb = stage(images, labels)
            if head.requires_minput:
                train_step(state, staged, lb, degrade_images(staged))
            else:
                train_step(state, staged, lb)

    calls = -(-steps // k)
    for _ in range(warmup):
        run()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"head": cfg.head, "use_fused_head": cfg.use_fused_head,
           "bn_dtype": cfg.bn_dtype, "scan_steps": k,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           **summarize(prof, calls * k, wall_ms)}
    if runner is not None:
        out["capture_seconds"] = runner.capture_seconds
        runner.close(state)
    return out


def bn_cast_host_us(cfg: cfg_lib.TrainConfig, device=None,
                    repeats: int = 50) -> dict:
    """Host microseconds a train step spends in BatchNorm's casts, by the
    profiler's CPU time of their aten::to calls: each BatchNorm input of one
    train-mode forward (as the step gives it; QAFace's degraded view
    doubles the calls) goes through the forward's three casts `repeats`
    times."""
    device = resolve_device(device)
    head, state, _, images, _ = _recipe(cfg, device)
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: inputs.append(
        (mod, a[0].detach()))) for m in state.backbone.modules()
        if isinstance(m, BatchNorm)]
    x = torch.as_tensor(images).to(device).float()
    with torch.no_grad():
        state.backbone.train()
        state.backbone(x)
    for h in hooks:
        h.remove()
    views = 2 if head.requires_minput else 1
    casts = [(mod, xin, xin.to(torch.float32)) for mod, xin in inputs]

    def cpu_us(fn) -> float:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(repeats):
                for mod, xin, x32 in casts:
                    fn(mod, xin, x32)
        return sum(ev.cpu_time_total for ev in prof.key_averages()
                   if ev.key == "aten::to") / repeats * views

    return {"bn_dtype": cfg.bn_dtype, "batchnorm_calls_per_step":
            len(casts) * views,
            "input_dtypes": sorted({str(xin.dtype) for _, xin, _ in casts}),
            # the cast of the input (a copy when it is bf16)
            "to_float32_us_per_step": cpu_us(
                lambda mod, xin, x32: xin.to(torch.float32)),
            # the statistics' x.float() and the output's .to(self.dtype),
            # on the float32 input and output the fp32 BatchNorm has
            "float_us_per_step": cpu_us(lambda mod, xin, x32: x32.float()),
            "to_dtype_us_per_step": cpu_us(
                lambda mod, xin, x32: x32.to(mod.dtype)),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def summarize(prof, steps: int, wall_ms: float) -> dict:
    """Per-step device times of a torch.profiler run of `steps` steps that
    took `wall_ms` on the host clock: kernel ms by category, their sum, the
    idle share, the host-to-device copies' ms and the top kernels."""
    by_cat, kernels, h2d_ms = {}, [], 0.0
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels'
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_ms = ev.self_device_time_total / 1e3 / steps
        kernels.append((dev_ms, ev.key))
        if "htod" in ev.key.lower():
            h2d_ms += dev_ms
        cat = _category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_ms
    busy = sum(by_cat.values())
    kernels.sort(reverse=True)
    return {"steps": steps, "ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy, "by_category_ms": by_cat,
            "idle_share": 1.0 - busy / (wall_ms / steps),
            "host_to_device_ms_per_step": h2d_ms,
            "top_kernels": [{"ms": ms, "name": name[:120]}
                            for ms, name in kernels[:15]]}

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", default="arcface",
                        choices=sorted(cfg_lib.HEAD_CONFIGS))
    parser.add_argument("--bn-dtype", choices=["float32", "bfloat16"],
                        default="float32")
    parser.add_argument("--scan-steps", type=int, default=1)
    parser.add_argument("--bn-casts", action="store_true")
    args = parser.parse_args()
    cfg = cfg_lib.TrainConfig(head=args.head, bn_dtype=args.bn_dtype,
                              use_fused_head=use_fused(args.head),
                              scan_steps=args.scan_steps)
    fn = bn_cast_host_us if args.bn_casts else profile_train_step
    print(json.dumps(fn(cfg)))
