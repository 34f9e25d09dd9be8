"""Where a train step's device time goes, from a torch.profiler trace.

    python -m face_recognition_models_tpu_torch.utils.profiling [--head NAME]
        [--bn-dtype bfloat16]

Runs the default recipe (resnet18 + fused ArcFace, or the head named on the
path `train --head-path auto` gives it, C=10,575, batch 512, 112 px, bf16
convs, fp32 or bf16 BatchNorm) on the card: 3 warm-up steps, then 5
profiled steps; QAFace's steps get the degraded view `fit` gives them, and
each batch goes to the card through `fit`'s pinned staging. Prints one JSON
line: host ms/step over the profiled steps, device kernel ms/step by
category, the device's idle share (1 - kernel time / wall time; kernels of
one stream do not overlap), the host-to-device copies' device ms/step and
the top kernels by device time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.heads.fused_adapter import use_fused
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


def profile_train_step(cfg: cfg_lib.TrainConfig, device=None,
                       warmup: int = 3, steps: int = 5) -> dict:
    device = resolve_device(device)
    head_cfg = cfg_lib.make_head_config(cfg.head, num_classes=cfg.num_classes)
    _, head, state = create_train_state(cfg, head_cfg, device)
    train_step = make_train_step(head, head_cfg,
                                 use_fused_head=cfg.use_fused_head,
                                 device=device)
    rs = np.random.RandomState(cfg.seed)
    size = cfg.data.image_size
    images = rs.randint(0, 256, (cfg.batch_size, size, size, 3), np.uint8)
    labels = rs.randint(0, cfg.num_classes, cfg.batch_size).astype(np.int32)

    stage = HostStaging(device)

    def step(state, images, labels):
        # as `fit` runs it: the batch staged to the device, then the step
        images, labels = stage(images, labels)
        if head.requires_minput:
            return train_step(state, images, labels, degrade_images(images))
        return train_step(state, images, labels)

    for _ in range(warmup):
        step(state, images, labels)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, images, labels)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"head": cfg.head, "use_fused_head": cfg.use_fused_head,
            "bn_dtype": cfg.bn_dtype,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            **summarize(prof, steps, wall_ms)}


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
    args = parser.parse_args()
    print(json.dumps(profile_train_step(cfg_lib.TrainConfig(
        head=args.head, bn_dtype=args.bn_dtype,
        use_fused_head=use_fused(args.head)))))
