"""The headline workload: ResNet-50 embedding extraction, as bench.py runs
it for the JAX package, on the card.

    python -m face_recognition_models_tpu_torch.scripts.bench_embed \\
        [--backbone resnet50] [--batch 512] [--bn-dtype bfloat16] \\
        [--profile] [--device cpu]

ResNet-50 with random weights from `--seed`, batch 512, 112 px, bf16
convolutions, BatchNorm output in bf16 (`bn_dtype`), eval mode: the port's
eval step (normalise on the device, backbone with running statistics, fp32
embeddings) over ITERS = 20 distinct seeded uint8 batches made and held on
the card (385 MB at b512). On the card the 20 steps are captured once as a
CUDA graph, each adding the sum of its embeddings to an accumulator so that
every step's output is used; after one warm-up replay, CUDA events time
REPLAYS back-to-back replays, so the host's launches do not set the pace.
Prints one JSON line: `metric` (<backbone>_embedding_images_per_sec),
`value`, `unit`, ms per batch, and the card's name and power limit
(`nvidia_smi`). `--profile` adds a second line: one eager step's device
time by category from torch.profiler. With `--device cpu` the steps run
eagerly and the host clock times them (a test of the path, not a speed).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import torch

from face_recognition_models_tpu_torch.models import get_backbone
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.models.resnet import init_weights
from face_recognition_models_tpu_torch.train.step import make_eval_step
from face_recognition_models_tpu_torch.utils.device import (nvidia_smi,
                                                            resolve_device)

ITERS = 20
REPLAYS = 5

# aten op-name fragments -> category, first match wins; device time is
# each op's own kernels (self time), so a cast inside a conv counts as a cast
_OP_CATEGORIES = (
    ("convolution", "conv"), ("batch_norm", "batch_norm"),
    ("copy", "casts"), ("max_pool", "pool"), ("mean", "pool"),
    ("addmm", "fc"), ("mm", "fc"), ("linear", "fc"),
    ("relu", "relu_add"), ("clamp", "relu_add"), ("add", "relu_add"),
    ("mul", "normalize"),
    ("sum", "accumulate"),
)


def build_model(backbone: str = "resnet50", bn_dtype: str = "bfloat16",
                seed: int = 0, device=None) -> torch.nn.Module:
    """The benchmark's backbone on `device`: bf16 convolutions, BatchNorm
    output in `bn_dtype`, weights from `seed` (the same for any bn_dtype)."""
    model = get_backbone(backbone, dtype=torch.bfloat16,
                         bn_dtype=getattr(torch, bn_dtype))
    init_weights(model, torch.Generator().manual_seed(seed))
    return to_device(model, resolve_device(device))


def make_batches(iters: int, batch: int, image_size: int, seed: int,
                 device) -> torch.Tensor:
    """[iters, batch, H, W, 3] uint8 images drawn on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (iters, batch, image_size, image_size, 3),
                         generator=g, dtype=torch.uint8, device=device)


def bench(backbone: str = "resnet50", batch: int = 512,
          image_size: int = 112, bn_dtype: str = "bfloat16",
          iters: int = ITERS, replays: int = REPLAYS, seed: int = 0,
          device=None) -> dict:
    """Embedding throughput of `backbone`; returns the JSON line's fields."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    step = make_eval_step(build_model(backbone, bn_dtype, seed, dev),
                          device=dev)
    batches = make_batches(iters, batch, image_size, seed, dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)

    def run():
        for i in range(iters):
            acc.add_(step(batches[i]).sum())

    if cuda:
        # first calls (cuDNN's algorithm choice) on a side stream, as
        # graph capture asks, then capture the 20 steps once
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        graph.replay()  # warm-up pass
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        run()  # warm-up pass
        t0 = time.perf_counter()
        for _ in range(replays):
            run()
        seconds = time.perf_counter() - t0
    total = float(acc)
    if total != total or abs(total) == float("inf"):
        raise RuntimeError(f"embedding benchmark: non-finite sum {total}")
    images = batch * iters * replays
    return {"metric": f"{backbone}_embedding_images_per_sec",
            "value": images / seconds, "unit": "images/sec",
            "ms_per_batch": 1e3 * seconds / (iters * replays),
            "backbone": backbone, "batch": batch, "image_size": image_size,
            "bn_dtype": bn_dtype, "iters": iters, "replays": replays,
            "timing": "cuda_graph_events" if cuda else "host_clock",
            "device": dev.type,
            "name": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "nvidia_smi": nvidia_smi() if cuda else None}


def _op_category(name: str) -> str:
    low = name.lower()
    for frag, cat in _OP_CATEGORIES:
        if frag in low:
            return cat
    return "other"


def device_split(step: Callable, images: torch.Tensor) -> Dict[str, float]:
    """{category: device ms} of one eager `step(images)` on the card, by
    the aten op that launched each kernel (torch.profiler self device
    time), with 'total'. On the CPU every category reads 0."""
    sync = torch.cuda.synchronize if images.is_cuda else (lambda: None)
    step(images)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if images.is_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        step(images)
        sync()
    out: Dict[str, float] = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type == torch.autograd.DeviceType.CPU and us > 0:
            cat = _op_category(ev.key)
            out[cat] = out.get(cat, 0.0) + us / 1e3
    out["total"] = sum(out.values())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backbone", default="resnet50",
                    choices=["resnet18", "resnet50"])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--bn-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--replays", type=int, default=REPLAYS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print one eager step's device ms by category")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' tests the path")
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.backbone, args.batch, args.image_size,
                           args.bn_dtype, args.iters, args.replays,
                           args.seed, args.device)), flush=True)
    if args.profile:
        dev = resolve_device(args.device)
        step = make_eval_step(build_model(args.backbone, args.bn_dtype,
                                          args.seed, dev), device=dev)
        images = make_batches(1, args.batch, args.image_size, args.seed,
                              dev)[0]
        print(json.dumps({"device_ms_by_category":
                          device_split(step, images)}), flush=True)


if __name__ == "__main__":
    main()
