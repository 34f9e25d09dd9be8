"""Eager against graphed train steps on the card: the ArcFace recipe's `fit`
with `scan_steps` 1 (one step at a time) and K (one CUDA graph of K steps
per replay, train/graphed.py), in turns in one process.

    python -m face_recognition_models_tpu_torch.scripts.bench_steps \
        [--pairs 3] [--scan 4,8] [--steps 64] [--batch 512]

Every run is one epoch of `steps` seeded uint8 batches (resnet18,
C=10,575, 112 px, bf16 convs, fp32 BatchNorm and head, SGD lr 0.1) from the
same seeded state. The runs go in turns, eager then each K, then the
reverse, `pairs` times: host ms/step moves by 10-30 ms between calls on the
card, so only runs of one process can rank the paths. `fit` reads the loss
once after the first chunk (its print) and at the epoch's end, so the host
runs ahead of the card as in a real run. After that read the card waits
while the host stages the next chunk (K loader batches): a cost a run pays
at every read (each `print_freq` step), which the ms/step below includes
once.

Per run: ms/step after the first chunk (the first step for the eager run),
from the wall time of the run less that of its first chunk, both ending in
a wait for the card; img/s over the whole run and after the first chunk;
peak device memory (`torch.cuda.max_memory_allocated`, and
`max_memory_reserved`, which holds the graph's private pool too); the
graph's warm-up and capture seconds. The runs of one path must have bitwise equal losses
(every run starts from the same state). Prints one JSON line with each
run, the medians and quartiles per path, and nvidia-smi's name and power
limit. `--device cpu --batch 4 --image-size 16 --num-classes 4` runs the
path here (the K steps as a plain loop, no graph).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.train.loop import fit
from face_recognition_models_tpu_torch.utils.device import (
    nvidia_smi,
    resolve_device,
)


def _quartiles(values):
    q1, q2, q3 = np.percentile(values, [25, 50, 75])
    return {"median": float(q2), "q1": float(q1), "q3": float(q3)}


def run_once(cfg: cfg_lib.TrainConfig, images, labels, device) -> dict:
    """One `fit` of cfg over the arrays; its timings, memory and losses."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    res = fit(cfg, ArrayLoader(images, labels, cfg.batch_size,
                               seed=cfg.seed), device=device)
    steps = len(res.losses)
    k = cfg.scan_steps
    wall = steps * cfg.batch_size / res.images_per_sec
    after = wall - sum(res.step_seconds[:k])
    out = {"scan_steps": k, "steps": steps,
           "ms_per_step_after_first_chunk": 1e3 * after / (steps - k),
           "img_per_s": res.images_per_sec,
           "img_per_s_after_first_chunk":
               (steps - k) * cfg.batch_size / after,
           "first_chunk_s": sum(res.step_seconds[:k]),
           "capture_seconds": res.capture_seconds,
           "replays": res.replays,
           "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                       if cuda else None),
           # the graph's private pool is reserved beside the eager steps'
           "peak_reserved_gb": (torch.cuda.max_memory_reserved(device) / 1e9
                                if cuda else None),
           "losses": res.losses}
    return out


def bench(pairs: int = 3, scans=(4, 8), steps: int = 64, batch: int = 512,
          image_size: int = 112,
          num_classes: int = cfg_lib.CASIA_NUM_CLASSES, seed: int = 0,
          device=None) -> dict:
    device = resolve_device(device)
    if any(steps <= k for k in scans):
        raise ValueError(f"--steps {steps} must exceed every K in {scans}")
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (steps * batch, image_size, image_size, 3),
                        np.uint8)
    labels = rs.randint(0, num_classes, steps * batch).astype(np.int32)
    paths = (1, *scans)
    order = []
    for i in range(pairs):
        order += list(paths if i % 2 == 0 else reversed(paths))
    runs = {k: [] for k in paths}
    for k in order:
        # print_freq: only the first chunk prints (and waits for the card)
        cfg = cfg_lib.TrainConfig(num_classes=num_classes, batch_size=batch,
                                  epochs=1, print_freq=10 ** 9, seed=seed,
                                  scan_steps=k,
                                  data=cfg_lib.DataConfig(
                                      image_size=image_size))
        runs[k].append(run_once(cfg, images, labels, device))
    for k, rs_ in runs.items():
        if any(r["losses"] != rs_[0]["losses"] for r in rs_):
            raise AssertionError(f"bench_steps: the scan_steps={k} runs' "
                                 "losses differ")
    keys = ("ms_per_step_after_first_chunk", "img_per_s",
            "img_per_s_after_first_chunk", "peak_gb", "peak_reserved_gb",
            "capture_seconds")
    summary = {str(k): {key: _quartiles([r[key] for r in rs_])
                        for key in keys if rs_[0][key] is not None}
               for k, rs_ in runs.items()}
    return {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "nvidia_smi": nvidia_smi() if device.type == "cuda" else None,
            "pairs": pairs, "steps": steps, "batch": batch,
            "image_size": image_size, "num_classes": num_classes,
            "order": order,
            "runs": {str(k): [{key: v for key, v in r.items()
                               if key != "losses"} for r in rs_]
                     for k, rs_ in runs.items()},
            "losses": {str(k): rs_[0]["losses"] for k, rs_ in runs.items()},
            "summary": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--scan", default="4,8",
                   help="comma-separated K values of the graphed runs")
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--num-classes", type=int,
                   default=cfg_lib.CASIA_NUM_CLASSES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    a = p.parse_args(argv)
    scans = tuple(int(k) for k in a.scan.split(",") if k)
    print(json.dumps(bench(a.pairs, scans, a.steps, a.batch, a.image_size,
                           a.num_classes, a.seed, a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
