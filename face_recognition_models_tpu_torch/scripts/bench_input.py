"""Host cost of the training input on the card: the same seeded batches
through `fit` from a pack (`PackedLoader`) and from memory (`ArrayLoader`),
in turns.

    python -m face_recognition_models_tpu_torch.scripts.bench_input \
        [--pairs 5] [--steps 20] [--batch 512]

Writes `steps` seeded uint8 batches (the ArcFace recipe: resnet18,
C=10,575, 112 px) into a pack in a temporary directory with
`pack_from_loader`, then runs `fit` for one epoch from the pack and from
the arrays in turns (pack, arrays, arrays, pack, ...), the loss read only at
the epoch's end, so the host runs ahead of the card as in a real run. Every
run starts from the same seeded state, so all runs' losses must be bitwise
equal. Prints one JSON line: each run's img/s and host ms/step after step
1, their medians and quartiles per loader, and nvidia-smi's name and power
limit. `--device cpu --batch 4 --image-size 16 --num-classes 4` runs the
path here.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.data.packed import (
    PackedDataset,
    PackedLoader,
    pack_from_loader,
)
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.train.loop import fit
from face_recognition_models_tpu_torch.utils.device import (
    nvidia_smi,
    resolve_device,
)


class _OnePass(ArrayLoader):
    """The arrays' unshuffled full pass, with the two fields
    `pack_from_loader` reads."""

    def __init__(self, images, labels, batch_size):
        super().__init__(images, labels, batch_size, shuffle=False,
                         drop_remainder=False)
        self.dataset = images
        self.skipped_images = 0


def _quartiles(values):
    q1, q2, q3 = np.percentile(values, [25, 50, 75])
    return {"median": float(q2), "q1": float(q1), "q3": float(q3)}


def bench(pairs: int = 5, steps: int = 20, batch: int = 512,
          image_size: int = 112, num_classes: int = cfg_lib.CASIA_NUM_CLASSES,
          seed: int = 0, device=None) -> dict:
    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (steps * batch, image_size, image_size, 3),
                        np.uint8)
    labels = rs.randint(0, num_classes, steps * batch).astype(np.int32)
    cfg = cfg_lib.TrainConfig(num_classes=num_classes, batch_size=batch,
                              epochs=1, print_freq=10 ** 9, seed=seed,
                              data=cfg_lib.DataConfig(image_size=image_size))
    runs = {"packed": [], "array": []}
    losses = []
    with tempfile.TemporaryDirectory() as root:
        pack_from_loader(_OnePass(images, labels, batch),
                         [str(c) for c in range(num_classes)], root,
                         image_size)
        packed = PackedDataset.open(root)
        loaders = {"packed": lambda: PackedLoader(packed, batch, seed=seed),
                   "array": lambda: ArrayLoader(images, labels, batch,
                                                seed=seed)}
        order = []
        for i in range(pairs):
            order += (["packed", "array"] if i % 2 == 0
                      else ["array", "packed"])
        for name in order:
            res = fit(cfg, loaders[name](), device=device)
            runs[name].append({
                "img_per_s": res.images_per_sec,
                "host_ms_per_step_after_1":
                    1e3 * float(np.mean(res.step_seconds[1:]))})
            losses.append(res.losses)
            del res
    if any(run != losses[0] for run in losses):
        raise AssertionError("bench_input: the runs' losses differ")
    summary = {name: {key: _quartiles([r[key] for r in rs_])
                      for key in ("img_per_s", "host_ms_per_step_after_1")}
               for name, rs_ in runs.items()}
    return {"device": device.type,
            "nvidia_smi": nvidia_smi() if device.type == "cuda" else None,
            "pairs": pairs, "steps": steps, "batch": batch,
            "image_size": image_size, "num_classes": num_classes,
            "order": order, "runs": runs, "summary": summary,
            "losses_bitwise_equal": True}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=5)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--num-classes", type=int,
                   default=cfg_lib.CASIA_NUM_CLASSES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    a = p.parse_args(argv)
    print(json.dumps(bench(a.pairs, a.steps, a.batch, a.image_size,
                           a.num_classes, a.seed, a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
