"""FaceNet triplet-path convergence on the synthetic protocol: the triplet
path's trained accuracy.

Port of the repo's root scripts/facenet_convergence.py, with the same flags
and the same JSON line (`--device` in place of `--platform`). Same identity
split and held-out 10-fold Youden verification as
`scripts/convergence_run.py`, but trained through the triplet pipeline:
PK-sampled batches -> semi-hard mining -> triplet loss (`triplet/train.py`).

    python -m face_recognition_models_tpu_torch.scripts.facenet_convergence \\
        [--classes 500] [--epochs 15] [--device cpu]

Defaults: resnet18, 128-d, P 16 x K 4, margin 0.2, lr 0.05, 15 epochs on
500 identities x (16 train + 4 held-out) copies at 112 px, noise 35; on the
card unless `--device cpu`. Prints one JSON line with the verification
result and throughput.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def verify(module, held_x, held_y, classes, eval_per_class, pairs_per_kind,
           seed, device=None):
    """Held-out 10-fold Youden verification of a trained trunk, as it is
    (its dtype, eval mode with its running BatchNorm statistics)."""
    from face_recognition_models_tpu_torch.evaluation.batch_eval import (
        make_embed_fn)
    from face_recognition_models_tpu_torch.evaluation.verification import (
        embed_unique_images,
        kfold_verification,
    )
    from face_recognition_models_tpu_torch.scripts.convergence_run import (
        _heldout_pairs)

    embed = make_embed_fn(module, device=device)
    emb = embed_unique_images(embed, held_x, batch_size=256)
    pairs = _heldout_pairs(held_y, classes, eval_per_class, pairs_per_kind,
                           seed)
    sims = np.sum(emb[pairs[:, 0]] * emb[pairs[:, 1]], axis=1)
    return kfold_verification(sims, pairs[:, 2])


def run(args):
    """Train and verify; print the JSON line. Returns (the
    TripletFitResult, the line's dict)."""
    from face_recognition_models_tpu_torch.config import FaceNetConfig
    from face_recognition_models_tpu_torch.scripts.convergence_run import (
        build_split)
    from face_recognition_models_tpu_torch.triplet import train_facenet

    train_x, train_y, held_x, held_y = build_split(
        args.classes, args.train_per_class, args.eval_per_class,
        args.image_size, args.seed, args.noise)

    cfg = FaceNetConfig(backbone=args.backbone, embed_dim=args.embed_dim,
                        p=args.p, k=args.k, margin=args.margin,
                        learning_rate=args.lr)
    t0 = time.time()
    result = train_facenet(cfg, train_x, train_y, epochs=args.epochs,
                           image_size=args.image_size, seed=args.seed,
                           verbose=True, checkpoint_dir=args.checkpoint_dir,
                           device=args.device)
    train_s = time.time() - t0

    res = verify(result.model, held_x, held_y, args.classes,
                 args.eval_per_class, args.pairs_per_kind, args.seed,
                 device=args.device)
    line = {
        "metric": "facenet_synthetic_verification",
        "backbone": args.backbone, "embed_dim": args.embed_dim,
        "classes": args.classes, "p": args.p, "k": args.k,
        "margin": args.margin, "epochs": args.epochs, "lr": args.lr,
        "mean_accuracy": round(res.mean_accuracy, 3),
        "std_accuracy": round(res.std_accuracy, 3),
        "mean_auc": round(res.mean_auc, 5),
        "final_loss": round(float(np.mean(result.losses[-10:])), 4),
        "images_per_sec": round(result.images_per_sec, 1),
        "train_seconds": round(train_s, 1),
    }
    print(json.dumps(line), flush=True)
    return result, line


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--classes", type=int, default=500)
    ap.add_argument("--train-per-class", type=int, default=16)
    ap.add_argument("--eval-per-class", type=int, default=4)
    ap.add_argument("--noise", type=float, default=35.0)
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--backbone", default="resnet18")
    ap.add_argument("--embed-dim", type=int, default=128)
    ap.add_argument("--p", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--margin", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--pairs-per-kind", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a dry run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    return ap


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
