"""Command line of the port. Port of the `train` subcommand of
face_recognition_models_tpu/cli/main.py; flag names and defaults follow it.

    python -m face_recognition_models_tpu_torch.cli train --synthetic \
        [--device cpu] ...

Runs on the card unless `--device cpu` is given, and fails without one.
"""

from __future__ import annotations

import argparse
import sys
import time

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.heads import available_heads
from face_recognition_models_tpu_torch.models import BACKBONES


def _add_train_parser(sub):
    p = sub.add_parser("train", help="train a margin-head model")
    p.add_argument("--head", default="arcface", choices=available_heads())
    p.add_argument("--backbone", "-bb", default="resnet18",
                   choices=sorted(BACKBONES))
    p.add_argument("--batch_size", "-bs", type=int, default=512)
    p.add_argument("--epochs", "-e", type=int, default=30)
    p.add_argument("--learning_rate", "-lr", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--lr-steps", default="20,40,60",
                   help="customstep drop epochs")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--head-path", choices=["fused", "eager"], default="fused",
                   help="fused: the CUDA margin + CE kernels; eager: the "
                        "[N, C] PyTorch head")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="train on a synthetic identity set (smoke runs)")
    p.add_argument("--synthetic-classes", type=int, default=64)
    p.add_argument("--synthetic-per-class", type=int, default=32)
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    return p


def cmd_train(args) -> int:
    if not args.synthetic:
        print("error: only --synthetic data is ported so far",
              file=sys.stderr)
        return 2
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)
    from face_recognition_models_tpu_torch.train.loop import fit

    cfg = cfg_lib.TrainConfig(
        backbone=args.backbone, head=args.head,
        num_classes=args.synthetic_classes, batch_size=args.batch_size,
        epochs=args.epochs, print_freq=args.print_freq,
        seed=args.seed,
        use_fused_head=args.head_path == "fused",
        optimizer=cfg_lib.OptimizerConfig(
            learning_rate=args.learning_rate, momentum=args.momentum,
            weight_decay=args.weight_decay),
        schedule=cfg_lib.ScheduleConfig(
            steps=tuple(int(s) for s in args.lr_steps.split(",") if s)),
        data=cfg_lib.DataConfig(image_size=args.image_size))
    images, labels = synthetic_identities(
        args.synthetic_classes, args.synthetic_per_class,
        image_size=args.image_size, seed=cfg.seed)
    loader = ArrayLoader(images, labels, batch_size=cfg.batch_size,
                         seed=cfg.seed)
    print(f"Training {cfg.head} ({cfg.backbone}) - batch {cfg.batch_size}, "
          f"epochs {cfg.epochs}, lr {args.learning_rate}")
    t0 = time.time()
    result = fit(cfg, loader, device=args.device)
    print(f"Done in {time.time() - t0:.0f}s - min train loss "
          f"{result.min_train_loss:.6f}, {result.images_per_sec:.0f} img/s")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m face_recognition_models_tpu_torch.cli",
        description="PyTorch/CUDA face-recognition training")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train_parser(sub)
    args = parser.parse_args(argv)
    if args.command == "train":
        return cmd_train(args)
    parser.error(f"unknown command {args.command}")
    return 2
