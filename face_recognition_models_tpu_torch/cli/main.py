"""Command line of the port. Port of the `train`, `eval`, `pack` and `list`
subcommands of face_recognition_models_tpu/cli/main.py; flag names and
defaults follow it.

    python -m face_recognition_models_tpu_torch.cli train \
        --dataset-path P | --synthetic [--head NAME] \
        [--head-path auto|fused|eager] [--lambda_g G] \
        [--pretrained STATE_DICT.pth] [--bn-dtype bfloat16] \
        [--scan-steps K] [--scheduler NAME] [--warmup-epochs E] \
        [--working-path W] [--continue_train latest] [--device cpu] ...
    python -m face_recognition_models_tpu_torch.cli pack \
        --dataset-path P --output DIR [--image-size 112] [--backend auto]
    python -m face_recognition_models_tpu_torch.cli eval \
        --checkpoint-dir W/checkpoints --eval-data-path E [--device cpu] ...
    python -m face_recognition_models_tpu_torch.cli list

`train --dataset-path` reads a pack (`pack`'s output, no decode), an
insightface RecordIO set (`train.rec` / `train.idx`: either path, their
prefix, or a dir holding `train.rec`) or an identity tree
(`P/CASIA-WebFace[/{train,valid}]/<id>/*.jpg`, or `P/<id>/*.jpg`). `train`
writes its checkpoints under <working>/checkpoints/<model> and tees its
output to <working>/log/<model>.txt; `eval` reads them. Both run on the card
unless `--device cpu` is given, and fail without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

from face_recognition_models_tpu_torch import config as cfg_lib
from face_recognition_models_tpu_torch.heads import available_heads
from face_recognition_models_tpu_torch.heads.fused_adapter import (
    HEAD_PATHS,
    use_fused,
)
from face_recognition_models_tpu_torch.models import BACKBONES


def _add_train_parser(sub):
    p = sub.add_parser("train", help="train a margin-head model")
    p.add_argument("--head", default="arcface",
                   choices=available_heads() + ["mv_softmax_arc"],
                   help="margin head (mv_softmax_arc = MV with arc margin)")
    p.add_argument("--head-arg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="head hyperparameter override, repeatable "
                        "(e.g. --head-arg delta=1 for qaface)")
    p.add_argument("--backbone", "-bb", default="resnet18",
                   choices=sorted(BACKBONES))
    p.add_argument("--batch_size", "-bs", type=int, default=512)
    p.add_argument("--epochs", "-e", type=int, default=30)
    p.add_argument("--learning_rate", "-lr", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--scheduler", default="customstep",
                   help="LR schedule (train/schedules.py: customstep, step, "
                        "multistep, cosine, exponential, warmup_cosine, "
                        "none)")
    p.add_argument("--lr-steps", default="20,40,60",
                   help="customstep drop epochs (reference schedulers.py:22)")
    p.add_argument("--warmup-epochs", type=int, default=5,
                   help="warmup length for --scheduler warmup_cosine")
    p.add_argument("--lambda_g", type=float, default=0.0,
                   help="Magnitude loss weight (MagFace)")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--continue_train", choices=["min_loss", "latest"],
                   help="resume from best or latest checkpoint")
    p.add_argument("--pretrained", default=None, metavar="STATE_DICT.pth",
                   help="torchvision backbone state_dict to initialize from "
                        "(the reference trains from ImageNet-pretrained "
                        "torchvision weights; resnet18/resnet50)")
    p.add_argument("--working-path", default=os.environ.get("WORKING_PATH",
                                                            "./working"))
    p.add_argument("--model-save-path", default=None,
                   help="checkpoint dir (default <working>/checkpoints/<name>)")
    p.add_argument("--head-path", choices=HEAD_PATHS, default="auto",
                   help="margin + CE implementation: 'fused' the CUDA "
                        "kernels (12 heads; refuses subcenter_arcface and "
                        "adacos), 'eager' the [N, C] PyTorch head, 'auto' "
                        "(default) the kernels for every head that has "
                        "them and the eager head for the other two")
    p.add_argument("--bn-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="BatchNorm output dtype (its statistics and math "
                        "stay fp32)")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="run K train steps per replay of one CUDA graph "
                        "(a plain loop of K steps on the CPU; amortizes "
                        "the host's per-step cost; 1 = off)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset-path", default=os.environ.get("DATASET_PATH", ""),
                   help="identity tree root, a `pack` dir, or an "
                        "insightface RecordIO set (train.rec/.idx: pass "
                        "the .rec/.idx path, their prefix, or a dir "
                        "holding train.rec)")
    p.add_argument("--num-classes", type=int,
                   default=cfg_lib.CASIA_NUM_CLASSES)
    p.add_argument("--num-workers", type=int, default=8,
                   help="decode threads of the tree and RecordIO loaders")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a synthetic identity set (smoke runs)")
    p.add_argument("--synthetic-classes", type=int, default=64)
    p.add_argument("--synthetic-per-class", type=int, default=32)
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    return p


class Tee:
    """A write-only stream that writes to several streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


class UsageError(Exception):
    """A refusal of the command line's arguments: printed, exit code 2."""


def _open_dataset(args, cfg):
    """(loader, cfg) for `train --dataset-path`. A pack's image size
    overrides --image-size; more identities than --num-classes raise
    UsageError."""
    from face_recognition_models_tpu_torch.data.index import index_tree
    from face_recognition_models_tpu_torch.data.packed import (
        PackedDataset, PackedLoader, is_packed_dir)
    from face_recognition_models_tpu_torch.data.pipeline import Loader
    from face_recognition_models_tpu_torch.data.recordio import (
        RecLoader, RecordIODataset, is_recordio)

    path = args.dataset_path
    if is_recordio(path):
        rec = RecordIODataset.open(path)
        if rec.num_identities > args.num_classes:
            raise UsageError(f"error: rec has {rec.num_identities} "
                             f"identities > --num-classes {args.num_classes}")
        return RecLoader(rec, batch_size=cfg.batch_size,
                         image_size=cfg.data.image_size,
                         num_workers=args.num_workers, seed=cfg.seed), cfg
    if is_packed_dir(path):
        # a pack from `pack`: no JPEG work on the host
        packed = PackedDataset.open(path)
        if packed.num_identities > args.num_classes:
            raise UsageError(f"error: pack has {packed.num_identities} "
                             f"identities > --num-classes {args.num_classes}")
        if packed.image_size != cfg.data.image_size:
            print(f"[pack] image size {packed.image_size} overrides "
                  f"--image-size {cfg.data.image_size}")
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, image_size=packed.image_size))
        return PackedLoader(packed, batch_size=cfg.batch_size,
                            seed=cfg.seed), cfg
    return Loader(index_tree(path), batch_size=cfg.batch_size,
                  image_size=cfg.data.image_size,
                  num_workers=args.num_workers, seed=cfg.seed), cfg


def cmd_train(args) -> int:
    if not args.synthetic and not args.dataset_path:
        print("error: --dataset-path required (or --synthetic)",
              file=sys.stderr)
        return 2
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)
    from face_recognition_models_tpu_torch.train.loop import fit

    head, head_kw = args.head, {}
    if head == "mv_softmax_arc":
        head, head_kw = "mv_softmax", {"margin_type": "arc"}
    model_name = args.head
    head_kw.update(cfg_lib.parse_head_overrides(head, args.head_arg))
    try:
        fused = use_fused(head, args.head_path)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = cfg_lib.TrainConfig(
        backbone=args.backbone, head=head,
        num_classes=(args.synthetic_classes if args.synthetic
                     else args.num_classes),
        batch_size=args.batch_size,
        epochs=args.epochs, lambda_g=args.lambda_g,
        print_freq=args.print_freq,
        seed=args.seed, working_path=args.working_path,
        continue_train=args.continue_train,
        pretrained_path=args.pretrained, bn_dtype=args.bn_dtype,
        use_fused_head=fused, scan_steps=args.scan_steps,
        optimizer=cfg_lib.OptimizerConfig(
            learning_rate=args.learning_rate, momentum=args.momentum,
            weight_decay=args.weight_decay),
        schedule=cfg_lib.ScheduleConfig(
            name=args.scheduler,
            steps=tuple(int(s) for s in args.lr_steps.split(",") if s),
            warmup_epochs=args.warmup_epochs),
        data=cfg_lib.DataConfig(image_size=args.image_size))
    head_cfg = cfg_lib.make_head_config(head, num_classes=cfg.num_classes,
                                        **head_kw)
    if args.synthetic:
        images, labels = synthetic_identities(
            args.synthetic_classes, args.synthetic_per_class,
            image_size=args.image_size, seed=cfg.seed)
        loader = ArrayLoader(images, labels, batch_size=cfg.batch_size,
                             seed=cfg.seed)
    else:
        try:
            loader, cfg = _open_dataset(args, cfg)
        except UsageError as e:
            print(e, file=sys.stderr)
            return 2
    log_dir = os.path.join(args.working_path, "log")
    os.makedirs(log_dir, exist_ok=True)
    ckpt_dir = args.model_save_path or os.path.join(
        args.working_path, "checkpoints", model_name)
    with open(os.path.join(log_dir, f"{model_name}.txt"), "a") as logfile, \
            contextlib.redirect_stdout(Tee(sys.stdout, logfile)):
        print(f"Training {model_name} ({cfg.backbone}, "
              f"{'fused' if fused else 'eager'} head) - batch "
              f"{cfg.batch_size}, epochs {cfg.epochs}, "
              f"lr {args.learning_rate}")
        mgr = CheckpointManager(ckpt_dir, model_name,
                                keep=cfg.keep_checkpoints)
        t0 = time.time()
        result = fit(cfg, loader, device=args.device, head_cfg=head_cfg,
                     checkpoint_manager=mgr)
        if result.preempted:
            return 143
        # the final artifact is the embedding model; the full train state
        # (head kernel and state, optimizer) lives in the epoch and
        # min_loss checkpoints
        mgr.save_final(result.state.backbone.state_dict())
        print(f"Done in {time.time() - t0:.0f}s - min train loss "
              f"{result.min_train_loss:.6f}, "
              f"{result.images_per_sec:.0f} img/s")
    return 0


def _add_eval_parser(sub):
    p = sub.add_parser("eval", help="10-fold verification over benchmarks")
    p.add_argument("--checkpoint-dir", required=True,
                   help="dir holding a <model>/ checkpoint dir per "
                        "trained model (train's <working>/checkpoints)")
    p.add_argument("--head", default=None,
                   help="evaluate one model (else all found)")
    p.add_argument("--backbone", default="resnet18",
                   choices=sorted(BACKBONES))
    p.add_argument("--embed-dim", type=int, default=512,
                   help="backbone embedding width")
    p.add_argument("--eval-data-path", required=True,
                   help="dir with <benchmark>/{pair.list,imgs} or "
                        "insightface-format <benchmark>.bin files")
    p.add_argument("--benchmarks", default=",".join(cfg_lib.EVAL_BENCHMARKS))
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-classes", type=int,
                   default=cfg_lib.CASIA_NUM_CLASSES)
    p.add_argument("--output-dir", default="evaluation_results")
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--which",
                   choices=["final", "min_loss", "final_ema", "best_acc"],
                   default="final",
                   help="which checkpoint to evaluate (the reference "
                        "evaluates min_loss)")
    p.add_argument("--standard-protocol", action="store_true",
                   help="use the CLASSIC LFW protocol (sequential folds, "
                        "accuracy-max grid threshold tuned on 9 folds, "
                        "tested on 1 — insightface semantics) instead of "
                        "the reference's inverted protocol; add "
                        "--eval-flip to match published insightface "
                        "numbers (they also flip-sum embeddings)")
    p.add_argument("--device-protocol", action="store_true",
                   help="run the 10-fold protocol vectorised on the device "
                        "instead of the numpy host path")
    p.add_argument("--eval-flip", action="store_true",
                   help="flip-sum TTA: sum each image's and its horizontal "
                        "flip's raw embeddings before normalizing (2x "
                        "embedding cost)")
    p.add_argument("--tpr-far", default="",
                   help="comma-separated FAR operating points (e.g. "
                        "'1e-2,1e-3') to additionally report TPR@FAR per "
                        "benchmark (evaluation/openset.py)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def cmd_eval(args) -> int:
    from face_recognition_models_tpu_torch.evaluation.batch_eval import (
        run_batch_evaluation)
    return run_batch_evaluation(
        checkpoint_dir=args.checkpoint_dir,
        head=args.head,
        backbone=args.backbone,
        eval_data_path=args.eval_data_path,
        benchmarks=args.benchmarks.split(","),
        batch_size=args.batch_size,
        num_classes=args.num_classes,
        output_dir=args.output_dir,
        image_size=args.image_size,
        which=args.which,
        protocol=("standard" if args.standard_protocol
                  else "device" if args.device_protocol else "host"),
        fars=tuple(float(f) for f in args.tpr_far.split(",") if f),
        flip=args.eval_flip,
        embed_dim=args.embed_dim,
        device=args.device,
    )


def _add_pack_parser(sub):
    p = sub.add_parser("pack",
                       help="decode a dataset once into a uint8 memmap "
                            "pack; `train --dataset-path <pack>` then "
                            "trains with no decode on the host")
    p.add_argument("--dataset-path", required=True,
                   help="identity tree root (the layouts train reads: "
                        "<root>/CASIA-WebFace[/{train,valid}]/<id>/*.jpg "
                        "or <root>/<id>/*.jpg) or an insightface RecordIO "
                        "train.rec/.idx set")
    p.add_argument("--output", required=True, metavar="DIR")
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--backend", choices=["auto", "native", "pil"],
                   default="auto")
    return p


def cmd_pack(args) -> int:
    from face_recognition_models_tpu_torch.data.index import index_tree
    from face_recognition_models_tpu_torch.data.packed import (
        pack_dataset, pack_from_loader)
    from face_recognition_models_tpu_torch.data.recordio import (
        RecLoader, RecordIODataset, is_recordio)

    t0 = time.time()
    if is_recordio(args.dataset_path):
        rec = RecordIODataset.open(args.dataset_path)
        loader = RecLoader(rec, batch_size=min(1024, len(rec)),
                           image_size=args.image_size, shuffle=False,
                           num_workers=args.num_workers,
                           drop_remainder=False, backend=args.backend)
        meta = pack_from_loader(loader, rec.identities, args.output,
                                args.image_size,
                                decode_backend=loader.backend,
                                progress_every=50_000)
        source = "RecordIO"
    else:
        meta = pack_dataset(index_tree(args.dataset_path), args.output,
                            image_size=args.image_size,
                            num_workers=args.num_workers,
                            backend=args.backend, progress_every=50_000)
        source = "an identity tree"
    n = meta["num_samples"]
    print(f"packed {n} images from {source} "
          f"({n * args.image_size**2 * 3 / 1e9:.2f} GB, "
          f"{len(meta['identities'])} identities) in {time.time() - t0:.0f}s "
          f"via {meta['decode_backend']} decode; "
          f"{meta['skipped_images']} corrupt resampled -> {args.output}")
    return 0


def cmd_list(args) -> int:
    print("heads:     ", ", ".join(available_heads()))
    print("backbones: ", ", ".join(sorted(BACKBONES)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m face_recognition_models_tpu_torch.cli",
        description="PyTorch/CUDA face-recognition training, "
                    "evaluation and dataset packing")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train_parser(sub)
    _add_eval_parser(sub)
    _add_pack_parser(sub)
    sub.add_parser("list", help="list the heads and backbones")
    args = parser.parse_args(argv)
    if args.command == "train":
        return cmd_train(args)
    if args.command == "eval":
        return cmd_eval(args)
    if args.command == "pack":
        return cmd_pack(args)
    if args.command == "list":
        return cmd_list(args)
    parser.error(f"unknown command {args.command}")
    return 2
