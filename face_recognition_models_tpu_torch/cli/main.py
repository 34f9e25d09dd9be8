"""Command line of the port. Port of the `train`, `facenet`, `eval`,
`pack`, `export`, `embed`, `serve`, `identify` and `list` subcommands of
face_recognition_models_tpu/cli/main.py; flag names and defaults follow it.

    python -m face_recognition_models_tpu_torch.cli train \
        --dataset-path P | --synthetic [--head NAME] \
        [--head-path auto|fused|eager] [--lambda_g G] \
        [--pretrained STATE_DICT.pth] [--bn-dtype bfloat16] \
        [--scan-steps K] [--partial-fc RATIO] [--scheduler NAME] \
        [--warmup-epochs E] \
        [--optimizer NAME|ID] [--clip-grad-norm X] [--grad-accum K] \
        [--model-ema D] [--freeze-backbone] [--flip] [--crop-pad P] \
        [--color-jitter S] [--random-erasing P] [--distill-dir DIR \
        --distill-weight W] [--working-path W] [--continue_train latest] \
        [--eval-every N | --eval-after] [--eval-data-path E] \
        [--benchmarks lfw,...] [--eval-flip] [--device cpu] ...
    python -m face_recognition_models_tpu_torch.cli facenet \
        --dataset-path TREE_OR_REC | --synthetic [--backbone resnet50] \
        [--embed-dim 128] [--p 16 --k 4] [--margin 0.2] [--resume] ...
    python -m face_recognition_models_tpu_torch.cli pack \
        --dataset-path P --output DIR [--image-size 112] [--backend auto]
    python -m face_recognition_models_tpu_torch.cli eval \
        --checkpoint-dir W/checkpoints --eval-data-path E [--device cpu] ...
    python -m face_recognition_models_tpu_torch.cli export \
        --checkpoint-dir W/checkpoints/<model> --output F.frte \
        [--fold-bn] [--platforms cuda,cpu] [--format stablehlo|torch]
    python -m face_recognition_models_tpu_torch.cli embed --input TREE \
        --output F.npz --model F.frte | --checkpoint-dir DIR
    python -m face_recognition_models_tpu_torch.cli serve \
        --model F.frte | --checkpoint-dir DIR [--gallery G.npz] [--port P]
    python -m face_recognition_models_tpu_torch.cli identify \
        --gallery G.npz --probes P.npz [--device cpu]
    python -m face_recognition_models_tpu_torch.cli list

`train --dataset-path` reads a pack (`pack`'s output, no decode), an
insightface RecordIO set (`train.rec` / `train.idx`: either path, their
prefix, or a dir holding `train.rec`) or an identity tree
(`P/CASIA-WebFace[/{train,valid}]/<id>/*.jpg`, or `P/<id>/*.jpg`). `train`
writes its checkpoints under <working>/checkpoints/<model> (with
--model-ema also <model>_final_ema, the averaged backbone; with
--eval-every also <model>_best_acc) and tees its output to
<working>/log/<model>.txt; `eval`, `export` and `embed` read them, and
`facenet`'s <working>/checkpoints/<model-name> (facenet_<backbone> by
default) with `--embed-dim 128`. `embed`
and `serve` decode images with PIL. Every subcommand that runs a model,
and `identify`'s scoring, runs on the card unless `--device cpu` is given,
and fails without one.
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
from face_recognition_models_tpu_torch.utils.pretrained import PORTED


def add_recipe_arguments(p) -> None:
    """The optimizer, accumulation, EMA, frozen-trunk, augmentation and
    distillation flags of `train` (the JAX CLI's names and defaults), which
    the benchmark and profiling scripts take too."""
    p.add_argument("--optimizer", default="sgd",
                   help="update rule, by name or 1-based id "
                        "(train/optim.py: sgd, adam, adamw, rmsprop, "
                        "adagrad, nadam, adamax, lion)")
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--nesterov", action="store_true")
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   help="clip the gradients to this global norm before the "
                        "update (optax.clip_by_global_norm; 0 = off)")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="average the gradients of K micro-batches per "
                        "update (1 = off)")
    p.add_argument("--model-ema", type=float, default=0.0, metavar="DECAY",
                   help="exponential moving average of the weights (0 = "
                        "off; typical 0.999-0.9999), saved as "
                        "<model>_final_ema")
    p.add_argument("--freeze-backbone", action="store_true",
                   help="train the margin head only: the backbone runs in "
                        "eval mode with no backward and keeps its weights")
    p.add_argument("--flip", action="store_true",
                   help="random horizontal flip on the card")
    p.add_argument("--crop-pad", type=int, default=0,
                   help="random shift-crop on the card: reflect-pad by N "
                        "pixels, crop back at a random offset")
    p.add_argument("--color-jitter", type=float, default=0.0,
                   help="brightness / contrast jitter strength on the card")
    p.add_argument("--random-erasing", type=float, default=0.0,
                   help="Random Erasing probability per image on the card")
    p.add_argument("--distill-dir", default="", metavar="CKPT_DIR",
                   help="distillation: the checkpoint dir of a trained "
                        "teacher (a previous `train` run's "
                        "<working>/checkpoints/<model>); needs "
                        "--distill-weight")
    p.add_argument("--distill-backbone", default="resnet50",
                   choices=sorted(BACKBONES), help="the teacher's trunk")
    p.add_argument("--distill-weight", type=float, default=0.0,
                   metavar="W", help="weight of the embedding-matching "
                                     "loss (0 = off)")
    p.add_argument("--distill-mode", choices=["cosine", "mse"],
                   default="cosine",
                   help="cosine: 1 - cos of the L2-normalised embeddings; "
                        "mse: squared L2 of the raw embeddings")
    p.add_argument("--distill-which",
                   choices=["final", "final_ema", "min_loss", "best_acc"],
                   default="final", help="which teacher artifact to load")


def recipe_config(cfg: cfg_lib.TrainConfig, args) -> cfg_lib.TrainConfig:
    """`cfg` with the flags of add_recipe_arguments and args.learning_rate.
    An unknown optimizer raises ValueError (the factory's message)."""
    from face_recognition_models_tpu_torch.train.optim import optimizer_name

    choice = args.optimizer
    name = optimizer_name(int(choice) if choice.isdigit() else choice)
    return dataclasses.replace(
        cfg, grad_accum=args.grad_accum, model_ema=args.model_ema,
        freeze_backbone=args.freeze_backbone,
        optimizer=cfg_lib.OptimizerConfig(
            name=name, learning_rate=args.learning_rate,
            momentum=args.momentum, weight_decay=args.weight_decay,
            nesterov=args.nesterov, clip_grad_norm=args.clip_grad_norm),
        data=dataclasses.replace(
            cfg.data, horizontal_flip=args.flip, crop_pad=args.crop_pad,
            color_jitter=args.color_jitter,
            random_erasing=args.random_erasing),
        distill=cfg_lib.DistillConfig(
            backbone=args.distill_backbone, checkpoint_dir=args.distill_dir,
            which=args.distill_which, weight=args.distill_weight,
            mode=args.distill_mode))


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
    add_recipe_arguments(p)
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
                   help="torchvision / arcface_torch backbone state_dict to "
                        "initialize from (the reference trains from "
                        "ImageNet-pretrained torchvision weights; resnet18/"
                        "50, mobilenet_v2, efficientnet_b0, iresnet18/50/"
                        "100)")
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
    p.add_argument("--partial-fc", type=float, default=0.0, metavar="RATIO",
                   help="Partial-FC sampled classifier: each step's softmax "
                        "over the batch's positives + RATIO*C sampled "
                        "negatives, on the eager head (the insightface "
                        "large-C recipe; 0 = dense; needs --optimizer sgd; "
                        "not for vpl_arcface, qaface, subcenter_arcface, "
                        "adacos)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--mesh-data", type=int, default=-1,
                   help="ranks on the mesh's data axis (with --multihost; "
                        "-1: every rank the model axis leaves)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="ranks the classifier's class axis is split over "
                        "(with --multihost)")
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
    p.add_argument("--eval-after", action="store_true",
                   help="run benchmark verification after training")
    p.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help="run benchmark verification every N epochs DURING "
                        "training (0 = off; needs --eval-data-path) and "
                        "save the best-by-verification backbone as "
                        "<model>_best_acc")
    p.add_argument("--eval-data-path", default="",
                   help="benchmark root for --eval-after / --eval-every")
    p.add_argument("--eval-flip", action="store_true",
                   help="flip-sum TTA for --eval-after / --eval-every "
                        "embeddings (the insightface convention)")
    p.add_argument("--benchmarks", default=",".join(cfg_lib.EVAL_BENCHMARKS))
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


def _open_dataset(args, cfg, batch_size: int, shard=None):
    """(loader, cfg) for `train --dataset-path`, loading `batch_size`
    rows a step of `shard` (the rank's data coordinate). A pack's image
    size overrides --image-size; more identities than --num-classes raise
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
        return RecLoader(rec, batch_size=batch_size,
                         image_size=cfg.data.image_size,
                         num_workers=args.num_workers, seed=cfg.seed,
                         shard=shard), cfg
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
        return PackedLoader(packed, batch_size=batch_size,
                            seed=cfg.seed, shard=shard), cfg
    return Loader(index_tree(path), batch_size=batch_size,
                  image_size=cfg.data.image_size,
                  num_workers=args.num_workers, seed=cfg.seed,
                  shard=shard), cfg


def cmd_train(args) -> int:
    if not args.synthetic and not args.dataset_path:
        print("error: --dataset-path required (or --synthetic)",
              file=sys.stderr)
        return 2
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)

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
        partial_fc=args.partial_fc,
        mesh=cfg_lib.MeshConfig(data=args.mesh_data, model=args.mesh_model),
        schedule=cfg_lib.ScheduleConfig(
            name=args.scheduler,
            steps=tuple(int(s) for s in args.lr_steps.split(",") if s),
            warmup_epochs=args.warmup_epochs),
        data=cfg_lib.DataConfig(image_size=args.image_size))
    try:
        cfg = recipe_config(cfg, args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    head_cfg = cfg_lib.make_head_config(head, num_classes=cfg.num_classes,
                                        **head_kw)
    # under --multihost cfg.batch_size is the global batch: each rank loads
    # batch_size // data rows a step of its data coordinate's shard, and
    # the model peers of one coordinate load the same rows
    mesh = _mesh(cfg.mesh) if args.multihost else None
    batch, shard = cfg.batch_size, None
    if mesh is not None and mesh.data > 1:
        if cfg.batch_size % mesh.data:
            print(f"error: batch_size {cfg.batch_size} must divide across "
                  f"the mesh data axis ({mesh.data})", file=sys.stderr)
            return 2
        batch, shard = cfg.batch_size // mesh.data, (mesh.data_index,
                                                     mesh.data)
    if args.synthetic:
        images, labels = synthetic_identities(
            args.synthetic_classes, args.synthetic_per_class,
            image_size=args.image_size, seed=cfg.seed)
        loader = ArrayLoader(images, labels, batch_size=batch,
                             seed=cfg.seed, shard=shard)
    else:
        try:
            loader, cfg = _open_dataset(args, cfg, batch, shard)
        except UsageError as e:
            print(e, file=sys.stderr)
            return 2
    if mesh is not None and mesh.rank != 0:
        # the other ranks train in step with rank 0 and keep quiet
        return _train(args, cfg, head_cfg, model_name, fused, loader, mesh,
                      False)
    log_dir = os.path.join(args.working_path, "log")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"{model_name}.txt"), "a") as logfile, \
            contextlib.redirect_stdout(Tee(sys.stdout, logfile)):
        return _train(args, cfg, head_cfg, model_name, fused, loader, mesh,
                      True)


def _mesh(mesh_cfg):
    from face_recognition_models_tpu_torch.parallel import make_mesh
    return make_mesh(mesh_cfg)


def _train(args, cfg, head_cfg, model_name, fused, loader, mesh,
           writer: bool) -> int:
    """The rest of `train` once the loader is open: fit, the final
    artifacts and --eval-after; under --multihost every rank runs it and
    rank 0 (the `writer`) alone prints and writes."""
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.evaluation.periodic import (
        PeriodicEvalHook)
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.state import (
        build_backbone, ema_state_dict)

    def say(*a):
        if writer:
            print(*a)

    ckpt_dir = args.model_save_path or os.path.join(
        args.working_path, "checkpoints", model_name)
    path = ("partial-fc" if cfg.partial_fc > 0
            else "fused" if fused else "eager")
    say(f"Training {model_name} ({cfg.backbone}, {path} head) - batch "
        f"{cfg.batch_size}, epochs {cfg.epochs}, "
        f"{cfg.optimizer.name} lr {args.learning_rate}"
        + ("" if mesh is None else
           f", mesh {mesh.data}x{mesh.model} (data x model)"))
    mgr = CheckpointManager(ckpt_dir, model_name,
                            keep=cfg.keep_checkpoints)
    eval_hook = None
    # the hook embeds on one rank, with no collective: rank 0's alone
    if args.eval_every > 0 and writer:
        if not args.eval_data_path:
            print("--eval-every: no --eval-data-path given, skipping")
        else:
            eval_hook = PeriodicEvalHook(
                build_backbone(cfg, head_cfg), args.eval_data_path,
                args.benchmarks.split(","), every=args.eval_every,
                image_size=cfg.data.image_size, total_epochs=cfg.epochs,
                checkpoint_manager=mgr, model_name=model_name,
                use_ema=cfg.model_ema > 0.0, flip=args.eval_flip,
                device=args.device)
    t0 = time.time()
    result = fit(cfg, loader, device=args.device, head_cfg=head_cfg,
                 checkpoint_manager=mgr, hooks=eval_hook, mesh=mesh)
    if result.preempted:
        return 143
    if eval_hook is not None and eval_hook.best_epoch > 0:
        print(f"Best verification {eval_hook.best_acc:.3f}% at epoch "
              f"{eval_hook.best_epoch} (saved {model_name}_best_acc)")
    # the final artifact is the embedding model; the full train state
    # (head kernel and state, optimizer) lives in the epoch and
    # min_loss checkpoints
    eval_weights = result.state.backbone.state_dict()
    if writer:
        mgr.save_final(eval_weights)
    if result.state.ema is not None:
        # the averaged weights are what a run with an EMA deploys
        eval_weights = ema_state_dict(result.state)
        if writer:
            mgr.save_final(eval_weights,
                           filename=f"{model_name}_final_ema")
    say(f"Done in {time.time() - t0:.0f}s - min train loss "
        f"{result.min_train_loss:.6f}, "
        f"{result.images_per_sec:.0f} img/s")
    if args.eval_after:
        if not args.eval_data_path:
            say("--eval-after: no --eval-data-path given, skipping")
        else:
            _eval_after(args, cfg, head_cfg, model_name, eval_weights,
                        mesh, say)
    return 0


def _add_facenet_parser(sub):
    p = sub.add_parser("facenet", help="FaceNet triplet training "
                                       "(PK sampling + semi-hard mining)")
    p.add_argument("--dataset-path", default="",
                   help="identity tree root or an insightface RecordIO "
                        "set, streamed through the PK loader (or "
                        "--synthetic)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-classes", type=int, default=32)
    p.add_argument("--synthetic-per-class", type=int, default=16)
    p.add_argument("--backbone", default="resnet50",
                   choices=sorted(BACKBONES))
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--p", type=int, default=16, help="identities per batch")
    p.add_argument("--k", type=int, default=4, help="images per identity")
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--working-path", default="train_output",
                   help="checkpoints land under "
                        "<working>/checkpoints/<model-name>, the layout "
                        "`train` writes, so `embed` / `eval` / `export "
                        "--checkpoint-dir` read the result")
    p.add_argument("--model-name", default=None,
                   help="default facenet_<backbone>")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest epoch checkpoint")
    p.add_argument("--keep-checkpoints", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--use-mesh", action="store_true",
                   help="data-parallel over every rank of the world (with "
                        "--multihost): each rank embeds its rows of the PK "
                        "batch, the mining runs on the global batch")
    return p


def cmd_facenet(args) -> int:
    from face_recognition_models_tpu_torch.triplet import train_facenet

    images = labels = loader = None
    if args.synthetic:
        from face_recognition_models_tpu_torch.data.synthetic import (
            synthetic_identities)
        images, labels = synthetic_identities(
            args.synthetic_classes, args.synthetic_per_class,
            image_size=args.image_size, seed=args.seed)
    elif not args.dataset_path:
        print("error: --dataset-path required (or --synthetic)",
              file=sys.stderr)
        return 2
    else:
        from face_recognition_models_tpu_torch.data.recordio import (
            is_recordio)
        if is_recordio(args.dataset_path):
            from face_recognition_models_tpu_torch.data import (
                PKRecLoader, RecordIODataset)
            loader = PKRecLoader(RecordIODataset.open(args.dataset_path),
                                 args.p, args.k, image_size=args.image_size,
                                 seed=args.seed,
                                 num_workers=args.num_workers)
        else:
            from face_recognition_models_tpu_torch.data import (
                ImageFolderIndex, PKLoader)
            loader = PKLoader(ImageFolderIndex.build(args.dataset_path),
                              args.p, args.k, image_size=args.image_size,
                              seed=args.seed, num_workers=args.num_workers)

    cfg = cfg_lib.FaceNetConfig(backbone=args.backbone,
                                embed_dim=args.embed_dim, p=args.p, k=args.k,
                                margin=args.margin,
                                learning_rate=args.learning_rate)
    mesh = None
    if args.use_mesh and args.multihost:
        mesh = _mesh(cfg_lib.MeshConfig(model=1))
        if (cfg.p * cfg.k) % mesh.data:
            print(f"error: PK batch {cfg.p}*{cfg.k} must divide the mesh "
                  f"data axis ({mesh.data})", file=sys.stderr)
            return 2
    model_name = args.model_name or f"facenet_{args.backbone}"
    ckpt_dir = os.path.join(args.working_path, "checkpoints", model_name)
    result = train_facenet(cfg, images, labels, epochs=args.epochs,
                           image_size=args.image_size, seed=args.seed,
                           loader=loader, checkpoint_dir=ckpt_dir,
                           model_name=model_name, resume=args.resume,
                           keep=args.keep_checkpoints, device=args.device,
                           mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return 0
    print(f"final loss {result.losses[-1]:.4f} — "
          f"{result.images_per_sec:.0f} img/s; saved {model_name}_final "
          f"under {ckpt_dir} (evaluate: `eval --checkpoint-dir "
          f"{os.path.dirname(ckpt_dir)} --head {model_name} "
          f"--backbone {args.backbone} --embed-dim {args.embed_dim} ...`)")
    return 0


def _eval_after(args, cfg, head_cfg, model_name, weights, mesh=None,
                say=print) -> None:
    """`train --eval-after`: each benchmark's verification of the trained
    backbone (its EMA with --model-ema); a missing benchmark is skipped.
    Under a mesh the embedding passes split over all its ranks."""
    from face_recognition_models_tpu_torch.evaluation.batch_eval import (
        evaluate_model_on_benchmark, make_embed_fn)
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.train.state import build_backbone
    from face_recognition_models_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    module = build_backbone(cfg, head_cfg)
    module.load_state_dict(weights)
    batch = 256
    if mesh is not None:
        mesh = _mesh(cfg_lib.MeshConfig(data=mesh.size, model=1))
        batch += (-batch) % mesh.data
    embed = make_embed_fn(to_device(module, device), device=device,
                          mesh=mesh)
    for bench in args.benchmarks.split(","):
        try:
            res = evaluate_model_on_benchmark(
                embed, args.eval_data_path, bench, cfg.data.image_size,
                batch, verbose=False, flip=args.eval_flip)
            say(f"[eval-after] {model_name} on {bench}: {res}")
        except FileNotFoundError as e:
            say(f"[eval-after] skip {bench}: {e}")


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
        mesh=(_mesh(cfg_lib.MeshConfig(model=1)) if args.multihost
              else None),
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


_WHICH = ["final", "final_ema", "min_loss", "best_acc"]


def _add_export_parser(sub):
    p = sub.add_parser("export", help="export a trained backbone as a "
                                      "self-contained serving artifact "
                                      "(a torch.export program; symbolic "
                                      "batch dim)")
    p.add_argument("--checkpoint-dir", required=True,
                   help="model checkpoint dir (the train run's "
                        "<working>/checkpoints/<name>)")
    p.add_argument("--backbone", default="resnet50",
                   choices=sorted(BACKBONES))
    p.add_argument("--embed-dim", type=int, default=512,
                   help="backbone embedding width")
    p.add_argument("--output", required=True, metavar="FILE.frte")
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--platforms", default=None,
                   help="comma list of devices to export a program for "
                        "(cuda, cpu); default: --device's")
    p.add_argument("--which", default="final", choices=_WHICH,
                   help="which checkpoint artifact to export "
                        "(same semantics as `eval --which`)")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold BatchNorm into the conv weights (ResNet; "
                        "exact in eval mode; other trunks stay unfolded)")
    p.add_argument("--format", default="stablehlo",
                   choices=["stablehlo", "torch"],
                   help="stablehlo (the JAX package's name for it): the "
                        "self-contained .frte serving artifact, which the "
                        "port writes as a torch.export program; torch: the "
                        "backbone's torchvision / arcface_torch-layout "
                        "state_dict .pth (resnet18/50, mobilenet_v2, "
                        "efficientnet_b0, iresnet18/50/100)")
    p.add_argument("--device", default=None,
                   help="torch device to export on (default: cuda)")
    return p


def cmd_export(args) -> int:
    import torch

    from face_recognition_models_tpu_torch.checkpoint import restore_backbone
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.serving.export import (
        export_embedder)
    from face_recognition_models_tpu_torch.utils.device import resolve_device

    if args.format == "torch" and args.backbone.lower() not in PORTED:
        raise ValueError(f"--format torch supports {sorted(PORTED)}; got "
                         f"'{args.backbone}'")
    finals = sorted(d for d in os.listdir(args.checkpoint_dir)
                    if d.endswith("_final"))
    if not finals and args.which != "min_loss":
        print(f"error: no *_final checkpoint under {args.checkpoint_dir} "
              "(train to completion first)", file=sys.stderr)
        return 1
    name = finals[0][:-len("_final")] if finals else None
    state_dict = restore_backbone(args.checkpoint_dir, args.which,
                                  model_name=name)
    if args.format == "torch":
        torch.save({k: v.contiguous() for k, v in state_dict.items()},
                   args.output)
        print(f"exported {args.backbone} ({args.which}) -> {args.output} "
              f"(torch state_dict, {len(state_dict)} tensors)")
        return 0
    platforms = (args.platforms.split(",") if args.platforms
                 else [resolve_device(args.device).type])
    header = export_embedder(get_backbone(args.backbone,
                                          embed_dim=args.embed_dim,
                                          image_size=args.image_size),
                             state_dict, args.output,
                             image_size=args.image_size,
                             platforms=platforms,
                             fold_bn="always" if args.fold_bn else "never",
                             meta={"backbone": args.backbone,
                                   "which": args.which})
    print(f"exported {args.backbone} ({args.which}) -> {args.output} "
          f"(platforms {header['platforms']}, {header['embed_dim']}-d"
          f"{', BN folded' if header['bn_folded'] else ''})")
    return 0


def _add_model_arguments(p) -> None:
    """The model source flags `embed` and `serve` share."""
    p.add_argument("--model", default=None,
                   help="serving artifact from `export`")
    p.add_argument("--checkpoint-dir", default=None,
                   help="alternatively: a training checkpoint dir")
    p.add_argument("--which", default="final", choices=_WHICH,
                   help="which checkpoint artifact to use "
                        "(same semantics as `eval --which`)")
    p.add_argument("--backbone", default="resnet50",
                   choices=sorted(BACKBONES))
    p.add_argument("--embed-dim", type=int, default=512,
                   help="backbone embedding width")
    p.add_argument("--image-size", type=int, default=cfg_lib.IMAGE_SIZE)
    p.add_argument("--bn-dtype", choices=["float32", "bfloat16"],
                   default="bfloat16",
                   help="BatchNorm output dtype of a checkpointed backbone; "
                        "float32 matches the training numerics")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")


def _add_embed_parser(sub):
    p = sub.add_parser("embed", help="batch-embed an image tree to .npz")
    p.add_argument("--input", required=True, help="image tree root")
    p.add_argument("--output", required=True, metavar="FILE.npz")
    _add_model_arguments(p)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-workers", type=int, default=8)
    return p


def cmd_embed(args) -> int:
    from face_recognition_models_tpu_torch.serving.embed import run_embed_cli
    return run_embed_cli(
        input_dir=args.input, output=args.output, model_path=args.model,
        checkpoint_dir=args.checkpoint_dir, backbone=args.backbone,
        which=args.which, image_size=args.image_size,
        batch_size=args.batch_size, num_workers=args.num_workers,
        bn_dtype=args.bn_dtype, embed_dim=args.embed_dim,
        device=args.device)


def _add_serve_parser(sub):
    p = sub.add_parser(
        "serve",
        help="online embedding / identification HTTP service: concurrent "
             "requests coalesce into one fixed-size micro-batch")
    _add_model_arguments(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--micro-batch", type=int, default=8,
                   help="fixed batch requests coalesce into")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time to wait for co-arriving requests")
    p.add_argument("--gallery", default=None, metavar="GALLERY.npz",
                   help="`embed` output enabling POST /identify")
    return p


def cmd_serve(args) -> int:
    from face_recognition_models_tpu_torch.serving.server import (
        run_serve_cli)
    return run_serve_cli(
        model_path=args.model, checkpoint_dir=args.checkpoint_dir,
        backbone=args.backbone, which=args.which,
        image_size=args.image_size, host=args.host, port=args.port,
        micro_batch=args.micro_batch, max_wait_ms=args.max_wait_ms,
        gallery=args.gallery, bn_dtype=args.bn_dtype,
        embed_dim=args.embed_dim, device=args.device)


def _add_identify_parser(sub):
    p = sub.add_parser(
        "identify",
        help="1:N identification between two `embed` outputs (CMC rank-k; "
             "TPIR@FPIR when probe identities are missing from the "
             "gallery). Identity = parent directory of each image path.")
    p.add_argument("--gallery", required=True, metavar="GALLERY.npz")
    p.add_argument("--probes", required=True, metavar="PROBES.npz")
    p.add_argument("--ranks", default="1,5")
    p.add_argument("--fpir", default="1e-1,1e-2",
                   help="open-set FPIR operating points")
    p.add_argument("--device", default=None,
                   help="torch device that scores the probe-gallery "
                        "cosines (default: cuda)")
    p.add_argument("--min-quality", type=float, default=0.0,
                   help="drop gallery / probe images whose quality score "
                        "(stored by `embed`) is below this [0, 1] "
                        "threshold")
    p.add_argument("--pool", default="none",
                   choices=["none", "probes", "gallery", "both"],
                   help="IJB-style template pooling: collapse each "
                        "identity's images to one renormalized mean "
                        "embedding before scoring")
    p.add_argument("--pool-weight", default="none",
                   choices=["none", "quality"],
                   help="weight the pooled mean by the stored per-image "
                        "quality scores")
    return p


def cmd_identify(args) -> int:
    from face_recognition_models_tpu_torch.evaluation.openset import (
        identify_from_npz)
    res = identify_from_npz(
        args.gallery, args.probes,
        ranks=tuple(int(r) for r in args.ranks.split(",") if r),
        fpirs=tuple(float(f) for f in args.fpir.split(",") if f),
        device=args.device, min_quality=args.min_quality,
        pool=args.pool, pool_weight=args.pool_weight)
    print(res)
    return 0


def cmd_list(args) -> int:
    print("heads:     ", ", ".join(available_heads()))
    print("backbones: ", ", ".join(sorted(BACKBONES)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m face_recognition_models_tpu_torch.cli",
        description="PyTorch/CUDA face-recognition training, "
                    "evaluation, dataset packing and serving")
    parser.add_argument(
        "--multihost", action="store_true",
        help="join the process group torchrun's environment describes "
             "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): "
             "one process a card, NCCL on the card and gloo with --device "
             "cpu; `train` then runs over the --mesh-data x --mesh-model "
             "mesh, `facenet --use-mesh` and `eval` data-parallel")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_train_parser(sub)
    _add_facenet_parser(sub)
    _add_eval_parser(sub)
    _add_pack_parser(sub)
    _add_export_parser(sub)
    _add_embed_parser(sub)
    _add_identify_parser(sub)
    _add_serve_parser(sub)
    sub.add_parser("list", help="list the heads and backbones")
    args = parser.parse_args(argv)
    commands = {"train": cmd_train, "facenet": cmd_facenet,
                "eval": cmd_eval, "pack": cmd_pack,
                "export": cmd_export, "embed": cmd_embed,
                "identify": cmd_identify, "serve": cmd_serve,
                "list": cmd_list}
    if not args.multihost:
        return commands[args.command](args)
    if args.command not in ("train", "facenet", "eval"):
        print(f"error: --multihost runs train, facenet and eval, not "
              f"{args.command}", file=sys.stderr)
        return 2
    from face_recognition_models_tpu_torch.parallel import dist as pdist
    args.device = str(pdist.initialize(device=args.device))
    try:
        return commands[args.command](args)
    finally:
        pdist.shutdown()
