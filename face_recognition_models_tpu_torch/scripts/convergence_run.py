"""Synthetic end-to-end convergence run: the port's trained accuracy.

Port of the repo's root scripts/convergence_run.py, with the same flags and
the same JSON lines (`--device` in place of `--platform`). There is no
CASIA / LFW data here, so training quality is measured on a synthetic
identity problem: N identities, noisy copies of per-identity prototypes
(noise 35), train on the first copies of each identity and verify on the
HELD-OUT copies with the reference's 10-fold Youden protocol
(model_utils.py:416-474).

    python -m face_recognition_models_tpu_torch.scripts.convergence_run

Defaults: ArcFace + resnet18, 500 identities x (16 train + 4 held-out)
copies at 112 px, batch 512, 15 epochs, SGD 0.1 with CustomStepLR,
`--scan-steps 8` (CUDA graphs of 8 steps), the fused head; on the card
unless `--device cpu`. Two-stage fine-tune (pretrain on a small class
count, then fine-tune the backbone on a disjoint identity set with a fresh
head):

    python -m face_recognition_models_tpu_torch.scripts.convergence_run \\
        --classes 1000 --finetune-classes 8192 [--finetune-epochs 15]

`--save-backbone F` writes the stage-1 backbone state_dict (torch.save) and
`--load-backbone F` starts the fine-tune stage from one. Prints one JSON
line per stage with the verification result.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_split(classes, train_per_class, eval_per_class, image_size, seed,
                noise):
    """Class-major identity blocks: the first train_per_class copies of
    each identity train, the rest are held out for verification."""
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)

    per = train_per_class + eval_per_class
    images, _ = synthetic_identities(
        classes, per, image_size=image_size, seed=seed, noise=noise)
    images = images.reshape(classes, per, *images.shape[1:])
    train_x = images[:, :train_per_class].reshape(-1, *images.shape[2:])
    train_y = np.repeat(np.arange(classes, dtype=np.int32), train_per_class)
    held_x = images[:, train_per_class:].reshape(-1, *images.shape[2:])
    held_y = np.repeat(np.arange(classes, dtype=np.int32), eval_per_class)
    return train_x, train_y, held_x, held_y


def _heldout_pairs(held_y, classes, eval_per_class, pairs_per_kind, seed):
    rs = np.random.RandomState(seed + 1)
    n = len(held_y)
    pos, neg = [], []
    while len(pos) < pairs_per_kind:
        c = rs.randint(classes)
        i, j = rs.choice(eval_per_class, 2, replace=False)
        pos.append((c * eval_per_class + i, c * eval_per_class + j, 1))
    while len(neg) < pairs_per_kind:
        a, b = rs.randint(n), rs.randint(n)
        if held_y[a] != held_y[b]:
            neg.append((a, b, 0))
    return np.asarray(pos + neg, np.int64)


def _eval_backbone(result, device):
    """The trained backbone in eval mode, its model-EMA weights when the run
    kept an EMA (the evaluation artifact of --model-ema)."""
    from face_recognition_models_tpu_torch.train.state import ema_state_dict

    state = result.state
    if state.ema is None:
        return state.backbone
    import copy

    module = copy.deepcopy(state.backbone)
    module.load_state_dict(ema_state_dict(state))
    return module


def verify(result, held_x, held_y, classes, eval_per_class, pairs_per_kind,
           batch, seed, device=None):
    """Held-out 10-fold Youden verification of the trained backbone."""
    from face_recognition_models_tpu_torch.evaluation.batch_eval import (
        make_embed_fn)
    from face_recognition_models_tpu_torch.evaluation.verification import (
        embed_unique_images,
        kfold_verification,
    )

    embed = make_embed_fn(_eval_backbone(result, device), device=device)
    emb = embed_unique_images(embed, held_x, batch_size=batch)
    pairs = _heldout_pairs(held_y, classes, eval_per_class, pairs_per_kind,
                           seed)
    sims = np.sum(emb[pairs[:, 0]] * emb[pairs[:, 1]], axis=1)
    return kfold_verification(sims, pairs[:, 2])


def _write_benchmark_dir(root, held_x, held_y, classes, eval_per_class,
                         pairs_per_kind, seed):
    """The held-out pairs as a <root>/heldout/{pair.list,imgs} benchmark,
    so the in-training PeriodicEvalHook (`train --eval-every`) evaluates
    the same protocol as verify()."""
    import os

    from PIL import Image

    pairs = _heldout_pairs(held_y, classes, eval_per_class, pairs_per_kind,
                           seed)
    bench = os.path.join(root, "heldout")
    imgs = os.path.join(bench, "imgs")
    os.makedirs(imgs, exist_ok=True)
    for i in sorted({int(v) for v in pairs[:, :2].ravel()}):
        Image.fromarray(held_x[i]).save(os.path.join(imgs, f"{i}.jpg"),
                                        quality=95)
    with open(os.path.join(bench, "pair.list"), "w") as f:
        for a, b, label in pairs:
            f.write(f"{a} {b} {label}\n")
    return root


def run_stage(args, classes, epochs, lr, seed, warm_start=None,
              stage="train"):
    """Train one stage on `classes` synthetic identities and print its
    JSON line; returns (the FitResult, the line's dict)."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit

    train_x, train_y, held_x, held_y = build_split(
        classes, args.train_per_class, args.eval_per_class,
        args.image_size, seed, args.noise)
    cfg = cfg_lib.TrainConfig(
        backbone=args.backbone, head=args.head, num_classes=classes,
        batch_size=args.batch, epochs=epochs,
        print_freq=args.print_freq, bn_dtype=args.bn_dtype,
        scan_steps=args.scan_steps, partial_fc=args.partial_fc,
        model_ema=args.model_ema,
        optimizer=cfg_lib.OptimizerConfig(
            name=args.optimizer, learning_rate=lr,
            weight_decay=args.weight_decay),
        schedule=cfg_lib.ScheduleConfig(
            name=args.scheduler, warmup_epochs=args.warmup_epochs),
        data=cfg_lib.DataConfig(image_size=args.image_size))
    head_cfg = None
    if args.head_arg:
        head_kw = cfg_lib.parse_head_overrides(args.head, args.head_arg)
        head_cfg = cfg_lib.make_head_config(args.head, num_classes=classes,
                                            **head_kw)
    loader = ArrayLoader(train_x, train_y, batch_size=args.batch, seed=seed)
    hook = None
    if args.eval_every > 0:
        import tempfile

        from face_recognition_models_tpu_torch.evaluation.periodic import (
            PeriodicEvalHook)
        from face_recognition_models_tpu_torch.models import get_backbone

        root = _write_benchmark_dir(
            tempfile.mkdtemp(prefix="convbench_"), held_x, held_y, classes,
            args.eval_per_class, args.pairs_per_kind, seed)
        hook = PeriodicEvalHook(
            get_backbone(args.backbone, bn_dtype=getattr(torch,
                                                         args.bn_dtype),
                         image_size=args.image_size),
            root, ["heldout"], every=args.eval_every,
            image_size=args.image_size, batch_size=args.batch,
            total_epochs=epochs, use_ema=args.model_ema > 0.0,
            verbose=True, device=args.device)
    t0 = time.time()
    result = fit(cfg, loader, device=args.device, hooks=hook,
                 head_cfg=head_cfg, warm_start=warm_start)
    train_s = time.time() - t0

    res = verify(result, held_x, held_y, classes, args.eval_per_class,
                 args.pairs_per_kind, args.batch, seed, device=args.device)
    line = {
        "metric": "synthetic_verification", "stage": stage,
        "head": args.head, "backbone": args.backbone,
        "classes": classes, "batch": args.batch, "epochs": epochs,
        "lr": lr, "optimizer": args.optimizer,
        "scheduler": args.scheduler, "partial_fc": args.partial_fc,
        "bn_dtype": args.bn_dtype, "model_ema": args.model_ema,
        **({"head_args": list(args.head_arg)} if args.head_arg else {}),
        "warm_started": warm_start is not None,
        "mean_accuracy": round(res.mean_accuracy, 3),
        "std_accuracy": round(res.std_accuracy, 3),
        "mean_auc": round(res.mean_auc, 5),
        "min_train_loss": round(result.min_train_loss, 4),
        "train_seconds": round(train_s, 1),
        **({"eval_every": args.eval_every,
            "val_curve": [round(r["heldout"].mean_accuracy, 3)
                          for _, r in hook.history],
            "best_val_acc": round(hook.best_acc, 3),
            "best_val_epoch": hook.best_epoch} if hook else {}),
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
    ap.add_argument("--head", default="arcface")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--scheduler", default="customstep")
    ap.add_argument("--warmup-epochs", type=int, default=1)
    ap.add_argument("--scan-steps", type=int, default=8)
    ap.add_argument("--bn-dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--partial-fc", type=float, default=0.0,
                    help="Partial-FC sample ratio (train --partial-fc; 0 = "
                    "dense)")
    ap.add_argument("--model-ema", type=float, default=0.0)
    ap.add_argument("--pairs-per-kind", type=int, default=1000)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run the held-out verification during training "
                    "every N epochs through PeriodicEvalHook (the `train "
                    "--eval-every` path); reports the per-epoch curve and "
                    "the best epoch's accuracy")
    ap.add_argument("--head-arg", action="append", default=[],
                    help="head hyperparameter override key=value "
                    "(repeatable; as `train --head-arg`)")
    ap.add_argument("--print-freq", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a dry run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--finetune-classes", type=int, default=0,
                    help="two-stage: fine-tune the stage-1 backbone on a "
                    "DISJOINT identity set of this size (fresh head)")
    ap.add_argument("--finetune-epochs", type=int, default=None)
    ap.add_argument("--finetune-lr", type=float, default=0.02,
                    help="fine-tune stage lr (the reference fine-tunes at a "
                    "lower lr than from scratch)")
    ap.add_argument("--save-backbone", default=None,
                    help="torch.save the stage-1 backbone state_dict here, "
                    "so a failed fine-tune stage can restart from it")
    ap.add_argument("--load-backbone", default=None,
                    help="skip stage 1: load a --save-backbone file and go "
                    "straight to the fine-tune stage")
    return ap


def main(argv=None) -> int:
    import torch

    args = parser().parse_args(argv)
    if args.load_backbone:
        warm = torch.load(args.load_backbone, map_location="cpu",
                          weights_only=True)
    else:
        result, _ = run_stage(args, args.classes, args.epochs, args.lr,
                              args.seed,
                              stage="pretrain" if args.finetune_classes
                              else "train")
        warm = {k: v.detach().cpu().clone()
                for k, v in result.state.backbone.state_dict().items()}
        if args.save_backbone:
            torch.save(warm, args.save_backbone)
        del result

    if args.finetune_classes:
        run_stage(args, args.finetune_classes,
                  args.finetune_epochs or args.epochs, args.finetune_lr,
                  args.seed + 10_000, warm_start=warm, stage="finetune")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
