"""Model validation on the PyTorch/CUDA port: load a trained checkpoint's
`*_final` backbone, tune the verification threshold, and run the 10-fold
protocol on one benchmark. On the card unless `--device cpu` is given.

Usage:
    python examples/validate_model_torch.py \\
        --checkpoint-dir work/checkpoints/arcface --backbone resnet18 \\
        --bench-root /data/face_evaluation_data/lfw [--device cpu]
"""

import argparse
import os
import sys

# run from a checkout: the repo root holds the port's package
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--backbone", default="resnet18")
    ap.add_argument("--bench-root", required=True)
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def validate(args):
    """The `*_final` backbone of `args.checkpoint_dir` through the 10-fold
    protocol on `args.bench_root`; returns the VerificationResult."""
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.evaluation.batch_eval import (
        evaluate_model_on_benchmark,
        make_embed_fn,
    )
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.utils.device import resolve_device

    finals = sorted(d for d in os.listdir(args.checkpoint_dir)
                    if d.endswith("_final"))
    if not finals:
        raise SystemExit(f"no *_final checkpoint in {args.checkpoint_dir}")
    mgr = CheckpointManager(args.checkpoint_dir, finals[0][:-len("_final")])
    state_dict = mgr.restore_final()
    model = get_backbone(args.backbone, image_size=args.image_size)
    model.load_state_dict(state_dict, strict=True)
    device = resolve_device(args.device)
    embed = make_embed_fn(to_device(model, device), device=device)
    bench_parent, bench_name = os.path.split(args.bench_root.rstrip("/"))
    return evaluate_model_on_benchmark(embed, bench_parent, bench_name,
                                       args.image_size, args.batch_size)


def main(argv=None) -> int:
    res = validate(parser().parse_args(argv))
    print(res)
    print("fold thresholds:", [f"{t:.4f}" for t in res.fold_thresholds])
    return 0


if __name__ == "__main__":
    sys.exit(main())
