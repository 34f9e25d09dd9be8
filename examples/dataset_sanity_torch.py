"""Dataset sanity checks on the PyTorch/CUDA port's data layer: image
counts per identity, pair-file <-> file-existence validation, unique
image-size audit, pair-field stats. Text only, the same lines as
examples/dataset_sanity.py.

Usage:
    python examples/dataset_sanity_torch.py \\
        --dataset-path /data/CASIA-WebFace \\
        [--eval-path /data/face_evaluation_data/lfw]
"""

import argparse
import collections
import os
import sys

# run from a checkout: the repo root holds the port's package
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def check_identity_tree(root: str):
    from face_recognition_models_tpu_torch.data import ImageFolderIndex

    for split in ("train", "valid", None):
        try:
            idx = ImageFolderIndex.build(root, split=split)
        except FileNotFoundError:
            continue
        counts = collections.Counter(lab for _, lab in idx.samples)
        print(f"[{split or 'flat'}] {idx.num_identities} identities, "
              f"{len(idx)} images; per-identity min={min(counts.values())} "
              f"max={max(counts.values())}")


def check_pair_benchmark(bench_root: str):
    from PIL import Image

    from face_recognition_models_tpu_torch.data.pairs import load_pair_list

    pairs = load_pair_list(os.path.join(bench_root, "pair.list"))
    imgs = os.path.join(bench_root, "imgs")
    missing, sizes = 0, collections.Counter()
    for img_id in sorted({int(x) for x in pairs[:, :2].ravel()}):
        p = os.path.join(imgs, f"{img_id}.jpg")
        if not os.path.exists(p):
            missing += 1
            continue
        with Image.open(p) as im:
            sizes[im.size] += 1
    pos = int((pairs[:, 2] == 1).sum())
    print(f"{len(pairs)} pairs ({pos} pos / {len(pairs) - pos} neg), "
          f"{missing} missing images, sizes: {dict(sizes)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-path")
    ap.add_argument("--eval-path")
    args = ap.parse_args(argv)
    if args.dataset_path:
        check_identity_tree(args.dataset_path)
    if args.eval_path:
        check_pair_benchmark(args.eval_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
