"""End-to-end production walkthrough on synthetic data, on the PyTorch/CUDA
port: every stage a deployment runs, chained through the port's CLI entry
points (no real dataset needed):

  1. train   — margin-head training with in-training verification
               (--eval-every) and a best-by-verification artifact
  2. export  — self-contained serving artifact (a torch.export program)
  3. embed   — batch-embed a gallery tree to .npz (with quality scores)
  4. identify— 1:N identification probes-vs-gallery
  5. serve   — online HTTP micro-batching service (one request)

Every stage runs on the card unless `--device cpu` is given. Besides its
printed lines it writes `<workdir>/pipeline.json`: each stage's seconds and
the served probe's answer.

Usage:
    python examples/production_pipeline_torch.py [--workdir DIR] [--device cpu]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request

# run from a checkout: the repo root holds the port's package
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the demo's sizes (the JAX walkthrough's): 16 training images an identity
# at batch 16, 10 written copies an identity (8 gallery + 2 probes)
TRAIN_PER_CLASS = 16
BATCH = 16


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "face_pipeline_demo"))
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (default cuda)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from face_recognition_models_tpu_torch.cli.main import main as face
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities,
        write_identity_tree,
        write_pair_benchmark,
    )

    wd = args.workdir
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    s = args.image_size
    dev = ["--device", args.device]
    seconds = {}

    # --- data: a synthetic identity tree + a pair benchmark ---------------
    images, labels = synthetic_identities(args.classes, 10, image_size=s,
                                          seed=0, noise=12.0)
    gallery_dir = os.path.join(wd, "gallery")
    probe_dir = os.path.join(wd, "probes")
    # gallery = first 8 copies per identity, probes = the remaining 2
    keep = np.concatenate([np.flatnonzero(labels == c)[:8]
                           for c in range(args.classes)])
    probe = np.concatenate([np.flatnonzero(labels == c)[8:]
                            for c in range(args.classes)])
    write_identity_tree(gallery_dir, images[keep], labels[keep], split="")
    write_identity_tree(probe_dir, images[probe], labels[probe], split="")
    write_pair_benchmark(os.path.join(wd, "bench", "lfw"),
                         num_classes=4, pairs_per_kind=12, image_size=s)

    def stage(name, argv):
        t0 = time.perf_counter()
        rc = face(argv)
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"{name} exited {rc}")

    # --- 1. train with in-training verification ---------------------------
    print("\n=== 1. train (--eval-every) ===")
    stage("train", [
        "train", "--synthetic", "--synthetic-classes", str(args.classes),
        "--synthetic-per-class", str(TRAIN_PER_CLASS), "--image-size",
        str(s), "-bs", str(BATCH), "-e", str(args.epochs), "-lr", "0.02",
        "--head", "arcface", "--working-path", wd,
        "--eval-every", "1", "--eval-data-path", os.path.join(wd, "bench"),
        "--benchmarks", "lfw", "--print_freq", "1000", *dev])
    ckpt = os.path.join(wd, "checkpoints", "arcface")

    # --- 2. export a serving artifact --------------------------------------
    print("\n=== 2. export ===")
    artifact = os.path.join(wd, "embedder.frte")
    stage("export", ["export", "--checkpoint-dir", ckpt,
                     "--backbone", "resnet18", "--which", "best_acc",
                     "--image-size", str(s), "--output", artifact, *dev])

    # --- 3. embed gallery + probes -----------------------------------------
    print("\n=== 3. embed ===")
    gal_npz = os.path.join(wd, "gallery.npz")
    probe_npz = os.path.join(wd, "probes.npz")
    for name, src, dst in (("embed_gallery", gallery_dir, gal_npz),
                           ("embed_probes", probe_dir, probe_npz)):
        stage(name, ["embed", "--input", src, "--output", dst,
                     "--model", artifact, "--batch-size", "32",
                     "--num-workers", "2", *dev])

    # --- 4. 1:N identification ---------------------------------------------
    print("\n=== 4. identify ===")
    stage("identify", ["identify", "--gallery", gal_npz, "--probes",
                       probe_npz, "--ranks", "1,5", *dev])

    # --- 5. online serving --------------------------------------------------
    print("\n=== 5. serve (one request) ===")
    from face_recognition_models_tpu_torch.serving.export import (
        load_embedder)
    from face_recognition_models_tpu_torch.serving.server import (
        EmbedService,
        make_server,
    )
    t0 = time.perf_counter()
    art = load_embedder(artifact, device=args.device)
    service = EmbedService(art.fn, art.image_size, batch_size=4,
                           max_wait_ms=2.0, gallery_path=gal_npz)
    server = make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    probe_img = sorted(os.path.join(r, f) for r, _, fs in os.walk(probe_dir)
                       for f in fs)[0]
    with open(probe_img, "rb") as f:
        req = urllib.request.Request(url + "/identify?top_k=3",
                                     data=f.read(), method="POST")
    try:
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    seconds["serve"] = time.perf_counter() - t0
    print(f"probe {os.path.relpath(probe_img, wd)} -> top match "
          f"{out['matches'][0]['path']} (score "
          f"{out['matches'][0]['score']:.4f}, quality "
          f"{out['quality']:.3f})")
    with open(os.path.join(wd, "pipeline.json"), "w") as f:
        json.dump({"seconds": seconds, "artifact": artifact,
                   "gallery": gal_npz, "probes": probe_npz,
                   "probe": os.path.relpath(probe_img, probe_dir),
                   "matches": out["matches"], "quality": out["quality"],
                   "norm": out["norm"]}, f, indent=1)
    print("\npipeline complete:", wd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
