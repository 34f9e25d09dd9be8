"""The port's CLI under `--multihost`, launched as torchrun launches it: one
process a rank with RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT in its environment, gloo on the CPU (`--device cpu`).

- `train --mesh-model 2` in a world of 4 (a 2 x 2 mesh) for one epoch:
  every rank exits 0 with the same global losses, rank 0 alone prints,
  writes the log, the one epoch checkpoint, min_loss and the final
  artifact, and the epoch checkpoint holds the whole [D, C] kernel.
- `train --mesh-model 2 --head-path eager` in a world of 4: the eager head
  on each rank's class shard; the ranks' losses equal, and the first step's
  loss that of the same command in one process (the same global batch and
  weights) at 1e-4 relative.
- `facenet --use-mesh` in a world of 2 trains and writes its final
  artifact.

Each rank runs the CLI's `main` through a small wrapper that prints the
losses `fit` returns (the ranks other than 0 print nothing of their own).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_mesh_world import ROOT, free_port
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

_WRAPPER = """
import json, sys
import face_recognition_models_tpu_torch.train.loop as loop
import face_recognition_models_tpu_torch.triplet as triplet
from face_recognition_models_tpu_torch.cli.main import main
seen = []
def spy(module, name):
    orig = getattr(module, name)
    def call(*a, **k):
        result = orig(*a, **k)
        seen.append(result.losses)
        return result
    setattr(module, name, call)
spy(loop, "fit")
spy(triplet, "train_facenet")
rc = main(sys.argv[1:])
print("LOSSES " + json.dumps(seen))
sys.exit(rc)
"""


def _launch(world, argv, timeout=240):
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WRAPPER, "--multihost", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out}\n{err}"
    return [out for _, out, _ in outs]


def _losses(out):
    line = [x for x in out.splitlines() if x.startswith("LOSSES ")][-1]
    return json.loads(line[len("LOSSES "):])


def test_train_multihost_mesh_model_2(tmp_path):
    work = tmp_path / "w"
    outs = _launch(4, [
        "train", "--synthetic", "--device", "cpu", "--mesh-model", "2",
        "--synthetic-classes", "8", "--synthetic-per-class", "4",
        "--batch_size", "8", "--epochs", "1", "--image-size", "16",
        "--print_freq", "1", "--working-path", str(work)])
    losses = [_losses(o) for o in outs]
    assert len(losses[0][0]) == 4           # 32 images, global batch 8
    assert all(x == losses[0] for x in losses)
    assert "mesh 2x2 (data x model)" in outs[0]
    assert "Epoch: [1/1][3/4]" in outs[0]
    for o in outs[1:]:
        assert "Epoch:" not in o and "Training" not in o
    ckpt = work / "checkpoints" / "arcface"
    assert sorted(os.listdir(ckpt)) == ["arcface_final", "epoch_1",
                                        "min_loss"]
    saved = torch.load(ckpt / "epoch_1", map_location="cpu",
                       weights_only=True)
    assert saved["state"]["kernel_w"].shape == (512, 8)
    assert saved["epoch"] == 1
    # rank 0's log and metrics alone
    assert sorted(os.listdir(work / "log")) == ["arcface.metrics.jsonl",
                                                "arcface.txt"]


def test_train_multihost_eager_head_mesh_model_2(tmp_path):
    argv = ["train", "--synthetic", "--device", "cpu", "--head-path",
            "eager", "--synthetic-classes", "8", "--synthetic-per-class",
            "4", "--batch_size", "8", "--epochs", "1", "--image-size", "16",
            "--print_freq", "1"]
    outs = _launch(4, [*argv, "--mesh-model", "2", "--working-path",
                       str(tmp_path / "world")])
    one = subprocess.run(
        [sys.executable, "-c", _WRAPPER, *argv, "--working-path",
         str(tmp_path / "one")], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT),
        timeout=240)
    assert one.returncode == 0, one.stderr
    losses = [_losses(o) for o in outs]
    assert "mesh 2x2 (data x model)" in outs[0]
    assert all(x == losses[0] for x in losses)
    world, single = losses[0][0], _losses(one.stdout)[0]
    assert len(world) == len(single) == 4
    assert all(np.isfinite(world))
    assert abs(world[0] - single[0]) <= 1e-4 * abs(single[0]), (world,
                                                                single)
    saved = torch.load(tmp_path / "world" / "checkpoints" / "arcface"
                       / "epoch_1", map_location="cpu", weights_only=True)
    assert saved["state"]["kernel_w"].shape == (512, 8)


def test_facenet_use_mesh(tmp_path):
    work = tmp_path / "w"
    outs = _launch(2, [
        "facenet", "--use-mesh", "--synthetic", "--device", "cpu",
        "--backbone", "resnet18", "--p", "4", "--k", "2",
        "--synthetic-classes", "8", "--synthetic-per-class", "4",
        "--image-size", "16", "--epochs", "1", "--working-path",
        str(work)])
    losses = [_losses(o) for o in outs]
    assert losses[0] == losses[1] and len(losses[0][0]) > 0
    assert "final loss" in outs[0] and "final loss" not in outs[1]
    assert os.path.isfile(work / "checkpoints" / "facenet_resnet18"
                          / "facenet_resnet18_final")


@pytest.mark.parametrize("argv,message", [
    (["train", "--synthetic", "--device", "cpu", "--mesh-data", "3"],
     "Mesh 3x1 does not cover 2 devices"),
    (["train", "--synthetic", "--device", "cpu", "--batch_size", "7"],
     "batch_size 7 must divide across the mesh data axis (2)"),
])
def test_train_multihost_refusals(tmp_path, argv, message):
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "face_recognition_models_tpu_torch.cli",
         "--multihost", *argv, "--working-path", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                           WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                           PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode != 0
        assert message in err
