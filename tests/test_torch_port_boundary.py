"""The port's boundary: it imports neither JAX nor the JAX package, its entry
points refuse to run without a card unless asked for the CPU, and its CLI
trains end to end on the CPU."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    import face_recognition_models_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")
             if not m.name.endswith("__main__")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    banned = ("jax", "jaxlib", "flax", "optax")
    bad = [m for m in sys.modules
           if m.split(".")[0] in banned
           or m.split(".")[0] == "face_recognition_models_tpu"]
    print(len(names), ",".join(sorted(bad)))
""")


def _run(args, **kw):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_port_imports_no_jax_and_no_jax_package():
    proc = _run([sys.executable, "-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    count, _, bad = proc.stdout.strip().partition(" ")
    assert int(count) >= 25, "walked too few modules of the port"
    assert bad == "", f"the port pulled in {bad}"


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.step import (
        make_eval_step, make_train_step)

    cfg = cfg_lib.TrainConfig(num_classes=4, batch_size=2, epochs=1)
    head_cfg = cfg_lib.make_head_config("arcface", num_classes=4)
    loader = ArrayLoader(np.zeros((2, 16, 16, 3), np.uint8),
                         np.zeros(2, np.int32), batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(cfg, loader)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(get_head("arcface"), head_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(get_backbone("resnet18"))
    proc = _run([sys.executable, "-m", "face_recognition_models_tpu_torch.cli",
                 "train", "--synthetic", "--synthetic-classes", "2",
                 "--synthetic-per-class", "2", "--batch_size", "4",
                 "--epochs", "1", "--image-size", "16",
                 "--working-path", str(tmp_path / "work")])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_cli_train_synthetic_on_cpu(tmp_path):
    proc = _run([sys.executable, "-m", "face_recognition_models_tpu_torch.cli",
                 "train", "--synthetic", "--backbone", "resnet18",
                 "--synthetic-classes", "8", "--synthetic-per-class", "2",
                 "--batch_size", "16", "--epochs", "1", "--image-size", "32",
                 "--print_freq", "1", "--device", "cpu",
                 "--working-path", str(tmp_path / "work")])
    assert proc.returncode == 0, proc.stderr
    losses = [float(x) for x in re.findall(r"\] loss (\S+)", proc.stdout)]
    assert len(losses) == 1 and np.isfinite(losses[0]), proc.stdout
    assert "min train loss" in proc.stdout
