"""The port's utilities against the JAX package's, on the CPU:
utils/logging.py (Tee, MetricTracker, TRAIN_COLUMNS), utils/experiment.py
(the JSONL of ExperimentLogger, and that of `fit` and of `train`),
utils/debug.py (`infer_and_compute_loss`, `--debug-nans`) and
utils/compile_cache.py (`--compile-cache DIR`).

`fit` runs in both packages on the tiny ResNet of
tests/test_torch_train_recipe.py (swapped in for get_backbone): their
weights differ, so the printed lines are compared column by column (the
labels and their order) and the JSONL lines key by key, step by step. The
debug helper's loss is compared on bridged weights at rtol 1e-5.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.data.pipeline import ArrayLoader as JLoader
from face_recognition_models_tpu.heads import get_head as jget_head
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu.train import loop as jloop
from face_recognition_models_tpu.train import state as jstate_mod
from face_recognition_models_tpu.utils import debug as jdebug
from face_recognition_models_tpu.utils import experiment as jexp
from face_recognition_models_tpu.utils import logging as jlog
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.cli.main import main as cli_main
from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
from face_recognition_models_tpu_torch.data.synthetic import (
    synthetic_identities,
)
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.native import fastdecode
from face_recognition_models_tpu_torch.ops import _build
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train import state as tstate_mod
from face_recognition_models_tpu_torch.utils import debug as tdebug
from face_recognition_models_tpu_torch.utils import experiment as texp
from face_recognition_models_tpu_torch.utils import logging as tlog
from face_recognition_models_tpu_torch.utils.weights import from_jax

from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, C, IMAGE = 32, 8, 16


# --- logging ----------------------------------------------------------------

def test_tee_fans_out_and_reports_fileno(tmp_path):
    a, b = io.StringIO(), io.StringIO()
    tee = tlog.Tee(a, b)
    with contextlib.redirect_stdout(tee):
        print("hello", end="")
    tee.flush()
    assert a.getvalue() == "hello" and b.getvalue() == "hello"
    assert tee.writable() and not tee.isatty()
    with pytest.raises(io.UnsupportedOperation):
        tee.fileno()   # StringIO has no fd
    path = tmp_path / "log.txt"
    with open(path, "w") as f:
        tee = tlog.Tee(io.StringIO(), f)
        assert tee.fileno() == f.fileno()
        with contextlib.redirect_stdout(tee):
            print("step 1")
    assert path.read_text() == "step 1\n"


def test_metric_tracker_line_matches_jax():
    assert tuple(tlog.TRAIN_COLUMNS) == tuple(jlog.TRAIN_COLUMNS)
    rs = np.random.RandomState(0)
    steps = [{"batch_time": rs.uniform(0, 2), "data_time": rs.uniform(),
              "throughput": rs.uniform(10, 9000)} for _ in range(4)]
    metrics = [{"loss": rs.uniform(0, 40), "loss_id": rs.uniform(0, 40),
                "loss_mag": rs.uniform(), "acc1": rs.uniform(0, 100),
                "acc5": rs.uniform(0, 100), "lr": 0.1,
                "feat_norm": rs.uniform(0, 50)} for _ in range(4)]
    metrics[2]["loss_kd"] = 0.25   # a column rendered once seen
    for total in (7, 100, 12345):
        t = tlog.MetricTracker(total, tlog.TRAIN_COLUMNS, prefix="Epoch: [2/30]")
        j = jlog.MetricTracker(total, jlog.TRAIN_COLUMNS,
                               prefix="Epoch: [2/30]")
        for k, (s, m) in enumerate(zip(steps, metrics)):
            for tracker in (t, j):
                tracker.observe(s)
                tracker.observe(m, weight=8 + k)
            assert t.line(k) == j.line(k)
        assert t.averages() == j.averages()
        assert t.average("never_seen") == 0.0


# --- experiment logger ------------------------------------------------------

def _jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines()]


def _drop_time(lines):
    return [{k: v for k, v in x.items() if k != "time"} for x in lines]


def test_experiment_logger_jsonl_matches_jax(tmp_path):
    runs = {}
    for name, mod in (("port", texp), ("jax", jexp)):
        logger = mod.ExperimentLogger("proj", "run1", config={"lr": 0.1},
                                      log_dir=str(tmp_path / name),
                                      use_wandb=False)
        logger.log({"loss": np.float32(1.5), "acc1": torch.tensor(3.0),
                    "epoch": 2}, step=7)
        logger.log({"val/lfw_acc": 99.5, "tag": "x"})
        art = tmp_path / name / "ckpt"
        art.write_bytes(b"0")
        logger.save_artifact(str(art))
        logger.finish()
        lines = _jsonl(tmp_path / name / "run1.metrics.jsonl")
        assert lines[-1]["path"] == str(art)
        runs[name] = _drop_time(lines[:-1]) + [
            {k: v for k, v in lines[-1].items() if k not in ("time", "path")}]
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == {"loss": 1.5, "acc1": 3.0, "epoch": 2.0,
                               "step": 7}


def _jget_backbone(name, embed_dim=D, dtype=jnp.float32, **kw):
    return JResNet(stage_sizes=(1, 1), block=JBasic, embed_dim=embed_dim,
                   num_filters=8, dtype=jnp.float32)


def _get_backbone(name="resnet18", embed_dim=D, dtype=torch.float32, **kw):
    return ResNet((1, 1), BasicBlock, embed_dim=embed_dim, num_filters=8,
                  dtype=torch.float32)


@pytest.fixture(scope="module")
def fit_logs(tmp_path_factory):
    """{package: (stdout, JSONL lines)} of a 2-epoch fit (3 steps an
    epoch, print_freq 2) of the tiny ResNet + ArcFace with a logger."""
    images, labels = synthetic_identities(4, 6, image_size=IMAGE, seed=0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstate_mod, "get_backbone", _jget_backbone)
        mp.setattr(tstate_mod, "get_backbone", _get_backbone)
        mp.setattr(loop, "get_backbone", _get_backbone)
        for name in ("port", "jax"):
            d = tmp_path_factory.mktemp(f"fit_{name}")
            cfg_lib = tcfg if name == "port" else jcfg
            cfg = cfg_lib.TrainConfig(num_classes=4, batch_size=8, epochs=2,
                                      print_freq=2, data=cfg_lib.DataConfig(
                                          image_size=IMAGE))
            head_cfg = cfg_lib.make_head_config("arcface", feature_dim=D,
                                                num_classes=4)
            mod = texp if name == "port" else jexp
            logger = mod.ExperimentLogger("proj", "arcface",
                                          log_dir=str(d), use_wandb=False)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if name == "port":
                    loop.fit(cfg, ArrayLoader(images, labels, batch_size=8,
                                              seed=0), logger=logger,
                             device="cpu", head_cfg=head_cfg)
                else:
                    jloop.fit(cfg, JLoader(images, labels, batch_size=8,
                                           seed=0), logger=logger,
                              head_cfg=head_cfg)
            logger.finish()
            out[name] = (buf.getvalue(),
                         _jsonl(os.path.join(d, "arcface.metrics.jsonl")))
    return out


def _columns(line):
    """The line's prefix and labels, the numbers dropped."""
    parts = line.split("\t")
    return [parts[0]] + [p.split(" ")[0] for p in parts[1:]]


def test_fit_prints_the_jax_line(fit_logs):
    lines = {k: [x for x in out.splitlines() if x.startswith("Epoch")]
             for k, (out, _) in fit_logs.items()}
    assert len(lines["port"]) == len(lines["jax"]) == 4
    assert ([_columns(x) for x in lines["port"]]
            == [_columns(x) for x in lines["jax"]])
    assert lines["port"][1].startswith("Epoch: [1/2][2/3]\tTime ")
    assert _columns(lines["port"][0])[1:] == [
        "Time", "Data", "img/s", "Loss", "L_ID", "L_mag", "Acc@1", "Acc@5"]


def test_fit_logs_the_jax_keys_and_steps(fit_logs):
    port, jax_ = fit_logs["port"][1], fit_logs["jax"][1]
    assert [x.get("event") for x in port] == [x.get("event") for x in jax_]
    assert port[0].keys() == jax_[0].keys()
    metric = [(sorted(x), x["step"], x["epoch"]) for x in port[1:]]
    assert metric == [(sorted(x), x["step"], x["epoch"]) for x in jax_[1:]]
    assert [m[1:] for m in metric] == [(1, 1.0), (3, 1.0), (4, 2.0),
                                       (6, 2.0)]


def test_train_cli_writes_the_metrics_jsonl(fit_logs, tmp_path):
    rc = cli_main(["train", "--synthetic", "--device", "cpu",
                   "--synthetic-classes", "4", "--synthetic-per-class", "4",
                   "--batch_size", "8", "--epochs", "1", "--image-size",
                   "16", "--print_freq", "1", "--working-path",
                   str(tmp_path), "--wandb-project", "proj-x"])
    assert rc == 0
    lines = _jsonl(tmp_path / "log" / "arcface.metrics.jsonl")
    init, steps, arts = lines[0], lines[1:3], lines[3:]
    assert init["event"] == "init" and init["project"] == "proj-x"
    assert init["config"]["wandb_project"] == "proj-x"
    jkeys = sorted(fit_logs["jax"][1][1])
    assert [sorted(x) for x in steps] == [jkeys, jkeys]
    assert [x["step"] for x in steps] == [1, 2]
    assert [os.path.basename(x["path"]) for x in arts] == ["arcface_final",
                                                           "min_loss"]
    with open(tmp_path / "log" / "arcface.txt") as f:
        assert "Epoch: [1/1][1/2]\tTime" in f.read()


def test_use_pallas_head_is_head_path_fused(tmp_path, capsys):
    args = ["train", "--synthetic", "--device", "cpu", "--synthetic-classes",
            "4", "--synthetic-per-class", "2", "--batch_size", "8",
            "--epochs", "1", "--image-size", "16", "--working-path",
            str(tmp_path)]
    assert cli_main(args + ["--head", "adacos", "--use-pallas-head"]) == 2
    assert "adacos" in capsys.readouterr().err
    assert cli_main(args + ["--use-pallas-head"]) == 0
    assert "(resnet18, fused head)" in capsys.readouterr().out


# --- debug ------------------------------------------------------------------

def test_infer_and_compute_loss_matches_jax(capsys):
    jmodel = JResNet(stage_sizes=(1,), block=JBasic, embed_dim=16,
                     num_filters=8, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            train=False)
    jcfg_ = jcfg.make_head_config("arcface", feature_dim=16, num_classes=5)
    kernel = jget_head("arcface").init_kernel(jax.random.PRNGKey(1), jcfg_)
    images = np.random.RandomState(0).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)
    labels = np.asarray([0, 1, 2, 3])
    want = jdebug.infer_and_compute_loss(
        jmodel, jget_head("arcface"), jcfg_, variables, kernel,
        jnp.asarray(images), jnp.asarray(labels))
    model = ResNet((1,), BasicBlock, embed_dim=16, num_filters=8,
                   dtype=torch.float32)
    sd, _ = from_jax(jax.tree.map(np.asarray, variables["params"]),
                     jax.tree.map(np.asarray, variables["batch_stats"]))
    model.load_state_dict(sd)
    got = tdebug.infer_and_compute_loss(
        model, get_head("arcface"),
        tcfg.make_head_config("arcface", feature_dim=16, num_classes=5),
        torch.from_numpy(np.asarray(kernel)), torch.from_numpy(images),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[debug] feats (4, 16) norm_mean=")
    assert out[1].startswith("[debug] feats (4, 16) norm_mean=")


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


def test_nan_checks_name_the_module_and_are_removable():
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), _Log())
    # fixed weights: each output is the row mean, so at x - 100 every log
    # is NaN whatever the process's global generator did before this test
    # (Linear's default init draws from it)
    with torch.no_grad():
        model[0].weight.fill_(1.0 / 3.0)
        model[0].bias.zero_()
    x = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    checks = tdebug.enable_nan_checks()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="_Log"):
            model(x - 100.0)
        w = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(w) * 0.0).sum().backward()   # 0 * inf in backward
        model[0](x).sum().backward()                  # finite: no error
    finally:
        checks.remove()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(model(x - 100.0)).any()        # unchecked again


def test_debug_nans_cli_raises_on_a_planted_nan(tmp_path, capsys):
    """A NaN learning rate makes every weight NaN at the first update; the
    second step's first module output is NaN and raises, naming it."""
    args = ["--debug-nans", "train", "--synthetic", "--device", "cpu",
            "--synthetic-classes", "4", "--synthetic-per-class", "4",
            "--batch_size", "8", "--epochs", "1", "--image-size", "16",
            "--working-path", str(tmp_path)]
    with pytest.raises(FloatingPointError, match="non-finite output of "
                                                 "Conv2d"):
        cli_main(args + ["--learning_rate", "nan"])
    assert not torch.is_anomaly_enabled()   # the checks end with main
    assert cli_main(args + ["--scan-steps", "2"]) == 2
    assert "--scan-steps" in capsys.readouterr().err
    assert cli_main(args) == 0


# --- compile cache ----------------------------------------------------------

_FAKE_NVCC = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"built")
"""


def test_compile_cache_builds_into_dir_and_reuses(tmp_path, monkeypatch):
    """`--compile-cache DIR` roots the kernels' build at DIR/kernels and the
    native decoder's at DIR/native; a library built there (here by a
    stand-in nvcc that logs its calls) is reused by a later build in this
    process and in another one given the same DIR, with no compiler run."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(fastdecode, "BUILD_DIR", fastdecode.BUILD_DIR)
    bindir, log = tmp_path / "bin", tmp_path / "nvcc.log"
    bindir.mkdir()
    (bindir / "nvcc").write_text(_FAKE_NVCC.format(python=sys.executable,
                                                   log=str(log)))
    (bindir / "nvcc").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    cache = tmp_path / "cache"
    assert cli_main(["--compile-cache", str(cache), "list"]) == 0
    assert _build.BUILD_DIR == cache / "kernels"
    assert fastdecode.BUILD_DIR == cache / "native"
    assert fastdecode.library_path().parent == cache / "native"
    _build.build(["conv3x3"])
    lib = _build.library_path("conv3x3")
    assert lib.parent == cache / "kernels" and lib.read_bytes() == b"built"
    assert len(log.read_text().splitlines()) == 1
    _build.build(["conv3x3"])
    script = ("import sys; from face_recognition_models_tpu_torch.utils."
              "compile_cache import enable_compilation_cache as e; "
              "from face_recognition_models_tpu_torch.ops import _build; "
              "e(sys.argv[1]); _build.build(['conv3x3']); "
              "print(_build.library_path('conv3x3'))")
    proc = subprocess.run([sys.executable, "-c", script, str(cache)],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(lib)
    assert len(log.read_text().splitlines()) == 1
