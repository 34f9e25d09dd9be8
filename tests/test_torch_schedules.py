"""The port's lr schedules (train/schedules.py) against the JAX package's
`get_schedule`: each of the seven at every step count from 0 to past its
last boundary, the numeric ids, the JAX errors, and `train --scheduler NAME`
reaching each one.

A port schedule takes the count as a 0-d int64 tensor and returns a 0-d
float32 tensor on the count's device; JAX traces its schedule in float32
too. Tolerance rtol 1e-6 (the two libraries' float32 pow and cos).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.train.schedules import (
    get_schedule as jget_schedule)
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.cli.main import main
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train.schedules import (
    SCHEDULER_DICT,
    SCHEDULES,
    get_schedule,
)
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

LR = 0.1
STEPS_PER_EPOCH = 3
EPOCHS = 12
# every knob off its default, so a field that does not reach the schedule
# shows
KNOBS = dict(steps=(1, 2, 4), ratio=0.2, step_size=2, gamma=0.5,
             milestones=(3, 5, 9), eta_min=0.001, warmup_epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(name):
    jsched = jget_schedule(jcfg.ScheduleConfig(name=name, **KNOBS), LR,
                           STEPS_PER_EPOCH, EPOCHS)
    tsched = get_schedule(tcfg.ScheduleConfig(name=name, **KNOBS), LR,
                          STEPS_PER_EPOCH, EPOCHS)
    return jsched, tsched


def _jax_lr(jsched, count):
    # "none" is a constant lr in the JAX package
    return float(jsched(jnp.int32(count)) if callable(jsched) else jsched)


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_jax(name):
    jsched, tsched = _pair(name)
    counts = range(EPOCHS * STEPS_PER_EPOCH + 4)
    got = []
    for count in counts:
        lr = tsched(torch.tensor(count, dtype=torch.int64))
        assert lr.dtype == torch.float32 and lr.shape == ()
        got.append(float(lr))
    want = [_jax_lr(jsched, c) for c in counts]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the schedule moves where it should: not flat, except "none"
    assert (len(set(got)) == 1) == (name == "none")


@pytest.mark.parametrize("sid", sorted(SCHEDULER_DICT))
def test_numeric_ids_select_the_named_schedule(sid):
    by_id = get_schedule(tcfg.ScheduleConfig(name=sid, **KNOBS), LR,
                         STEPS_PER_EPOCH, EPOCHS)
    by_name = get_schedule(
        tcfg.ScheduleConfig(name=SCHEDULER_DICT[sid], **KNOBS), LR,
        STEPS_PER_EPOCH, EPOCHS)
    jsched = jget_schedule(jcfg.ScheduleConfig(name=sid, **KNOBS), LR,
                           STEPS_PER_EPOCH, EPOCHS)
    for count in range(0, EPOCHS * STEPS_PER_EPOCH, 5):
        c = torch.tensor(count)
        assert float(by_id(c)) == float(by_name(c))
        np.testing.assert_allclose(float(by_id(c)), _jax_lr(jsched, count),
                                   rtol=1e-6)


@pytest.mark.parametrize("cfg,num_epochs,match", [
    (dict(name=6), EPOCHS, "Invalid scheduler id: 6"),
    (dict(name="linear"), EPOCHS, "Unknown scheduler name: linear"),
    (dict(name="cosine"), None, "num_epochs must be provided for cosine"),
    (dict(name="warmup_cosine"), None,
     "num_epochs must be provided for warmup_cosine"),
], ids=["bad-id", "bad-name", "cosine-no-epochs", "warmup-no-epochs"])
def test_errors_match_jax(cfg, num_epochs, match):
    with pytest.raises(ValueError, match=match):
        jget_schedule(jcfg.ScheduleConfig(**cfg), LR, STEPS_PER_EPOCH,
                      num_epochs)
    with pytest.raises(ValueError, match=match):
        get_schedule(tcfg.ScheduleConfig(**cfg), LR, STEPS_PER_EPOCH,
                     num_epochs)


def test_schedule_reads_nothing_back_to_the_host(monkeypatch):
    """A schedule of a count tensor is tensor ops only: no .item(), no
    float() of the count, so a CUDA graph can hold it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the schedule read a tensor back to the host")

    for name in SCHEDULES:
        tsched = _pair(name)[1]
        count = torch.tensor(7)
        monkeypatch.setattr(torch.Tensor, "item", refuse)
        monkeypatch.setattr(torch.Tensor, "__float__", refuse)
        monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
        lr = tsched(count)
        monkeypatch.undo()
        assert isinstance(lr, torch.Tensor)


@pytest.mark.parametrize("name", SCHEDULES)
def test_train_scheduler_flag_reaches_each_schedule(tmp_path, name,
                                                    monkeypatch, capsys):
    """`train --scheduler NAME` builds that schedule for the run, with
    `fit`'s num_epochs and --warmup-epochs, and its steps log its lr (the
    metrics JSONL; the printed line has the JAX loop's columns, no lr)."""
    built = []

    def recording(cfg, learning_rate, steps_per_epoch, num_epochs=None,
                  device=None):
        sched = get_schedule(cfg, learning_rate, steps_per_epoch, num_epochs,
                             device)
        built.append((cfg, num_epochs, sched))
        return sched

    monkeypatch.setattr(loop, "get_schedule", recording)
    assert main(["train", "--synthetic", "--device", "cpu",
                 "--synthetic-classes", "4", "--synthetic-per-class", "2",
                 "--batch_size", "8", "--epochs", "2", "--image-size", "16",
                 "--print_freq", "1", "--scheduler", name,
                 "--warmup-epochs", "1",
                 "--working-path", str(tmp_path)]) == 0
    (cfg, num_epochs, sched), = built
    assert (cfg.name, cfg.warmup_epochs, num_epochs) == (name, 1, 2)
    # one step an epoch: the steps train at the lr of counts 0 and 1
    with open(tmp_path / "log" / "arcface.metrics.jsonl") as f:
        logged = [x for x in map(json.loads, f.read().splitlines())
                  if "lr" in x]
    assert [x["step"] for x in logged] == [1, 2]
    assert ([f"{x['lr']:.5f}" for x in logged]
            == [f"{float(sched(torch.tensor(c))):.5f}" for c in (0, 1)])
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Epoch")]
    assert len(printed) == 2
