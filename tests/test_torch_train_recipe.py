"""The rest of the `train` recipe in the port's `fit` against the JAX
package's `fit`: gradient accumulation (K = 2 and 3, across a customstep lr
drop), the model EMA (with and without accumulation), the frozen trunk
(SGD and AdamW; QAFace's second view), distillation (cosine and mse, an
in-memory teacher), AdamW with clipping, and the four augmentations (the
port's draws replaced by JAX's own draws of each step, so both apply the
same flips, offsets, jitters and boxes). Also `fit`'s errors and a resumed
run against an uninterrupted one.

Both run the tiny ResNet of tests/test_torch_train_step.py (one BasicBlock
in each of two stages, 8 filters; `get_backbone` is replaced by it in both
packages, the teacher's too) at 16 px in fp32, D = 32, C = 8, batch 8, 2
epochs of 3 fixed batches, from the same weights (the JAX state's, carried
into the port's by utils/weights.from_jax). JAX runs its jnp head (the CPU path of
`use_pallas_head='auto'`), the port its fused head's plain versions. Bounds
are those of tests/test_torch_train_step.py: per-step loss 1e-4 relative,
the final parameters, BatchNorm buffers, EMA and head state rtol 5e-3 atol
2e-3; the per-step lr rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from face_recognition_models_tpu import config as jcfg
from face_recognition_models_tpu.models.resnet import BasicBlock as JBasic
from face_recognition_models_tpu.models.resnet import ResNet as JResNet
from face_recognition_models_tpu.train import loop as jloop
from face_recognition_models_tpu.train import state as jstate_mod
from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.ops import image_ops
from face_recognition_models_tpu_torch.train import loop
from face_recognition_models_tpu_torch.train import state as tstate_mod
from face_recognition_models_tpu_torch.train.state import state_tensors
from face_recognition_models_tpu_torch.utils.weights import (
    from_jax,
    head_state_from_jax,
)
from torch_backbone_parity import _free_disk  # noqa: F401  (fixture)

N, D, C, IMAGE = 8, 32, 8, 16
STEPS_PER_EPOCH, EPOCHS = 3, 2
TOL = {"rtol": 5e-3, "atol": 2e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jget_backbone(name, embed_dim=D, dtype=jnp.float32, **kw):
    return JResNet(stage_sizes=(1, 1), block=JBasic, embed_dim=embed_dim,
                   num_filters=8, dtype=jnp.float32)


def get_backbone(name="resnet18", embed_dim=D, dtype=torch.float32, **kw):
    return ResNet((1, 1), BasicBlock, embed_dim=embed_dim, num_filters=8,
                  dtype=torch.float32)


@pytest.fixture(autouse=True)
def _tiny_backbones(monkeypatch):
    monkeypatch.setattr(jstate_mod, "get_backbone", jget_backbone)
    monkeypatch.setattr(tstate_mod, "get_backbone", get_backbone)
    monkeypatch.setattr(loop, "get_backbone", get_backbone)


class ListLoader:
    """The same fixed batches every epoch."""

    def __init__(self, seed=3):
        rs = np.random.RandomState(seed)
        self.batches = [(rs.randint(0, 256, (N, IMAGE, IMAGE, 3), np.uint8),
                         rs.randint(0, C, N).astype(np.int32))
                        for _ in range(STEPS_PER_EPOCH)]

    def steps_per_epoch(self):
        return STEPS_PER_EPOCH

    def epoch(self, i):
        return iter(self.batches)


def _optimizer(lib, name, clip):
    lr = 0.01 if name == "sgd" else 0.001
    return lib.OptimizerConfig(name=name, learning_rate=lr,
                               clip_grad_norm=clip)


def _configs(head="arcface", optimizer="sgd", clip=0.0, distill=None,
             augment=False, **kw):
    """(JAX TrainConfig, port TrainConfig) of one recipe."""
    data = dict(image_size=IMAGE)
    if augment:
        data.update(horizontal_flip=True, crop_pad=3, color_jitter=0.3,
                    random_erasing=0.5)
    out = []
    for lib in (jcfg, tcfg):
        extra = {"use_pallas_head": False} if lib is jcfg else {}
        out.append(lib.TrainConfig(
            backbone="resnet18", head=head, num_classes=C, batch_size=N,
            epochs=EPOCHS, print_freq=1, seed=0, compute_dtype="float32",
            optimizer=_optimizer(lib, optimizer, clip),
            schedule=lib.ScheduleConfig(name="customstep", steps=(1,)),
            data=lib.DataConfig(**data),
            distill=lib.DistillConfig(**(distill or {})), **extra, **kw))
    return out


def _head_cfgs(head):
    # QAFace at its default delta: with the memory active from step 1 the
    # two fp32 programs part by 1e-4 within 3 steps, frozen trunk or not
    return (jcfg.make_head_config(head, feature_dim=D, num_classes=C),
            tcfg.make_head_config(head, feature_dim=D, num_classes=C))


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


class Recorder:
    """A JAX logger that keeps each step's metrics."""

    def __init__(self):
        self.steps = []

    def log(self, metrics, step):
        self.steps.append(metrics)


def _teachers(embed_dim=D):
    """(JAX triple, port module) of one seeded fp32 resnet18 teacher."""
    module = jget_backbone("resnet18", embed_dim=embed_dim,
                           dtype=jnp.float32)
    tv = module.init(jax.random.PRNGKey(7),
                     jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)
    sd, _ = from_jax({"backbone": _host(tv["params"]),
                      "kernel_w": np.zeros((embed_dim, 1), np.float32)},
                     _host(tv["batch_stats"]))
    teacher = get_backbone(embed_dim=embed_dim)
    teacher.load_state_dict(sd)
    return (module, tv["params"], tv["batch_stats"]), teacher


def _jax_draws(seed, steps, cfg):
    """Each step's augmentation parameters as the JAX step draws them: its
    flip key is the 4th of split(state.rng, 4), the state's key starts as
    the 3rd of split(PRNGKey(seed), 3), and apply_augmentations splits the
    flip key in 4 (ops/image_ops.py)."""
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    data, out = cfg.data, []
    h = w = IMAGE
    for _ in range(steps):
        key, _, _, flip_key = jax.random.split(key, 4)
        k1, k2, k3, k4 = jax.random.split(flip_key, 4)
        ky, kx = jax.random.split(k2)
        kb, kc = jax.random.split(k3)
        s, pad = data.color_jitter, data.crop_pad
        karea, kaspect, ky0, kx0, kp = jax.random.split(k4, 5)
        area = jax.random.uniform(karea, (N,), jnp.float32, 0.02, 0.2) * (
            h * w)
        aspect = jnp.exp(jax.random.uniform(kaspect, (N,), jnp.float32,
                                            -1.204, 1.204))
        eh = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, h)
        ew = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, w)
        draw = {
            "flip": (jax.random.bernoulli(k1, 0.5, (N, 1, 1, 1)).reshape(N),),
            "shift": (jax.random.randint(ky, (N,), -pad, pad + 1),
                      jax.random.randint(kx, (N,), -pad, pad + 1)),
            "jitter": (jax.random.uniform(kb, (N,), jnp.float32, -s, s),
                       jax.random.uniform(kc, (N,), jnp.float32, 1 - s,
                                          1 + s)),
            "erasing": (
                (jax.random.uniform(ky0, (N,)) * (h - eh + 1)).astype(
                    jnp.int32),
                (jax.random.uniform(kx0, (N,)) * (w - ew + 1)).astype(
                    jnp.int32),
                eh, ew, jax.random.bernoulli(kp, data.random_erasing, (N,)))}
        draw = {k: tuple(torch.from_numpy(np.array(v)) for v in vs)
                for k, vs in draw.items()}
        draw["flip"] = draw["flip"][0]   # draw_flip returns the mask
        out.append(draw)
    return out


def _inject_draws(monkeypatch, draws):
    """Replace the port's draws by the JAX steps' draws, in step order."""
    pending = {k: [d[k] for d in draws] for k in draws[0]}
    for name in pending:
        monkeypatch.setattr(image_ops, f"draw_{name}",
                            lambda *a, _n=name, **kw: pending[_n].pop(0))
    return pending


def _port_fit(monkeypatch, cfg, head_cfg, jstate0, teacher=None,
              manager=None):
    """The port's fit from the JAX initial weights; (result, per-step
    metrics)."""
    make_state = loop.create_train_state
    build = loop.make_train_step
    metrics = []

    def from_jax_state(cfg_, head_cfg_, device):
        backbone, head, state = make_state(cfg_, head_cfg_, device)
        sd, kernel_w = from_jax(_host(jstate0.params),
                                _host(jstate0.batch_stats))
        backbone.load_state_dict(sd)
        with torch.no_grad():
            state.kernel_w.copy_(kernel_w)
            if state.head_state is not None:
                for x, y in zip(state.head_state, head_state_from_jax(
                        cfg_.head, _host(jstate0.head_state))):
                    x.copy_(y)
            for e, p in zip(state.ema or (), state.params()):
                e.copy_(p)
        return backbone, head, state

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def wrapped(state, *batch):
            out = step(state, *batch)
            metrics.append({k: float(v) for k, v in out[1].items()})
            return out
        return wrapped

    monkeypatch.setattr(loop, "create_train_state", from_jax_state)
    monkeypatch.setattr(loop, "make_train_step", recording)
    res = loop.fit(cfg, ListLoader(), device="cpu", head_cfg=head_cfg,
                   teacher=teacher, checkpoint_manager=manager)
    return res, metrics


def _jax_fit(cfg, head_cfg, teacher=None):
    rec = Recorder()
    res = jloop.fit(cfg, ListLoader(), logger=rec, use_mesh=False,
                    head_cfg=head_cfg, teacher=teacher)
    return res, rec.steps


CASES = {
    "accum2": dict(grad_accum=2),
    "accum3_adamw_clip": dict(grad_accum=3, optimizer="adamw", clip=1.0),
    "ema": dict(model_ema=0.9),
    "ema_accum2": dict(model_ema=0.9, grad_accum=2),
    "freeze": dict(freeze_backbone=True),
    "freeze_adamw": dict(freeze_backbone=True, optimizer="adamw"),
    "freeze_qaface": dict(freeze_backbone=True, head="qaface"),
    "distill_cosine": dict(distill={"weight": 2.0, "mode": "cosine",
                                    "backbone": "resnet18"}),
    "distill_mse": dict(distill={"weight": 0.01, "mode": "mse",
                                 "backbone": "resnet18"}),
    "adamw_clip": dict(optimizer="adamw", clip=1.0),
    "augment": dict(augment=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(case, monkeypatch):
    kw = CASES[case]
    jc, tc = _configs(**kw)
    jhc, thc = _head_cfgs(tc.head)
    jteacher = tteacher = None
    if "distill" in kw:
        jteacher, tteacher = _teachers()
    if kw.get("augment"):
        _inject_draws(monkeypatch, _jax_draws(
            0, STEPS_PER_EPOCH * EPOCHS, tc))
    _, _, jstate0 = jstate_mod.create_train_state(jc, jhc, optax.sgd(0.1))
    jres, jsteps = _jax_fit(jc, jhc, jteacher)
    tres, tsteps = _port_fit(monkeypatch, tc, thc, jstate0, tteacher)

    assert len(tsteps) == len(jsteps) == STEPS_PER_EPOCH * EPOCHS
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * max(1.0, abs(j["loss"])), \
            f"step {i}: port loss {t['loss']:.6f} vs jax {j['loss']:.6f}"
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
        np.testing.assert_allclose(t["feat_norm"], j["feat_norm"],
                                   rtol=1e-4, atol=1e-5)
        if "distill" in kw:
            np.testing.assert_allclose(t["loss_kd"], j["loss_kd"],
                                       rtol=1e-4, atol=1e-6)
    assert tres.losses == [s["loss"] for s in tsteps]

    js = jres.state
    want, want_kernel = from_jax(_host(js.params), _host(js.batch_stats))
    state = tres.state
    got = state.backbone.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(state.kernel_w.detach().numpy(),
                               want_kernel.numpy(), **TOL)
    if state.head_state is not None:
        want_state = head_state_from_jax(tc.head, _host(js.head_state))
        for field, x, y in zip(want_state._fields, state.head_state,
                               want_state):
            np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=field,
                                       **TOL)
    assert (js.ema_params is None) == (state.ema is None)
    if state.ema is not None:
        ema_sd, ema_kernel = from_jax(_host(js.ema_params),
                                      _host(js.batch_stats))
        names = [n for n, _ in state.backbone.named_parameters()]
        for name, e in zip(names, state.ema):
            np.testing.assert_allclose(e.numpy(), ema_sd[name].numpy(),
                                       err_msg=f"ema {name}", **TOL)
        np.testing.assert_allclose(state.ema[-1].numpy(),
                                   ema_kernel.numpy(), **TOL)
    if tc.freeze_backbone:
        # the trunk, its BatchNorm buffers and its optimizer slots stay
        # byte for byte; the head trained
        sd0, _ = from_jax(_host(jstate0.params), _host(jstate0.batch_stats))
        for key, value in sd0.items():
            assert torch.equal(got[key], value), key
        opt = state.optimizer
        for p in state.backbone.parameters():
            for slot in opt.state[p].values():
                assert not slot.any()
        assert opt.state[state.kernel_w] and any(
            s.any() for s in opt.state[state.kernel_w].values())


def _small_cfg(**kw):
    kw = {"epochs": 1, "data": tcfg.DataConfig(image_size=IMAGE), **kw}
    return tcfg.TrainConfig(backbone="resnet18", num_classes=C, batch_size=N,
                            print_freq=100, seed=0, **kw)


def test_fit_errors(tmp_path):
    head_cfg = tcfg.make_head_config("arcface", feature_dim=D,
                                     num_classes=C)
    teacher = get_backbone("resnet18", embed_dim=D)
    fit = lambda cfg, **kw: loop.fit(cfg, ListLoader(), device="cpu",
                                     head_cfg=head_cfg, **kw)
    with pytest.raises(ValueError, match="distill.weight == 0"):
        fit(_small_cfg(), teacher=teacher)
    on = tcfg.DistillConfig(weight=1.0)
    with pytest.raises(ValueError, match="needs a teacher"):
        fit(_small_cfg(distill=on))
    with pytest.raises(ValueError, match="embedding dim 16 != student "
                                         "feature dim 32"):
        fit(_small_cfg(distill=on),
            teacher=get_backbone("resnet18", embed_dim=16))
    with pytest.raises(ValueError, match="contradictory"):
        fit(_small_cfg(distill=on, freeze_backbone=True), teacher=teacher)
    with pytest.raises(ValueError, match="unknown distill mode"):
        fit(_small_cfg(distill=dataclasses.replace(on, mode="kl")),
            teacher=teacher)
    # a teacher checkpoint that is not there raises, nothing runs without
    missing = dataclasses.replace(on, checkpoint_dir=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        fit(_small_cfg(distill=missing))
    with pytest.raises(ValueError, match="Unknown optimizer name"):
        fit(_small_cfg(optimizer=tcfg.OptimizerConfig(name="sgdw")))


def _recipe_fit(directory, epochs, resume=None, scan_steps=1):
    cfg = _small_cfg(
        epochs=epochs, continue_train=resume, grad_accum=2, model_ema=0.9,
        scan_steps=scan_steps,
        optimizer=tcfg.OptimizerConfig(name="adamw", learning_rate=0.002,
                                       clip_grad_norm=1.0),
        data=tcfg.DataConfig(image_size=IMAGE, horizontal_flip=True,
                             crop_pad=2, color_jitter=0.2,
                             random_erasing=0.5))
    head_cfg = tcfg.make_head_config("arcface", feature_dim=D,
                                     num_classes=C)
    return loop.fit(cfg, ListLoader(), device="cpu", head_cfg=head_cfg,
                    checkpoint_manager=CheckpointManager(str(directory)))


def _assert_same_state(got, want):
    a, b = state_tensors(got), state_tensors(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"tensor {i}"
    assert got.step == want.step
    assert torch.equal(got.rng.get_state(), want.rng.get_state())


def test_resumed_recipe_equals_uninterrupted(tmp_path):
    """AdamW + clip + grad_accum 2 + EMA + the four augmentations: one
    epoch (3 micro-steps: the resume lands mid-cycle), then a resumed one,
    equal two uninterrupted epochs bit for bit, with scan_steps 2 (a chunk
    and a leftover step an epoch) as with one step at a time."""
    whole = _recipe_fit(tmp_path / "whole", 2)
    first = _recipe_fit(tmp_path / "parts", 1)
    second = _recipe_fit(tmp_path / "parts", 1, resume="latest")
    assert first.losses + second.losses == whole.losses
    _assert_same_state(second.state, whole.state)
    assert int(second.state.optimizer.mini_step) == 0
    assert int(second.state.optimizer.inner.count) == 3
    chunked = _recipe_fit(tmp_path / "chunked", 2, scan_steps=2)
    assert chunked.losses == whole.losses
    _assert_same_state(chunked.state, whole.state)
