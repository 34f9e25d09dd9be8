"""Jobs the ranks of a tests/torch_mesh_world.World run: each builds its mesh
over the world's gloo group, runs one piece of the port on its rows and its
class shard, and returns numpy arrays for the test process to compare with
the JAX package. No JAX import here: the workers run the port alone."""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from face_recognition_models_tpu_torch import config as tcfg
from face_recognition_models_tpu_torch.heads import get_head
from face_recognition_models_tpu_torch.heads import margins
from face_recognition_models_tpu_torch.heads.fused_adapter import (
    MEM_FUSED_HEADS,
    _mem_row_params,
    _row_params,
    fused_apply,
)
from face_recognition_models_tpu_torch.models.resnet import BasicBlock, ResNet
from face_recognition_models_tpu_torch.ops.image_ops import degrade_images
from face_recognition_models_tpu_torch.ops.normalize import (
    feature_norms,
    l2_normalize,
)
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.parallel import make_mesh, sharding
from face_recognition_models_tpu_torch.parallel.sharded_fused import (
    sharded_fused_margin_ce,
    take_target_columns,
)
from face_recognition_models_tpu_torch.train.optim import get_optimizer
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import (
    eager_apply,
    make_train_step,
)


def _np(x):
    return x.detach().cpu().numpy()


def _rows(x, mesh):
    if mesh is None:
        return x
    n = x.shape[0] // mesh.data
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]


def mesh_layout(data, model):
    """(rank, data_index, model_index, the ranks of each group)."""
    mesh = make_mesh(tcfg.MeshConfig(data=data, model=model))
    return (mesh.rank, mesh.data_index, mesh.model_index,
            dist.get_process_group_ranks(mesh.data_group),
            dist.get_process_group_ranks(mesh.model_group))


def fused_head(name, data, model, kernel, feats, labels, head_state,
               head_args=None):
    """The class-sharded fused head on the rank's rows and shard: the
    global loss, the rank's (lse, target, higher), the kernel shard's
    gradient averaged over the data group, the rank's feature gradient
    and the whole new head state."""
    mesh = make_mesh(tcfg.MeshConfig(data=data, model=model))
    c = kernel.shape[1]
    cfg = tcfg.make_head_config(name, feature_dim=kernel.shape[0],
                                num_classes=c, **(head_args or {}))
    k = torch.nn.Parameter(sharding.shard(
        torch.tensor(kernel), sharding.spec_for("kernel_w", kernel.shape,
                                                   c), mesh))
    x = _rows(torch.as_tensor(feats), mesh).clone().requires_grad_()
    y = _rows(torch.as_tensor(labels), mesh)
    state = sharding.shard_head_state(head_state, c, mesh)
    out = fused_apply(cfg, k, x, y, state, mesh=mesh)
    out.loss_id.backward()
    coll.average_gradients([k], mesh)
    # the statistics alone, as fused_apply computes them
    with coll.using(mesh), torch.no_grad():
        xf = x.detach().float()
        xn, wn = l2_normalize(xf, dim=1), l2_normalize(k.detach(), dim=0)
        tcos_raw = (xn * take_target_columns(wn, y, mesh)).sum(1)
        memn = lam = None
        if name in MEM_FUSED_HEADS:
            rp, memn, lam = _mem_row_params(cfg, k.detach(), xn, xf, y,
                                            tcos_raw, state, None)
        else:
            rp = _row_params(cfg, tcos_raw, feature_norms(xf), state)
        stats = sharded_fused_margin_ce(mesh, xn, wn, y, rp.t, rp.tcos,
                                        rp.scale, rp.ab, rp.mode,
                                        rp.clamp_eps, memn=memn, lam=lam)
    loss = coll.data_sum(out.loss_id.detach(), mesh) / mesh.data
    new_state = sharding.gather_head_state(out.state, c, mesh)
    return {"loss": float(loss), "lse": _np(stats.lse),
            "target": _np(stats.target_logit), "higher": _np(stats.higher),
            "gk": _np(k.grad), "gf": _np(x.grad),
            "state": None if new_state is None else [_np(s) for s in
                                                     new_state],
            "data_index": mesh.data_index, "model_index": mesh.model_index}


@contextlib.contextmanager
def no_class_gather():
    """Inside the block, collectives.gather_classes and
    sharding.gather_head_state raise: a head or step that would make the
    whole class axis on a rank fails."""
    kept = coll.gather_classes, sharding.gather_head_state

    def refuse(*args, **kwargs):
        raise AssertionError("the whole class axis gathered under a model "
                             "axis")

    coll.gather_classes = sharding.gather_head_state = refuse
    try:
        yield
    finally:
        coll.gather_classes, sharding.gather_head_state = kept


def eager_head(name, data, model, kernel, feats, labels, head_state,
               head_args=None, noise=None, num_classes=None, lambda_g=0.0):
    """The train step's eager head, loss and top-k (train/step.
    eager_apply: heads/margins.py, train/losses.py, train/metrics.py) on
    the rank's rows and class shard, with the whole class axis refused
    (no_class_gather); the loss is the CE + lambda_g loss_g. `noise` is
    the elastic heads' normal draw for the global batch. Returns the
    global loss and top-1 / top-5, the kernel shard's gradient averaged
    over the data group, the rank's feature gradient and the whole new
    head state by field."""
    mesh = make_mesh(tcfg.MeshConfig(data=data, model=model))
    c = num_classes or kernel.shape[1]
    cfg = tcfg.make_head_config(name, feature_dim=kernel.shape[0],
                                num_classes=c, **(head_args or {}))
    k = torch.nn.Parameter(sharding.shard(
        torch.tensor(kernel), sharding.spec_for("kernel_w", kernel.shape,
                                                   c), mesh))
    x = _rows(torch.as_tensor(feats), mesh).clone().requires_grad_()
    y = _rows(torch.as_tensor(labels), mesh)
    state = sharding.shard_head_state(head_state, c, mesh)
    draw = margins._normal_noise
    if noise is not None:
        margins._normal_noise = lambda rng, n, device: torch.as_tensor(noise)
    try:
        with no_class_gather():
            out, loss_id, *acc = eager_apply(get_head(name), cfg, k, x, y,
                                             state, torch.Generator(),
                                             mesh=mesh)
            loss = loss_id + lambda_g * out.loss_g
            loss.backward()
    finally:
        margins._normal_noise = draw
    coll.average_gradients([k], mesh)
    metrics = coll.average_metrics({"loss": loss, "acc1": acc[0],
                                    "acc5": acc[1]}, mesh)
    new_state = sharding.gather_head_state(out.state, c, mesh)
    return {**{key: float(v) for key, v in metrics.items()},
            "logit_columns": out.logits.shape[1],
            "gk": _np(k.grad), "gf": _np(x.grad),
            "state": None if new_state is None else {
                f: _np(v) for f, v in zip(new_state._fields, new_state)},
            "data_index": mesh.data_index, "model_index": mesh.model_index}


def tiny_resnet(stages, width, d):
    return ResNet(tuple(stages), BasicBlock, embed_dim=d, num_filters=width,
                  dtype=torch.float32)


def train_steps(name, data, model, stages, width, sd, kernel, batches, lr,
                use_fused=True, step_kw=None, seed=7, opt_kw=None,
                num_classes=None):
    """`len(batches)` train steps of the port's step from the backbone
    state_dict `sd` and the whole `kernel`, on the rank's rows and shard
    of a data x model mesh (data = model = 0: one process, no mesh), with
    SGD (momentum 0.9, weight decay 5e-4, or `opt_kw`'s overrides); the
    steps may not gather the class axis (no_class_gather). `num_classes`
    defaults to the kernel's width (sub-center: C of its C k columns).
    Returns the global losses and the whole state after the steps."""
    mesh = (make_mesh(tcfg.MeshConfig(data=data, model=model))
            if data else None)
    c = num_classes or kernel.shape[1]
    backbone = tiny_resnet(stages, width, kernel.shape[0])
    backbone.load_state_dict(sd, strict=True)
    k = torch.nn.Parameter(sharding.shard(
        torch.tensor(kernel), sharding.spec_for("kernel_w", kernel.shape,
                                                   c), mesh))
    opt = get_optimizer("sgd", [*backbone.parameters(), k], lr,
                        **{"momentum": 0.9, "weight_decay": 5e-4,
                           **(opt_kw or {})})
    cfg = tcfg.make_head_config(name, feature_dim=kernel.shape[0],
                                num_classes=c)
    head = get_head(name)
    state = TrainState(backbone=backbone, kernel_w=k, optimizer=opt,
                       head_state=sharding.shard_head_state(
                           head.init_state(cfg), c, mesh),
                       rng=torch.Generator().manual_seed(seed))
    step = make_train_step(head, cfg, use_fused_head=use_fused,
                           device="cpu", mesh=mesh, **(step_kw or {}))
    losses = []
    for images, labels in batches:
        images = _rows(torch.as_tensor(images), mesh)
        view = (degrade_images(images),) if head.requires_minput else ()
        with no_class_gather():
            state, metrics = step(state, images,
                                  _rows(torch.as_tensor(labels), mesh),
                                  *view)
        losses.append(float(metrics["loss"]))
    return {"losses": losses,
            "kernel": _np(sharding.gather(k.detach(), sharding.CLASS_COLUMNS,
                                          mesh)),
            "state": [_np(x) for x in sharding.gather_head_state(
                state.head_state, c, mesh) or ()],
            "sd": {n: _np(v) for n, v in backbone.state_dict().items()}}


def pfc_steps(name, data, model, stages, width, sd, kernel, batches, lr,
              num_sampled_local, logq=True, seed=7):
    """Steps of the class-sharded Partial-FC on the rank's rows and
    shard. Returns the global losses and acc1, the whole kernel and
    kernel_mom, the backbone state_dict, and per step the global columns
    each shard's sample holds (replayed from a copy of the generator) and
    those the step wrote."""
    from face_recognition_models_tpu_torch.train.partial_fc_sharded import (
        local_sample_from_draws, make_sharded_partial_fc_train_step)

    mesh = make_mesh(tcfg.MeshConfig(data=data, model=model))
    c = kernel.shape[1]
    c_local = c // model
    backbone = tiny_resnet(stages, width, kernel.shape[0])
    backbone.load_state_dict(sd, strict=True)
    k = torch.nn.Parameter(sharding.shard(torch.tensor(kernel),
                                          sharding.CLASS_COLUMNS, mesh))
    opt = get_optimizer("sgd", list(backbone.parameters()), lr,
                        momentum=0.9, weight_decay=5e-4)
    cfg = tcfg.make_head_config(name, feature_dim=kernel.shape[0],
                                num_classes=c)
    head = get_head(name)
    state = TrainState(backbone=backbone, kernel_w=k, optimizer=opt,
                       head_state=sharding.shard_head_state(
                           head.init_state(cfg), c, mesh),
                       rng=torch.Generator().manual_seed(seed),
                       kernel_mom=torch.zeros_like(k.detach()))
    step = make_sharded_partial_fc_train_step(
        head, cfg, num_sampled_local, mesh, logq_correction=logq,
        device="cpu")
    offset = mesh.model_index * c_local
    losses, acc1, sampled, written = [], [], [], []
    for images, labels in batches:
        g = torch.Generator()
        g.set_state(state.rng.get_state())
        scores = torch.rand((model, c_local + 1), generator=g)
        shift = torch.randint(0, c_local, (model,), generator=g)
        n_slots = min(len(labels), c_local)
        cls, valid, _ = local_sample_from_draws(
            torch.as_tensor(labels), c_local, n_slots, num_sampled_local,
            offset, scores[mesh.model_index], shift[mesh.model_index])
        sampled.append(sorted(set((cls[valid] + offset).tolist())))
        before = k.detach().clone()
        state, metrics = step(state, _rows(torch.as_tensor(images), mesh),
                              _rows(torch.as_tensor(labels), mesh))
        moved = (k.detach() != before).any(0).nonzero()[:, 0] + offset
        written.append(moved.tolist())
        losses.append(float(metrics["loss"]))
        acc1.append(float(metrics["acc1"]))
    mom_cols = (state.kernel_mom != 0).any(0).nonzero()[:, 0] + offset
    return {"losses": losses, "acc1": acc1, "sampled": sampled,
            "written": written, "mom_cols": mom_cols.tolist(),
            "kernel": _np(sharding.gather(k.detach(), sharding.CLASS_COLUMNS,
                                          mesh)),
            "sd": {n: _np(v) for n, v in backbone.state_dict().items()}}


def _state_arrays(state, mesh=None):
    """The state's class tensors (whole) and backbone, as numpy."""
    whole = lambda x: _np(sharding.gather(x.detach(), sharding.CLASS_COLUMNS,
                                          mesh))
    out = {"kernel_w": whole(state.kernel_w), "step": state.step,
           "sd": {n: _np(v) for n, v in state.backbone.state_dict().items()},
           "head_state": [_np(x) for x in sharding.gather_head_state(
               state.head_state, state.kernel_w.shape[1]
               * (1 if mesh is None else mesh.model), mesh) or ()]}
    if state.kernel_mom is not None:
        out["kernel_mom"] = whole(state.kernel_mom)
    slots = [v for v in state.optimizer.state[state.kernel_w].values()
             if isinstance(v, torch.Tensor)] if state.kernel_mom is None \
        else []
    out["kernel_slots"] = [whole(v) for v in slots]
    return out


def fit_checkpoint(cfg, images, labels, directory, data=0, model=0,
                   resume=False, shuffle=True):
    """With resume=False, one `fit` of cfg on the arrays (a world's rank
    when data > 0) that saves its epochs under `directory`; with
    resume=True, a restore of the directory's latest checkpoint into a
    fresh state of cfg. Returns _state_arrays of the state, with the
    losses of a fit. Unshuffled, a world's global batches hold the rows
    of one process's."""
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit, make_recipe

    mesh = (make_mesh(tcfg.MeshConfig(data=data, model=model))
            if data else None)
    head_cfg = tcfg.make_head_config(cfg.head, num_classes=cfg.num_classes)
    mgr = CheckpointManager(directory, cfg.head)
    device = torch.device("cpu")
    if resume:
        _, state, _ = make_recipe(cfg, head_cfg, device, mesh=mesh)
        mgr.restore(state, mesh=mesh)
        return _state_arrays(state, mesh)
    shard = None if mesh is None else (mesh.data_index, mesh.data)
    loader = ArrayLoader(images, labels, cfg.batch_size // max(data, 1),
                         shuffle=shuffle, seed=cfg.seed, shard=shard)
    result = fit(cfg, loader, device="cpu", head_cfg=head_cfg,
                 checkpoint_manager=mgr, mesh=mesh)
    return {**_state_arrays(result.state, mesh), "losses": result.losses}


def fit_preempted(cfg, images, labels, directory, data, model,
                  signal_rank, signal_batch):
    """`fit` of cfg in a data x model world with a checkpoint manager,
    where rank `signal_rank` sends itself SIGTERM as its loader hands out
    batch `signal_batch` of epoch 1. Returns the steps the rank ran, its
    `preempted` and (rank 0) the checkpoint files."""
    import os
    import signal

    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit

    mesh = make_mesh(tcfg.MeshConfig(data=data, model=model))
    loader = ArrayLoader(images, labels, cfg.batch_size // data,
                         shuffle=False, seed=cfg.seed,
                         shard=(mesh.data_index, mesh.data))

    class Signalling:
        def steps_per_epoch(self):
            return loader.steps_per_epoch()

        def epoch(self, i):
            for b, batch in enumerate(loader.epoch(i)):
                if (mesh.rank, i, b) == (signal_rank, 1, signal_batch):
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

    result = fit(cfg, Signalling(), device="cpu",
                 checkpoint_manager=CheckpointManager(directory, cfg.head),
                 mesh=mesh)
    return {"steps": len(result.losses), "preempted": result.preempted,
            "files": sorted(os.listdir(directory)) if mesh.rank == 0
            else None}


def triplet_steps(stages, width, sd, batches, margin=0.2, seed=5,
                  data=0):
    """Triplet steps of the tiny trunk (data-parallel over `data` ranks, or
    one process with data=0): the losses, the mined (valid, negatives) of
    every step and the backbone state_dict after them."""
    from face_recognition_models_tpu_torch.triplet import train as tt

    mesh = make_mesh(tcfg.MeshConfig(data=data, model=1)) if data else None
    backbone = tiny_resnet(stages, width, 16)
    backbone.load_state_dict(sd, strict=True)
    opt = get_optimizer("sgd", backbone.parameters(), 0.05, momentum=0.9,
                        weight_decay=5e-4)
    state = tt.TripletTrainState(backbone=backbone, optimizer=opt,
                                 rng=torch.Generator().manual_seed(seed))
    mined = []
    orig = tt.mined_triplet_loss

    def spy(emb, labels, margin, rng):
        loss, m = orig(emb, labels, margin, rng)
        mined.append((_np(m.valid), _np(m.negatives)))
        return loss, m

    tt.mined_triplet_loss = spy
    try:
        step = tt.make_triplet_train_step(margin, device="cpu", mesh=mesh)
        losses = []
        for images, labels in batches:
            state, m = step(state, _rows(torch.as_tensor(images), mesh),
                            _rows(torch.as_tensor(labels), mesh))
            losses.append(float(m["loss"]))
    finally:
        tt.mined_triplet_loss = orig
    return {"losses": losses, "mined": mined,
            "sd": {n: _np(v) for n, v in backbone.state_dict().items()}}


def pooled_scores(gallery, ids, probes, chunk):
    """pooled_scores_device on the CPU, its gallery split over the world."""
    from face_recognition_models_tpu_torch.evaluation.openset import (
        pooled_scores_device)

    return pooled_scores_device(gallery, ids, probes, chunk=chunk,
                                device="cpu")


def embed_batches(stages, width, sd, batches, data):
    """make_embed_fn(mesh=) over a data-axis mesh of the world: each rank
    embeds its share of every batch and gets the whole batch's rows."""
    from face_recognition_models_tpu_torch.evaluation.batch_eval import (
        make_embed_fn)

    mesh = make_mesh(tcfg.MeshConfig(data=data, model=1))
    backbone = tiny_resnet(stages, width, 16)
    backbone.load_state_dict(sd, strict=True)
    embed = make_embed_fn(backbone, device="cpu", mesh=mesh)
    out = [_np(embed(torch.as_tensor(b))) for b in batches]
    try:
        embed(torch.as_tensor(batches[0][:data + 1]))
    except ValueError as e:
        out.append(str(e))
    return out

