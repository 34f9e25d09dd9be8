"""Class-sharded Partial-FC. Port of face_recognition_models_tpu/train/
partial_fc_sharded.py.

The replicated Partial-FC (train/partial_fc.py) holds the whole [D, C]
classifier and its momentum on every card. Here both are split over the
mesh's 'model' axis (each rank of a model group owns C/mp class columns,
the layout of the class-sharded fused head) and each shard samples within
its own class range: the original Partial FC design (An et al. 2021: each
card holds a class shard and samples locally).

Per step, on each rank:

1. the sample: the global batch's labels (gathered over the data group)
   that fall in the shard's range are its positives, in ascending order,
   padded to min(N, C/mp) slots; exact uniform local negatives fill the rest
   of the shard's C_s/mp columns (`local_sample_from_draws`, the top-k of
   uniform scores with the positives pushed below the range, bucketed at
   large C). Every rank draws the scores and the bucket shift of every
   shard from the step generator and keeps its own row, so the generators
   stay in step and the ranks of one data group sample alike;
2. the shard's sampled columns [D, C_s/mp] are the differentiated leaf, so
   no dense [D, C] gradient is made;
3. margin + CE over the sampled cosines [N, C_s/mp] in plain PyTorch: the
   per-row margin scalars come from the fused adapter's `_row_params` (so
   the nine fusable heads without memories work, the EMA ones included)
   and the non-target transform from the kernels' `_h` rules; the
   non-target logsumexp combines over the model group as in
   parallel/sharded_fused.py;
4. the gradients are averaged over the data group; the backbone takes its
   optimizer's step, the kernel and `kernel_mom` torch SGD on the shard's
   sampled columns only.

The logQ correction uses each shard's own inclusion probability of a
negative, (C/mp - u_m) / (C_s/mp - slots), u_m the shard's unique
positives. The memory-blended heads are refused, as in the JAX package:
their [C, D] memories key on absolute class ids.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from face_recognition_models_tpu_torch.heads.fused_adapter import (
    MEM_FUSED_HEADS,
    _row_params,
    fused_supported,
)
from face_recognition_models_tpu_torch.ops.fused_head import _h
from face_recognition_models_tpu_torch.ops.image_ops import (
    apply_augmentations,
    normalization_constants,
)
from face_recognition_models_tpu_torch.ops.normalize import (
    feature_norms,
    l2_normalize,
)
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.parallel.sharding import check_divides
from face_recognition_models_tpu_torch.train.partial_fc import (
    _unique_padded,
    sample_negatives,
)
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import (
    copy_head_state,
    ema_update,
)
from face_recognition_models_tpu_torch.utils.device import resolve_device

_NEG_INF = -1e30


def local_sample_from_draws(labels_full: torch.Tensor, c_local: int,
                            n_slots: int, num_sampled_local: int,
                            offset: int, scores: torch.Tensor,
                            shift: torch.Tensor):
    """One shard's sample from its draws: `scores` [c_local + 1] uniform in
    [0, 1) and `shift` a 0-d int in [0, c_local). Returns (classes
    [C_s_local] int64 local ids, col_valid [C_s_local] bool, u 0-d int64,
    the shard's unique positives), the JAX `_local_sample`'s:

    - `classes[:n_slots]` are the global labels in [offset, offset +
      c_local), shifted to local ids, distinct and ascending (padded slots:
      class 0, col_valid False);
    - `classes[n_slots:]` are distinct uniform local negatives.

    n_slots = min(batch, c_local): a shard has at most c_local distinct
    positives, so the padding never drops a real one."""
    lab = labels_full.long() - offset
    in_range = (lab >= 0) & (lab < c_local)
    masked = torch.where(in_range, lab, c_local)
    pos = _unique_padded(masked, c_local)[:n_slots]
    pos_valid = pos < c_local
    scores = scores.index_fill(0, pos, -1.0)   # the sentinel hits slot C
    neg = sample_negatives(scores[:c_local], num_sampled_local - n_slots,
                           n_slots, shift=shift)
    classes = torch.cat([torch.where(pos_valid, pos, 0), neg])
    col_valid = torch.cat([pos_valid, torch.ones(
        (num_sampled_local - n_slots,), dtype=torch.bool,
        device=pos.device)])
    return classes, col_valid, pos_valid.sum()


def make_sharded_partial_fc_train_step(
        head, head_cfg, num_sampled_local: int, mesh,
        lr_schedule: Optional[Callable] = None,
        momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False, lambda_g: float = 0.0,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
        horizontal_flip: bool = False, crop_pad: int = 0,
        color_jitter: float = 0.0, random_erasing: float = 0.0,
        logq_correction: bool = True, model_ema: float = 0.0,
        device=None) -> Callable:
    """Build step(state, images, labels, minput_images=None) -> (state,
    metrics), one rank's sampled-classifier step with `state.kernel_w` and
    `state.kernel_mom` the rank's [D, C/mp] class shards.

    num_sampled_local: sampled columns per shard (the batch's positive
    slots + at least one negative); the global sample is mp times it. The
    metrics are the global batch's, the accuracies over the sampled
    classes. Runs on the card unless device='cpu'.
    """
    if not fused_supported(head_cfg.name) or head_cfg.name in MEM_FUSED_HEADS:
        raise ValueError(
            f"sharded partial_fc does not support head '{head_cfg.name}'")
    mp = mesh.model
    check_divides(head_cfg.num_classes, mp)
    c_local = head_cfg.num_classes // mp
    c_s_local = num_sampled_local
    if c_s_local > c_local:
        raise ValueError(f"num_sampled_local {c_s_local} > local classes "
                         f"{c_local}")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    scale, bias = normalization_constants(mean, std, device=device)
    offset = mesh.model_index * c_local

    def sample(state, labels_full):
        n_slots = min(labels_full.shape[0], c_local)
        if c_s_local - n_slots < 0:
            raise ValueError(
                f"per-shard positive slots {n_slots} (= min(batch, C/mp)) "
                f"leave no negative slots in num_sampled_local {c_s_local}")
        scores = torch.rand((mp, c_local + 1), generator=state.rng,
                            device=device)[mesh.model_index]
        shift = torch.randint(0, c_local, (mp,), generator=state.rng,
                              device=device)[mesh.model_index]
        return n_slots, *local_sample_from_draws(
            labels_full, c_local, n_slots, c_s_local, offset, scores, shift)

    def train_step(state: TrainState, images, labels, minput_images=None):
        del minput_images  # the memory heads (its users) are refused
        with coll.using(mesh):
            state, metrics = one_step(state, images, labels)
            return state, coll.average_metrics(metrics, mesh)

    def one_step(state, images, labels):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) * scale + bias
        images = apply_augmentations(state.rng, images, horizontal_flip,
                                     crop_pad, color_jitter, random_erasing)
        labels = torch.as_tensor(labels).to(device, non_blocking=True).long()
        n_slots, classes, col_valid, u = sample(state,
                                                coll.gather_rows(labels))
        n_negs = c_s_local - n_slots
        cols = torch.where(col_valid, classes, classes[:1])
        w_s = state.kernel_w.detach().index_select(1, cols).requires_grad_()
        slot = torch.arange(c_s_local, device=device)
        if logq_correction and n_negs > 0:
            shift_m = torch.log(torch.clamp_min(c_local - u.float(), 1.0)
                                / float(n_negs))
            logq = torch.where(slot >= n_slots, shift_m, 0.0)
        else:
            logq = torch.zeros((c_s_local,), device=device)

        state.backbone.train()
        kw = ({"rng": state.rng}
              if getattr(state.backbone, "takes_rng", False) else {})
        feats = state.backbone(images, **kw).to(torch.float32)
        xn = l2_normalize(feats, dim=1)
        norms = feature_norms(feats)
        cos = coll.copy_to_model(xn) @ l2_normalize(w_s, dim=0)
        one_hot = ((classes + offset)[None, :] == labels[:, None]) \
            & col_valid[None, :]
        tcos_raw = coll.reduce_from_model(
            torch.where(one_hot, cos, 0.0).sum(1))
        rp = _row_params(head_cfg, tcos_raw, norms, state.head_state,
                         state.rng if head.requires_rng else None)
        cosc = cos
        if rp.clamp_eps is not None:
            cosc = cos.clamp(-1.0 + rp.clamp_eps, 1.0 - rp.clamp_eps)
        s_c, a_c, b_c = (coll.copy_to_model(v) for v in (
            rp.scale[:, None], rp.ab[:, 0:1], rp.ab[:, 1:2]))
        nt_mask = col_valid[None, :] & ~one_hot
        z_nt = torch.where(nt_mask, s_c * _h(rp.mode, cosc, a_c, b_c)
                           + logq[None, :], _NEG_INF)
        lse_l = torch.logsumexp(z_nt, dim=1)
        mx = coll.max_over_model(lse_l.detach())
        lse_nt = torch.log(coll.reduce_from_model(torch.exp(lse_l - mx))) + mx
        target_z = rp.scale * rp.t
        loss_id = (torch.logaddexp(target_z, lse_nt) - target_z).mean()
        loss_mag = lambda_g * rp.loss_g
        loss = loss_id + loss_mag
        higher = coll.reduce_from_model(
            (nt_mask & (cos > tcos_raw.detach()[:, None])).sum(1).float())
        lr = (torch.full((), state.optimizer.param_groups[0]["lr"],
                         dtype=torch.float32, device=device)
              if lr_schedule is None else lr_schedule(state.count))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        coll.average_gradients([*state.backbone.parameters(), w_s], mesh)
        with torch.no_grad():
            state.lr.copy_(lr)
            state.optimizer.step(state.lr)
            valid = col_valid[None, :].to(torch.float32)
            g = (w_s.grad + weight_decay * w_s) * valid
            mom_s = state.kernel_mom.index_select(1, cols)
            new_mom_s = momentum * mom_s + g
            step_dir = g + momentum * new_mom_s if nesterov else new_mom_s
            new_w = w_s + (-lr * step_dir * valid)
            new_mom = mom_s + (new_mom_s - mom_s) * valid
            # a padded slot writes slot 0's new values into its column
            keep = col_valid[None, :]
            state.kernel_w.index_copy_(1, cols, torch.where(
                keep, new_w, new_w[:, :1]))
            state.kernel_mom.index_copy_(1, cols, torch.where(
                keep, new_mom, new_mom[:, :1]))
            if model_ema > 0.0:
                ema_update(state, model_ema, 1)
            copy_head_state(state.head_state, rp.new_state)
            state.count.add_(1)
        state.step += 1
        return state, {
            "loss": loss.detach(), "loss_id": loss_id.detach(),
            "loss_mag": loss_mag.detach(),
            "acc1": 100.0 * (higher < 1).float().mean(),
            "acc5": 100.0 * (higher < 5).float().mean(),
            "lr": lr, "feat_norm": norms.detach().mean()}

    return train_step
