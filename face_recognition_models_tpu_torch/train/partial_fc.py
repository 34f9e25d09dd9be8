"""Partial-FC sampled-classifier training. Port of
face_recognition_models_tpu/train/partial_fc.py; the class-sharded step is
train/partial_fc_sharded.py.

At production identity counts the classifier dominates the step. Partial FC
(An et al., "Partial FC: Training 10 Million Identities on a Single
Machine", 2021) runs each step's softmax over a SAMPLED class set: the
batch's positive classes plus uniformly drawn negatives. The margin only
ever touches the target column, so every supported head's math is
unchanged in sampled space; the CE denominator is a biased estimate, which
the logQ shift corrects.

Every shape is static and nothing is read back to the host, so the step
runs eagerly and inside a CUDA graph of K steps (`--scan-steps`):

- the batch's unique positives come from a sort, a first-occurrence mask
  and a second sort that moves the repeats (set to the sentinel C) behind
  them: `jnp.unique(size=N, fill_value=C)`'s ascending order without its
  data-dependent size;
- the negatives are the top-k of uniform scores with the positives pushed
  below the range (exact sampling without replacement), bucketed at large
  C (`sample_negatives`); the scores and the bucket shift are drawn from
  the state's generator (`sample_classes`), and
  `sample_classes_from_draws` takes them as arguments, so a test can hand
  it the JAX package's draws;
- the sampled columns [D, C_s] of the [D, C] kernel are a gathered leaf,
  so the backward never makes a dense [D, C] gradient;
- the kernel and its momentum `kernel_mom` follow torch's SGD on the
  sampled columns only (weight decay into the gradient, then momentum,
  optionally Nesterov; the lr of the schedule at the step count); the
  unsampled columns are not written. The columns go back with index_copy_,
  which writes each class once with its one value: a padded positive slot
  (a batch with repeated labels) gathers and writes slot 0's column with
  slot 0's values, so no index is written twice with two values and the
  result does not depend on the order of the writes.

Supported heads: the ten without per-class memories, sub-centers or a
full-softmax statistic (UNSUPPORTED_HEADS says why for the other four).
The head is always the eager head of heads/margins.py at C_s columns,
whatever the run's head path, as in the JAX package. Over a data-only mesh
(`mesh=`) every rank samples from the global batch's labels with the same
draws, and the sampled columns' and the backbone's gradients are averaged
over the data group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from face_recognition_models_tpu_torch.ops.image_ops import (
    apply_augmentations,
    normalization_constants,
)
from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.train.losses import mean_cross_entropy
from face_recognition_models_tpu_torch.train.metrics import topk_accuracy
from face_recognition_models_tpu_torch.train.state import TrainState
from face_recognition_models_tpu_torch.train.step import (
    copy_head_state,
    ema_update,
)
from face_recognition_models_tpu_torch.utils.device import resolve_device

_NEG_INF = -1e30

# vpl/qaface: the [C, D] memory state does not follow sampled columns;
# subcenter: assumes one kernel column per class; adacos: its adaptive
# scale is a FULL-softmax statistic (B_avg sums every non-target class,
# and the init is ln(C-1)): both would be biased in sampled space.
UNSUPPORTED_HEADS = ("vpl_arcface", "qaface", "subcenter_arcface", "adacos")


def num_sampled_classes(num_classes: int, sample_ratio: float,
                        batch_size: int, multiple: int = 256) -> int:
    """C_s = max(2 * batch, ratio * C) rounded up to a multiple of
    `multiple`, capped at C.

    The 2 * batch floor keeps at least `batch` negative slots: the first
    `batch` slots hold the batch's unique positives. `fit` falls back to
    the dense path when the cap C is reached."""
    want = max(2 * batch_size, int(num_classes * sample_ratio))
    want = -(-want // multiple) * multiple
    return min(num_classes, want)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, largest
    first, equal values lower index first (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def sample_negatives(scores: torch.Tensor, k: int, max_pos: int,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k distinct uniform negative indices from random `scores` [C] whose
    positive entries were set to -1.

    A full top-k sorts all C scores; at large C the bucketed form takes
    k/B winners from each of B equal buckets (selections stay distinct
    and positives excluded as long as any bucket can seat its quota even
    if all `max_pos` positives land in it, which the choice of B
    guarantees), and falls back to the exact global top-k when no valid B
    exists. The bucket of class i is its residue (i + shift) mod B over a
    transposed [C/B, B] view, so adjacent ids land in different buckets,
    and `shift` (a 0-d int tensor, drawn anew each step) rotates every
    class through all B buckets across steps."""
    c = scores.shape[0]
    b = 64
    while b > 1 and not (k % b == 0 and c % b == 0
                         and k // b + max_pos <= c // b
                         and c // b >= 1024):
        b //= 2
    if b == 1:
        return _top_k(scores, k)
    arange = torch.arange(c, device=scores.device)
    if shift is None:
        shift = torch.zeros((), dtype=torch.int64, device=scores.device)
    # jnp.roll(scores, shift) on the device: rolled position p holds class
    # (p - shift) mod C; the transpose puts position p in bucket p mod B
    rolled = scores[(arange - shift) % c]
    idx = _top_k(rolled.reshape(c // b, b).T, k // b)     # [B, k/B]
    pos = idx * b + arange[:b, None]
    return ((pos - shift) % c).reshape(-1)


def _unique_padded(labels: torch.Tensor, fill: int) -> torch.Tensor:
    """jnp.unique(labels, size=N, fill_value=fill): the distinct labels in
    ascending order, then `fill` (> every label) in the rest of N slots."""
    s = torch.sort(labels.long()).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return torch.sort(torch.where(first, s, fill)).values


def sample_classes_from_draws(labels: torch.Tensor, num_classes: int,
                              num_sampled: int, scores: torch.Tensor,
                              shift: torch.Tensor):
    """The step's class sample from its draws: `scores` [C + 1] uniform in
    [0, 1) and `shift` a 0-d int in [0, C). Returns (classes [C_s] int64,
    col_valid [C_s] bool, target [N] int64):

    - `classes[:N]` are the batch's unique positives in ascending order
      (padded slots map to class 0 with col_valid False);
    - `classes[N:]` are distinct uniform negatives, never positives;
    - `target[i]` is the sampled-space column of labels[i].
    """
    n = labels.shape[0]
    if not n <= num_sampled <= num_classes:
        raise ValueError(
            f"need batch {n} <= num_sampled {num_sampled} <= C {num_classes}")
    pos = _unique_padded(labels, num_classes)
    pos_valid = pos < num_classes
    # positives pushed below the valid range; the sentinel's writes land in
    # the extra slot C, which is dropped
    scores = scores.index_fill(0, pos, -1.0)
    neg = sample_negatives(scores[:num_classes], num_sampled - n, n,
                           shift=shift)
    classes = torch.cat([torch.where(pos_valid, pos, 0), neg])
    col_valid = torch.cat([pos_valid, torch.ones(
        (num_sampled - n,), dtype=torch.bool, device=pos.device)])
    # the first (only) valid column equal to the label: its slot among the
    # ascending positives (jnp.argmax over the equality mask)
    target = torch.searchsorted(pos, labels.long())
    return classes, col_valid, target


def sample_classes(rng: Optional[torch.Generator], labels: torch.Tensor,
                   num_classes: int, num_sampled: int):
    """sample_classes_from_draws with the scores and the shift drawn from
    `rng` on the labels' device (static shapes, no host read)."""
    dev = labels.device
    scores = torch.rand((num_classes + 1,), generator=rng, device=dev)
    shift = torch.randint(0, num_classes, (), generator=rng, device=dev)
    return sample_classes_from_draws(labels, num_classes, num_sampled,
                                     scores, shift)


def logq_shift(col_valid: torch.Tensor, n: int,
               num_classes: int) -> torch.Tensor:
    """[C_s] logit shift of the sampled softmax: ln((C - u) / (C_s - N)),
    floored at 0, on the negative slots (u = the batch's unique
    positives; the log inverse inclusion probability of a negative,
    Bengio & Senecal 2008), 0 on the positive slots. Zero when the sample
    covers every class."""
    c_s = col_valid.shape[0]
    u = col_valid[:n].to(torch.float32).sum()
    log_inv_q = torch.log((num_classes - u) / float(c_s - n))
    is_neg = torch.arange(c_s, device=col_valid.device) >= n
    return torch.where(is_neg, torch.clamp_min(log_inv_q, 0.0), 0.0)


def make_partial_fc_train_step(
        head, head_cfg, num_sampled: int,
        lr_schedule: Optional[Callable] = None,
        momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False, lambda_g: float = 0.0,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
        horizontal_flip: bool = False, crop_pad: int = 0,
        color_jitter: float = 0.0, random_erasing: float = 0.0,
        logq_correction: bool = True, model_ema: float = 0.0,
        device=None, mesh=None) -> Callable:
    """Build step(state, images, labels, minput_images=None)
    -> (state, metrics), the sampled-classifier train step (one rank's of
    a data-only `mesh`: module docstring).

    `state.optimizer` updates the backbone alone; `state.kernel_w` [D, C]
    and `state.kernel_mom` (init_partial_fc_opt_state) follow the manual
    torch-SGD rule on the sampled columns. The lr is lr_schedule(count)
    (or the optimizer's own); the augmentations, the class sample, the
    dropout masks of the trunks that draw them and the heads' margins draw
    from `state.rng`; `model_ema` > 0 updates `state.ema`. The metrics are
    those of train/step.py, the accuracies over the sampled classes.
    logq_correction adds logq_shift to the negative logits (on by default,
    as in the JAX package). Runs on the card unless device='cpu'.
    """
    if head.name in UNSUPPORTED_HEADS:
        raise ValueError(
            f"partial_fc does not support head '{head.name}' "
            "(memory-blended heads need the full class axis for their "
            "[C, D] memories; sub-center kernels are [D, C*K], not one "
            "column per class)")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg_s = dataclasses.replace(head_cfg, num_classes=num_sampled)
    scale, bias = normalization_constants(mean, std, device=device)

    def train_step(state: TrainState, images, labels, minput_images=None):
        del minput_images  # the memory heads (its users) are unsupported
        if mesh is None:
            return one_step(state, images, labels)
        with coll.using(mesh):
            state, metrics = one_step(state, images, labels)
            return state, coll.average_metrics(metrics, mesh)

    def one_step(state, images, labels):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) * scale + bias
        images = apply_augmentations(state.rng, images, horizontal_flip,
                                     crop_pad, color_jitter, random_erasing)
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        labels_all = coll.gather_rows(labels)
        kernel, n = state.kernel_w, labels_all.shape[0]
        num_classes = kernel.shape[1]
        classes, col_valid, target = sample_classes(
            state.rng, labels_all, num_classes, num_sampled)
        target = coll.local_rows(target)
        # a padded positive slot takes slot 0's column (always a valid
        # positive) for its gather and its write-back
        cols = torch.where(col_valid, classes, classes[:1])
        w_s = kernel.detach().index_select(1, cols).requires_grad_()
        shift = (logq_shift(col_valid, n, num_classes) if logq_correction
                 else torch.zeros((num_sampled,), device=device))

        state.backbone.train()
        kw = ({"rng": state.rng}
              if getattr(state.backbone, "takes_rng", False) else {})
        feats = state.backbone(images, **kw).to(torch.float32)
        out = head.apply(cfg_s, w_s, feats, target, state.head_state,
                         rng=state.rng if head.requires_rng else None)
        # padded columns drop out of both softmaxes; the logQ shift moves
        # only the CE, not accuracy's pre-margin logits
        logits = torch.where(col_valid[None, :],
                             out.logits + shift[None, :], _NEG_INF)
        pre = torch.where(col_valid[None, :], out.pre_logits.detach(),
                          _NEG_INF)
        loss_id = mean_cross_entropy(logits, target)
        loss_mag = lambda_g * out.loss_g
        loss = loss_id + loss_mag
        if lr_schedule is None:
            lr = torch.full((), state.optimizer.param_groups[0]["lr"],
                            dtype=torch.float32, device=device)
        else:
            lr = lr_schedule(state.count)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        coll.average_gradients([*state.backbone.parameters(), w_s], mesh)
        with torch.no_grad():
            state.lr.copy_(lr)
            state.optimizer.step(state.lr)
            # the kernel: torch SGD on the sampled columns (JAX
            # partial_fc.py:261-270, its formulas)
            valid = col_valid[None, :].to(torch.float32)
            g = (w_s.grad + weight_decay * w_s) * valid
            mom_s = state.kernel_mom.index_select(1, cols)
            new_mom_s = momentum * mom_s + g
            step_dir = g + momentum * new_mom_s if nesterov else new_mom_s
            new_w = w_s + (-lr * step_dir * valid)
            new_mom = mom_s + (new_mom_s - mom_s) * valid
            # the padded slots write slot 0's new values into its column
            keep = col_valid[None, :]
            kernel.index_copy_(1, cols, torch.where(keep, new_w,
                                                    new_w[:, :1]))
            state.kernel_mom.index_copy_(1, cols, torch.where(
                keep, new_mom, new_mom[:, :1]))
            if model_ema > 0.0:
                ema_update(state, model_ema, 1)
            copy_head_state(state.head_state, out.state)
            state.count.add_(1)
        state.step += 1
        acc1, acc5 = topk_accuracy(pre, target)
        return state, {"loss": loss.detach(), "loss_id": loss_id.detach(),
                       "loss_mag": loss_mag.detach(), "acc1": acc1,
                       "acc5": acc5, "lr": lr,
                       "feat_norm": out.norms.detach().mean()}

    return train_step


def init_partial_fc_opt_state(kernel_w: torch.Tensor) -> torch.Tensor:
    """The kernel's momentum `kernel_mom`: zeros like the [D, C] kernel
    (the JAX opt_state's "kernel_mom"; the backbone's slots live in the
    state's optimizer)."""
    return torch.zeros_like(kernel_w)
