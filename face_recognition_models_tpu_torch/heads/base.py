"""Margin-head framework.

Port of face_recognition_models_tpu/heads/base.py. A head is a bundle of
plain functions over tensors:

    kernel = init_kernel(cfg, generator, device)   # [D, C] class prototypes
    state  = init_state(cfg, device)               # head state (or None)
    out    = apply(cfg, kernel, feats, labels, state, rng=None, minput=None)

`rng` is a torch.Generator on the step's device; only heads with
`requires_rng` (the elastic heads, which draw per-sample margins) read it.
`minput` is the feature of a second, degraded view of the batch; only heads
with `requires_minput` (QAFace) read it.

All head math is fp32 whatever the backbone's compute dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from face_recognition_models_tpu_torch.parallel import collectives as coll


class HeadOutput(NamedTuple):
    pre_logits: torch.Tensor  # margin-free scaled logits [N, C] (accuracy)
    logits: torch.Tensor      # post-margin scaled logits [N, C] (CE loss)
    norms: torch.Tensor       # per-sample feature norms [N, 1]
    loss_g: torch.Tensor      # scalar auxiliary loss (MagFace regulariser)
    one_hot: torch.Tensor     # [N, C] target mask
    state: Any                # updated head state


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """[N, C] one-hot; a label outside [0, C) (-1: ignore) gives an all-zero
    row, as jax.nn.one_hot does. The heads' target mask, and the loss's and
    the metrics' target selection."""
    cols = torch.arange(num_classes, device=labels.device)
    return (labels.long()[:, None] == cols[None, :]).to(dtype)


def shard_one_hot(labels: torch.Tensor, num_local: int,
                  dtype=torch.float32) -> torch.Tensor:
    """[N, num_local] one-hot over the rank's class shard [offset, offset +
    num_local) of the active model axis (collectives.class_range): a label
    in another shard, or -1, gives a zero row. Without a model axis,
    one_hot(labels, num_local)."""
    offset, _ = coll.class_range(num_local)
    return one_hot(labels.long() - offset, num_local, dtype)


class _TakeColumns(torch.autograd.Function):
    """w.index_select(1, idx) with a backward that adds each column's rows
    in one fixed order. index_select's own backward (index_add_) adds
    repeated indices with float atomics on the card, in an order that moves
    with timing; there index_put_ with accumulate=True sorts the indices
    stably and adds each index's rows in that order. On the CPU index_add_
    already adds them one after another, in batch order; index_put_ would
    add them with atomics across threads."""

    @staticmethod
    def forward(ctx, w, idx):
        ctx.save_for_backward(idx)
        ctx.columns = w.shape[1]
        return w.index_select(1, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        if grad.device.type != "cuda":
            return grad.new_zeros((grad.shape[0], ctx.columns)).index_add_(
                1, idx, grad), None
        return sorted_column_sums(grad, idx, ctx.columns), None


def sorted_column_sums(grad: torch.Tensor, idx: torch.Tensor,
                       columns: int) -> torch.Tensor:
    """[D, columns]: column c the sum of the grad [D, N] columns n with
    idx[n] == c, through index_put_'s sorted accumulate (take_columns'
    backward on the card). Without the range check of index_put_, which
    reads the indices' min and max back to the host: the forward's
    index_select already checked them, and a step that waits for the host
    cannot be captured in a CUDA graph."""
    rows = grad.new_zeros((columns, grad.shape[0]))   # [C, D]
    torch.ops.aten._index_put_impl_(rows, (idx,), grad.T.contiguous(),
                                    accumulate=True, unsafe=True)
    return rows.T


def take_columns(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The columns `idx` of w [D, C] as [D, N], the same values as
    w.index_select(1, idx); its gradient is bitwise repeatable where idx
    repeats (the target-column gathers of the heads)."""
    return _TakeColumns.apply(w, idx.long())


class Head(NamedTuple):
    name: str
    init_kernel: Callable[..., torch.Tensor]
    init_state: Callable[..., Any]
    apply: Callable[..., HeadOutput]
    requires_rng: bool = False     # the elastic heads sample per-step margins
    requires_minput: bool = False  # QAFace needs a second (degraded) view


_REGISTRY: Dict[str, Head] = {}


def register_head(head: Head) -> Head:
    _REGISTRY[head.name] = head
    return head


def get_head(name: str) -> Head:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown head '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_heads():
    return sorted(_REGISTRY)
