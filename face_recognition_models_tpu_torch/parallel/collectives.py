"""The collectives of the mesh, and their gradients.

In the JAX package one process sees global arrays and GSPMD inserts the
collectives; here each rank holds its rows and its class shard, and every
collective is made in this module. The rule the pieces keep: a world of
data x model ranks gives the step one process gives on the global batch, up
to the order of reductions.

Each rank backpropagates its own loss: the mean over its rows (the same
value on the ranks of one model group). The parameters' gradients are then
averaged over the data group (`average_gradients`), so a tensor a rank
backpropagates into carries `data` times the gradient of the global loss
with respect to it. The differentiable pieces keep that convention:

- `data_sum`: the sum over the data group; its backward is the same sum.
  The heads' batch statistics with a gradient (QAFace's magnitude mean and
  std) are global through it.
- `gather_rows`: the rows of every rank of the data group, in rank order;
  its backward sums the gradient over the group and keeps the rank's rows.
- `copy_to_model` / `reduce_from_model`: the edges of a class-sharded
  region (Megatron's "copy to" and "reduce from" the model-parallel
  region). A tensor every model peer holds enters the region through
  `copy_to_model` (identity forward; backward: the sum of the peers'
  gradients, since each shard's backward gives only its own share); a
  per-shard partial leaves it through `reduce_from_model` (forward: the sum
  over the model group; backward: identity, since the peers all hold the
  same loss). `max_over_model` has no gradient.

The statistics without a gradient (BatchNorm's running averages, the
CurricularFace / AdaFace EMAs, AdaCos's median) go through the same calls
on tensors that need none.

The heads, the augmentations and the dropout masks reach the mesh through
`using(mesh)`, which the train steps enter: without an active mesh every
function here is the identity of the one-process step. Per-row random draws
are global: `local_rows(torch.rand(global_rows(n), ...))` draws the global
batch's values from the step generator on every rank and keeps the rank's
rows, so a world draws what one process draws from the same seed.

The collectives are all-reduce, all-gather (`all_gather_into_tensor`) and
broadcast. gloo takes each of them on CUDA tensors as well as on CPU ones,
so the same calls run two ranks that share one card over gloo and one rank
a card over NCCL. `dist.barrier` is not among them: under gloo with a CUDA
device current it hands the socket a device pointer (`barrier` below is an
all-reduce of one int).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

_ACTIVE = None


@contextlib.contextmanager
def using(mesh) -> Iterator[None]:
    """Make `mesh` (a parallel/mesh.Mesh, or None) the active mesh inside
    the block."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = previous


def active():
    """The active mesh, or None."""
    return _ACTIVE


def _data_mesh(mesh=None):
    mesh = _ACTIVE if mesh is None else mesh
    return mesh if mesh is not None and mesh.data > 1 else None


def _model_mesh(mesh=None):
    mesh = _ACTIVE if mesh is None else mesh
    return mesh if mesh is not None and mesh.model > 1 else None


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """The reduction of x over `group`, in a new tensor (bool as int)."""
    if x.dtype == torch.bool:
        return _all_reduce(x.to(torch.int32), group, op).bool()
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size * n, ...] rows of every rank of `group`, rank order (bool as
    uint8)."""
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), group, size).bool()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.detach().contiguous(), group=group)
    return out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.group, ctx.index, ctx.n = group, index, x.shape[0]
        return _gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        i, n = ctx.index, ctx.n
        return g[i * n:(i + 1) * n], None, None, None


# ---------------------------------------------------------------------------
# the data group: rows of the batch
# ---------------------------------------------------------------------------


def data_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x summed over the data group (differentiable; identity without a
    data axis)."""
    m = _data_mesh(mesh)
    if m is None:
        return x
    if not x.requires_grad:
        return _all_reduce(x, m.data_group)
    return _Sum.apply(x, m.data_group)


def data_size(mesh=None) -> int:
    m = _data_mesh(mesh)
    return 1 if m is None else m.data


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of every element of x, whose rows are the rank's rows, over
    the global batch."""
    m = _data_mesh(mesh)
    if m is None:
        return x.mean()
    return data_sum(x.sum(), m) / (x.numel() * m.data)


def batch_var(x: torch.Tensor, correction: int = 1, mesh=None
              ) -> torch.Tensor:
    """The variance of every element of x over the global batch (two
    passes, `correction` as torch.var's)."""
    m = _data_mesh(mesh)
    if m is None:
        return x.var(correction=correction)
    mean = batch_mean(x, m)
    return data_sum(((x - mean) ** 2).sum(), m) / (
        x.numel() * m.data - correction)


def gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The global batch's rows of x, every rank's in rank order
    (differentiable)."""
    m = _data_mesh(mesh)
    if m is None:
        return x
    if not x.requires_grad:
        return _gather(x, m.data_group, m.data)
    return _GatherRows.apply(x, m.data_group, m.data_index, m.data)


def global_rows(n: int, mesh=None) -> int:
    """The global batch's row count for a rank's n rows."""
    return n * data_size(mesh)


def local_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rank's rows of a global-batch tensor x."""
    m = _data_mesh(mesh)
    if m is None:
        return x
    n = x.shape[0] // m.data
    return x[m.data_index * n:(m.data_index + 1) * n]


def average_gradients(params: Sequence[torch.Tensor], mesh=None) -> None:
    """Average the parameters' gradients over the data group, in one
    all-reduce of a flat buffer."""
    m = _data_mesh(mesh)
    if m is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat, group=m.data_group)
    flat.div_(m.data)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def average_metrics(metrics: dict, mesh=None) -> dict:
    """The metrics (0-d tensors, means over the rank's rows) as means over
    the global batch, in one all-reduce."""
    m = _data_mesh(mesh)
    if m is None or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=m.data_group)
    flat.div_(m.data)
    return dict(zip(keys, flat.unbind(0)))


# ---------------------------------------------------------------------------
# the model group: shards of the class axis
# ---------------------------------------------------------------------------


def copy_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    m = _model_mesh(mesh)
    return x if m is None else _Copy.apply(x, m.model_group)


def reduce_from_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    m = _model_mesh(mesh)
    if m is None:
        return x
    if not x.requires_grad:
        return _all_reduce(x, m.model_group)
    return _Reduce.apply(x, m.model_group)


def max_over_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    m = _model_mesh(mesh)
    return x if m is None else _all_reduce(x, m.model_group,
                                           dist.ReduceOp.MAX)


def model_size(mesh=None) -> int:
    m = _model_mesh(mesh)
    return 1 if m is None else m.model


def class_range(num_local: int, mesh=None):
    """(offset, num_local) of the rank's class shard."""
    m = _model_mesh(mesh)
    return (0 if m is None else m.model_index * num_local), num_local


class _GatherClasses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, m):
        ctx.dim, ctx.index, ctx.n = dim, m.model_index, x.shape[dim]
        moved = x.detach().movedim(dim, 0).contiguous()
        return _gather(moved, m.model_group, m.model).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        # every peer holds the same loss of the whole tensor: the shard's
        # gradient is its own slice, with no sum
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def gather_classes(x: torch.Tensor, dim: int, mesh=None,
                   grad: bool = False) -> torch.Tensor:
    """The whole class axis of a shard x (its classes on `dim`). With
    `grad`, differentiable: the shard's gradient is its slice of the whole
    tensor's, which every model peer computes alike."""
    m = _model_mesh(mesh)
    if m is None:
        return x
    if grad:
        return _GatherClasses.apply(x, dim, m)
    moved = x.detach().movedim(dim, 0).contiguous()
    return _gather(moved, m.model_group, m.model).movedim(0, dim)


def any_rank(flag: bool, mesh=None) -> bool:
    """True on every rank when `flag` is true on any rank of the world (the
    ranks' common stop decision)."""
    mesh = _ACTIVE if mesh is None else mesh
    if mesh is None or mesh.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier(mesh=None) -> None:
    """Wait for every rank of the world. An all-reduce of one int:
    `dist.barrier` under gloo hands the socket a device pointer when a CUDA
    device is current."""
    any_rank(False, mesh)


def is_writer(mesh=None) -> bool:
    """Whether this rank prints and writes files: rank 0, or any rank
    without a mesh."""
    m = _ACTIVE if mesh is None else mesh
    return m is None or m.rank == 0
