"""Layout rules of the train state over the mesh. Port of
face_recognition_models_tpu/parallel/sharding.py.

`spec_for` is the JAX `_spec_for`: by a tensor's path and global shape,

- the classifier kernel [D, C] and its momenta (`kernel_w`, `kernel_mom`,
  the sub-center [D, C * K] included: whole classes stay together on a
  shard) split their columns over 'model': (None, 'model');
- the head memories [C, D] and lifetimes [C] split their rows:
  ('model', None) and ('model',);
- everything else is replicated: ().

The specs are tuples, as a JAX PartitionSpec is one. `shard` takes a
rank's part of a whole tensor and `gather` puts the whole tensor back
together; the train state is made whole on every rank from the seed and
sharded at once (train/state.create_train_state), and a checkpoint holds
whole tensors (checkpoint/manager.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from face_recognition_models_tpu_torch.parallel import collectives as coll

REPLICATED: Tuple = ()
CLASS_COLUMNS = (None, "model")
CLASS_ROWS = ("model", None)
CLASS_VECTOR = ("model",)


def spec_for(path: str, shape: Sequence[int], num_classes: int) -> Tuple:
    """The spec of one state tensor by its path and global shape."""
    shape = tuple(shape)
    if not shape:
        return REPLICATED
    if (("kernel_w" in path or "kernel_mom" in path)
            and len(shape) == 2 and shape[1] % num_classes == 0):
        return CLASS_COLUMNS
    if ("head_state" in path or "kernel_w" in path) \
            and shape[0] == num_classes:
        return CLASS_VECTOR if len(shape) == 1 else CLASS_ROWS
    return REPLICATED


def sharded_dim(spec: Tuple):
    """The dim a spec splits over 'model', or None."""
    return spec.index("model") if "model" in spec else None


def check_divides(num_classes: int, model: int) -> None:
    if num_classes % model != 0:
        raise ValueError(f"num_classes {num_classes} must divide over the "
                         f"model axis ({model})")


def shard(x: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The rank's part of the whole tensor x (a new contiguous tensor
    for a sharded spec, x itself otherwise)."""
    dim = sharded_dim(spec)
    if dim is None or mesh is None or mesh.model == 1:
        return x
    check_divides(x.shape[dim], mesh.model)
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_index * n, n).clone()


def shard_head_state(state, num_classes: int, mesh):
    """A head state (a NamedTuple of tensors, or None) with its class
    tensors cut to the rank's shard."""
    if state is None or mesh is None or mesh.model == 1:
        return state
    return type(state)(*(shard(x, spec_for("head_state", x.shape,
                                           num_classes), mesh)
                         for x in state))


def gather_head_state(state, num_classes: int, mesh):
    """The whole head state of the ranks' shards (shard_head_state's
    inverse)."""
    if state is None or mesh is None or mesh.model == 1:
        return state

    def whole(x):
        if x.dim() == 0:
            return x
        spec = spec_for("head_state", (x.shape[0] * mesh.model,)
                        + tuple(x.shape[1:]), num_classes)
        return gather(x, spec, mesh)

    return type(state)(*(whole(x) for x in state))


def gather(x: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The whole tensor of the ranks' parts x, on every rank of the model
    group, without gradient."""
    dim = sharded_dim(spec)
    if dim is None or mesh is None or mesh.model == 1:
        return x
    return coll.gather_classes(x, dim, mesh)
