"""The ('data', 'model') mesh. Port of face_recognition_models_tpu/
parallel/mesh.py.

`make_mesh` lays the world's ranks out row-major on a
`torch.distributed.device_mesh.DeviceMesh` with dims ('data', 'model'), as
the JAX mesh lays out its devices: rank r sits at data coordinate
r // model and model coordinate r % model. The batch splits over 'data'
(the gradients are averaged over each data group), the classifier's class
axis and the head memories over 'model'. `Mesh` keeps the DeviceMesh, its
two process groups and this rank's coordinates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from face_recognition_models_tpu_torch.config import MeshConfig


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[int, int]:
    """(data, model) of cfg over n ranks, with the JAX make_mesh's rules and
    error."""
    model = cfg.model if cfg.model > 0 else 1
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(
            f"Mesh {data}x{model} does not cover {n} devices. "
            "Set MeshConfig(data=..., model=...) so data*model == device "
            "count.")
    return data, model


class Mesh:
    """A ('data', 'model') DeviceMesh, its groups and this rank's place."""

    def __init__(self, device_mesh: DeviceMesh,
                 axis_names: Tuple[str, str] = ("data", "model")):
        self.device_mesh = device_mesh
        data_axis, model_axis = axis_names
        self.data, self.model = device_mesh.mesh.shape
        self.data_group = device_mesh.get_group(data_axis)
        self.model_group = device_mesh.get_group(model_axis)
        self.data_index = device_mesh.get_local_rank(data_axis)
        self.model_index = device_mesh.get_local_rank(model_axis)
        self.rank = dist.get_rank()
        self.size = self.data * self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}"
                f" at ({self.data_index}, {self.model_index}))")


def make_mesh(cfg: MeshConfig = MeshConfig(),
              world_size: Optional[int] = None) -> Mesh:
    """The mesh of cfg over the process group (which must be joined:
    parallel/dist.initialize). Its DeviceMesh is a 'cuda' one under NCCL
    and a 'cpu' one under gloo, whatever device the tensors are on: gloo
    takes tensors of either."""
    n = dist.get_world_size() if world_size is None else world_size
    data, model = mesh_shape(cfg, n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(data, model)
    return Mesh(DeviceMesh(device_type, ranks,
                           mesh_dim_names=tuple(cfg.axis_names)),
                tuple(cfg.axis_names))
