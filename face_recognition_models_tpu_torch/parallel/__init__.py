"""Multi-process training over a ('data', 'model') mesh. Port of
face_recognition_models_tpu/parallel/: one process per card, each holding
its rows of the batch and its shard of the class axis, with every
collective made by the port itself (parallel/collectives.py)."""

from face_recognition_models_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
