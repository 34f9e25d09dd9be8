"""Checkpoints with the reference's rotation / best / resume semantics,
saved with torch.save. Port of face_recognition_models_tpu/checkpoint/
manager.py.

Reference behaviour replicated (model_utils.py:43-138, 569-581):
- rotating epoch checkpoints, keep the 3 latest (`:72-78`);
- a separate best-by-min-TRAIN-loss checkpoint (`:79-81`, `:572-575`);
- resume 'latest' picks the highest epoch (`:104-109`);
- resume 'min_loss' DELETES all epoch checkpoints first (min_loss may be
  older than the newest epoch, `:112-121`), but only once the best file
  is there, then loads the best;
- a fresh (non-resume) run wipes the checkpoint dir (`:532-534`);
- returns (start_epoch = saved epoch + 1, train_loss) (`:133-136`).

One file per checkpoint, named as the JAX package names its directories:
`epoch_<n>`, `min_loss`, `<model>_final`. A save writes a temporary file
and renames it over the target, so a file that exists is complete, and
rotation deletes the oldest epoch only after the new one is in place.
Saves are synchronous.

The payload is everything a resumed run needs to repeat the uninterrupted
one bit for bit: the backbone's state_dict (parameters and BatchNorm
buffers, num_batches_tracked included), `kernel_w` (and Partial-FC's
`kernel_mom`; none of either for the triplet path), every head-state
tensor in its own dtype (the VPL / QAFace memory and counters, SphereFace's
int iter, CurricularFace's t, AdaFace's statistics, AdaCos's scale), the
optimizer's state_dict (its slots and step count; under grad_accum also
the accumulated gradients and mini_step), the model EMA, the step, the
state's step generator
(`TrainState.rng`, the elastic heads' draws) and the default generators
(CPU and the card's) that dropout or sampling would draw from; plus the
epoch and its train loss (a Python float; the JAX package rounds it to
float32). Restoring
loads into a live TrainState in place: the parameters keep their objects
and layout (channels-last on the card), so the optimizer's slots stay bound
to them, and the slots, the EMA and the head state keep their addresses.

Under a mesh (`mesh=` of save / restore / reset) a checkpoint holds whole
tensors in the one-process layout, so a world's checkpoint resumes in one
process and the reverse. The class shards (kernel_w, kernel_mom, the
kernel's optimizer slots and EMA, the head memories and lifetimes) are
broadcast over rank 0's model group in blocks of columns (or rows) into
one host copy on rank 0, which alone writes and rotates the files; on
restore each rank maps the file and takes its own slice. Every rank calls
save and restore, and each ends with a barrier, so no rank runs ahead of a
file or waits in a collective the others have left.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from face_recognition_models_tpu_torch.parallel import collectives as coll
from face_recognition_models_tpu_torch.parallel import sharding

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")


def _write(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str, map_location, mmap: bool = False) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True,
                      mmap=mmap)


# columns (or rows) of a class shard per broadcast when a checkpoint is
# gathered: the device holds one block of it at a time
_BLOCK = 1 << 16


def _class_entries(payload: Dict[str, Any], state, num_classes: int,
                   model: int):
    """(container, key, dim) of every class-sharded tensor of a payload
    whose kernel has num_classes / model columns (a rank's shard, or with
    model 1 the whole): kernel_w and kernel_mom on dim 1, the kernel's
    optimizer slots and gradient means and its EMA, and the head state's
    class rows."""
    kernel = state.kernel_w
    if kernel is None:
        return []
    shape = payload["kernel_w"].shape
    out = [(payload, "kernel_w", 1)]
    if payload["kernel_mom"] is not None:
        out.append((payload, "kernel_mom", 1))
    if payload["ema"] is not None:
        out.append((payload["ema"], len(payload["ema"]) - 1, 1))
    for i, x in enumerate(payload["head_state"] or ()):
        if x.dim() and sharding.sharded_dim(sharding.spec_for(
                "head_state", (x.shape[0] * model,) + tuple(x.shape[1:]),
                num_classes)) == 0:
            out.append((payload["head_state"], i, 0))
    params = state.optimizer._params
    k = next((i for i, p in enumerate(params) if p is kernel), None)
    if k is not None:
        opt = payload["optimizer"]
        inner = opt.get("inner", opt)
        slots = inner["state"].get(k, {})
        out += [(slots, name, 1) for name, v in slots.items()
                if isinstance(v, torch.Tensor) and v.shape == shape]
        if "acc" in opt:
            out.append((opt["acc"], k, 1))
    return out


def _gather_to_host(x: torch.Tensor, dim: int, mesh, writer: bool):
    """The whole tensor of the model group's shards x on the host of the
    writer (None elsewhere), one block of `_BLOCK` broadcast at a time."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.model
    whole = torch.empty(shape, dtype=x.dtype) if writer else None
    ranks = dist.get_process_group_ranks(mesh.model_group)
    for j, src in enumerate(ranks):
        for start in range(0, n, _BLOCK):
            width = min(_BLOCK, n - start)
            if j == mesh.model_index:
                buf = x.detach().narrow(dim, start, width).contiguous()
            else:
                size = list(x.shape)
                size[dim] = width
                buf = torch.empty(size, dtype=x.dtype, device=x.device)
            dist.broadcast(buf, src=src, group=mesh.model_group)
            if writer:
                whole.narrow(dim, j * n + start, width).copy_(buf)
    return whole


def _payload(state, mesh=None) -> Optional[Dict[str, Any]]:
    """The train state's tensors and counters, as torch.save takes them.
    A state without a head (the triplet path's) has kernel_w None. Under a
    mesh with a model axis the class shards are gathered on rank 0, and
    the payload is None on the other ranks."""
    payload = _local_payload(state)
    if mesh is None or mesh.model == 1:
        return payload if coll.is_writer(mesh) else None
    writer = coll.is_writer(mesh)
    # new containers: the optimizer's state_dict holds its live slot dicts
    payload = _containers_copied(payload)
    c = state.kernel_w.shape[1] * mesh.model
    for box, key, dim in _class_entries(payload, state, c, mesh.model):
        box[key] = _gather_to_host(box[key], dim, mesh, writer)
    return payload if writer else None


def _containers_copied(obj):
    """obj with every dict and list copied, the tensors shared."""
    if isinstance(obj, dict):
        return {k: _containers_copied(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_containers_copied(v) for v in obj]
    return obj


def _shard_payload(payload: Dict[str, Any], state, mesh) -> None:
    """Cut a whole payload's class tensors to the rank's shards, in
    place."""
    if mesh is None or mesh.model == 1 or state.kernel_w is None:
        return
    c = payload["kernel_w"].shape[1]
    for box, key, dim in _class_entries(payload, state, c, 1):
        size = box[key].shape[dim] // mesh.model
        box[key] = box[key].narrow(dim, mesh.model_index * size, size)


def _local_payload(state) -> Dict[str, Any]:
    rng = {"cpu": torch.get_rng_state()}
    device = state.count.device
    if device.type == "cuda":
        rng["cuda"] = torch.cuda.get_rng_state(device)
    return {"backbone": state.backbone.state_dict(),
            "kernel_w": (None if state.kernel_w is None
                         else state.kernel_w.detach()),
            "kernel_mom": state.kernel_mom,
            "head_state": (None if state.head_state is None
                           else list(state.head_state)),
            "optimizer": state.optimizer.state_dict(),
            "ema": None if state.ema is None else list(state.ema),
            "step": state.step,
            "rng": rng,
            "generator": (None if state.rng is None
                          else state.rng.get_state())}


def _load_into(state, payload: Dict[str, Any]) -> None:
    """Load `payload` (_payload's) into the live `state` in place: the head
    state's tensors and the step count keep their addresses."""
    state.backbone.load_state_dict(payload["backbone"])
    with torch.no_grad():
        if state.kernel_w is not None:
            state.kernel_w.copy_(payload["kernel_w"])
        if payload["head_state"] is not None:
            for x, y in zip(state.head_state, payload["head_state"],
                            strict=True):
                x.copy_(y)
        for key in ("ema", "kernel_mom"):
            if (payload.get(key) is None) != (getattr(state, key) is None):
                raise ValueError(f"the checkpoint and the run differ in "
                                 f"{key}: one has it, the other not")
        for x, y in zip(state.ema or (), payload.get("ema") or (),
                        strict=True):
            x.copy_(y)
        if state.kernel_mom is not None:
            state.kernel_mom.copy_(payload["kernel_mom"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.set_step(payload["step"])
    # generator states are CPU byte tensors, wherever the load mapped them
    if payload.get("generator") is not None:
        state.rng.set_state(payload["generator"].cpu())
    torch.set_rng_state(payload["rng"]["cpu"].cpu())
    if "cuda" in payload["rng"]:
        torch.cuda.set_rng_state(payload["rng"]["cuda"].cpu(),
                                 state.count.device)


class CheckpointManager:
    def __init__(self, directory: str, model_name: str = "model",
                 keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.model_name = model_name
        self.keep = keep

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}")

    @property
    def _best_path(self) -> str:
        return os.path.join(self.directory, "min_loss")

    def _final_path(self, filename: Optional[str]) -> str:
        return os.path.join(self.directory,
                            filename or f"{self.model_name}_final")

    def _list_epochs(self):
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            m = _EPOCH_RE.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def reset(self, mesh=None):
        """Fresh-run wipe (model_utils.py:532-534), by rank 0."""
        if coll.is_writer(mesh):
            if os.path.isdir(self.directory):
                shutil.rmtree(self.directory)
            os.makedirs(self.directory, exist_ok=True)
        coll.barrier(mesh)

    def save(self, state, epoch: int, train_loss: float,
             is_best: bool = False, mesh=None):
        """Save an epoch checkpoint (rotating keep-N) or the best one.
        Under a mesh every rank calls it and rank 0 writes."""
        payload = (_payload(state, mesh)
                   if mesh is None or mesh.data_index == 0 else None)
        if payload is not None:
            os.makedirs(self.directory, exist_ok=True)
            target = self._best_path if is_best else self._epoch_path(epoch)
            _write({"state": payload, "epoch": int(epoch),
                    "train_loss": float(train_loss)}, target)
            if not is_best:
                epochs = self._list_epochs()
                while len(epochs) > self.keep:
                    victim = epochs.pop(0)
                    if victim != epoch:
                        os.remove(self._epoch_path(victim))
        coll.barrier(mesh)

    def restore(self, state, mode: str = "latest", mesh=None
                ) -> Tuple[Any, int, float]:
        """Load per resume semantics into `state` (a live TrainState of the
        same configuration; under a mesh the rank's sharded one). Returns
        (state, start_epoch, loss); (None, 1, inf) when there is nothing to
        restore."""
        if mode not in ("latest", "min_loss"):
            raise ValueError("mode must be 'latest' or 'min_loss'")
        coll.barrier(mesh)
        if not os.path.isdir(self.directory):
            return None, 1, float("inf")
        if mode == "min_loss":
            # min_loss may predate newer epoch checkpoints: delete them,
            # but only once the best file is known to exist, so a missing
            # best never destroys the only resumable state
            if not os.path.isfile(self._best_path):
                return None, 1, float("inf")
            coll.barrier(mesh)
            if coll.is_writer(mesh):
                for e in self._list_epochs():
                    os.remove(self._epoch_path(e))
            target = self._best_path
        else:
            epochs = self._list_epochs()
            if not epochs:
                return None, 1, float("inf")
            target = self._epoch_path(epochs[-1])
        if mesh is None:
            payload = _load(target, state.count.device)
        else:
            payload = _load(target, "cpu", mmap=True)
            _shard_payload(payload["state"], state, mesh)
        _load_into(state, payload["state"])
        coll.barrier(mesh)
        return state, payload["epoch"] + 1, payload["train_loss"]

    def save_final(self, obj: Any, filename: Optional[str] = None):
        """The final artifact (model_utils.py:581): what `obj` holds, the
        backbone's state_dict for `train`."""
        os.makedirs(self.directory, exist_ok=True)
        _write(obj, self._final_path(filename))

    def restore_final(self, filename: Optional[str] = None):
        """The final artifact, on the CPU."""
        return _load(self._final_path(filename), "cpu")


def restore_backbone(checkpoint_dir: str, which: str = "final",
                     model_name: Optional[str] = None
                     ) -> Dict[str, torch.Tensor]:
    """The embedding model's state_dict from a train run's checkpoint dir,
    selecting the artifact like `eval --which`:

    - 'final'     — the end-of-training backbone (<model>_final);
    - 'final_ema' — the model-EMA backbone (<model>_final_ema);
    - 'best_acc'  — the best-by-verification backbone (<model>_best_acc);
    - 'min_loss'  — the backbone inside the best-by-train-loss full train
      state (the artifact the reference evaluates, evaluate_models.py:61).

    The port's training writes 'final', 'min_loss' and, with model_ema,
    'final_ema'; 'best_acc' is read where another run wrote it. The
    tensors come back on the CPU.
    model_name defaults to the dir's basename."""
    name = model_name or os.path.basename(checkpoint_dir.rstrip("/"))
    if which == "min_loss":
        full = _load(os.path.join(checkpoint_dir, "min_loss"), "cpu")
        return full["state"]["backbone"]
    if which in ("final", "final_ema", "best_acc"):
        mgr = CheckpointManager(checkpoint_dir, name)
        return mgr.restore_final(
            None if which == "final" else f"{name}_{which}")
    raise ValueError(
        f"which must be final, final_ema, best_acc or min_loss "
        f"(got {which!r})")
