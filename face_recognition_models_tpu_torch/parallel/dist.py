"""Joining the process group: the counterpart of the JAX package's
`jax.distributed.initialize()` (cli/main.py `--multihost`).

One process drives one card. Under `torchrun` each process reads RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT from its environment;
`initialize` joins the group those name and returns the rank's device,
`cuda:LOCAL_RANK` unless the caller asks for the CPU. The backend is NCCL on
the card and gloo on the CPU, unless one is named: two ranks that share one
card must name gloo, since NCCL refuses two ranks on one device. Every group
gets a timeout, so a rank left waiting in a collective fails instead of
hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def local_device(device: Optional[Union[str, torch.device]] = None
                 ) -> torch.device:
    """The rank's device: `device` when given (a bare 'cuda' becomes
    cuda:LOCAL_RANK), else cuda:LOCAL_RANK."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None,
               init_method: str = "env://",
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT
               ) -> torch.device:
    """Join the process group and return this rank's device. Without
    `rank` / `world_size` they come from the environment (torchrun's);
    `init_method` may be 'tcp://host:port' instead of env://. A second
    call in a process that already joined returns the device and joins
    nothing."""
    dev = local_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass --device cpu to run the "
                "ranks on the CPU")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kw)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
