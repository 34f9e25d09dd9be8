"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and there
    is no card; it never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    return dev


def nvidia_smi() -> str:
    """The first card's `name, power.limit` as nvidia-smi prints them: a
    card may be set below its maximum power and then runs slower, so every
    time measured on it is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]
