"""Experiment metric logging. Port of
face_recognition_models_tpu/utils/experiment.py.

The reference logs per-step metrics to Weights & Biases with the API key
from its environment. Here the logger uses W&B when the package is
installed and enabled, and otherwise appends JSON lines to
`<log_dir>/<name>.metrics.jsonl`, which works with no network. The
per-step payload has the reference's keys.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class ExperimentLogger:
    def __init__(self, project: str, name: str, config: Optional[Dict] = None,
                 log_dir: str = "logs", use_wandb: Optional[bool] = None):
        self.project = project
        self.name = name
        self._wandb = None
        self._file = None

        if use_wandb is None:
            use_wandb = os.environ.get("WANDB_API_KEY") is not None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project, name=name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # no package, no login: log to the file
                print(f"[logger] W&B unavailable ({type(e).__name__}: {e});"
                      f" writing {name}.metrics.jsonl")

        if self._wandb is None:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{name}.metrics.jsonl")
            self._file = open(path, "a", buffering=1)
            self._file.write(json.dumps(
                {"event": "init", "project": project, "name": name,
                 "config": config or {}, "time": time.time()}) + "\n")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        payload = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(payload, step=step)
        else:
            if step is not None:
                payload["step"] = step
            self._file.write(json.dumps(payload) + "\n")

    def save_artifact(self, path: str):
        """Record a checkpoint artifact (the reference's end-of-training
        wandb.save): W&B registers `path` (each file under it for a
        directory); the JSONL file records its absolute path."""
        if self._wandb is not None:
            pattern = (os.path.join(path, "**") if os.path.isdir(path)
                       else path)
            self._wandb.save(pattern, base_path=os.path.dirname(
                os.path.abspath(path)))
        elif self._file is not None:
            self._file.write(json.dumps(
                {"event": "artifact", "path": os.path.abspath(path),
                 "time": time.time()}) + "\n")

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
