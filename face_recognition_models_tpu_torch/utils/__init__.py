"""Utilities of the port: device selection, the weight bridge, the
training loop's console and experiment logging, debugging and the
compiled libraries' cache."""

from face_recognition_models_tpu_torch.utils.experiment import (  # noqa: F401
    ExperimentLogger,
)
from face_recognition_models_tpu_torch.utils.logging import (  # noqa: F401
    MetricTracker,
    Tee,
)

__all__ = ["MetricTracker", "Tee", "ExperimentLogger"]
