"""Console and file metric reporting of the training loop. Port of
face_recognition_models_tpu/utils/logging.py.

The reference's observability layer: stdout teed to log/<model>.txt,
running averages, a progress line a print step. The loop keeps its metrics
on the device and hands `MetricTracker.observe` host floats only at
print_freq steps, so nothing here waits for the card or holds a tensor.
"""

from __future__ import annotations

import io
from typing import Dict, Iterable, Mapping, Sequence, Tuple


class Tee(io.TextIOBase):
    """A text stream writing to several underlying streams.

    With `contextlib.redirect_stdout(Tee(sys.stdout, logfile))` every
    training line reaches both the console and the model's log file.
    """

    def __init__(self, *streams):
        super().__init__()
        self._streams = tuple(streams)

    def write(self, text: str) -> int:
        for stream in self._streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self._streams:
            stream.flush()

    def writable(self) -> bool:
        return True

    def isatty(self) -> bool:
        return any(getattr(s, "isatty", lambda: False)()
                   for s in self._streams)

    def fileno(self) -> int:
        # libraries that probe stdout's fd get the first stream that has one
        for stream in self._streams:
            fn = getattr(stream, "fileno", None)
            if fn is not None:
                try:
                    return fn()
                except (OSError, io.UnsupportedOperation):
                    continue
        raise io.UnsupportedOperation("no underlying stream has a fileno")


class MetricTracker:
    """Weighted running averages over an ordered metric spec, with one-line
    progress rendering.

    spec: (key, label, format_spec) triples, e.g. ("loss", "Loss", ".3f").
    `observe` folds in one step's values; `line(step)` renders
    `prefix [step/total] Label last (avg) ...`; `averages()` gives the
    epoch means.
    """

    def __init__(self, total_steps: int,
                 spec: Iterable[Tuple[str, str, str]], prefix: str = ""):
        self.total_steps = total_steps
        self.prefix = prefix
        self._spec = [tuple(entry) for entry in spec]
        self._last: Dict[str, float] = {}
        self._sum: Dict[str, float] = {}
        self._weight: Dict[str, float] = {}

    def observe(self, values: Mapping[str, float], weight: float = 1.0):
        """Fold one step's host metric floats in. Keys not in the spec are
        tracked; they just don't render."""
        for key, value in values.items():
            value = float(value)
            self._last[key] = value
            self._sum[key] = self._sum.get(key, 0.0) + value * weight
            self._weight[key] = self._weight.get(key, 0.0) + weight

    def average(self, key: str) -> float:
        w = self._weight.get(key, 0.0)
        return self._sum.get(key, 0.0) / w if w else 0.0

    def averages(self) -> Dict[str, float]:
        return {k: self.average(k) for k in self._weight}

    def line(self, step: int) -> str:
        width = len(str(self.total_steps))
        parts = [f"{self.prefix}[{step:{width}d}/{self.total_steps}]"]
        for key, label, fmt in self._spec:
            if key not in self._last:
                continue
            parts.append(f"{label} {self._last[key]:{fmt}}"
                         f" ({self.average(key):{fmt}})")
        return "\t".join(parts)


# The reference's train loop renders these columns; the keys are the train
# step's metrics plus the loop's timings.
TRAIN_COLUMNS: Sequence[Tuple[str, str, str]] = (
    ("batch_time", "Time", "6.3f"),
    ("data_time", "Data", "6.3f"),
    ("throughput", "img/s", ".0f"),
    ("loss", "Loss", ".3f"),
    ("loss_id", "L_ID", ".3f"),
    ("loss_mag", "L_mag", ".6f"),
    # only rendered when the train step emits it (distillation on)
    ("loss_kd", "L_KD", ".4f"),
    ("acc1", "Acc@1", "6.2f"),
    ("acc5", "Acc@5", "6.2f"),
)
