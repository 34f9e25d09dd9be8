"""Step batching: K train steps as one CUDA graph. Port of `scan_steps`
of face_recognition_models_tpu/train/loop.py (`chunk_fn` / `jit_chunk`,
loop.py:325-336), where K steps run as one `lax.scan` in one dispatch.

`make_chunk_fn` is the scan: K calls of the one train step over the slots of
a [K, N, H, W, 3] uint8 and a [K, N] int32 batch, QAFace's degraded view
made on the device inside the body, the metrics stacked into [K] vectors.
`ChunkRunner` runs it over static slots on the device. On the card it
captures the chunk once into a CUDA graph and then replays it: one launch
for K steps, whatever the host costs a step. On the CPU, where there are no
graphs, it calls the chunk function itself.

Capture records and runs nothing, but the capture needs warm kernels,
libraries and workspaces. So the first call runs the chunk eagerly on the
slots it was given, with host synchronisation made an error, on the
stream the capture uses, then puts back the state it had before (every
tensor of the state, the host step and the generator's state), captures,
and replays: the first chunk's batches are trained by the graph, as every
later chunk's. The step generator is registered with the graph, so each
replay draws the elastic heads' margins anew and moves the generator on as
the eager steps do. A step that waits for the host, or a capture that
fails, raises with its cause; nothing falls back to the eager steps.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from face_recognition_models_tpu_torch.ops import fused_head
from face_recognition_models_tpu_torch.ops.image_ops import degrade_images
from face_recognition_models_tpu_torch.train.state import (
    TrainState,
    restore,
    snapshot,
)


def make_chunk_fn(step_fn: Callable, requires_minput: bool) -> Callable:
    """chunk(state, images_k, labels_k) -> (state, {metric: [K] tensor}):
    the steps of `step_fn` over the K slots, in order."""

    def chunk(state, images_k, labels_k):
        metrics = []
        for images, labels in zip(images_k, labels_k):
            if requires_minput:
                state, m = step_fn(state, images, labels,
                                   degrade_images(images))
            else:
                state, m = step_fn(state, images, labels)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    return chunk


class ChunkRunner:
    """K train steps per call over static device slots: a CUDA graph on the
    card, the chunk function on the CPU.

    `fill` stages K loader batches into the slots, `run` trains the state on
    them and returns the chunk's [K] metrics as tensors of the caller's (a
    replay overwrites the graph's own outputs). `close` frees the graph and
    its memory pool. `capture_seconds` is the first call's warm-up and
    capture, `replays` the graph's replays, `replay_launches` the kernel
    launches of ops/fused_head.py one replay makes.
    """

    def __init__(self, chunk: Callable, k: int, device: torch.device):
        self.chunk, self.k, self.device = chunk, k, device
        self.images: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Dict[str, torch.Tensor] = {}
        self.capture_seconds = 0.0
        self.replays = 0
        self.replay_launches: Dict[str, int] = {}

    def fill(self, stage, batches) -> None:
        """Copy K (uint8 images, labels) loader batches into the slots
        through `stage` (loop.HostStaging), on the current stream."""
        if len(batches) != self.k:
            raise ValueError(f"a chunk takes {self.k} batches, got "
                             f"{len(batches)}")
        for i, (images, labels) in enumerate(batches):
            if self.images is None:
                self.images = torch.empty((self.k, *images.shape),
                                          dtype=torch.uint8,
                                          device=self.device)
                self.labels = torch.empty((self.k, len(labels)),
                                          dtype=torch.int32,
                                          device=self.device)
            stage(images, labels, out=(self.images[i], self.labels[i]))

    def run(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Train `state` on the filled slots: K steps."""
        if self.device.type != "cuda":
            return self.chunk(state, self.images, self.labels)[1]
        if self.graph is None:
            self._capture(state)
        self.graph.replay()
        state.step += self.k
        self.replays += 1
        return {k: v.clone() for k, v in self._out.items()}

    def _capture(self, state: TrainState) -> None:
        t0 = time.perf_counter()
        saved = snapshot(state)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.chunk(state, self.images, self.labels)
            except RuntimeError as e:
                raise RuntimeError(
                    "scan_steps: the train step cannot be captured in a "
                    f"CUDA graph: {e}") from e
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            restore(state, saved)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if state.rng is not None:
            graph.register_generator_state(state.rng)
        before = dict(fused_head.captured_counts)
        try:
            with torch.cuda.graph(graph, stream=side):
                _, self._out = self.chunk(state, self.images, self.labels)
        except RuntimeError as e:
            raise RuntimeError(
                f"scan_steps: capturing {self.k} train steps in a CUDA "
                f"graph failed: {e}") from e
        # the capture ran the steps' Python code but none of their work
        state.step = saved[1]
        if state.rng is not None:
            state.rng.set_state(saved[2])
        self.replay_launches = {
            k: v - before[k] for k, v in fused_head.captured_counts.items()
            if v != before[k]}
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def close(self, state: TrainState) -> None:
        """Free the graph, its memory pool and the slots; the parameters'
        gradients, which live in the pool after a replay, go too."""
        if self.graph is not None:
            state.optimizer.zero_grad(set_to_none=True)
            self._out = {}
            self.graph.reset()
            self.graph = None
            torch.cuda.empty_cache()
        self.images = self.labels = None
