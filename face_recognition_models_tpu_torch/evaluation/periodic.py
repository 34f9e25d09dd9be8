"""Verification evaluation during training. Port of face_recognition_
models_tpu/evaluation/periodic.py (`train --eval-every`).

A `fit(hooks=...)` callback that:
- loads each benchmark's pairs and images once (host memory);
- every N epochs, and at the last one, embeds them with a module of its
  own that takes a copy of the weights to evaluate (the live trunk's, or
  the model EMA's), so it never touches the train state;
- runs the 10-fold Youden protocol (evaluation/verification.py) on each
  benchmark;
- logs `val/<bench>_acc` / `val/<bench>_auc` to a logger, when one is
  given;
- keeps the best mean verification accuracy, saving that backbone as
  `<model>_best_acc` (restorable with `restore_backbone(..., 'best_acc')`
  and `eval --which best_acc`), a validation-gated best beside the
  best-by-train-loss `min_loss`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from face_recognition_models_tpu_torch.evaluation.batch_eval import (
    load_benchmark,
)
from face_recognition_models_tpu_torch.evaluation.verification import (
    embed_unique_images,
    kfold_verification,
    pair_cosine_similarities,
)
from face_recognition_models_tpu_torch.models.backbones import to_device
from face_recognition_models_tpu_torch.train.state import ema_state_dict
from face_recognition_models_tpu_torch.train.step import make_eval_step
from face_recognition_models_tpu_torch.utils.device import resolve_device


class PeriodicEvalHook:
    """Epoch-end hook: verification benchmarks every `every` epochs.

    Pass the instance as `fit(..., hooks=hook)`. The last training epoch
    (`total_epochs`) always evaluates, so the run ends with fresh numbers.
    `backbone` is a module built as the trained one (its weights are
    overwritten at each evaluation). use_ema: evaluate the model-EMA
    weights (train/state.ema_state_dict) instead of the raw ones, the
    artifact `--model-ema` runs deploy. Runs on `device` (the card unless
    'cpu').
    """

    def __init__(self, backbone, eval_root: str,
                 benchmarks: Sequence[str], every: int = 1,
                 image_size: int = 112, batch_size: int = 256,
                 total_epochs: Optional[int] = None,
                 logger=None, checkpoint_manager=None,
                 model_name: str = "model", use_ema: bool = False,
                 verbose: bool = True, flip: bool = False, device=None):
        if every < 1:
            raise ValueError(f"every must be >= 1 (got {every})")
        self.every = int(every)
        self.total_epochs = total_epochs
        self.logger = logger
        self.manager = checkpoint_manager
        self.model_name = model_name
        self.use_ema = use_ema
        self.verbose = verbose
        self.flip = flip  # insightface flip-sum TTA (--eval-flip)
        self.batch_size = int(batch_size)
        device = resolve_device(device)
        self.backbone = to_device(backbone, device)
        self._step = make_eval_step(self.backbone, device=device)

        # {bench: (pairs [P,3] int, stack [U,H,W,3] u8, id_to_row)}, in
        # either on-disk form (batch_eval.load_benchmark); a missing
        # benchmark is reported and skipped
        self._data = {}
        for bench in benchmarks:
            try:
                self._data[bench] = load_benchmark(eval_root, bench,
                                                   image_size)
            except FileNotFoundError as e:
                print(f"[eval-every] skip benchmark {bench}: {e}")
                continue
        if not self._data:
            raise FileNotFoundError(
                f"no benchmarks found under {eval_root!r} "
                f"(looked for {list(benchmarks)})")

        self.best_acc = -float("inf")
        self.best_epoch = -1
        self.history: list = []  # (epoch, {bench: VerificationResult})

    def _weights_of(self, state):
        if self.use_ema:
            if state.ema is None:
                raise ValueError(
                    "use_ema=True but the train state carries no EMA — "
                    "pass --model-ema DECAY")
            return ema_state_dict(state)
        return state.backbone.state_dict()

    def __call__(self, epoch: int, state, train_loss: float, **_):
        last = self.total_epochs is not None and epoch >= self.total_epochs
        if epoch % self.every and not last:
            return
        weights = self._weights_of(state)
        self.backbone.load_state_dict(weights)

        results = {}
        logged = {}
        for bench, (pairs, stack, id_to_row) in self._data.items():
            emb = embed_unique_images(self._step, stack, self.batch_size,
                                      flip=self.flip)
            sims = pair_cosine_similarities(emb, pairs, id_to_row)
            res = kfold_verification(sims, pairs[:, 2], verbose=False)
            results[bench] = res
            logged[f"val/{bench}_acc"] = res.mean_accuracy
            logged[f"val/{bench}_auc"] = res.mean_auc
            if self.verbose:
                print(f"[eval-every] epoch {epoch} {bench}: {res}")
        self.history.append((epoch, results))
        if self.logger is not None:
            self.logger.log({**logged, "epoch": epoch})

        mean_acc = float(np.mean([r.mean_accuracy
                                  for r in results.values()]))
        if mean_acc > self.best_acc:
            self.best_acc = mean_acc
            self.best_epoch = epoch
            if self.manager is not None:
                self.manager.save_final(
                    weights, filename=f"{self.model_name}_best_acc")
                if self.verbose:
                    print(f"[eval-every] new best verification "
                          f"{mean_acc:.3f}% (epoch {epoch}) — saved "
                          f"{self.model_name}_best_acc")

