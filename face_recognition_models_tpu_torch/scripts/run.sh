#!/usr/bin/env bash
# Launcher of the PyTorch/CUDA port with the reference run.sh's defaults
# (batch 1024, 200 epochs, lr 0.1), forwarding any extra flags to the port's
# `train`; later flags override the defaults. On the card unless
# `--device cpu` is among them.
#
# Usage: face_recognition_models_tpu_torch/scripts/run.sh <head> [train flags...]
set -euo pipefail

HEAD="${1:?usage: run.sh <head> [flags...]}"
shift || true

# run from a checkout: the repo root holds the port's package
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

exec python3 -m face_recognition_models_tpu_torch.cli train \
  --head "$HEAD" \
  --batch_size 1024 \
  --epochs 200 \
  -lr 0.1 \
  "$@"
