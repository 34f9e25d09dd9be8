#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--only partial_fc,facenet,mesh,detect]

(`--only` runs just those phases after the device line: no build, no
kernels line and no result line.) Phases, one JSON line each; any failure ends the run with a non-zero exit
and no result line:

1. device  - the card's name and power limit (nvidia-smi).
2. build   - nvcc builds every kernel source of the port (sm_90a), all at
             once, into the git-ignored build/ directory.
3. kernels - each CUDA kernel against its plain PyTorch version: at the
             training shape (N=512, D=512, C=10,575), at N=24 / C=100 in all
             three margin modes with an out-of-range label, and the backward
             at N=4,096; the memory-blended (_mem) kernels at N=24 / C=100
             with lam mixing 0, 0.15 and 1, and at the training shape with
             lam and memory from a VPL state after one step, and with a dense
             lam (0.15 on every class, as after ~100 VPL steps). The same for
             the bf16 tensor-core kernels (_bf16, mm_dtype=torch.bfloat16),
             plus N=40 / D=72 / C=300 (D not a multiple of 16). The split
             fp32 and bf16 fwd and bwd_dx also at shapes of several class
             ranges (N=1, N not a multiple of 32, a ragged last range, D=72,
             a last range holding only a target column), and the fp32 and
             bf16 bwd_dw at shapes of several row ranges (N=600 and 520, a
             ragged last range): each range's partials and the combine
             kernels against their plain versions, and two launches of
             every entry bitwise equal. Times (CUDA events, after warm-up)
             of the kernel, its plain version and the eager library head
             (the median of 5 repeats, with their spread), beside the
             bound.
4. conv    - the implicit-GEMM 3x3 conv against its plain version at small
             fp32 and bf16 shapes on each route (the 16-byte routes and the
             ragged ones are chosen by width: bf16 wgmma or wmma, fp32
             3xTF32 wgmma or IEEE FMA), then at the ResNet-50 stage shapes
             of its benchmark (b512 bf16: 28x28x128, 14x14x256, 7x7x512),
             timed beside its plain version and cuDNN's channels-last conv;
             and the fp32 route at b512 14x14x256 beside cuDNN's fp32 conv
             (TF32 off).
5. train   - the port's `fit` at full width (resnet18, C=10,575, batch 512,
             112 px, bf16), 5 steps each of the ArcFace, VPL-ArcFace and
             QAFace heads. Each path's launch counters must equal the steps
             and the other kernels' stay 0; VPL must have active memory
             classes from step 1. Then one step from the same state through
             the kernels and through the eager head (ArcFace, VPL-ArcFace),
             and QAFace's BatchNorm buffers after a step with its degraded
             view against a step without it.
5b. heads  - 3 full-width `fit` steps of each of the eleven other heads
             (sphereface, cosface, mv_softmax, curricularface, adaface,
             elastic_cosface, elastic_arcface, magface, combined_margin on
             the kernels, launched once a step; subcenter_arcface and adacos
             on the eager head, launching none), then one step through the
             kernels against one through the eager head for each fused
             head, and each head's forward + backward device ms (kernels
             and eager) at N=512, D=512, C=10,575.
5c. pretrained - a seeded torchvision-layout resnet18 state_dict (1000-class
             fc) saved and loaded (seconds), then 2 ArcFace steps of `fit`
             from it with bf16 BatchNorm: the trunk equals the file before
             step 1.
5d. scan   - step batching (`train --scan-steps`): for each of ArcFace,
             VPL-ArcFace, QAFace, sphereface, curricularface, adaface,
             adacos (eager head) and elastic_arcface, 10 full-width `fit`
             steps with scan_steps=4 (two replays of a CUDA graph of 4
             steps, then two leftover eager steps) against the same 10
             steps one at a time from the same seeded state and batches:
             losses, every state tensor (parameters, BatchNorm and momentum
             buffers, head state, step count, lr) and the step generator
             bit for bit; each replay runs 4 launches of each of the head's
             kernels. Then `scripts/bench_steps` (eager against K = 4 and
             8, 3 alternating pairs of 64 steps: ms/step after the first
             chunk, img/s, peak GB, capture seconds) and the profiler's
             host and device ms/step and idle share of each path.
5e. recipe - the rest of the train recipe at full width: ResNet-50 +
             ArcFace (C=10,575, b512, 112 px) with AdamW, clipping at 5,
             grad_accum 2, model EMA 0.999, flip, crop_pad 8, color
             jitter 0.2 and random erasing 0.25, 8 eager steps against 2
             replays of a CUDA graph of 4 steps from the same state and
             batches, bit for bit (losses, every state tensor, the
             generator), ms/step and peak memory of both; each of the
             eight update rules with clipping on the resnet18 recipe, 4
             graphed steps against 4 eager ones, bit for bit, and its
             update's device ms on the ResNet-50 + head parameters beside
             its HBM bound; the frozen trunk unchanged over 4 steps, and
             the profiler's device ms/step frozen against unfrozen and of
             the ResNet-50 recipe eager and graphed; a resnet18 student
             distilled from the ResNet-50 run's `final` through
             `fit(distill.checkpoint_dir)`, its loss_kd at steps 1 and 8.
6. head_bf16 - one forward and backward through the public
             `fused_margin_ce` and `fused_margin_ce_mem` with
             mm_dtype=torch.bfloat16 at the training shape: one launch of
             each bf16 kernel and none of the fp32 ones; the loss within 5%
             of the fp32 loss.
7. conv3x3_bench - the conv's benchmark entry point
             (`scripts/bench_conv3x3.bench`) on the card at 14x14x256, b512,
             in bf16 and in fp32: the kernel path and the cuDNN path.
8. conv_f32 - the fp32 routes at b512 14x14x256: two launches of the
             3xTF32 route bitwise equal, its pre-pass and main kernel timed
             apart by torch.profiler, the plain version's time, and the
             ragged IEEE kernel (launched by name) against the plain version
             and timed. After the train phases, as device_times.
9. device_times - at the training shape, a device-only time (`device_ms`:
             the calls queued behind a spin kernel) of each bf16 kernel and
             of the eager bf16 backward, and the bf16 dx and dw entries'
             launches timed apart by torch.profiler.
10. checkpoint - `fit` at full width (resnet18, C=10,575, b512, 112 px,
             ArcFace, fused head) on 256 synthetic identities x 4 images,
             with a CheckpointManager in a temporary directory: run A
             takes 2 epochs x 2 steps; run B 1 epoch, then a new `fit`
             with continue_train='latest' for epoch 2, both in PyTorch's
             default (not deterministic) mode. Run B's losses, kernel_w,
             backbone tensors and momentum buffers must equal run A's bit
             for bit. A state restored into a fresh one
             equals the saved one bit for bit, channels-last weights
             included; keep-3 rotation and min_loss resume (the epoch files
             go). File sizes, save and restore seconds.
11. eval   - run A's <model>_final through `restore_backbone`, on a
             synthetic LFW-size benchmark (6,000 pairs, half genuine, over
             12,000 `synthetic_identities` images, a .bin of uint8 arrays):
             its embeddings equal the live state's bit for bit; the `eval`
             CLI at batch 256 with the host and the device protocol and
             --tpr-far 1e-2,1e-3: equal fold thresholds and accuracies, AUC
             within 1e-12, mean AUC >= 0.9; the embedding img/s.
11b. facenet - the FaceNet triplet path at FaceNet's defaults (ResNet-50,
             embed 128, P = 16 x K = 4, margin 0.2, lr 0.05, 112 px, bf16
             convs): `train_facenet` for 10 steps on synthetic identities
             (finite losses, mined valid triplets > 0 at every step, ms/step
             after step 1 with each step waited for, peak GB, beside 3x the
             forward FLOPs at 989 TFLOP/s; the mining's device ms by
             torch.profiler); the `facenet` CLI over a PNG identity tree
             (PKLoader, PIL), whose <model>_final the `eval` CLI (on the
             eval phase's .bin) and `embed` read; inception_v3 trained 3
             steps with its dropout from the step generator, two runs from
             one seed bitwise equal, another seed different. No kernel of
             the port launches.
12. bench_embed - the headline workload (`scripts/bench_embed.bench`:
             ResNet-50, b512, 112 px, bf16 BatchNorm, 20 batches in a CUDA
             graph) and the same with fp32 BatchNorm, one eager step's
             device time by category (torch.profiler), and the bf16-BN
             embeddings against the fp32-BN ones of the same weights and
             batch: the least row cosine >= 0.99.
13. serve  - serving at full width, one JSON line a part. export: a
             seeded ResNet-50 (512-d, 112 px, bf16 convs) with moved
             BatchNorm statistics (move_bn_statistics: a fold of the
             initial ones is the identity) saved with save_final and
             written by the `export` CLI unfolded and with --fold-bn (fp32
             BatchNorm, as the CLI builds it), and by export_embedder with
             bf16 BatchNorm (the serving default); each artifact loaded,
             held against the live eval step at b512 (rtol = atol 1e-2;
             folded row by row: error <= 2e-2 of the row's norm, least
             cosine >= 0.9998), at batches 1, 3 and 8, and timed (img/s of
             its fn, host arrays in and out, beside bench_embed's); export
             and load seconds, bytes; four folds with a wrong term (mean
             dropped or negated, scale or variance left out) each refused
             by the fold check. http: an EmbedService on the bf16 artifact
             with a gallery of 1,000 synthetic identities x 2 images,
             served on 127.0.0.1 in a thread; 32 client threads x 16 PNG
             requests to /embed (each within 2e-3 of the direct embedding)
             and to /identify?top_k=5 (top-1 the probe's identity for >=
             99%), at micro-batch 8 and 1 (wait 5 ms), on a new connection
             per request and on kept-alive connections: p50 / p99 ms, the
             connects' p50 / p99, requests/s, the rise of the kernel's
             listen-overflow counters, batches, max_coalesced; /healthz,
             404, 411 and the 409 of /detect; `embed` over a PNG tree; no
             kernel of the port launched. PIL decodes, as in the JAX
             package: the phase fails without it. identify:
             pooled_scores_device on a 1,000,000 x 512 gallery of 100,000
             identities and 10,000 probes, timed, its first 256 probes
             within 1e-6 of the host path, a chunk's product and scatter
             by CUDA events, and closed-set CMC on the card equal to the
             CPU's on a 100,000-image subset. periodic:
             `train --eval-every 1` (resnet18 ArcFace, b512, 2 epochs)
             against the eval phase's synthetic .bin writes
             <model>_best_acc, which `eval --which best_acc` reads; `fit`
             with scan_steps=4 and the hook equals the same run without
             it bit for bit.
13b. detect - the MTCNN cascade (detection/) at its published widths with
             seeded random weights written as facenet_pytorch-layout .pt
             files and loaded back by `preprocess`'s build_detector, at the
             published thresholds (0.5, 0.7, 0.7); DETECT_CLS_SCALE says
             how the random weights are shaped so faces come out): P-Net,
             R-Net and O-Net on the card against the same
             nets on the CPU (TF32 off, max abs <= 1e-5); `detect` on a
             250 x 250 (CASIA-WebFace's raw size) and a 640 x 480 noise
             photo on the card against the CPU (the same box count, boxes
             and landmarks within 1e-3, probs within 1e-5), ms per detect
             (median of 3 after a warm-up) split into the card's share
             (CUDA events around the pyramid + P-Net and each R-/O-Net
             batch, copies included) and the host's, the boxes at each
             stage; `preprocess` on the card over 2 x 2 photos (img/s); an
             EmbedService with the detector in front of the serve phase's
             bf16 ResNet-50 artifact: 10 PNG requests each to /detect (the
             detector's boxes) and /embed (aligned, within 2e-3 of the
             artifact's embedding of the extracted face) on one kept-alive
             connection, p50 / p99 ms; api.ArcFaceNet('resnet50').embed of a
             b64 batch against the eval step on the same module. Each line
             carries nvidia-smi's name and power limit; no kernel of the
             port launches.
14. backbones - the other trunks of the registry at full width: 3 `fit`
             steps of each of efficientnet_b0, mobilenet_v2, mobilefacenet,
             iresnet18 / 50 / 100 and vit_t / s / b (ArcFace, C=10,575,
             b512, 112 px, bf16 convs, fp32 BatchNorm, SGD 0.1 / 0.9 /
             5e-4, the fused head; vit_b with its default remat): finite
             losses, K1 / K2 launched once a step and no other kernel,
             ms/step after step 1, peak GB; the trained trunk's eval-mode
             embedding at b512 timed by CUDA events beside its bound (1x
             the forward FLOPs of its convs, Dense layers and attention
             products, from the module's shapes, at 989 TFLOP/s), and 8
             images on the card against the port's CPU forward of the same
             weights (both fp32, TF32 off; rtol 2e-3, atol 2e-4 x max),
             and the timed module's own embeddings of them against that
             CPU forward row by row (error / row norm <= 0.05, cosine >=
             0.999), which two faulty forwards (every BatchNorm, or the
             last, on the batch's statistics) must fail;
             the profiler's device ms/step by category. inception_v3: the
             embedding checks, and `fit` refused. Then efficientnet_b0
             (dropout and stochastic depth from the step generator) and
             vit_b (remat inside the graph): 10 steps with scan_steps=4
             against 10 eager ones, bit for bit (losses, every state
             tensor, the generator). Then `export_embedder` ->
             `load_embedder` -> `fn` for iresnet50, mobilefacenet and vit_s
             (seeded, moved BatchNorm statistics) against the live eval
             step at b512, and iresnet50's `fn` on 150 rows of an artifact
             of max_batch 64 (three slices joined) against the live step
             on the same slices.
14b. partial_fc - `fit` with partial_fc 0.1 on ResNet-50 + ArcFace (D =
             512, b512, 112 px, bf16 convs, SGD 0.1 / 0.9 / 5e-4): at C =
             1,048,576 (C_s = 104,960) 5 steps (finite losses, step 1
             writes exactly the sampled columns of kernel_w and kernel_mom,
             no kernel of the port launched, ms/step after step 1, peak GB,
             the sampler's device ms by torch.profiler, the gather +
             scatter's by CUDA events (split by the profiler) beside its
             HBM bound, the profiler's device ms/step, idle share and
             split over 3 steps), 3 steps of the
             dense fused head at the same C (K1 / K2 once a step; the
             yardstick, not counted in the kernels line), and 10 steps with
             scan_steps=4 against 10 eager ones, bit for bit (losses, every
             state tensor with kernel_mom, the generator); at C = 10,575
             (C_s = 1,280) two seeded runs bitwise equal, one full-sample
             step (C_s = C, distinct labels) against the dense eager step
             from the same state (loss rtol 1e-6, kernel_w rtol 1e-5 /
             atol 1e-7, kernel_mom rtol = atol 1e-5), and 1 epoch + a
             resumed epoch against 2 epochs, bit for bit; then `train
             --partial-fc 0.1` through the CLI on the card's default
             device (resnet18, 3,072 synthetic identities, b512): the
             sampled path, no kernel, kernel_mom in the epoch checkpoint.
14c. mesh - the ('data', 'model') mesh (parallel/): two ranks, each a
             process of this script (`--mesh-rank`), share the one card
             over gloo (NCCL refuses two ranks on one device), so their
             times and memory are no scaling figure. The collectives gloo
             takes on CUDA tensors (probed in a group of their own);
             data=2: `fit` of ResNet-50 + ArcFace (fused head, C = 10,575,
             global b512, 112 px, 5 steps) in fp32 (TF32 off) and in bf16
             against one process on the same global batches (the step-1
             loss, the step-1 update's drift, that of the classifier's
             update, every loss; the bf16 drifts bounded by twice the
             one-process bf16-vs-fp32 drift; both ranks' losses,
             parameters and BatchNorm running statistics bitwise equal; K1
             / K2 once a step a rank), and two faults planted in the bf16
             world's data path (BatchNorm on the rank's half batch,
             gradients summed and not averaged) that these checks must
             each catch; model=2: the class-sharded fused head at C =
             1,048,576 (a rank's [512, 524,288] shard, about half its rows
             with no target column) on ResNet-50's b512 features, one
             step's loss, dx and the rank's kernel-gradient shard against
             the one-process head (tests/test_sharded_fused.py's bounds)
             for ArcFace (K1 / K2) and VPL-ArcFace (K4), each twice a rank
             (the second call timed), and each kernel's output on the
             rank's own shard inputs against its plain version (the
             kernels phase's tolerances); the eager head on the rank's
             class shard (`train/step.eager_apply`, a `--head-path eager`
             step's head, CE and top-k) for AdaCos (dynamic), sub-center
             ArcFace (K = 3) and ArcFace at C = 1,048,576 against the
             one-process eager head from the same kernel (the ranks take
             turns on it, a barrier between them; sub-center at C =
             851,968, `MESH_EAGER_CLASSES` says why): the loss, dx and the
             rank's dw slice within the fused head's bounds, AdaCos's new
             scale within 1e-6 relative, no gather of the class axis, and
             each rank's peak allocated GB at most 0.6 of the one-process
             head's (both printed, with ms of a second, warm forward +
             backward);
             the sharded Partial-FC's `fit` at C = 1,048,576 for 5 steps
             (finite losses, step 1 writes exactly each shard's sampled
             columns of kernel_w and kernel_mom), its state saved by the
             world and restored in one process, bitwise (fingerprints of
             each shard); ms/step and peak GB a rank. With two or more
             cards the data=2 and model=2 checks again over NCCL, one
             rank a card; otherwise it prints that NCCL was not run.
15. convergence - the port's scripts/convergence_run at its defaults
             (ArcFace + resnet18, 500 synthetic identities x 16 train + 4
             held-out copies at noise 35, b512, 15 epochs, scan_steps 8,
             the fused head): mean held-out 10-fold accuracy >= 98.0% and
             AUC >= 0.995, beside the JAX package's 99.74% +- 0.22 (a
             quality reference); K1 / K2 launched once a step (and once a
             step of the capture's warm-up chunk).

The line before the last is {"kernels": [...]} (each kernel's launches from
the phase that runs its entry point: train, head_bf16, conv3x3_bench; the
fp32 head kernels' and the _mem kernels' add the scan phase's graphed
ArcFace and VPL-ArcFace runs, whose replays the host's counters do not see:
the launches one replay captured times the replays, plus the real ones;
the fp32 head kernels' also the recipe, backbones, mesh and convergence
runs, the _mem kernels' the mesh phase's VPL-ArcFace head: each rank's
launches; the partial_fc, facenet and detect phases launch none),
the last {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import pickle
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet) for the bound: fp32 outside
# the tensor cores, dense bf16 and tf32 on the tensor cores, and HBM3
# bandwidth. The fp32 conv's 16-byte route takes three tf32 products for
# each fp32 one (3xTF32).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 494.7e12
TF32X3_PRODUCTS = 3
PEAK_BYTES = 3.35e12
N_MAIN, D_MAIN, C_MAIN = 512, 512, 10575
TRAIN_STEPS = 5
LIB_REPEATS = 5   # repeats of the library head's timing; the median counts
CONV_SHAPES = ((28, 128), (14, 256), (7, 512))   # (H = W, C = C_out) at b512
CONV_MAIN = (14, 256)   # the benchmark phase's shape, and the kernels line's
# (lam source, margin mode, clamp, case) of the timed training-shape cases,
# all in the identity mode (fused_head.MODE_IDENTITY = 0): ArcFace-like, a
# VPL state after one step, and a dense lam
TIMED_CASES = ((None, 0, None, "N512_D512_C10575_identity"),
               ("vpl", 0, 1e-7, "N512_D512_C10575_vpl_mem"),
               ("dense", 0, 1e-7, "N512_D512_C10575_vpl_mem_dense"))
# (fused head, case): the training shape with the row scalars of a head in
# each margin mode the other heads bring (fused_head.MODE_MV = 1,
# MODE_CURRICULAR = 2, and MODE_IDENTITY with a per-row norm scale)
MODE_CASES = (("mv_softmax", "N512_D512_C10575_mv"),
              ("curricularface", "N512_D512_C10575_curricular"),
              ("sphereface", "N512_D512_C10575_identity_normscale"))
# the heads beyond ArcFace, VPL-ArcFace and QAFace, and their steps of fit
NEW_HEADS = ("sphereface", "cosface", "mv_softmax", "curricularface",
             "adaface", "elastic_cosface", "elastic_arcface", "magface",
             "combined_margin", "subcenter_arcface", "adacos")
HEAD_STEPS = 3
# the scan phase: each head's SCAN_STEPS steps with scan_steps=SCAN_K (two
# graphed chunks and two leftover eager steps) against the same steps one at
# a time; then bench_steps' eager against graphed runs of the ArcFace recipe
SCAN_HEADS = ("arcface", "vpl_arcface", "qaface", "sphereface",
              "curricularface", "adaface", "adacos", "elastic_arcface")
SCAN_K = 4
SCAN_STEPS = 10
SCAN_BENCH = {"pairs": 3, "scans": (4, 8), "steps": 64}
# the recipe phase: ResNet-50's RECIPE_STEPS steps eager and graphed
# (RECIPE_K steps a replay), each rule's RULE_STEPS steps, the profiler's
# RECIPE_PROFILED steps a path
RECIPE_STEPS = 8
RECIPE_K = 4
RULE_STEPS = 4
RECIPE_PROFILED = 8
RECIPE_KEYS = ("ms_per_step_after_first_chunk", "img_per_s_after_first_chunk",
               "first_chunk_s", "capture_seconds", "peak_gb",
               "peak_reserved_gb")
# ResNet-50 (embed 512) and the [512, 10,575] head: 24,557,120 + 5,414,400
RN50_HEAD_PARAMS = 29_971_520
HEAD_TIMED_CALLS = 5   # calls a head's device_ms reading averages
SOURCE = "face_recognition_models_tpu_torch/csrc/fused_head.cu"
CONV_SOURCE = "face_recognition_models_tpu_torch/csrc/conv3x3.cu"
REPLACES = {
    "fused_ce_fwd": "face_recognition_models_tpu/ops/fused_head.py:95",
    "fused_ce_bwd_dx": "face_recognition_models_tpu/ops/fused_head.py:315",
    "fused_ce_bwd_dw": "face_recognition_models_tpu/ops/fused_head.py:315",
    # the has_mem=True bodies of the same Pallas kernels
    "fused_ce_fwd_mem": "face_recognition_models_tpu/ops/fused_head.py:122",
    "fused_ce_bwd_dx_mem":
        "face_recognition_models_tpu/ops/fused_head.py:395",
    "fused_ce_bwd_dw_mem":
        "face_recognition_models_tpu/ops/fused_head.py:401",
    # mm_dtype=bfloat16: the casts before each product of the same kernels
    "fused_ce_fwd_bf16": "face_recognition_models_tpu/ops/fused_head.py:119",
    "fused_ce_bwd_dx_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:242",
    "fused_ce_bwd_dw_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:307",
    "fused_ce_fwd_mem_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:123",
    "fused_ce_bwd_dx_mem_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:237",
    "fused_ce_bwd_dw_mem_bf16":
        "face_recognition_models_tpu/ops/fused_head.py:305",
    "conv3x3_same": "face_recognition_models_tpu/ops/conv3x3.py:42",
    # the same Pallas kernel with fp32 x
    "conv3x3_same_f32": "face_recognition_models_tpu/ops/conv3x3.py:42",
}
PLAIN_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_dx", "fused_ce_bwd_dw")
MEM_KERNELS = ("fused_ce_fwd_mem", "fused_ce_bwd_dx_mem",
               "fused_ce_bwd_dw_mem")
BF16_KERNELS = tuple(k + "_bf16" for k in PLAIN_KERNELS + MEM_KERNELS)
# kernel vs plain, both IEEE fp32 on the card: the sums run in different
# orders (10^4 exp terms, 512-deep dot products), a few ulps apart.
TOL_STATS = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD_RTOL = 1e-3     # plus an atol of 1e-5 x the output's largest value
TOLERANCE = {"lse_target_logit": TOL_STATS,
             "gradients": {"rtol": TOL_GRAD_RTOL, "atol": "1e-5 x max|plain|"},
             "higher": "differs by at most 1 per row"}
# bf16 products: dcos is rounded to bf16 after an fp32 computation whose
# order differs between kernel and plain version, so a dcos within that
# difference of a rounding boundary rounds one way in one and the other way
# in the other, moving one term of dx or dw by one bf16 ulp (2^-7 of it).
# The gradient atol adds one ulp of each element's largest product term.
BF16_ULP = 2.0 ** -7
TOLERANCE_BF16 = {**TOLERANCE, "gradients": {
    "rtol": TOL_GRAD_RTOL,
    "atol": "1e-5 x max|plain| + 2^-7 x the element's largest product term"}}
# the conv, rtol = atol: fp32 sums in different orders; bf16 outputs a bf16
# ulp or two apart (0.03 at |y| of 4-8)
TOL_CONV = {"float32": 1e-5, "bfloat16": 2e-2}
# the fp32 conv at b512 14x14x256: each output sums 2,304 fp32 products of
# |y| ~ 2.4 in another order than the plain version's 9 matmuls
TOL_CONV_DEEP = 1e-4
# (n, h, w, c, co, dtype) of the small conv cases. The bf16 16-byte route
# at M not a multiple of the 128-row tile, C_out of 24 and 40, C of 40 and
# 72 and two C_out tiles; the bf16 ragged route at C = 12 and C_out = 12;
# the fp32 3xTF32 route at the same kinds of shape (M = 135 with C = 40 and
# C_out = 136, C_out = 4) and the fp32 ragged route at C = 6, C_out = 10.
CONV_SMALL = ((4, 7, 7, 16, 24, "float32"), (2, 5, 9, 4, 12, "float32"),
              (6, 4, 4, 8, 8, "float32"), (16, 7, 7, 72, 40, "float32"),
              (2, 7, 7, 32, 16, "bfloat16"), (8, 14, 14, 40, 24, "bfloat16"),
              (3, 5, 9, 40, 24, "bfloat16"), (8, 14, 14, 72, 40, "bfloat16"),
              (1, 12, 12, 136, 136, "bfloat16"),
              (4, 7, 7, 12, 16, "bfloat16"), (2, 6, 6, 16, 12, "bfloat16"),
              (3, 5, 9, 40, 136, "float32"), (2, 7, 7, 8, 4, "float32"),
              (2, 6, 6, 6, 10, "float32"), (4, 7, 7, 12, 10, "float32"))


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the seconds since the
    script started (`elapsed_s`)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def close(name, got, want, rtol, atol):
    """Max abs error of `got` against `want`; raises past atol + rtol x
    |want| (atol a number or a tensor of `want`'s shape)."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        big = float(atol.max()) if hasattr(atol, "max") else atol
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance, max abs err "
            f"{float(err.max()):.3e} (rtol {rtol}, atol up to {big:.3e})")
    return float(err.max())


def close_grad(name, got, want, term=None):
    """The gradient tolerance; `term` (bf16 products only) is each element's
    largest product term, of which one bf16 ulp is allowed on top."""
    atol = 1e-5 * float(want.abs().max())
    if term is not None:
        atol = atol + BF16_ULP * term
    return close(name, got, want, TOL_GRAD_RTOL, atol)


def close_higher(name, got, want):
    # `higher` counts cos > tcos; a cosine within rounding of the target's
    # can flip between two summation orders. Allow a flip of 1 per row.
    diff = (got - want).abs()
    if float(diff.max()) > 1:
        raise AssertionError(f"{name}: higher differs by {float(diff.max())}")
    return int((diff > 0).sum())


def cuda_ms(fn, warmup=3, iters=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per ms on this card (its clock
    under a spin), from CUDA events around one long spin."""
    import torch

    cycles = 50_000_000
    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn, warmup=3, iters=20, tries=3):
    """The card's time per call of `fn`, without the host's launch gaps: a
    spin kernel (torch.cuda._sleep) is queued ahead of the start event and
    the `iters` calls behind it, so the card runs them back to back. The
    reading counts only if the start event is still pending once the host
    has queued the last call (start.query() False); otherwise the spin is
    made 4x longer and the run repeated, and after `tries` runs it raises.
    Inputs under 50 MB stay warm in L2 between the calls, as in cuda_ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin_ms = 4.0 * host_ms + 2.0
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_ms *= 4.0
    raise AssertionError(f"device_ms: the card reached the calls before the "
                         f"host had queued them ({tries} spins, the last "
                         f"{spin_ms / 4.0:.1f} ms)")


def launch_ms(fn, iters=20, kernel=r"fused_ce_\w+"):
    """{kernel: device ms per call of `fn`} from a torch.profiler trace of
    `iters` calls (kernels named by the match of the regex `kernel` in
    their name in the trace)."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(kernel, e.key)
        us = getattr(e, "device_time_total", None)
        if found and us:
            out[found.group(0)] = us / iters / 1e3
    return out


def make_inputs(n, d, c, mode, seed, oor_label=False, mem=None):
    """Row-normalised xn, column-normalised wn and ArcFace-like row scalars
    on the card, from a seeded generator. mem="mixed" adds a random memn and
    lam mixing 0, 0.15 and 1; mem="dense" a random memn and lam = 0.15 on
    every class (VPL after ~100 steps at b512); mem="vpl" the memn and lam
    of a VPL-ArcFace state after one step on random features."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.ops.normalize import l2_normalize

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    xn = l2_normalize(torch.randn(n, d, device=dev, generator=g), dim=1)
    wn = l2_normalize(torch.randn(d, c, device=dev, generator=g), dim=0)
    labels = torch.randint(0, c, (n,), device=dev, generator=g,
                           dtype=torch.int32)
    tcos = (xn * wn[:, labels.long()].T).sum(1)
    if oor_label:
        labels[n // 2] = c + 7
    t = torch.cos(torch.acos(tcos.clamp(-1, 1)) + 0.5)
    scale = torch.full((n,), 64.0, device=dev)
    if mode == fh.MODE_IDENTITY:
        ab = torch.zeros(n, 2, device=dev)
    else:
        ab = torch.stack([tcos - 0.2, torch.full_like(tcos, 1.12)], 1)
    g_lse = torch.full((n,), 1.0 / n, device=dev)
    g_t = torch.full((n,), -1.0 / n, device=dev)
    x = dict(xn=xn, wn=wn, labels=labels, t=t, tcos=tcos, scale=scale,
             ab=ab.contiguous(), g_lse=g_lse, g_t=g_t)
    if mem in ("mixed", "dense"):
        x["memn"] = l2_normalize(torch.randn(d, c, device=dev, generator=g),
                                 dim=0)
        pick = torch.randint(0, 3, (c,), device=dev, generator=g)
        x["lam"] = (torch.tensor([0.0, 0.15, 1.0], device=dev)[pick]
                    if mem == "mixed" else torch.full((c,), 0.15, device=dev))
    elif mem == "vpl":
        from face_recognition_models_tpu_torch import config as cfg_lib
        from face_recognition_models_tpu_torch.heads import get_head
        from face_recognition_models_tpu_torch.heads import margins

        cfg = cfg_lib.VPLArcFaceConfig(feature_dim=d, num_classes=c)
        state = get_head("vpl_arcface").init_state(cfg, dev)
        feats = 10.0 * torch.randn(n, d, device=dev, generator=g)
        mem_, life, _ = margins._class_mean_update(
            feats, labels, labels >= 0, state.mem, state.life, cfg.delta)
        x["memn"] = l2_normalize(mem_, dim=1).T.contiguous()
        x["lam"] = cfg.lamda * (life > 0).to(torch.float32)
    return x


def kernel_fns(mem, bf16=False):
    """(names, [(kernel, plain) for fwd, bwd_dx, bwd_dw]) of the plain or
    the memory-blended family, with fp32 or (bf16) bf16 products."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    if mem:
        names, fns = MEM_KERNELS, [
            (fh.fused_ce_fwd_mem, fh.fused_margin_ce_mem_plain),
            (fh.fused_ce_bwd_dx_mem, fh.fused_ce_bwd_dx_mem_plain),
            (fh.fused_ce_bwd_dw_mem, fh.fused_ce_bwd_dw_mem_plain)]
    else:
        names, fns = PLAIN_KERNELS, [
            (fh.fused_ce_fwd, fh.fused_margin_ce_plain),
            (fh.fused_ce_bwd_dx, fh.fused_ce_bwd_dx_plain),
            (fh.fused_ce_bwd_dw, fh.fused_ce_bwd_dw_plain)]
    if not bf16:
        return names, fns
    bf = functools.partial
    return tuple(k + "_bf16" for k in names), [
        (bf(k, mm_dtype=torch.bfloat16), bf(p, mm_dtype=torch.bfloat16))
        for k, p in fns]


def kernel_args(x, mode, clamp_eps, lse=None):
    """Positional arguments of (fwd, bwd_dx, bwd_dw) on inputs `x`."""
    head = (x["xn"], x["wn"], *((x["memn"], x["lam"]) if "memn" in x
                                else ()), x["labels"], x["t"])
    fwd = (*head, x["tcos"], x["scale"], x["ab"], mode, clamp_eps)
    bwd = (*head, x["scale"], x["ab"], lse, x["g_lse"])
    return fwd, (*bwd, x["g_t"], mode, clamp_eps), (*bwd, mode, clamp_eps)


def bf16_terms(x, mode, clamp_eps, lse):
    """(dx, dw) of each element's largest product term with bf16 operands:
    max |dcos| of the row (column) times max |wn or memn| (|xn|) of the
    other factor."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    dcos, _, _ = fh._dcos_plain(x["xn"], x["wn"], x["labels"], x["t"],
                                x["scale"], x["ab"], lse, x["g_lse"], mode,
                                clamp_eps, x.get("memn"), x.get("lam"),
                                torch.bfloat16)
    dcos = dcos.abs()
    w = x["wn"].abs().amax(1)
    if "memn" in x:
        w = torch.maximum(w, x["memn"].abs().amax(1))
    return (dcos.amax(1)[:, None] * w[None, :],
            x["xn"].abs().amax(0)[:, None] * dcos.amax(0)[None, :])


def past_fp32_tol(got, want):
    """Elements of a gradient outside the fp32 tolerance: those that needed
    the bf16 ulp allowance."""
    err = (got - want).abs()
    return int((err > TOL_GRAD_RTOL * want.abs()
                + 1e-5 * float(want.abs().max())).sum())


def same(name, *pairs):
    """Two launches on the same inputs must give bitwise-equal outputs."""
    import torch

    for a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches differ")


def check_case(x, mode, clamp_eps, bf16=False):
    """Each kernel against its plain version on inputs `x` (the _mem family
    when `x` holds memn, the bf16 products with `bf16`); returns (max abs
    err per kernel, number of rows where `higher` differs, and with `bf16`
    {"dx": n, "dw": n} elements that needed the ulp allowance). Every
    kernel runs twice and must agree bitwise."""
    names, fns = kernel_fns("memn" in x, bf16)
    fwd_args, _, _ = kernel_args(x, mode, clamp_eps)
    out = fns[0][0](*fwd_args)
    same(names[0], *zip(out, fns[0][0](*fwd_args)))
    ref = fns[0][1](*fwd_args)
    errs = {names[0]: max(
        close("lse", out.lse, ref.lse, **TOL_STATS),
        close("target_logit", out.target_logit, ref.target_logit,
              **TOL_STATS))}
    flips = close_higher("higher", out.higher, ref.higher)
    _, dx_args, dw_args = kernel_args(x, mode, clamp_eps, ref.lse)
    dx_term, dw_term = (bf16_terms(x, mode, clamp_eps, ref.lse) if bf16
                        else (None, None))
    dx, dt, dscale = fns[1][0](*dx_args)
    same(names[1], *zip((dx, dt, dscale), fns[1][0](*dx_args)))
    rdx, rdt, rdscale = fns[1][1](*dx_args)
    errs[names[1]] = max(close_grad("dx", dx, rdx, dx_term),
                         close_grad("dt", dt, rdt),
                         close_grad("dscale", dscale, rdscale))
    dw = fns[2][0](*dw_args)
    same(names[2], (dw, fns[2][0](*dw_args)))
    rdw = fns[2][1](*dw_args)
    errs[names[2]] = close_grad("dw", dw, rdw, dw_term)
    ulp = ({"dx": past_fp32_tol(dx, rdx), "dw": past_fp32_tol(dw, rdw)}
           if bf16 else {})
    if "lam" in x and bool((x["lam"] == 1).any()):
        # a column fully replaced by its memory takes no dw
        if float(dw[:, x["lam"] == 1].abs().max()) != 0.0:
            raise AssertionError("dw is not 0 in lam = 1 columns")
    return errs, flips, ulp


def check_split(x, mode, clamp_eps):
    """The split fp32 fwd, bwd_dx and bwd_dw (the _mem ones when `x` holds
    memn) on inputs `x`: each class range's (bwd_dw: row range's) partials
    from the kernel's workspace (bwd_dw of one range: dw itself) against
    fused_ce_*_partials_plain, and the combine kernels, on the plain
    partials, against their plain versions. Returns ({check: max abs err},
    {"fwd": ranges, "bwd_dx": ranges, "bwd_dw": ranges})."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    mem = ((x["memn"], x["lam"]) if "memn" in x else ())
    kw = dict(memn=x["memn"], lam=x["lam"]) if mem else {}
    sfx, which = ("_mem", 3) if mem else ("", 0)
    (n, d), c = x["xn"].shape, x["wn"].shape[1]
    splits, cols = fh.split_plan(n, c)
    plan = dict(splits=splits, range_cols=cols)
    ranges = {"fwd": splits}
    fwd = (x["labels"], x["t"], x["tcos"], x["scale"], x["ab"], mode,
           clamp_eps)
    ws = []
    fh._fwd("fused_ce_fwd" + sfx, which, x["xn"], x["wn"], mem, *fwd,
            torch.float32, ws)
    got = ws[0].view(splits, 3, n)
    want = fh.fused_ce_fwd_partials_plain(x["xn"], x["wn"], *fwd, **plan,
                                          **kw)
    errs = {"fwd_partials": close("m, l", got[:, :2], want[:, :2],
                                  **TOL_STATS)}
    close_higher("range higher", got[:, 2], want[:, 2])
    comb = fh.fused_ce_fwd_combine(want, x["t"], x["scale"])
    ref = fh.fused_ce_fwd_combine_plain(want, x["t"], x["scale"])
    errs["fwd_combine"] = max(
        close("combined lse", comb.lse, ref.lse, **TOL_STATS),
        close("combined target_logit", comb.target_logit, ref.target_logit,
              **TOL_STATS))
    close_higher("combined higher", comb.higher, ref.higher)
    bwd = (x["labels"], x["t"], x["scale"], x["ab"], ref.lse, x["g_lse"])
    splits, cols = fh.split_plan(n, c, dx=True)
    plan = dict(splits=splits, range_cols=cols)
    ranges["bwd_dx"] = splits
    ws = []
    fh._bwd_dx("fused_ce_bwd_dx" + sfx, which + 1, x["xn"], x["wn"], mem,
               *bwd, x["g_t"], mode, clamp_eps, torch.float32, ws)
    got_dx, got_rows = fh.dx_workspace_views(ws[0], splits, n, d)
    want_dx, want_rows = fh.fused_ce_bwd_dx_partials_plain(
        x["xn"], x["wn"], *bwd, mode, clamp_eps, **plan, **kw)
    errs["dx_partials"] = max(close_grad("dx partials", got_dx, want_dx),
                              close_grad("dt, dscale partials", got_rows,
                                         want_rows))
    comb = fh.fused_ce_bwd_dx_combine(want_dx, want_rows, x["t"],
                                      x["scale"], x["g_t"])
    ref = fh.fused_ce_bwd_dx_combine_plain(want_dx, want_rows, x["t"],
                                           x["scale"], x["g_t"])
    errs["dx_combine"] = max(close_grad("combined " + k, a, b) for k, a, b
                             in zip(("dx", "dt", "dscale"), comb, ref))
    splits, rows = fh.dw_split_plan(n, c)
    ranges["bwd_dw"] = splits
    ws = []
    dw = fh._bwd_dw("fused_ce_bwd_dw" + sfx, which + 2, x["xn"], x["wn"], mem,
                    *bwd, mode, clamp_eps, torch.float32, ws)
    got = ws[0].view(splits, d, c) if splits > 1 else dw[None]
    want = fh.fused_ce_bwd_dw_partials_plain(x["xn"], x["wn"], *bwd, mode,
                                             clamp_eps, splits=splits,
                                             range_rows=rows, **kw)
    errs["dw_partials"] = close_grad("dw partials", got, want)
    errs["dw_combine"] = close_grad("combined dw",
                                    fh.fused_ce_bwd_dw_combine(want),
                                    fh.fused_ce_bwd_dw_combine_plain(want))
    return errs, ranges


def check_split_bf16(x, mode, clamp_eps):
    """The split bf16 fwd, bwd_dx and bwd_dw (the _mem ones when `x` holds
    memn) on inputs `x`: each class range's (bwd_dw: row range's) partials
    from the front of the kernel's workspace (bwd_dw of one range: dw
    itself) against fused_ce_*_partials_plain with bf16 products, and the dx
    and dw combine kernels on the plain partials against their plain
    versions. Returns ({check: max abs err}, {"fwd_bf16": ranges,
    "bwd_dx_bf16": ranges, "bwd_dw_bf16": ranges})."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    mem = ((x["memn"], x["lam"]) if "memn" in x else ())
    kw = dict(memn=x["memn"], lam=x["lam"]) if mem else {}
    sfx, which = ("_mem", 3) if mem else ("", 0)
    (n, d), c = x["xn"].shape, x["wn"].shape[1]
    bf = torch.bfloat16
    splits, cols = fh.split_plan(n, c, mm_dtype=bf)
    ranges = {"fwd_bf16": splits}
    fwd = (x["labels"], x["t"], x["tcos"], x["scale"], x["ab"], mode,
           clamp_eps)
    ws = []
    fh._fwd("fused_ce_fwd" + sfx, which, x["xn"], x["wn"], mem, *fwd, bf, ws)
    got = ws[0][:splits * 3 * n].view(splits, 3, n)
    want = fh.fused_ce_fwd_partials_plain(x["xn"], x["wn"], *fwd,
                                          splits=splits, range_cols=cols,
                                          mm_dtype=bf, **kw)
    errs = {"fwd_bf16_partials": close("bf16 m, l", got[:, :2], want[:, :2],
                                       **TOL_STATS)}
    close_higher("bf16 range higher", got[:, 2], want[:, 2])
    lse = fh.fused_ce_fwd_combine_plain(want, x["t"], x["scale"]).lse
    bwd = (x["labels"], x["t"], x["scale"], x["ab"], lse, x["g_lse"])
    splits, cols = fh.split_plan(n, c, dx=True, mm_dtype=bf)
    ranges["bwd_dx_bf16"] = splits
    ws = []
    fh._bwd_dx("fused_ce_bwd_dx" + sfx, which + 1, x["xn"], x["wn"], mem,
               *bwd, x["g_t"], mode, clamp_eps, bf, ws)
    got_dx, got_rows = fh.dx_workspace_views(ws[0], splits, n, d)
    want_dx, want_rows = fh.fused_ce_bwd_dx_partials_plain(
        x["xn"], x["wn"], *bwd, mode, clamp_eps, splits=splits,
        range_cols=cols, mm_dtype=bf, **kw)
    dx_term, dw_term = bf16_terms(x, mode, clamp_eps, lse)
    errs["dx_bf16_partials"] = max(
        close_grad("bf16 dx partials", got_dx, want_dx, dx_term),
        close_grad("bf16 dt, dscale partials", got_rows, want_rows))
    comb = fh.fused_ce_bwd_dx_combine(want_dx, want_rows, x["t"], x["scale"],
                                      x["g_t"])
    ref = fh.fused_ce_bwd_dx_combine_plain(want_dx, want_rows, x["t"],
                                           x["scale"], x["g_t"])
    errs["dx_bf16_combine"] = max(
        close_grad("bf16 combined " + k, a, b) for k, a, b
        in zip(("dx", "dt", "dscale"), comb, ref))
    splits, rows = fh.dw_split_plan(n, c, mm_dtype=bf, mem=bool(mem))
    ranges["bwd_dw_bf16"] = splits
    ws = []
    dw = fh._bwd_dw("fused_ce_bwd_dw" + sfx, which + 2, x["xn"], x["wn"], mem,
                    *bwd, mode, clamp_eps, bf, ws)
    got = (ws[0][:splits * d * c].view(splits, d, c) if splits > 1
           else dw[None])
    want = fh.fused_ce_bwd_dw_partials_plain(
        x["xn"], x["wn"], *bwd, mode, clamp_eps, splits=splits,
        range_rows=rows, mm_dtype=bf, **kw)
    # each range's largest product term is at most the whole sum's
    errs["dw_bf16_partials"] = close_grad("bf16 dw partials", got, want,
                                          dw_term)
    errs["dw_bf16_combine"] = close_grad(
        "bf16 combined dw", fh.fused_ce_bwd_dw_combine(want),
        fh.fused_ce_bwd_dw_combine_plain(want))
    return errs, ranges


def eager_head(x, clamp_eps=None, bf16=False, mode=0):
    """(xn, wn, forward) of the eager head on inputs `x`: forward() returns
    the mean loss through torch.matmul + the margin `mode`'s non-target
    map (fused_head._h: none in the identity mode) + the margin select +
    F.cross_entropy, with xn and wn as leaves of its graph. With memn in
    `x`, the eager VPL head: two torch.matmul + the blend (+ the clamp)
    before the select. With `bf16`, each torch.matmul takes bf16 operands
    (cast in the timed region, as the kernels cast as they stage) and its
    bf16 result is taken on in fp32."""
    import torch
    import torch.nn.functional as F

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    xn = x["xn"].clone().requires_grad_(True)
    wn = x["wn"].clone().requires_grad_(True)
    labels = x["labels"].long()
    onehot = F.one_hot(labels, wn.shape[1]).bool()

    def mm(a, b):
        if not bf16:
            return torch.matmul(a, b)
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()

    def forward():
        cos = mm(xn, wn)
        if "memn" in x:
            cos = (1.0 - x["lam"]) * cos + x["lam"] * mm(xn, x["memn"])
        if clamp_eps is not None:
            cos = cos.clamp(-1.0 + clamp_eps, 1.0 - clamp_eps)
        cos = fh._h(mode, cos, x["ab"][:, :1], x["ab"][:, 1:])
        logits = x["scale"][:, None] * torch.where(onehot, x["t"][:, None],
                                                   cos)
        return F.cross_entropy(logits, labels)

    return xn, wn, forward


def library_bwd_device_ms(x, clamp_eps=None, bf16=False):
    """device_ms of the eager head's whole backward (eager_head): one
    forward's graph, kept, taken back 20 times by torch.autograd.grad."""
    import torch

    xn, wn, forward = eager_head(x, clamp_eps, bf16)
    loss = forward()
    return device_ms(lambda: torch.autograd.grad(loss, (xn, wn),
                                                 retain_graph=True))


def library_head_ms(x, clamp_eps=None, bf16=False, mode=0):
    """The eager head (eager_head) as the yardstick, forward and backward
    timed apart (CUDA events). Each is timed LIB_REPEATS times over 20
    iterations; returns (forward ms, backward ms, spread), the times the
    medians of the repeats, the spread their [min, max]."""
    import torch

    _, _, forward = eager_head(x, clamp_eps, bf16, mode)
    fwd = [cuda_ms(forward) for _ in range(LIB_REPEATS)]
    for _ in range(3):
        forward().backward()
    torch.cuda.synchronize()
    iters = 20
    bwd = []
    for _ in range(LIB_REPEATS):
        total = 0.0
        for _ in range(iters):
            loss = forward()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss.backward()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        bwd.append(total / iters)
    spread = {"fwd_ms": [min(fwd), max(fwd)], "bwd_ms": [min(bwd), max(bwd)],
              "repeats": LIB_REPEATS}
    return float(np.median(fwd)), float(np.median(bwd)), spread


def bound_rows(x, names, errs, ms, library, peak=PEAK_FP32_FLOPS):
    """The `kernels` line entries of one family at the shape of `x`, with
    the bound from this run's inputs: inputs read once, outputs written once,
    and the products these inputs need at `peak` FLOP/s. With the memory
    blend a column with lam = 0 needs no memory product and one with lam = 1
    no weight product, so the products are counted over the columns that
    need them."""
    n, d = x["xn"].shape
    c = x["wn"].shape[1]
    product = 2.0 * n * d * c
    row = 4 * n
    if "memn" in x:
        fw = float((x["lam"] != 1).float().mean())   # share needing wn
        fm = float((x["lam"] != 0).float().mean())   # share needing memn
        w_bytes = 4 * d * c * (fw + fm) + 4 * c
    else:
        fw, fm = 1.0, 0.0
        w_bytes = 4 * d * c
    cos = product * (fw + fm)
    bytes_ = [4 * n * d + w_bytes + 7 * row + 3 * row,
              4 * n * d + w_bytes + 9 * row + 4 * n * d + 2 * row,
              4 * n * d + w_bytes + 8 * row + 4 * d * c]
    # fwd: cos; bwd_dx: cos again, then dx through the same products;
    # bwd_dw: cos again, then dw through the weight share only
    flops = [cos, 2 * cos, cos + product * fw]
    rows = []
    for k, name in enumerate(names):
        t_ops = flops[k] / peak * 1e3
        t_bytes = bytes_[k] / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": ms[name][0],
            "plain_ms": ms[name][1], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[k]})
    return rows


def family_calls(x, mode, clamp_eps, bf16=False):
    """[(name, kernel call, plain call)] of one family on inputs `x`."""
    names, fns = kernel_fns("memn" in x, bf16)
    fwd_args, _, _ = kernel_args(x, mode, clamp_eps)
    lse = fns[0][1](*fwd_args).lse
    args = kernel_args(x, mode, clamp_eps, lse)
    return [(name, functools.partial(kernel, *a), functools.partial(plain, *a))
            for name, (kernel, plain), a in zip(names, fns, args)]


def time_family(x, mode, clamp_eps, bf16=False):
    """{name: (kernel ms, plain ms)} of one family on inputs `x`."""
    return {name: (cuda_ms(kernel), cuda_ms(plain)) for name, kernel, plain
            in family_calls(x, mode, clamp_eps, bf16)}


def head_inputs(name, seed):
    """(inputs of the fp32 family at the training shape, mode, clamp) with
    the row scalars (t, tcos, scale, ab) that the fused head `name`
    (heads/fused_adapter._row_params, from its initial state) gives random
    features of norm ~22 and the head's own kernel initialisation."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads import fused_adapter as fa
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.ops.normalize import (
        feature_norms, l2_normalize)

    dev = "cuda"
    cfg = cfg_lib.make_head_config(name, feature_dim=D_MAIN,
                                   num_classes=C_MAIN)
    head = get_head(name)
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(N_MAIN, D_MAIN, device=dev, generator=g)
    labels = torch.randint(0, C_MAIN, (N_MAIN,), device=dev, generator=g,
                           dtype=torch.int32)
    kernel = head.init_kernel(cfg, torch.Generator().manual_seed(seed), dev)
    xn = l2_normalize(feats, dim=1)
    wn = l2_normalize(kernel, dim=0).contiguous()
    tcos = (xn * wn[:, labels.long()].T).sum(1)
    rp = fa._row_params(cfg, tcos, feature_norms(feats),
                        head.init_state(cfg, dev))
    x = dict(xn=xn, wn=wn, labels=labels, t=rp.t.contiguous(),
             tcos=rp.tcos.contiguous(), scale=rp.scale.contiguous(),
             ab=rp.ab.contiguous(),
             g_lse=torch.full((N_MAIN,), 1.0 / N_MAIN, device=dev),
             g_t=torch.full((N_MAIN,), -1.0 / N_MAIN, device=dev))
    return x, rp.mode, rp.clamp_eps


def check_mode_cases():
    """The fp32 family at MODE_CASES against the plain versions (bitwise
    repeat, split partials and combine), timed beside the plain versions,
    the eager library head in the same mode and the bound."""
    import torch

    for name, case in MODE_CASES:
        x, mode, eps = head_inputs(name, seed=17)
        errs, flips, _ = check_case(x, mode, eps)
        split, splits = check_split(x, mode, eps)
        ms = time_family(x, mode, eps)
        lib_fwd, lib_bwd, lib_spread = library_head_ms(x, eps, mode=mode)
        fam = bound_rows(x, PLAIN_KERNELS, errs, ms,
                         (lib_fwd, lib_bwd, lib_bwd))
        emit({"phase": "kernels", "case": case, "head": name, "mode": mode,
              "clamp_eps": eps, "splits": splits,
              "scale_range": [float(x["scale"].min()),
                              float(x["scale"].max())],
              "max_abs_err": {**errs, **split}, "higher_flips": flips,
              "bitwise_repeat": True, "tolerance": TOLERANCE,
              "kernel_ms": {r["name"]: r["ms"] for r in fam},
              "plain_ms": {r["name"]: r["plain_ms"] for r in fam},
              "library_ms": {"head_fwd": lib_fwd, "head_bwd": lib_bwd},
              "library_spread": lib_spread,
              "bound_ms": {r["name"]: r["bound_ms"] for r in fam},
              "bound_by": {r["name"]: r["bound_by"] for r in fam},
              "ok": True})
        del x
        torch.cuda.empty_cache()


def phase_kernels():
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    fh.reset_launch_counts()
    # small shapes: every mode, an out-of-range label, C not a tile multiple;
    # the _mem family with lam mixing 0, 0.15 and 1; fp32 and bf16 products,
    # and the bf16 kernels at a D that is not a multiple of 16
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        tol = TOLERANCE_BF16 if bf16 else TOLERANCE
        for mem in (None, "mixed"):
            msfx = "_mem" if mem else ""
            for mode, eps in ((fh.MODE_IDENTITY, None), (fh.MODE_MV, 1e-7),
                              (fh.MODE_CURRICULAR, 0.0)):
                x = make_inputs(24, 64, 100, mode,
                                seed=mode + (10 if mem else 0),
                                oor_label=True, mem=mem)
                errs, flips, ulp = check_case(x, mode, eps, bf16)
                emit({"phase": "kernels",
                      "case": f"N24_D64_C100_mode{mode}{msfx}{sfx}",
                      "max_abs_err": errs, "higher_flips": flips,
                      **({"bf16_ulp_elems": ulp} if bf16 else {}),
                      "tolerance": tol, "ok": True})
            if bf16:
                x = make_inputs(40, 72, 300, fh.MODE_MV, seed=21,
                                oor_label=True, mem=mem)
                errs, flips, ulp = check_case(x, fh.MODE_MV, 1e-7, bf16)
                emit({"phase": "kernels",
                      "case": f"N40_D72_C300_mode1{msfx}{sfx}",
                      "max_abs_err": errs, "higher_flips": flips,
                      "bf16_ulp_elems": ulp, "tolerance": tol, "ok": True})
    # the split fp32 fwd and bwd_dx over several class ranges: N = 1, N
    # not a multiple of the 32-row tile, ragged last ranges, D = 72, and a
    # last range of one column that is row 0's target; bwd_dw over 3 row
    # ranges of 256-row tiles, the last ragged, at N = 600 and 520; the
    # split bf16 fwd and bwd_dx (128-wide class tiles) and the bf16 bwd_dw
    # (ranges of 32-row tiles, 16 with the blend) over the same shapes
    for mem in (None, "mixed"):
        msfx = "_mem" if mem else ""
        for n, d, c, last in ((1, 64, 300, False), (40, 72, 300, False),
                              (70, 512, 2000, False), (1, 64, 257, True),
                              (600, 72, 300, False),
                              (520, 512, 1000, False)):
            x = make_inputs(n, d, c, fh.MODE_MV, seed=n + c, mem=mem)
            if last:
                x["labels"][0] = c - 1
            errs, flips, _ = check_case(x, fh.MODE_MV, 1e-7)
            split, splits = check_split(x, fh.MODE_MV, 1e-7)
            case = (f"N{n}_D{d}_C{c}_mode1{msfx}_split"
                    + ("_last_target" if last else ""))
            emit({"phase": "kernels", "case": case,
                  "splits": splits, "max_abs_err": {**errs, **split},
                  "higher_flips": flips, "bitwise_repeat": True,
                  "tolerance": TOLERANCE, "ok": True})
            errs, flips, ulp = check_case(x, fh.MODE_MV, 1e-7, bf16=True)
            split, splits = check_split_bf16(x, fh.MODE_MV, 1e-7)
            emit({"phase": "kernels", "case": case + "_bf16",
                  "splits": splits,
                  "max_abs_err": {**errs, **split},
                  "higher_flips": flips, "bf16_ulp_elems": ulp,
                  "bitwise_repeat": True, "tolerance": TOLERANCE_BF16,
                  "ok": True})
    # backward where the JAX package switches to its two-kernel form (K3)
    x = make_inputs(4096, D_MAIN, C_MAIN, fh.MODE_IDENTITY, seed=11)
    errs, flips, _ = check_case(x, fh.MODE_IDENTITY, None)
    split, splits = check_split(x, fh.MODE_IDENTITY, None)
    ms = time_family(x, fh.MODE_IDENTITY, None)
    _, lib_bwd, lib_spread = library_head_ms(x)
    k3 = bound_rows(x, PLAIN_KERNELS, errs, ms, (None, lib_bwd, lib_bwd))
    emit({"phase": "kernels", "case": "N4096_D512_C10575_identity",
          "splits": splits, "max_abs_err": {**errs, **split},
          "higher_flips": flips, "bitwise_repeat": True,
          "tolerance": TOLERANCE,
          "kernel_ms": {r["name"]: r["ms"] for r in k3[1:]},
          "plain_ms": {r["name"]: r["plain_ms"] for r in k3[1:]},
          "library_ms": {"head_bwd": lib_bwd},
          "library_spread": lib_spread,
          "bound_ms": {r["name"]: r["bound_ms"] for r in k3[1:]},
          "ok": True})
    del x
    torch.cuda.empty_cache()
    # the training shape, with times: ArcFace's kernels, then the _mem
    # kernels with the memory and lam of a VPL state after one step; each
    # with fp32 and with bf16 products (the library head then with bf16
    # torch.matmul, the bound at the bf16 tensor-core peak); then the _mem
    # kernels at a dense lam, the work of a VPL run past ~100 steps
    rows = []
    for mem, mode, eps, case in TIMED_CASES:
        x = make_inputs(N_MAIN, D_MAIN, C_MAIN, mode, seed=7, mem=mem)
        for bf16 in (False, True):
            names, _ = kernel_fns(mem, bf16)
            errs, flips, ulp = check_case(x, mode, eps, bf16)
            split = dict(zip(("split", "splits"),
                             (check_split_bf16 if bf16 else check_split)(
                                 x, mode, eps)))
            ms = time_family(x, mode, eps, bf16)
            lib_fwd, lib_bwd, lib_spread = library_head_ms(x, eps, bf16)
            fam = bound_rows(x, names, errs, ms, (lib_fwd, lib_bwd, lib_bwd),
                             PEAK_BF16_TC_FLOPS if bf16 else PEAK_FP32_FLOPS)
            extra = ({"active_classes": int((x["lam"] > 0).sum())} if mem
                     else {})
            if split:
                extra["splits"] = split["splits"]
                errs = {**errs, **split["split"]}
            emit({"phase": "kernels", "case": case + ("_bf16" if bf16
                                                      else ""), **extra,
                  "max_abs_err": errs, "higher_flips": flips,
                  "bitwise_repeat": True,
                  **({"bf16_ulp_elems": ulp} if bf16 else {}),
                  "tolerance": TOLERANCE_BF16 if bf16 else TOLERANCE,
                  "kernel_ms": {r["name"]: r["ms"] for r in fam},
                  "plain_ms": {r["name"]: r["plain_ms"] for r in fam},
                  "library_ms": {"head_fwd": lib_fwd, "head_bwd": lib_bwd},
                  "library_spread": lib_spread,
                  "bound_ms": {r["name"]: r["bound_ms"] for r in fam},
                  "ok": True})
            if mem != "dense":
                rows += fam
        del x
        torch.cuda.empty_cache()
    check_mode_cases()
    return rows


def phase_device_times():
    """device_ms of the bf16 kernels and of the eager bf16 backward at the
    training shape, on the cases that phase_kernels times, with the bf16
    dx and dw entries' per-launch device ms (pre-pass, split kernel, and
    the combine where it runs). It
    runs after the train phases: these timers leave the caching allocator
    in another state, and the train phases' peak memory is read after the
    same allocations as before they existed. Returns {kernel: device_ms}
    of the cases of the kernels line (not the dense lam)."""
    import torch

    out = {}
    for mem, mode, eps, case in TIMED_CASES:
        x = make_inputs(N_MAIN, D_MAIN, C_MAIN, mode, seed=7, mem=mem)
        calls = family_calls(x, mode, eps, bf16=True)
        dev = {name: device_ms(kernel) for name, kernel, _ in calls}
        emit({"phase": "device_times", "case": case + "_bf16",
              "device_ms": dev,
              "library_device_ms": {
                  "head_bwd": library_bwd_device_ms(x, eps, bf16=True)},
              "dx_launch_ms": launch_ms(calls[1][1]),
              "dw_launch_ms": launch_ms(calls[2][1]), "ok": True})
        if mem != "dense":
            out.update(dev)
        del x, calls
        torch.cuda.empty_cache()
    return out


def conv_case(n, h, w, c, co, dtype, seed):
    """(x, kernel) on the card: x ~ N(0, 1), kernel ~ 0.05 N(0, 1)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w, c, device="cuda", generator=g).to(dtype)
    k = 0.05 * torch.randn(3, 3, c, co, device="cuda", generator=g)
    return x, k.to(dtype)


def conv_routes(x, k):
    """One launch of the conv on (x, k): its output and the route counted."""
    from face_recognition_models_tpu_torch.ops import conv3x3

    conv3x3.reset_launch_counts()
    y = conv3x3.conv3x3_same(x, k, block_n=x.shape[0])
    launched = [r for r, v in conv3x3.launch_counts.items() for _ in range(v)]
    want = conv3x3.route(x.dtype, x.shape[3], k.shape[3])
    if launched != [want]:
        raise AssertionError(f"conv3x3: launched {launched}, not [{want}]")
    return y, want


def phase_conv():
    """The conv against its plain version: small fp32 and bf16 shapes on
    each route, then the ResNet-50 stage shapes at b512 bf16, timed beside
    its plain version and cuDNN's channels-last conv (TF32 off), the
    library yardstick, and the fp32 route at b512 14x14x256 beside cuDNN's
    fp32 conv (the rest of its checks in phase_conv_f32). Returns the
    kernels line entries at CONV_MAIN, bf16 and fp32."""
    import torch

    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.scripts import bench_conv3x3

    for i, (n, h, w, c, co, dname) in enumerate(CONV_SMALL):
        dtype = getattr(torch, dname)
        x, k = conv_case(n, h, w, c, co, dtype, seed=i)
        tol = TOL_CONV[dname]
        y, route = conv_routes(x, k)
        err = close("conv3x3", y.float(),
                    conv3x3.conv3x3_same_plain(x, k).float(), tol, tol)
        emit({"phase": "conv", "case": f"N{n}_H{h}_W{w}_C{c}_Co{co}_{dname}",
              "route": route, "max_abs_err": err,
              "tolerance": {"rtol": tol, "atol": tol}, "ok": True})
    row = None
    for h, c in CONV_SHAPES:
        n = 512
        x, k = conv_case(n, h, h, c, c, torch.bfloat16, seed=h)
        y, route = conv_routes(x, k)
        err = close("conv3x3", y.float(),
                    conv3x3.conv3x3_same_plain(x, k).float(),
                    TOL_CONV["bfloat16"], TOL_CONV["bfloat16"])
        del y
        ms = cuda_ms(lambda: conv3x3.conv3x3_same(x, k))
        plain_ms = cuda_ms(lambda: conv3x3.conv3x3_same_plain(x, k))
        cudnn = bench_conv3x3.conv_fn("cudnn", k, 16)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = cuda_ms(lambda: cudnn(x))
        flops = 2.0 * n * h * h * 9 * c * c
        bytes_ = 2.0 * (2 * n * h * h * c + 9 * c * c)
        t_ops = flops / PEAK_BF16_TC_FLOPS * 1e3
        t_bytes = bytes_ / PEAK_BYTES * 1e3
        emit({"phase": "conv", "case": f"N{n}_H{h}_C{c}_bf16", "route": route,
              "max_abs_err": err,
              "tolerance": {"rtol": TOL_CONV["bfloat16"],
                            "atol": TOL_CONV["bfloat16"]},
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": max(t_ops, t_bytes), "kernel_tflops":
              flops / ms / 1e9, "library_tflops": flops / lib_ms / 1e9,
              "ok": True})
        if (h, c) == CONV_MAIN:
            row = {"name": "conv3x3_same", "route": "cuda",
                   "source": CONV_SOURCE,
                   "replaces": REPLACES["conv3x3_same"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": lib_ms}
        del x, k
        torch.cuda.empty_cache()
    # the fp32 route at the benchmark's shape, against cuDNN's fp32 conv
    # (TF32 off); 2,304-deep fp32 sums in different orders: TOL_CONV_DEEP.
    # Its other checks and timers run after the train phases
    # (phase_conv_f32): the train phases' peak memory depends on what the
    # phases before them leave in the caching allocator.
    h, c = CONV_MAIN
    n = 512
    x, k = conv_case(n, h, h, c, c, torch.float32, seed=h)
    y, route = conv_routes(x, k)
    err = close("conv3x3 fp32", y, conv3x3.conv3x3_same_plain(x, k),
                TOL_CONV_DEEP, TOL_CONV_DEEP)
    del y
    ms = cuda_ms(lambda: conv3x3.conv3x3_same(x, k))
    cudnn = bench_conv3x3.conv_fn("cudnn", k, 16)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = cuda_ms(lambda: cudnn(x))
    flops = 2.0 * n * h * h * 9 * c * c
    t_ops = TF32X3_PRODUCTS * flops / PEAK_TF32_TC_FLOPS * 1e3
    t_bytes = 4.0 * (2 * n * h * h * c + 9 * c * c) / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    emit({"phase": "conv", "case": f"N{n}_H{h}_C{c}_float32", "route": route,
          "max_abs_err": err,
          "tolerance": {"rtol": TOL_CONV_DEEP, "atol": TOL_CONV_DEEP},
          "kernel_ms": ms, "library_ms": lib_ms, "bound_ms": bound,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "bound_share": bound / ms,
          "kernel_tflops": flops / ms / 1e9,
          "library_tflops": flops / lib_ms / 1e9, "ok": True})
    del x, k
    torch.cuda.empty_cache()
    return [row, {"name": "conv3x3_same_f32", "route": "cuda",
                  "source": CONV_SOURCE,
                  "replaces": REPLACES["conv3x3_same_f32"], "launches": 0,
                  "max_abs_err": err, "ms": ms, "plain_ms": None,
                  "bound_ms": bound,
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "library_ms": lib_ms}]


def phase_conv_f32():
    """The fp32 routes at CONV_MAIN, b512, after the train phases: two
    launches of the 3xTF32 route bitwise equal, its pre-pass and main kernel
    timed apart (torch.profiler), the plain version's time, and the ragged
    IEEE kernel, launched by name at the same shape, against the plain
    version (TOL_CONV_DEEP) and timed beside its CUDA-core bound. Returns
    the plain version's ms for the kernels line."""
    import torch

    from face_recognition_models_tpu_torch.ops import conv3x3

    h, c = CONV_MAIN
    n = 512
    x, k = conv_case(n, h, h, c, c, torch.float32, seed=h)
    same("conv3x3 fp32", (conv3x3.conv3x3_same(x, k),
                          conv3x3.conv3x3_same(x, k)))
    plain = conv3x3.conv3x3_same_plain(x, k)
    ragged = conv3x3._launch("conv3x3_same_f32_ragged", x, k)
    err = close("conv3x3 fp32 ragged", ragged, plain, TOL_CONV_DEEP,
                TOL_CONV_DEEP)
    del ragged, plain
    ragged_ms = cuda_ms(
        lambda: conv3x3._launch("conv3x3_same_f32_ragged", x, k))
    plain_ms = cuda_ms(lambda: conv3x3.conv3x3_same_plain(x, k))
    parts_ms = launch_ms(lambda: conv3x3.conv3x3_same(x, k),
                         kernel=r"conv3x3_\w+")
    flops = 2.0 * n * h * h * 9 * c * c
    t_simt = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4.0 * (2 * n * h * h * c + 9 * c * c) / PEAK_BYTES * 1e3
    emit({"phase": "conv_f32", "case": f"N{n}_H{h}_C{c}_float32",
          "launch_ms": parts_ms, "plain_ms": plain_ms,
          "bound_fp32_simt_ms": t_simt, "ragged_max_abs_err": err,
          "ragged_ms": ragged_ms,
          "ragged_bound_share": max(t_simt, t_bytes) / ragged_ms,
          "tolerance": {"rtol": TOL_CONV_DEEP, "atol": TOL_CONV_DEEP},
          "ok": True})
    del x, k
    torch.cuda.empty_cache()
    return plain_ms


def train_batches(steps, bs, size, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (steps * bs, size, size, 3), np.uint8)
    labels = rs.randint(0, C_MAIN, steps * bs).astype(np.int32)
    return images, labels


@contextlib.contextmanager
def observe_steps(after=None, before=None, factory="make_train_step"):
    """Run `before(state)` before and `after(state)` after every train step
    that `fit` takes (by wrapping the loop's `factory`,
    `make_partial_fc_train_step` for Partial-FC); the step itself is as
    is."""
    from face_recognition_models_tpu_torch.train import loop

    build = getattr(loop, factory)

    def make(*args, **kwargs):
        step = build(*args, **kwargs)

        def observed(state, *batch):
            if before is not None:
                before(state)
            out = step(state, *batch)
            if after is not None:
                after(out[0])
            return out
        return observed

    setattr(loop, factory, make)
    try:
        yield
    finally:
        setattr(loop, factory, build)


def train_phase(head_name, kernels, steps=TRAIN_STEPS, phase="train",
                **cfg_kw):
    """`steps` full-width steps of resnet18 (or cfg_kw's backbone) +
    `head_name` through the port's
    `fit` (TrainConfig fields in `cfg_kw`). The counters of `kernels` must
    equal the steps and all others stay 0. Returns (fit result, the step's
    batch, launch counts)."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    bs, size = 512, 112
    cfg = cfg_lib.TrainConfig(head=head_name, num_classes=C_MAIN,
                              batch_size=bs, epochs=1, print_freq=1, seed=0,
                              **cfg_kw)
    images, labels = train_batches(steps, bs, size)
    loader = ArrayLoader(images, labels, batch_size=bs, seed=0)
    active = []

    def count_active(state):
        if hasattr(state.head_state, "life"):
            active.append(int((state.head_state.life > 0).sum()))

    torch.cuda.reset_peak_memory_stats()
    fh.reset_launch_counts()
    with observe_steps(count_active):
        res = fit(cfg, loader, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{head_name}: non-finite loss: {res.losses}")
    if len(res.losses) != steps:
        raise AssertionError(f"{head_name}: {len(res.losses)} steps run")
    for name, count in launches.items():
        want = steps if name in kernels else 0
        if count != want:
            raise AssertionError(f"{head_name}: {name} launched {count} "
                                 f"times in {steps} steps, not {want}")
    if head_name == "vpl_arcface" and not (
            len(active) == steps and min(active) > 0):
        raise AssertionError(f"vpl_arcface: active classes {active}: the "
                             "memory blend was not exercised")
    # print_freq=1 reads the loss every step, so each step time includes
    # the wait for the card; step 1 carries cuDNN's first-call set-up
    ms_step = 1e3 * float(np.mean(res.step_seconds[1:]))
    extra = {"active_classes": active} if active else {}
    emit({"phase": phase, "backbone": cfg.backbone, "head": head_name,
          "num_classes": C_MAIN, "batch": bs, "image_size": size,
          "dtype": cfg.compute_dtype, "bn_dtype": cfg.bn_dtype,
          "use_fused_head": cfg.use_fused_head, "losses": res.losses,
          **extra,
          "step_ms": [1e3 * s for s in res.step_seconds],
          "ms_per_step_after_1": ms_step, "img_per_s_after_1": bs / ms_step
          * 1e3, "max_memory_allocated": peak, "peak_gb": peak / 1e9,
          "launches": launches,
          "ok": True})
    return res, (images[:bs], labels[:bs]), launches


def train_vs_eager(res, batch):
    """One step from the same state through the kernels and the eager head."""
    import torch

    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.train.state import (
        restore, snapshot)
    from face_recognition_models_tpu_torch.train.step import (
        make_eval_step, make_train_step)

    state, head_cfg = res.state, res.head_cfg
    saved = snapshot(state)
    head = get_head(head_cfg.name)
    out = {}
    for path, fused in (("kernel", True), ("eager", False)):
        restore(state, saved)
        step = make_train_step(head, head_cfg, use_fused_head=fused,
                               device="cuda")
        _, metrics = step(state, *batch)
        out[path] = (float(metrics["loss"]), state.kernel_w.detach().clone())
    loss_err = abs(out["kernel"][0] - out["eager"][0])
    # same backbone, same batch: the heads differ only in fp32 summation
    # order, and kernel_w moves by lr * grad, so the updated weights agree
    # far inside 1e-6 of values ~2e-2
    if loss_err > 1e-4 * abs(out["eager"][0]):
        raise AssertionError(f"{head_cfg.name}: loss kernel "
                             f"{out['kernel'][0]} vs eager {out['eager'][0]}")
    w_err = close("kernel_w", out["kernel"][1], out["eager"][1], 1e-5, 1e-6)
    emb = make_eval_step(state.backbone, device="cuda")(batch[0][:2])
    if emb.shape != (2, head_cfg.feature_dim) or not bool(
            torch.isfinite(emb).all()):
        raise AssertionError(f"embeddings {tuple(emb.shape)} not finite")
    emit({"phase": "train_vs_eager", "head": head_cfg.name,
          "loss_kernel": out["kernel"][0], "loss_eager": out["eager"][0],
          "loss_abs_err": loss_err, "kernel_w_max_abs_err": w_err,
          "embed_shape": list(emb.shape), "ok": True})


def qaface_bn_check(res, batch):
    """QAFace's degraded view runs in train mode but must move no BatchNorm
    buffer: after one step with it the buffers equal those after one step
    without it (the first forward is the same computation in both)."""
    import torch

    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.train.loop import degrade_images
    from face_recognition_models_tpu_torch.train.state import (
        restore, snapshot)
    from face_recognition_models_tpu_torch.train.step import make_train_step

    state, head_cfg = res.state, res.head_cfg
    saved = snapshot(state)
    step = make_train_step(get_head("qaface"), head_cfg, device="cuda")
    images = torch.as_tensor(batch[0]).cuda()
    buffers = {}
    for path, view in (("with_view", degrade_images(images)),
                       ("without_view", None)):
        restore(state, saved)
        step(state, images, batch[1], view)
        buffers[path] = {k: v.clone() for k, v in
                         state.backbone.state_dict().items()
                         if "running" in k or "num_batches" in k}
    err = 0.0
    for key, got in buffers["with_view"].items():
        want = buffers["without_view"][key]
        if got.dtype == torch.long:
            if not torch.equal(got, want):
                raise AssertionError(f"qaface: {key} {got} vs {want}")
            continue
        # the same forward twice on one card: equal but for the atomics of
        # a reduction, far below the 0.1 x (batch statistic) a second update
        # would add
        err = max(err, close(key, got, want, 1e-5, 1e-6))
    emit({"phase": "qaface_bn_buffers", "buffers": len(buffers["with_view"]),
          "max_abs_err": err, "ok": True})


def phase_train():
    """Returns {kernel: launches on its own path's run}."""
    res, batch, arc = train_phase("arcface", PLAIN_KERNELS)
    train_vs_eager(res, batch)
    del res
    res, batch, vpl = train_phase("vpl_arcface", MEM_KERNELS)
    train_vs_eager(res, batch)
    del res
    res, batch, _ = train_phase("qaface", MEM_KERNELS)
    qaface_bn_check(res, batch)
    return {**{k: arc[k] for k in PLAIN_KERNELS},
            **{k: vpl[k] for k in MEM_KERNELS}}


def head_device_ms(name):
    """{path: device ms} (device_ms over HEAD_TIMED_CALLS calls) of one
    forward + backward of head `name` at N=512,
    D=512, C=10,575 on random features (norm ~22) and the head's own kernel
    initialisation, from its initial state: through the kernels
    (fused_apply, where the head has them) and through the eager head
    (head.apply + the CE), each with the loss_g term; plus the memory each
    holds at its peak above what was allocated before it (MB)."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        fused_apply, fused_supported)
    from face_recognition_models_tpu_torch.train.losses import (
        mean_cross_entropy)

    dev = "cuda"
    cfg = cfg_lib.make_head_config(name, feature_dim=D_MAIN,
                                   num_classes=C_MAIN)
    head = get_head(name)
    g = torch.Generator(device=dev).manual_seed(3)
    feats = torch.randn(N_MAIN, D_MAIN, device=dev,
                        generator=g).requires_grad_(True)
    labels = torch.randint(0, C_MAIN, (N_MAIN,), device=dev, generator=g)
    kernel = head.init_kernel(cfg, torch.Generator().manual_seed(3),
                              dev).requires_grad_(True)
    state = head.init_state(cfg, dev)
    rng = torch.Generator(device=dev).manual_seed(4)

    def fused():
        out = fused_apply(cfg, kernel, feats, labels, state, rng=rng)
        torch.autograd.grad(out.loss_id + out.loss_g, (feats, kernel))

    def eager():
        out = head.apply(cfg, kernel, feats, labels, state, rng=rng)
        loss = mean_cross_entropy(out.logits, labels) + out.loss_g
        torch.autograd.grad(loss, (feats, kernel))

    out = {}
    paths = (("fused", fused), ("eager", eager)) if fused_supported(name) \
        else (("eager", eager),)
    for path, fn in paths:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"{path}_peak_mb"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 20
        # 5 calls: a forward + backward is 60-120 launches, and the card's
        # launch queue (about a thousand) must hold all the calls queued
        # behind the spin
        out[f"{path}_ms"] = device_ms(fn, warmup=2, iters=HEAD_TIMED_CALLS)
    return out


def phase_heads():
    """Each of NEW_HEADS at full width: HEAD_STEPS steps of `fit` on the
    path `train --head-path auto` gives it (K1 / K2 once a step for the
    fused heads, no kernel for the eager two), one step through the kernels
    against one through the eager head for each fused head, and the head's
    own forward + backward device ms on both paths. Returns {head:
    launches}."""
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        use_fused)

    out = {}
    for name in NEW_HEADS:
        fused = use_fused(name)
        res, batch, launches = train_phase(
            name, PLAIN_KERNELS if fused else (), steps=HEAD_STEPS,
            phase="heads", use_fused_head=fused)
        if fused:
            train_vs_eager(res, batch)
        del res
        emit({"phase": "heads_head_ms", "head": name,
              "N": N_MAIN, "D": D_MAIN, "C": C_MAIN, **head_device_ms(name),
              "ok": True})
        out[name] = launches
    return out


def torchvision_state_dict(seed):
    """A seeded resnet18 state_dict in torchvision's layout (the port's
    names) with a 1000-class fc and random BatchNorm statistics."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone

    g = torch.Generator().manual_seed(seed)
    sd = get_backbone("resnet18", embed_dim=1000,
                      dtype=torch.float32).state_dict()
    for k, v in sd.items():
        if k.endswith("running_var") or (k.endswith("weight")
                                         and v.ndim == 1):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.dtype.is_floating_point:
            sd[k] = 0.05 * torch.randn(v.shape, generator=g)
    return sd


def phase_pretrained(root):
    """`train --pretrained` with `--bn-dtype bfloat16`: a seeded
    torchvision-layout resnet18 state_dict saved under `root`, its load
    timed on the host, then 2 full-width ArcFace steps of `fit` from it
    with bf16 BatchNorm. Before step 1 the trunk equals the file (every key
    but the 1000-class fc) bit for bit and every BatchNorm rounds to
    bf16."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.utils.pretrained import (
        load_pretrained_backbone)

    sd = torchvision_state_dict(seed=5)
    path = os.path.join(root, "resnet18_torchvision.pth")
    torch.save(sd, path)
    trunk = get_backbone("resnet18")
    t0 = time.perf_counter()
    load_pretrained_backbone(path, "resnet18", trunk)
    load_s = time.perf_counter() - t0
    del trunk
    checked = []

    def trunk_is_file(state):
        if checked:
            return
        got = state.backbone.state_dict()
        for key, value in sd.items():
            if not key.startswith("fc.") and not torch.equal(
                    got[key].cpu(), value):
                raise AssertionError(f"pretrained: {key} differs from the "
                                     "file before step 1")
        dtypes = {m.dtype for m in state.backbone.modules()
                  if type(m).__name__ == "BatchNorm"}
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"pretrained: BatchNorm dtypes {dtypes}")
        checked.append(len(sd))

    with observe_steps(before=trunk_is_file):
        res, _, launches = train_phase(
            "arcface", PLAIN_KERNELS, steps=2, phase="pretrained_train",
            pretrained_path=path, bn_dtype="bfloat16")
    if not checked:
        raise AssertionError("pretrained: no step ran")
    emit({"phase": "pretrained", "file_bytes": os.path.getsize(path),
          "load_seconds": load_s, "keys_checked": checked[0],
          "losses": res.losses, "launches": launches, "ok": True})


def scan_fit(name, k, images, labels):
    """One epoch of full-width steps of head `name` over the arrays through
    `fit` with scan_steps=k, on the path `train --head-path auto` gives the
    head. Returns (result, {kernel: real launches})."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        use_fused)
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    bs = 512
    cfg = cfg_lib.TrainConfig(head=name, num_classes=C_MAIN, batch_size=bs,
                              epochs=1, print_freq=10 ** 9, seed=0,
                              scan_steps=k, use_fused_head=use_fused(name))
    fh.reset_launch_counts()
    res = fit(cfg, ArrayLoader(images, labels, batch_size=bs, seed=0),
              device="cuda")
    torch.cuda.synchronize()
    return res, dict(fh.launch_counts)


def same_state(name, got, want):
    """Raise unless two train states are equal bit for bit: every tensor a
    step changes (train.state.state_tensors: parameters, BatchNorm buffers,
    kernel_w, momentum buffers, head state, the step count and lr), the
    host step and the step generator's state."""
    import torch

    from face_recognition_models_tpu_torch.train.state import state_tensors

    a, b = state_tensors(got), state_tensors(want)
    bad = [i for i, (x, y) in enumerate(zip(a, b, strict=True))
           if x.dtype != y.dtype or not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} of {len(a)} state tensors "
                             f"differ (first {bad[:5]})")
    if got.step != want.step:
        raise AssertionError(f"{name}: step {got.step} vs {want.step}")
    if got.rng is not None and not torch.equal(got.rng.get_state(),
                                               want.rng.get_state()):
        raise AssertionError(f"{name}: the step generators' states differ")
    return len(a)


def phase_scan():
    """Step batching (`train --scan-steps`): for each of SCAN_HEADS,
    SCAN_STEPS full-width steps with scan_steps=SCAN_K against the same
    steps one at a time, from the same seeded state and batches: losses and
    the whole state bit for bit. The graph's kernel launches are counted by
    its replays: a replay runs SCAN_K launches of each of the head's
    kernels, which the host's counters never see. Then bench_steps' eager
    against graphed runs of the ArcFace recipe and the profiler's host and
    device ms/step and idle share of each path. Returns {kernel: launches}
    of the ArcFace (fp32 kernels) and VPL-ArcFace (_mem kernels) graphed
    runs, replays included."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        use_fused)
    from face_recognition_models_tpu_torch.scripts import bench_steps
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi
    from face_recognition_models_tpu_torch.utils.profiling import (
        profile_train_step)

    images, labels = train_batches(SCAN_STEPS, 512, 112)
    chunks = SCAN_STEPS // SCAN_K
    out = {}
    for name in SCAN_HEADS:
        eager, eager_launches = scan_fit(name, 1, images, labels)
        graphed, real = scan_fit(name, SCAN_K, images, labels)
        # the real launches: SCAN_K warm-up steps before the capture (then
        # undone) and the leftover steps; the replays run the rest
        launches = {k: v + graphed.replay_launches.get(k, 0)
                    * graphed.replays for k, v in real.items()}
        kernels = (() if not use_fused(name) else
                   MEM_KERNELS if name in ("vpl_arcface", "qaface")
                   else PLAIN_KERNELS)
        want_replay = {k: SCAN_K for k in kernels}
        if graphed.replays != chunks or graphed.replay_launches != \
                want_replay:
            raise AssertionError(
                f"scan {name}: {graphed.replays} replays of "
                f"{graphed.replay_launches}, not {chunks} of {want_replay}")
        for k, v in launches.items():
            want = SCAN_STEPS + SCAN_K if k in kernels else 0
            if v != want or eager_launches[k] != (
                    SCAN_STEPS if k in kernels else 0):
                raise AssertionError(f"scan {name}: {k} launched {v} times "
                                     f"(eager {eager_launches[k]})")
        if graphed.losses != eager.losses:
            raise AssertionError(f"scan {name}: losses {graphed.losses} vs "
                                 f"eager {eager.losses}")
        tensors = same_state(f"scan {name}", graphed.state, eager.state)
        emit({"phase": "scan", "head": name, "steps": SCAN_STEPS,
              "scan_steps": SCAN_K, "replays": graphed.replays,
              "capture_seconds": graphed.capture_seconds,
              "replay_launches": graphed.replay_launches,
              "launches": launches, "losses": graphed.losses,
              "bitwise_losses": True, "bitwise_state_tensors": tensors,
              "bitwise_generator": graphed.state.rng is not None,
              "ok": True})
        if name == "arcface":
            out.update({k: launches[k] for k in PLAIN_KERNELS})
        if name == "vpl_arcface":
            out.update({k: launches[k] for k in MEM_KERNELS})
        del eager, graphed
        torch.cuda.empty_cache()

    smi = nvidia_smi()
    res = bench_steps.bench(device="cuda", **SCAN_BENCH)
    for k, summary in res["summary"].items():
        emit({"phase": "scan_bench", "scan_steps": int(k),
              "ms_per_step_after_first_chunk":
                  summary["ms_per_step_after_first_chunk"],
              "img_per_s_after_first_chunk":
                  summary["img_per_s_after_first_chunk"],
              "img_per_s": summary["img_per_s"],
              "peak_gb": summary["peak_gb"],
              "capture_seconds": summary["capture_seconds"],
              "runs": res["runs"][k], "nvidia_smi": smi, "ok": True})
    for k in (1, *SCAN_BENCH["scans"]):
        prof = profile_train_step(cfg_lib.TrainConfig(
            num_classes=C_MAIN, scan_steps=k), device="cuda")
        emit({"phase": "scan_profile", "scan_steps": k,
              "host_ms_per_step": prof["ms_per_step"],
              "device_ms_per_step": prof["device_ms_per_step"],
              "idle_share": prof["idle_share"],
              "by_category_ms": prof["by_category_ms"],
              "capture_seconds": prof.get("capture_seconds"),
              "nvidia_smi": smi, "ok": True})
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recorded_metrics(out):
    """Append the metrics of every train step that `fit` takes to `out`
    (by wrapping the loop's `make_train_step`), as device tensors."""
    from face_recognition_models_tpu_torch.train import loop

    build = loop.make_train_step

    def make(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(state, *batch):
            state, metrics = step(state, *batch)
            out.append(metrics)
            return state, metrics
        return recorded

    loop.make_train_step = make
    try:
        yield
    finally:
        loop.make_train_step = build


def recipe_cfg(backbone="resnet50", **kw):
    """The full-width train recipe of the recipe phase: ArcFace, C=10,575,
    b512, 112 px, bf16 convs, fp32 BatchNorm and head, AdamW lr 1e-3 with
    clipping at 5.0, grad_accum 2, model EMA 0.999 and the four
    augmentations; TrainConfig fields in `kw` replace these."""
    from face_recognition_models_tpu_torch import config as cfg_lib

    fields = dict(
        backbone=backbone, head="arcface", num_classes=C_MAIN,
        batch_size=512, epochs=1, print_freq=10 ** 9, seed=0,
        grad_accum=2, model_ema=0.999,
        optimizer=cfg_lib.OptimizerConfig(name="adamw", learning_rate=1e-3,
                                          clip_grad_norm=5.0),
        data=cfg_lib.DataConfig(horizontal_flip=True, crop_pad=8,
                                color_jitter=0.2, random_erasing=0.25))
    fields.update(kw)
    return cfg_lib.TrainConfig(**fields)


def counted_fit(label, cfg, images, labels, kernels):
    """`bench_steps.timed_fit` of cfg with the launch counters set to 0
    just before and read just after: (summary, result, {kernel:
    launches}), a graph's replays counted by its replay launches. Each of
    `kernels` must run once a step (once more for each warm-up step before
    a capture), every other kernel never; the losses must be finite."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.scripts import bench_steps

    fh.reset_launch_counts()
    summary, res = bench_steps.timed_fit(cfg, images, labels,
                                         torch.device("cuda"))
    torch.cuda.synchronize()
    launches = {k: v + res.replay_launches.get(k, 0) * res.replays
                for k, v in fh.launch_counts.items()}
    steps = len(res.losses)
    k = cfg.scan_steps
    warm = k if k > 1 and steps >= k else 0
    for name, count in launches.items():
        want = steps + warm if name in kernels else 0
        if count != want:
            raise AssertionError(f"{label}: {name} launched {count} times "
                                 f"in {steps} steps, not {want}")
    if k > 1 and res.replay_launches != {n: k for n in kernels}:
        raise AssertionError(f"{label}: a replay launches "
                             f"{res.replay_launches}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{label}: non-finite loss {res.losses}")
    return summary, res, launches


def rule_update_ms(name):
    """One update (clip 5.0, then the rule) of `name` over the ResNet-50 +
    head parameter set (fp32): its kernels' device ms a call from a
    torch.profiler trace of 10 calls, and CUDA events around 20
    back-to-back calls (`cuda_ms`, the host's launch gaps included), beside
    the HBM bound of the bytes it must move: each parameter, gradient and
    slot read once, each parameter and slot written once."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.train.optim import get_optimizer
    from face_recognition_models_tpu_torch.utils.profiling import summarize

    shapes = [p.shape for p in get_backbone("resnet50").parameters()]
    shapes.append((D_MAIN, C_MAIN))
    count = sum(math.prod(s) for s in shapes)
    if count != RN50_HEAD_PARAMS:
        raise AssertionError(f"resnet50 + head: {count} parameters, not "
                             f"{RN50_HEAD_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [torch.nn.Parameter(0.05 * torch.randn(
        s, generator=gen, device="cuda")) for s in shapes]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device="cuda")
    opt = get_optimizer(name, params, 1e-3, momentum=0.9, weight_decay=5e-4,
                        nesterov=False, clip_grad_norm=5.0)
    lr = torch.tensor(1e-3, device="cuda")
    words = 2 + 2 * len(opt.slot_names) + 1   # p, slots in and out; g in
    bound = words * 4 * count / PEAK_BYTES * 1e3
    ms = cuda_ms(lambda: opt.step(lr))
    calls = 10
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            opt.step(lr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = summarize(prof, calls, wall_ms)["device_ms_per_step"]
    return {"params": count, "update_device_ms": device, "update_ms": ms,
            "bound_ms": bound, "bytes": words * 4 * count,
            "bound_by": "bytes"}


def phase_recipe(root):
    """The rest of the train recipe at full width (train/optim.py,
    train/accum.py, the EMA, the augmentations, the frozen trunk,
    distillation). ResNet-50 + ArcFace with recipe_cfg(): RECIPE_STEPS
    steps eager and the same steps graphed (scan_steps RECIPE_K), from the
    same state and batches, bit for bit (losses, every state tensor, the
    generator); its `final` goes to `root` for the distillation run. Then
    each of the eight rules with clipping on the resnet18 recipe:
    RULE_STEPS graphed steps against as many eager ones, bit for bit, and
    each rule's update device ms on the ResNet-50 + head parameters beside
    its bound. Then the frozen trunk (RULE_STEPS steps leave the trunk,
    its BatchNorm buffers and its optimizer slots as they were; the
    profiler's device ms/step against the unfrozen step), the profiler's
    breakdown of the ResNet-50 recipe eager and graphed, and a resnet18
    student distilled from the ResNet-50 `final` through
    `fit(distill.checkpoint_dir)`. Returns {kernel: launches} of the
    ResNet-50 runs."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.train.optim import (
        OPTIMIZER_CONFIGS)
    from face_recognition_models_tpu_torch.train.state import (
        create_train_state)
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi
    from face_recognition_models_tpu_torch.utils.profiling import (
        profile_train_step)

    smi = nvidia_smi()
    images, labels = train_batches(RECIPE_STEPS, 512, 112)
    runs, launches = {}, {k: 0 for k in PLAIN_KERNELS}
    for k in (1, RECIPE_K):
        summary, res, counts = counted_fit(
            f"recipe resnet50 scan_steps={k}", recipe_cfg(scan_steps=k),
            images, labels, PLAIN_KERNELS)
        for name in PLAIN_KERNELS:
            launches[name] += counts[name]
        runs[k] = (summary, res, counts)
    eager, graphed = runs[1][1], runs[RECIPE_K][1]
    if graphed.replays != RECIPE_STEPS // RECIPE_K:
        raise AssertionError(f"recipe: {graphed.replays} replays")
    if graphed.losses != eager.losses:
        raise AssertionError(f"recipe: losses {graphed.losses} vs eager "
                             f"{eager.losses}")
    tensors = same_state("recipe resnet50", graphed.state, eager.state)
    teacher_dir = os.path.join(root, "resnet50")
    CheckpointManager(teacher_dir, "resnet50").save_final(
        eager.state.backbone.state_dict())
    emit({"phase": "recipe", "backbone": "resnet50", "head": "arcface",
          "num_classes": C_MAIN, "batch": 512, "image_size": 112,
          "optimizer": "adamw", "clip_grad_norm": 5.0, "grad_accum": 2,
          "model_ema": 0.999, "flip": True, "crop_pad": 8,
          "color_jitter": 0.2, "random_erasing": 0.25,
          "steps": RECIPE_STEPS, "scan_steps": RECIPE_K,
          "replays": graphed.replays, "losses": eager.losses,
          "bitwise_losses": True, "bitwise_state_tensors": tensors,
          "bitwise_generator": True,
          "eager": {key: runs[1][0][key] for key in RECIPE_KEYS},
          "graphed": {key: runs[RECIPE_K][0][key] for key in RECIPE_KEYS},
          "launches": {k: runs[1][2][k] for k in PLAIN_KERNELS},
          "graphed_launches": {k: runs[RECIPE_K][2][k]
                               for k in PLAIN_KERNELS},
          "nvidia_smi": smi, "ok": True})
    del eager, graphed, runs
    torch.cuda.empty_cache()

    rule_images = images[:RULE_STEPS * 512], labels[:RULE_STEPS * 512]
    for name in OPTIMIZER_CONFIGS:
        out = []
        for k in (1, RULE_STEPS):
            cfg = recipe_cfg(
                "resnet18", scan_steps=k, grad_accum=1, model_ema=0.0,
                data=cfg_lib.DataConfig(),
                optimizer=cfg_lib.OptimizerConfig(
                    name=name, learning_rate=0.1 if name == "sgd" else 1e-3,
                    clip_grad_norm=5.0))
            out.append(counted_fit(f"rule {name} scan_steps={k}", cfg,
                                   *rule_images, PLAIN_KERNELS)[1])
        if out[1].losses != out[0].losses:
            raise AssertionError(f"rule {name}: losses {out[1].losses} vs "
                                 f"eager {out[0].losses}")
        tensors = same_state(f"rule {name}", out[1].state, out[0].state)
        emit({"phase": "recipe_rule", "optimizer": name,
              "clip_grad_norm": 5.0, "backbone": "resnet18",
              "steps": RULE_STEPS, "scan_steps": RULE_STEPS,
              "losses": out[0].losses, "bitwise_losses": True,
              "bitwise_state_tensors": tensors,
              "resnet50_head_update": rule_update_ms(name),
              "nvidia_smi": smi, "ok": True})
        del out
        torch.cuda.empty_cache()

    frozen_cfg = recipe_cfg(freeze_backbone=True, grad_accum=1,
                            model_ema=0.0, data=cfg_lib.DataConfig())
    _, res, _ = counted_fit("recipe frozen", frozen_cfg, *rule_images,
                            PLAIN_KERNELS)
    head_cfg = cfg_lib.make_head_config("arcface", num_classes=C_MAIN)
    _, _, start = create_train_state(frozen_cfg, head_cfg,
                                     torch.device("cuda"))
    trunk = same_tensors_of("frozen trunk", res.state, start)
    del res, start
    torch.cuda.empty_cache()
    profiles = {}
    for label, cfg in (
            ("unfrozen", dataclasses.replace(frozen_cfg,
                                             freeze_backbone=False)),
            ("frozen", frozen_cfg), ("recipe_eager", recipe_cfg()),
            ("recipe_graphed", recipe_cfg(scan_steps=RECIPE_K))):
        prof = profile_train_step(cfg, device="cuda", steps=RECIPE_PROFILED)
        profiles[label] = {
            "host_ms_per_step": prof["ms_per_step"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "idle_share": prof["idle_share"],
            "by_category_ms": prof["by_category_ms"]}
        torch.cuda.empty_cache()
    emit({"phase": "recipe_freeze", "backbone": "resnet50",
          "optimizer": "adamw", "steps": RULE_STEPS,
          "bitwise_unchanged_trunk_tensors": trunk,
          "device_ms_per_step_unfrozen":
              profiles["unfrozen"]["device_ms_per_step"],
          "device_ms_per_step_frozen":
              profiles["frozen"]["device_ms_per_step"],
          "profiles": profiles, "nvidia_smi": smi, "ok": True})
    if not (profiles["frozen"]["device_ms_per_step"]
            < profiles["unfrozen"]["device_ms_per_step"]):
        raise AssertionError(f"frozen trunk: device ms/step "
                             f"{profiles['frozen']} not below the unfrozen "
                             f"{profiles['unfrozen']}")

    student = recipe_cfg(
        "resnet18", grad_accum=1, model_ema=0.0, data=cfg_lib.DataConfig(),
        optimizer=cfg_lib.OptimizerConfig(learning_rate=0.1),
        distill=cfg_lib.DistillConfig(backbone="resnet50",
                                      checkpoint_dir=teacher_dir,
                                      which="final", weight=1.0,
                                      mode="cosine"))
    metrics = []
    with recorded_metrics(metrics):
        summary, res, _ = counted_fit("distill", student, images, labels,
                                      PLAIN_KERNELS)
    loss_kd = [float(m["loss_kd"]) for m in metrics]
    if len(loss_kd) != RECIPE_STEPS or not all(
            math.isfinite(v) for v in loss_kd):
        raise AssertionError(f"distill: loss_kd {loss_kd}")
    emit({"phase": "recipe_distill", "student": "resnet18",
          "teacher": "resnet50", "teacher_which": "final",
          "mode": "cosine", "weight": 1.0, "steps": RECIPE_STEPS,
          "loss_kd_step_1": loss_kd[0], "loss_kd_step_8": loss_kd[-1],
          "loss_kd": loss_kd, "losses": res.losses,
          **{key: summary[key] for key in RECIPE_KEYS},
          "nvidia_smi": smi, "ok": True})
    del res
    torch.cuda.empty_cache()
    return launches


def same_tensors_of(name, got, want):
    """Raise unless the backbone's parameters and buffers and its
    parameters' optimizer slots are equal bit for bit in two train
    states; returns how many tensors were compared."""
    import torch

    a = [*got.backbone.state_dict().values()]
    b = [*want.backbone.state_dict().values()]
    for p, q in zip(got.backbone.parameters(), want.backbone.parameters(),
                    strict=True):
        a += list(got.optimizer.state[p].values())
        b += list(want.optimizer.state[q].values())
    bad = [i for i, (x, y) in enumerate(zip(a, b, strict=True))
           if not torch.equal(x, y)]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} of {len(a)} tensors "
                             f"moved (first {bad[:5]})")
    return len(a)


def phase_head_bf16():
    """One forward and backward through the public fused_margin_ce and
    fused_margin_ce_mem with mm_dtype=torch.bfloat16 at the training shape
    (ArcFace-like margin, scale 64; the _mem family with a VPL state after
    one step). Returns {kernel: launches}."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh

    cases = []
    for mem, eps in ((None, None), ("vpl", 1e-7)):
        x = make_inputs(N_MAIN, D_MAIN, C_MAIN, fh.MODE_IDENTITY, seed=13,
                        mem=mem)
        cases.append((x, eps))
    fh.reset_launch_counts()
    out = []
    for x, eps in cases:
        xn = x["xn"].clone().requires_grad_(True)
        wn = x["wn"].clone().requires_grad_(True)
        mem = (x["memn"], x["lam"]) if "memn" in x else ()
        fn = fh.fused_margin_ce_mem if mem else fh.fused_margin_ce
        res = fn(xn, wn, *mem, x["labels"], x["t"], x["tcos"], x["scale"],
                 x["ab"], fh.MODE_IDENTITY, eps, mm_dtype=torch.bfloat16)
        loss = (res.lse - res.target_logit).mean()
        loss.backward()
        out.append((x, eps, loss.detach(), xn.grad, wn.grad))
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    for name, count in launches.items():
        want = 1 if name in BF16_KERNELS else 0
        if count != want:
            raise AssertionError(f"head_bf16: {name} launched {count} times, "
                                 f"not {want}")
    losses = {}
    for x, eps, loss16, gx, gw in out:
        family = "mem" if "memn" in x else "plain"
        if not (bool(torch.isfinite(gx).all())
                and bool(torch.isfinite(gw).all())):
            raise AssertionError(f"head_bf16 {family}: non-finite gradient")
        mem = (x["memn"], x["lam"]) if "memn" in x else ()
        plain = (fh.fused_margin_ce_mem_plain if mem
                 else fh.fused_margin_ce_plain)
        ref = plain(x["xn"], x["wn"], *mem, x["labels"], x["t"], x["tcos"],
                    x["scale"], x["ab"], fh.MODE_IDENTITY, eps)
        loss32 = float((ref.lse - ref.target_logit).mean())
        rel = abs(float(loss16) - loss32) / abs(loss32)
        # the JAX package's contract for the option (its
        # test_bf16_matmul_variant_close): within 5% of the fp32 loss
        if not rel < 0.05:
            raise AssertionError(f"head_bf16 {family}: loss {float(loss16)} "
                                 f"vs fp32 {loss32}")
        losses[family] = {"bf16": float(loss16), "fp32": loss32,
                          "rel_diff": rel}
    emit({"phase": "head_bf16", "losses": losses, "launches": launches,
          "ok": True})
    return {k: launches[k] for k in BF16_KERNELS}


def phase_conv_bench():
    """The conv's benchmark entry point on the card at CONV_MAIN, b512, in
    bf16 and in fp32: the kernel path, whose launches are counted and must
    all be of the dtype's 16-byte route, and the cuDNN path. Returns
    {route: launches}."""
    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.scripts import bench_conv3x3

    shape = ",".join(map(str, CONV_MAIN))
    iters = 10
    want = (1 + bench_conv3x3.N_REPS) * iters
    launches = {}
    for dtype, key in (("bfloat16", "conv3x3_same"),
                       ("float32", "conv3x3_same_f32")):
        conv3x3.reset_launch_counts()
        res = bench_conv3x3.bench(shape, 512, "kernel", iters, dtype=dtype,
                                  device="cuda")
        counts = dict(conv3x3.launch_counts)
        if counts != {r: want * (r == key) for r in counts}:
            raise AssertionError(f"conv3x3_bench {dtype}: launches {counts}, "
                                 f"not {want} of {key}")
        launches[key] = counts[key]
        lib = bench_conv3x3.bench(shape, 512, "cudnn", iters, dtype=dtype,
                                  device="cuda")
        for r in (res, lib):
            if not (r["ms"] > 0 and math.isfinite(r["tflops"])):
                raise AssertionError(f"conv3x3_bench: {r}")
            emit({"phase": "conv3x3_bench", **r, "ok": True})
    return launches


def state_tensors(state):
    """{name: tensor} of everything a resumed run must carry over bit for
    bit: backbone parameters and buffers, kernel_w, momentum buffers."""
    out = {f"backbone.{k}": v for k, v in state.backbone.state_dict().items()}
    out["kernel_w"] = state.kernel_w.detach()
    for i, slot in state.optimizer.state_dict()["state"].items():
        out[f"momentum.{i}"] = slot["momentum_buffer"]
    return out


def same_tensors(name, got, want, layout=False):
    """Raise unless `got` and `want` hold equal tensors bit for bit; with
    `layout`, the backbone's tensors must have the same strides too (the
    card's channels-last weights). Momentum buffers may come back in
    another layout; their values must still be equal."""
    if got.keys() != want.keys():
        raise AssertionError(f"{name}: tensors {sorted(got)} vs "
                             f"{sorted(want)}")
    import torch

    for key in want:
        a, b = got[key], want[key]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{name}: {key} differs")
        if (layout and key.startswith("backbone.")
                and got[key].stride() != want[key].stride()):
            raise AssertionError(f"{name}: {key} strides {got[key].stride()}"
                                 f" vs {want[key].stride()}")


def phase_checkpoint(root):
    """Checkpoints and resume at full width under `root` (run A's files
    stay there for phase_eval). Returns run A's fit result."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.state import (
        create_train_state)

    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)

    bs, size, steps = 512, 112, 2
    # identity-structured data (256 identities x 4 images): the eval phase
    # verifies this model on other identities; 4 steps at lr 0.1 on uniform
    # noise with random labels collapse the embeddings instead
    images, labels = synthetic_identities(steps * bs // 4, 4,
                                          image_size=size, seed=1)
    loader = ArrayLoader(images, labels, batch_size=bs, seed=0)

    def config(epochs, resume=None):
        return cfg_lib.TrainConfig(head="arcface", num_classes=C_MAIN,
                                   batch_size=bs, epochs=epochs,
                                   print_freq=100, seed=0,
                                   continue_train=resume)

    def run(directory, epochs, resume=None):
        mgr = CheckpointManager(directory, "arcface")
        res = fit(config(epochs, resume), loader, device="cuda",
                  checkpoint_manager=mgr)
        torch.cuda.synchronize()
        return res, mgr

    dir_a = os.path.join(root, "a", "arcface")
    dir_b = os.path.join(root, "b", "arcface")
    # two runs compared bit for bit, in PyTorch's default mode
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("checkpoint: deterministic mode is on")
    a, mgr_a = run(dir_a, 2)
    b1, mgr_b = run(dir_b, 1)
    b2, _ = run(dir_b, 1, "latest")
    mgr_a.save_final(a.state.backbone.state_dict())
    if b1.losses + b2.losses != a.losses:
        raise AssertionError(f"checkpoint: resumed losses {b1.losses} + "
                             f"{b2.losses} vs {a.losses}")
    same_tensors("resumed run", state_tensors(b2.state),
                 state_tensors(a.state))

    # one save and one restore timed; the restored state bit for bit
    head_cfg = cfg_lib.make_head_config("arcface", num_classes=C_MAIN)
    epoch_loss = float(np.mean(a.losses[steps:]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr_a.save(a.state, 2, epoch_loss)
    save_s = time.perf_counter() - t0
    _, _, fresh = create_train_state(config(1), head_cfg,
                                     torch.device("cuda"))
    t0 = time.perf_counter()
    restored, start, loss = mgr_a.restore(fresh, "latest")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if (start, loss) != (3, epoch_loss) or restored.step != a.state.step:
        raise AssertionError(f"checkpoint: restore gave epoch {start}, "
                             f"loss {loss}, step {restored.step}")
    same_tensors("restored state", state_tensors(restored),
                 state_tensors(a.state), layout=True)
    sizes = {name: os.path.getsize(os.path.join(dir_a, name))
             for name in sorted(os.listdir(dir_a))}

    # keep-3 rotation, then min_loss resume deletes the epoch files
    for epoch in (3, 4, 5):
        mgr_b.save(b2.state, epoch, 1e9)
    kept = sorted(n for n in os.listdir(dir_b) if n.startswith("epoch_"))
    if kept != ["epoch_3", "epoch_4", "epoch_5"]:
        raise AssertionError(f"checkpoint: rotation kept {kept}")
    best = min(np.mean(a.losses[:steps]), np.mean(a.losses[steps:]))
    _, start, loss = mgr_b.restore(fresh, "min_loss")
    left = sorted(os.listdir(dir_b))
    if loss != best or any(n.startswith("epoch_") for n in left):
        raise AssertionError(f"checkpoint: min_loss resume gave loss {loss} "
                             f"(best {best}), left {left}")
    emit({"phase": "checkpoint", "backbone": "resnet18", "head": "arcface",
          "num_classes": C_MAIN, "batch": bs, "steps_per_epoch": steps,
          "losses": a.losses, "bytes": sizes, "save_seconds": save_s,
          "restore_seconds": restore_s, "min_loss_start_epoch": start,
          "ok": True})
    return a


@contextlib.contextmanager
def recorded(module, name):
    """Record the return value of every call of module.name."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def synthetic_benchmark(path, identities=3000, size=112):
    """A .bin of uint8 arrays in the insightface layout: for each identity
    one genuine pair (its images 0 and 1) and one impostor pair (its image
    2 and the next identity's image 3): 2 x identities pairs."""
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)

    images, _ = synthetic_identities(identities, 4, image_size=size, seed=2)
    bins, issame = [], []
    for i in range(identities):
        j = (i + 1) % identities
        bins += [images[4 * i], images[4 * i + 1],
                 images[4 * i + 2], images[4 * j + 3]]
        issame += [True, False]
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f, protocol=pickle.HIGHEST_PROTOCOL)


def phase_eval(root, run_a):
    """Run A's final artifact through restore_backbone and the `eval` CLI
    on a synthetic LFW-size benchmark (see the module docstring)."""
    import torch

    from face_recognition_models_tpu_torch.checkpoint import restore_backbone
    from face_recognition_models_tpu_torch.cli.main import main as cli_main
    from face_recognition_models_tpu_torch.data.pairs import load_bin
    from face_recognition_models_tpu_torch.evaluation import batch_eval
    from face_recognition_models_tpu_torch.evaluation.verification import (
        embed_unique_images)
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device

    bench_dir = os.path.join(root, "benchmarks")
    os.makedirs(bench_dir)
    synthetic_benchmark(os.path.join(bench_dir, "synth_lfw.bin"))
    stack, pairs = load_bin(os.path.join(bench_dir, "synth_lfw.bin"))
    model = get_backbone("resnet18")
    model.load_state_dict(restore_backbone(os.path.join(root, "a", "arcface"),
                                           "final"))
    model = to_device(model, torch.device("cuda"))
    live = embed_unique_images(
        batch_eval.make_embed_fn(run_a.state.backbone, device="cuda"),
        stack, 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = embed_unique_images(batch_eval.make_embed_fn(model, device="cuda"),
                              stack, 256)
    embed_s = time.perf_counter() - t0
    if not np.array_equal(emb, live):
        raise AssertionError("eval: restored embeddings differ from the live "
                             f"state's by {np.abs(emb - live).max()}")
    results, rates = {}, {}
    for protocol, flag in (("host", []), ("device", ["--device-protocol"])):
        out_dir = os.path.join(root, "eval_" + protocol)
        with recorded(batch_eval, "evaluate_model_on_benchmark") as calls:
            rc = cli_main(["eval", "--checkpoint-dir",
                           os.path.join(root, "a"), "--eval-data-path",
                           bench_dir, "--benchmarks", "synth_lfw",
                           "--batch-size", "256", "--tpr-far", "1e-2,1e-3",
                           "--output-dir", out_dir] + flag)
        tables = [os.path.join(out_dir, f) for f in
                  ("accuracy_10fold.csv", "auc_10fold.csv")]
        if rc != 0 or len(calls) != 1 or not all(map(os.path.isfile,
                                                     tables)):
            raise AssertionError(f"eval {protocol}: rc {rc}, {len(calls)} "
                                 f"benchmark runs, tables {tables}")
        results[protocol], rates[protocol] = calls[0]
    host, dev = results["host"], results["device"]
    auc_err = float(np.max(np.abs(np.subtract(host.fold_aucs,
                                              dev.fold_aucs))))
    if (host.fold_thresholds != dev.fold_thresholds
            or host.fold_accuracies != dev.fold_accuracies
            or auc_err > 1e-12 or rates["host"] != rates["device"]):
        raise AssertionError(f"eval: host {host} vs device {dev} "
                             f"(auc err {auc_err})")
    if not host.mean_auc >= 0.9:
        raise AssertionError(f"eval: mean AUC {host.mean_auc} below 0.9")
    emit({"phase": "eval", "backbone": "resnet18", "pairs": len(pairs),
          "images": len(stack), "batch": 256,
          "mean_accuracy": host.mean_accuracy, "std_accuracy":
          host.std_accuracy, "mean_auc": host.mean_auc,
          "fold_thresholds": host.fold_thresholds,
          "auc_host_vs_device_max_abs_err": auc_err,
          "tpr_at_far": {f"{k:g}": v for k, v in rates["host"].items()},
          "embed_img_per_s": len(stack) / embed_s, "ok": True})


def fit_arcface(loader, steps_label):
    """`fit` of the full-width ArcFace recipe over `loader` for one epoch,
    in PyTorch's default mode, the loss read only at the epoch's end (so
    the host runs ahead of the card as in a real run). Returns the result
    and {kernel: launches} of the run."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"{steps_label}: deterministic mode is on")
    cfg = cfg_lib.TrainConfig(head="arcface", num_classes=C_MAIN,
                              batch_size=loader.batch_size, epochs=1,
                              print_freq=10_000, seed=0)
    fh.reset_launch_counts()
    res = fit(cfg, loader, device="cuda")
    torch.cuda.synchronize()
    launches = dict(fh.launch_counts)
    steps = len(res.losses)
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{steps_label}: non-finite loss {res.losses}")
    for name, count in launches.items():
        want = steps if name in PLAIN_KERNELS else 0
        if count != want:
            raise AssertionError(f"{steps_label}: {name} launched {count} "
                                 f"times in {steps} steps, not {want}")
    return res, launches


def phase_gather():
    """The target-column gather's backward (`heads.base.take_columns`)
    at the training shape: bitwise repeats where labels repeat, against
    index_select's backward (float atomics) and the one-hot product, and
    each one's device ms; then two default-mode runs of 3 full-width
    ArcFace steps on the same batches must be bitwise equal."""
    import torch

    from face_recognition_models_tpu_torch.heads.base import (
        one_hot, take_columns)

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the one-hot product
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(D_MAIN, C_MAIN, device=cuda, generator=g)
    idx = torch.randint(0, C_MAIN, (N_MAIN,), device=cuda, generator=g)
    grad = torch.randn(D_MAIN, N_MAIN, device=cuda, generator=g)
    repeated = N_MAIN - int(torch.unique(idx).numel())
    w.requires_grad_()

    def index_select_bwd():
        return torch.autograd.grad(w.index_select(1, idx), w, grad)[0]

    def take_columns_bwd():
        return torch.autograd.grad(take_columns(w, idx), w, grad)[0]

    def one_hot_bwd():
        return grad @ one_hot(idx, C_MAIN)

    got = take_columns_bwd()
    if not torch.equal(got, take_columns_bwd()):
        raise AssertionError("gather: take_columns' backward did not repeat")
    err = max(close("gather vs index_select", got, index_select_bwd(),
                    1e-6, 1e-6),
              close("gather vs one-hot", got, one_hot_bwd(), 1e-6, 1e-6))
    ms = {name: device_ms(fn) for name, fn in (
        ("take_columns", take_columns_bwd),
        ("index_select", index_select_bwd), ("one_hot", one_hot_bwd))}

    bs, steps = N_MAIN, 3
    images, labels = train_batches(steps, bs, 112, seed=2)
    dup = [bs - len(np.unique(labels[i * bs:(i + 1) * bs]))
           for i in range(steps)]
    if min(dup) == 0:
        raise AssertionError(f"gather: no repeated label in a batch: {dup}")
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader

    runs = []
    for _ in range(2):
        res, _ = fit_arcface(ArrayLoader(images, labels, batch_size=bs,
                                         seed=0), "gather")
        runs.append((res.losses, state_tensors(res.state)))
        del res
    if runs[0][0] != runs[1][0]:
        raise AssertionError(f"gather: losses {runs[0][0]} vs {runs[1][0]}")
    same_tensors("gather: the second default-mode run", runs[1][1],
                 runs[0][1])
    emit({"phase": "gather", "shape": [N_MAIN, D_MAIN, C_MAIN],
          "repeated_labels": repeated, "max_abs_err": err,
          "backward_device_ms": ms, "chosen": "take_columns",
          "train_steps": steps, "repeated_labels_per_batch": dup,
          "losses": runs[0][0], "bitwise_equal_runs": True, "ok": True})


class PackableArrays:
    """An ArrayLoader's one unshuffled full pass, with the two fields
    `pack_from_loader` reads (`dataset` for the length and
    `skipped_images`), so seeded arrays pack with no decoder."""

    def __init__(self, images, labels, batch_size):
        from face_recognition_models_tpu_torch.data.pipeline import (
            ArrayLoader)

        self.loader = ArrayLoader(images, labels, batch_size, shuffle=False,
                                  drop_remainder=False)
        self.dataset = images
        self.skipped_images = 0

    def epoch(self, epoch=0):
        return self.loader.epoch(epoch)


def phase_train_packed():
    """This slice's path: the ArcFace phase's seeded batches (20 steps at
    b512, 112 px) packed with `pack_from_loader`, then the full-width
    `fit` from `PackedLoader` and from `ArrayLoader` over the same arrays
    with the same seed: bitwise equal losses. Pack write GB/s, PackedLoader
    batches/s on the host alone, img/s and host ms/step of both runs, and
    each run once more under torch.profiler: device ms/step, idle share
    and the host-to-device copy's device ms."""
    import torch

    from face_recognition_models_tpu_torch.data.packed import (
        PackedDataset, PackedLoader, pack_from_loader)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.utils.profiling import summarize

    steps, bs, size = 20, N_MAIN, 112
    images, labels = train_batches(steps, bs, size)
    out = {"phase": "train_packed", "steps": steps, "batch": bs,
           "image_size": size, "num_classes": C_MAIN}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        meta = pack_from_loader(PackableArrays(images, labels, bs),
                                [str(c) for c in range(C_MAIN)], root, size)
        write_s = time.perf_counter() - t0
        ds = PackedDataset.open(root)
        if not (np.array_equal(np.asarray(ds.images), images)
                and np.array_equal(ds.labels, labels)):
            raise AssertionError("train_packed: the pack differs from the "
                                 "arrays it was written from")
        t0 = time.perf_counter()
        batches = sum(1 for _ in PackedLoader(ds, bs, seed=0).epoch(1))
        read_s = time.perf_counter() - t0
        runs = {}
        for name, make in (
                ("packed", lambda: PackedLoader(ds, batch_size=bs, seed=0)),
                ("array", lambda: ArrayLoader(images, labels, batch_size=bs,
                                              seed=0))):
            res, launches = fit_arcface(make(), f"train_packed {name}")
            runs[name] = {
                "losses": res.losses, "img_per_s": res.images_per_sec,
                "host_ms_per_step_after_1":
                    1e3 * float(np.mean(res.step_seconds[1:])),
                "launches": launches}
            del res
            # the same run again under the profiler, for its device times
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res, _ = fit_arcface(make(), f"train_packed {name}")
                wall_ms = 1e3 * (time.perf_counter() - t0)
            if res.losses != runs[name]["losses"]:
                raise AssertionError(f"train_packed {name}: the profiled "
                                     "run's losses differ")
            runs[name]["profiler"] = {k: v for k, v in summarize(
                prof, steps, wall_ms).items() if k != "top_kernels"}
            del res, prof
    if runs["packed"]["losses"] != runs["array"]["losses"]:
        raise AssertionError("train_packed: losses from the pack "
                             f"{runs['packed']['losses']} vs the arrays "
                             f"{runs['array']['losses']}")
    emit({**out, "pack_bytes": int(meta["num_samples"]) * size * size * 3,
          "pack_write_seconds": write_s,
          "pack_write_gb_per_s": images.nbytes / write_s / 1e9,
          "packed_loader_batches": batches,
          "packed_loader_batches_per_s": batches / read_s,
          "runs": runs, "losses_bitwise_equal": True, "ok": True})
    return runs["packed"]["launches"]


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "jpeg_fixture")
DECODE_MAD = 2.0   # mean abs diff vs PIL, the JAX test's bound


def phase_decode():
    """Whether the port's native JPEG decoder builds here; if it does, the
    committed fixture decoded at 112 px against PIL's decode of it (the
    committed .npy) and `decode_batch`'s img/s at b512 (the fixture tiled)
    with 8 threads. A failed build is reported and does not fail the
    smoke (the pack path needs no decoder); a wrong decode does."""
    from face_recognition_models_tpu_torch.native import fastdecode

    t0 = time.perf_counter()
    if not fastdecode.is_available():
        emit({"phase": "decode", "native_builds": False,
              "build_error": fastdecode.build_error(), "ok": True})
        return
    build_s = time.perf_counter() - t0
    paths = sorted(os.path.join(FIXTURE, f) for f in os.listdir(FIXTURE)
                   if f.endswith(".jpg"))
    want = np.load(os.path.join(FIXTURE, "pil_112.npy"))
    got, status = fastdecode.decode_batch(paths, 112, n_threads=8)
    mad = float(np.abs(got.astype(np.int32) - want.astype(np.int32)).mean())
    if status.any() or not mad < DECODE_MAD:
        raise AssertionError(f"decode: status {status.tolist()}, mean abs "
                             f"diff {mad} vs PIL (bound {DECODE_MAD})")
    batch = (paths * (-(-N_MAIN // len(paths))))[:N_MAIN]
    out = np.empty((N_MAIN, 112, 112, 3), np.uint8)
    fastdecode.decode_batch(batch, 112, out=out, n_threads=8)
    seconds = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, status = fastdecode.decode_batch(batch, 112, out=out, n_threads=8)
        seconds.append(time.perf_counter() - t0)
        if status.any():
            raise AssertionError("decode: a tiled fixture image failed")
    emit({"phase": "decode", "native_builds": True, "build_seconds": build_s,
          "library": fastdecode.library_path().name, "images": len(paths),
          "source_size": 250, "mean_abs_diff_vs_pil": mad,
          "tolerance": DECODE_MAD, "batch": N_MAIN, "threads": 8,
          "img_per_s": N_MAIN / float(np.median(seconds)),
          "seconds": seconds, "ok": True})


def phase_bench_embed():
    """The headline workload at full size, its device split, and bf16 vs
    fp32 BatchNorm on the same weights and batch."""
    import torch
    import torch.nn.functional as F

    from face_recognition_models_tpu_torch.scripts import bench_embed
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    res = bench_embed.bench(device="cuda")
    res32 = bench_embed.bench(bn_dtype="float32", device="cuda")
    for r in (res, res32):
        if not (r["value"] > 0 and math.isfinite(r["value"])):
            raise AssertionError(f"bench_embed: {r}")
    cuda = torch.device("cuda")
    images = bench_embed.make_batches(1, 512, 112, 0, cuda)[0]
    split, emb = {}, {}
    for bn in ("bfloat16", "float32"):
        step = make_eval_step(bench_embed.build_model("resnet50", bn, 0, cuda),
                              device=cuda)
        split[bn] = bench_embed.device_split(step, images)
        emb[bn] = step(images)
    cos = F.cosine_similarity(emb["bfloat16"], emb["float32"], dim=1)
    min_cos = float(cos.min())
    if not min_cos >= 0.99:
        raise AssertionError(f"bench_embed: bf16-BN vs fp32-BN least cosine "
                             f"{min_cos}")
    emit({"phase": "bench_embed", **res,
          "fp32_bn": {k: res32[k] for k in ("value", "ms_per_batch")},
          "device_ms_by_category": split,
          "min_cosine_bf16_vs_fp32_bn": min_cos,
          "mean_cosine_bf16_vs_fp32_bn": float(cos.mean()), "ok": True})
    return res["value"]


# the serve phase: ResNet-50 (512-d, 112 px, bf16 convs) exported and
# served; a gallery of SERVE_IDENTITIES synthetic identities x 2 images,
# each client thread's requests a probe image (a third image) of one
SERVE_IDENTITIES = 1000
SERVE_CLIENTS, SERVE_REQUESTS = 32, 16
SERVE_MICRO_BATCHES = (8, 1)
SERVE_WAIT_MS = 5.0
SERVE_RETRIES = 3   # a request the server's connection reset, sent again
# an artifact against the live eval step (tests/test_serving.py of the JAX
# package: rtol = atol 1e-2), an HTTP embedding against the direct one
# (tests/test_server.py: atol 2e-3), the card's pooled scores against the
# host's (tests/test_openset.py: atol 1e-6). The folded artifact (moved
# BatchNorm statistics, bf16 convs, full width) row by row: the JAX
# folded bound's 2e-2 relative to the embedding's norm, and a least
# cosine of 0.9998 (the cosine such an error leaves: 1 - 0.02^2 / 2)
TOL_ARTIFACT, TOL_FOLDED, TOL_HTTP, TOL_POOLED = 1e-2, 2e-2, 2e-3, 1e-6
MIN_FOLDED_COSINE = 0.9998
MIN_TOP1 = 0.99
# identification at scale: a million-image gallery over 100,000 identities
ID_GALLERY, ID_IDENTITIES, ID_PROBES = 1_000_000, 100_000, 10_000
ID_SUBSET_IDENTITIES = 10_000   # 100,000 gallery images for the CMC check
ID_SUBSET_PROBES = 2560
ID_DIM = 512
# the periodic-eval runs: resnet18 ArcFace, b512, 2 epochs of 4 steps
PERIODIC_CLASSES, PERIODIC_PER_CLASS = 256, 8


def timed_fn_img_per_s(fn, images, calls=10):
    """img/s of an artifact's fn (host uint8 in, host fp32 out) over
    `calls` calls after 2 warm-up calls, host clock."""
    for _ in range(2):
        fn(images)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(images)
    return calls * len(images) / (time.perf_counter() - t0)


def move_bn_statistics(model, seed=4):
    """Seeded BatchNorm statistics away from their initial ones (scale
    0.8-1.2, shift and mean -0.1-0.1, variance 0.5-1.5), as a trained
    model's are, in place: with the initial ones (scale 1, shift 0, mean 0,
    variance 1) a fold is the identity and a wrong fold goes unseen. The
    same seed gives the same statistics in any model of one backbone."""
    import torch

    from face_recognition_models_tpu_torch.models.resnet import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.running_mean.numel()
                for t, lo, width in ((mod.weight, 0.8, 0.4),
                                     (mod.bias, -0.1, 0.2),
                                     (mod.running_mean, -0.1, 0.2),
                                     (mod.running_var, 0.5, 1.0)):
                    t.copy_(torch.rand(n, generator=gen) * width + lo)
    return model


def row_agreement(got, want):
    """`got` against `want` ([N, D] host arrays) row by row: the least
    cosine and the largest error relative to the row's norm."""
    norm = np.linalg.norm(want, axis=1)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * norm)
    rel = np.linalg.norm(got - want, axis=1) / norm
    return {"min_cosine": float(cos.min()), "max_rel_err": float(rel.max())}


def fold_agreement(got, want):
    """The folded embeddings against the unfolded ones, row by row: the
    least cosine and the largest error relative to the row's norm
    (folding moves where the bf16 rounding happens, so the check is on
    each embedding, not on each of its 512 values), and, as readings, the
    elementwise error and its excess over rtol = atol TOL_FOLDED."""
    diff = got - want
    out = {**row_agreement(got, want),
           "max_abs_err": float(np.abs(diff).max()),
           "max_abs_of_unfolded": float(np.abs(want).max()),
           "max_excess_over_elementwise_2e-2": float(
               (np.abs(diff) - TOL_FOLDED * (1 + np.abs(want))).max())}
    out["within"] = bool(out["min_cosine"] >= MIN_FOLDED_COSINE
                         and out["max_rel_err"] <= TOL_FOLDED)
    return out


def wrong_folds(model, images, want):
    """The fold check's negative controls: folds of `model` (eager, bf16
    convs) with one term wrong, each of which fold_agreement must refuse
    against the unfolded embeddings `want`: the running mean dropped, the
    running mean negated, the BatchNorm scale left out, the variance left
    out."""
    import torch

    from face_recognition_models_tpu_torch.models.folding import (
        fold_resnet_bn)
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    def mean_dropped(k, v):
        return torch.zeros_like(v) if k.endswith("running_mean") else v

    def mean_negated(k, v):
        return -v if k.endswith("running_mean") else v

    def var_dropped(k, v):
        return torch.ones_like(v) if k.endswith("running_var") else v

    bn = {k.rsplit(".", 1)[0] for k in model.state_dict()
          if k.endswith("running_mean")}

    def scale_dropped(k, v):
        return (torch.ones_like(v) if k.rsplit(".", 1)[0] in bn
                and k.endswith(".weight") else v)

    out = {}
    for name, change in (("mean_dropped", mean_dropped),
                         ("mean_negated", mean_negated),
                         ("scale_dropped", scale_dropped),
                         ("variance_dropped", var_dropped)):
        state = {k: change(k, v) for k, v in model.state_dict().items()}
        folded = model.clone(folded=True)
        folded.load_state_dict(fold_resnet_bn(state))
        folded = folded.to(images.device, memory_format=torch.channels_last)
        got = make_eval_step(folded, device=images.device)(
            images).cpu().numpy()
        out[name] = fold_agreement(got, want)
        if out[name]["within"]:
            raise AssertionError(f"serve: a fold with the {name} passes "
                                 f"the fold check: {out[name]}")
        del folded
    return out


def serve_export(root, bench_embed_img_per_s):
    """A seeded ResNet-50 with moved BatchNorm statistics saved with
    save_final, exported by the `export` CLI unfolded and with --fold-bn
    (fp32 BatchNorm: the CLI builds the backbone as the JAX package's
    does), and by export_embedder with bf16 BatchNorm (the serving
    default); each artifact against the live eval step of the same module
    at b512, timed; wrong folds refused by the fold check. Returns the bf16
    artifact's path and the checkpoint dir."""
    import torch

    from face_recognition_models_tpu_torch.checkpoint import CheckpointManager
    from face_recognition_models_tpu_torch.cli.main import main as cli_main
    from face_recognition_models_tpu_torch.scripts import bench_embed
    from face_recognition_models_tpu_torch.serving.export import (
        export_embedder, load_embedder)
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    cuda = torch.device("cuda")
    models = {bn: move_bn_statistics(
        bench_embed.build_model("resnet50", bn, 0, cuda))
        for bn in ("float32", "bfloat16")}
    ckpt = os.path.join(root, "serve", "arcface")
    CheckpointManager(ckpt, "arcface").save_final(
        models["float32"].state_dict())
    images = bench_embed.make_batches(1, N_MAIN, 112, 1, cuda)[0]
    host = images.cpu().numpy()
    want = {bn: make_eval_step(m, device=cuda)(images).cpu().numpy()
            for bn, m in models.items()}
    out, paths = {}, {}
    for name in ("unfolded", "folded", "unfolded_bf16_bn"):
        path = paths[name] = os.path.join(root, name + ".frte")
        t0 = time.perf_counter()
        if name == "unfolded_bf16_bn":
            export_embedder(models["bfloat16"],
                            models["bfloat16"].state_dict(), path,
                            meta={"backbone": "resnet50"})
        else:
            rc = cli_main(["export", "--checkpoint-dir", ckpt, "--backbone",
                           "resnet50", "--output", path]
                          + (["--fold-bn"] if name == "folded" else []))
            if rc != 0:
                raise AssertionError(f"serve: export {name} rc {rc}")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = load_embedder(path)
        load_s = time.perf_counter() - t0
        got = art.fn(host)
        ref = want["bfloat16" if name.endswith("bf16_bn") else "float32"]
        if name == "folded":
            check = fold_agreement(got, ref)
            ok = check["within"]
            limit = {"min_cosine": MIN_FOLDED_COSINE,
                     "max_rel_err": TOL_FOLDED}
        else:
            err = float(np.abs(got - ref).max())
            check = {"max_abs_err_vs_live": err,
                     "bitwise_vs_live": bool(np.array_equal(got, ref))}
            ok = np.allclose(got, ref, rtol=TOL_ARTIFACT, atol=TOL_ARTIFACT)
            limit = {"rtol": TOL_ARTIFACT, "atol": TOL_ARTIFACT}
        if (art.meta["bn_folded"] != (name == "folded") or not ok
                or not all(art.fn(host[:b]).shape == (b, 512)
                           for b in (1, 3, 8))):
            raise AssertionError(f"serve: artifact {name} vs the live eval "
                                 f"step: {check} (limit {limit})")
        out[name] = {"export_s": export_s, "load_s": load_s,
                     "bytes": os.path.getsize(path), **check,
                     "limit": limit,
                     "b512_img_per_s": timed_fn_img_per_s(art.fn, host)}
        del art
    emit({"phase": "serve", "part": "export", "backbone": "resnet50",
          "embed_dim": 512, "batch": N_MAIN,
          "bn_statistics": "moved (move_bn_statistics)", "artifacts": out,
          "bench_embed_img_per_s": bench_embed_img_per_s,
          "wrong_folds_refused": wrong_folds(models["float32"], images,
                                             want["float32"]),
          "timer": "host clock around fn (numpy uint8 in, numpy fp32 out)",
          "ok": True})
    return paths["unfolded_bf16_bn"], ckpt


def _png(arr):
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _listen_counters():
    """The kernel's TcpExt counters of connections a listening socket
    refused or dropped (its accept queue full), from /proc/net/netstat
    (read only); a string saying why where they cannot be read."""
    keys = ("ListenOverflows", "ListenDrops", "TCPReqQFullDrop",
            "SyncookiesSent")
    try:
        with open("/proc/net/netstat") as f:
            lines = f.read().splitlines()
    except OSError as e:
        return f"not readable: {type(e).__name__}: {e}"
    for names, values in zip(lines[::2], lines[1::2]):
        if names.startswith("TcpExt:"):
            got = dict(zip(names.split()[1:], map(int, values.split()[1:])))
            return {k: got.get(k) for k in keys}
    return f"no TcpExt line among {len(lines)} lines"


def _http_status(method, url, data=None, headers=()):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def _chunked_status(url):
    import socket
    host, port = url.replace("http://", "").split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /embed HTTP/1.1\r\nHost: smoke\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n4\r\nabcd\r\n0\r\n\r\n")
        head = s.recv(4096).decode("utf-8", "replace")
    return int(head.split()[1])


def _clients(url, bodies, route, keep_alive):
    """SERVE_CLIENTS threads, each sending its SERVE_REQUESTS bodies to
    `route` one after another: on a new connection per request
    (`Connection: close`, as urllib sends) or on one kept-alive connection
    per thread. A request whose connection the server resets is sent again
    on a new connection, at most SERVE_RETRIES times, and counted. Returns
    (responses, latencies s, connect s, resets, wall s); a request's
    latency runs from its first connect (timed apart) to its response."""
    import http.client
    import threading

    host, port = url.replace("http://", "").split(":")
    n = len(bodies)
    responses, latency, connect = [None] * n, [0.0] * n, [0.0] * n
    resets = {}
    errors = []
    headers = {"Content-Type": "application/octet-stream"}
    if not keep_alive:
        headers["Connection"] = "close"

    def client(t):
        conn = None
        try:
            for i in range(t * SERVE_REQUESTS, (t + 1) * SERVE_REQUESTS):
                t0 = time.perf_counter()
                for attempt in range(SERVE_RETRIES + 1):
                    stage = "connect"
                    try:
                        if conn is None:
                            conn = http.client.HTTPConnection(
                                host, int(port), timeout=60)
                            conn.connect()
                        if attempt == 0:
                            connect[i] = time.perf_counter() - t0
                        stage = "request"
                        conn.request("POST", route, body=bodies[i],
                                     headers=headers)
                        stage = "response"
                        resp = conn.getresponse()
                        data = resp.read()
                        break
                    except (ConnectionResetError, BrokenPipeError,
                            http.client.RemoteDisconnected) as e:
                        conn.close()
                        conn = None
                        key = f"{stage}: {type(e).__name__}"
                        resets[key] = resets.get(key, 0) + 1
                        if attempt == SERVE_RETRIES:
                            raise
                latency[i] = time.perf_counter() - t0
                if resp.status != 200:
                    raise AssertionError(f"{route}: HTTP {resp.status}")
                responses[i] = json.loads(data)
                if not keep_alive or resp.will_close:
                    conn.close()
                    conn = None
        except Exception as e:  # reported below, after every join
            errors.append(e)
        finally:
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: clients of {route} failed: {errors} "
                             f"(resets {resets})")
    return responses, latency, connect, resets, wall


def _client_main(url, route, keep_alive, bodies_path, out_path):
    """The clients' process: _clients over the pickled bodies (written by
    this script), the result as JSON at out_path."""
    with open(bodies_path, "rb") as f:
        bodies = pickle.load(f)
    responses, latency, connect, resets, wall = _clients(
        url, bodies, route, keep_alive)
    with open(out_path, "w") as f:
        json.dump({"responses": responses, "latency": latency,
                   "connect": connect, "resets_resent": resets,
                   "wall": wall}, f)


def _remote_clients(url, route, keep_alive, bodies_path, root):
    """_clients in a process of its own (spawned), as traffic arrives at a
    server: the clients' threads do not share the server's interpreter
    lock. Returns (responses, the window's latency summary), the summary
    with the listen counters' rise over the window."""
    import multiprocessing

    out = os.path.join(root, "clients.json")
    before = _listen_counters()
    proc = multiprocessing.get_context("spawn").Process(
        target=_client_main,
        args=(url, route, keep_alive, bodies_path, out))
    proc.start()
    proc.join(timeout=900)
    if proc.is_alive():
        proc.kill()
        proc.join()
        raise AssertionError(f"serve: the clients of {route} timed out")
    if proc.exitcode != 0:
        raise AssertionError(f"serve: the clients of {route} exited "
                             f"{proc.exitcode}")
    after = _listen_counters()
    with open(out) as f:
        got = json.load(f)
    summary = _latency(got["latency"], got["wall"])
    connect_ms = np.asarray(got["connect"]) * 1e3
    summary.update({
        "connect_p50_ms": float(np.percentile(connect_ms, 50)),
        "connect_p99_ms": float(np.percentile(connect_ms, 99)),
        "connect_max_ms": float(connect_ms.max()),
        "connects_over_500_ms": int((connect_ms > 500).sum()),
        "resets_resent": got["resets_resent"],
        **{f"request_after_connect_p{q}_ms": float(np.percentile(
            (np.asarray(got["latency"]) - np.asarray(got["connect"]))
            * 1e3, q)) for q in (50, 99)},
        "connects_by_whole_seconds": {
            str(k): int(v) for k, v in zip(*np.unique(
                np.rint(connect_ms[connect_ms > 500] / 1e3).astype(int),
                return_counts=True))},
        "slowest_client_s": max(
            sum(got["latency"][t * SERVE_REQUESTS:(t + 1) * SERVE_REQUESTS])
            for t in range(SERVE_CLIENTS)),
        "listen_counters_rise": after if not isinstance(after, dict)
        or not isinstance(before, dict)
        else {k: (None if after[k] is None or before[k] is None
                  else after[k] - before[k]) for k in after}})
    return got["responses"], summary


class _TimedFn:
    """An embed_fn that records each call's host seconds (the batch's
    time inside the service: the copy in, the program, the copy out)."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, []

    def __call__(self, images):
        t0 = time.perf_counter()
        out = self.fn(images)
        self.seconds.append(time.perf_counter() - t0)
        return out


def _fn_ms(fn, images, calls=20):
    """Median host ms of fn(images) alone, after 2 warm-up calls."""
    seconds = []
    for i in range(calls + 2):
        t0 = time.perf_counter()
        fn(images)
        seconds.append(time.perf_counter() - t0)
    return float(np.median(seconds[2:])) * 1e3


def _latency(lat, wall):
    ms = np.asarray(lat) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()),
            "requests_per_s": len(lat) / wall}


def serve_http(root, artifact):
    """EmbedService on the bf16-BatchNorm artifact with a gallery of the
    artifact's embeddings, on 127.0.0.1 in a thread; SERVE_CLIENTS x
    SERVE_REQUESTS PNG requests to /embed and to /identify?top_k=5 at each
    micro-batch size, on a new connection per request and on kept-alive
    connections; the error routes; `embed` over a PNG tree. PIL decodes
    both (as in the JAX package), so the phase fails without it."""
    import threading

    import torch

    from face_recognition_models_tpu_torch.cli.main import main as cli_main
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)
    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.serving.export import load_embedder
    from face_recognition_models_tpu_torch.serving.server import (
        EmbedService, make_server)

    try:
        from PIL import Image
    except ImportError as e:
        raise AssertionError("serve: `embed` and the service's decode need "
                             "PIL, which does not import here") from e
    art = load_embedder(artifact)
    images, _ = synthetic_identities(SERVE_IDENTITIES, 3, image_size=112,
                                     seed=3)
    images = images.reshape(SERVE_IDENTITIES, 3, 112, 112, 3)
    gallery = images[:, :2].reshape(-1, 112, 112, 3)
    emb = np.concatenate([art.fn(gallery[i:i + N_MAIN])
                          for i in range(0, len(gallery), N_MAIN)])
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    gallery_npz = os.path.join(root, "gallery.npz")
    np.savez(gallery_npz, embeddings=emb,
             paths=np.asarray([f"id{i // 2:04d}/{i % 2}.png"
                               for i in range(len(gallery))]))
    n = SERVE_CLIENTS * SERVE_REQUESTS
    ids = np.random.RandomState(5).choice(SERVE_IDENTITIES, n,
                                          replace=False)
    probes = images[ids, 2]
    bodies = [_png(im) for im in probes]
    bodies_path = os.path.join(root, "bodies.pkl")
    with open(bodies_path, "wb") as f:
        pickle.dump(bodies, f)
    direct = art.fn(probes)
    direct /= np.linalg.norm(direct, axis=1, keepdims=True)
    fh.reset_launch_counts()
    conv3x3.reset_launch_counts()
    results = {}
    for mb in SERVE_MICRO_BATCHES:
        alone_ms = _fn_ms(art.fn, probes[:mb])
        timed = _TimedFn(art.fn)
        service = EmbedService(timed, 112, batch_size=mb,
                               max_wait_ms=SERVE_WAIT_MS,
                               gallery_path=gallery_npz)
        server = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        windows = {}
        try:
            code, health = _http_status("GET", url + "/healthz")
            statuses = {
                "healthz": code,
                "get_404": _http_status("GET", url + "/nope")[0],
                "post_404": _http_status("POST", url + "/nope", b"x")[0],
                "detect_409": _http_status("POST", url + "/detect",
                                           bodies[0])[0],
                "chunked_411": _chunked_status(url)}
            if (statuses != {"healthz": 200, "get_404": 404,
                             "post_404": 404, "detect_409": 409,
                             "chunked_411": 411}
                    or health["embed_dim"] != 512
                    or health["gallery_size"] != len(gallery)):
                raise AssertionError(f"serve: {statuses}, {health}")
            for conn in ("new_connection", "keep_alive"):
                keep = conn == "keep_alive"
                got, lat_e = _remote_clients(url, "/embed", keep,
                                             bodies_path, root)
                http = np.asarray([r["embedding"] for r in got], np.float32)
                err = float(np.abs(http - direct).max())
                if not err <= TOL_HTTP:
                    raise AssertionError(f"serve: HTTP embeddings vs direct "
                                         f"{err} (tol {TOL_HTTP})")
                found, lat_i = _remote_clients(url, "/identify?top_k=5",
                                               keep, bodies_path, root)
                top1 = float(np.mean([r["matches"][0]["path"].split("/")[0]
                                      == f"id{i:04d}"
                                      for r, i in zip(found, ids)]))
                if not (top1 >= MIN_TOP1
                        and all(len(r["matches"]) == 5 for r in found)):
                    raise AssertionError(f"serve: top-1 {top1} < {MIN_TOP1}")
                windows[conn] = {"embed": lat_e, "identify": lat_i,
                                 "max_abs_err_vs_direct": err, "top1": top1}
            stats = service.batcher.stats()
        finally:
            server.shutdown()
            server.server_close()
            service.close()
        results[f"micro_batch_{mb}"] = {
            **windows,
            "batches": stats["batches"], "images": stats["images"],
            "max_coalesced": stats["max_coalesced"],
            "fn_ms_alone": alone_ms,
            "fn_ms_in_service": {
                "p50": float(np.percentile(timed.seconds[1:], 50)) * 1e3,
                "p99": float(np.percentile(timed.seconds[1:], 99)) * 1e3},
            "statuses": statuses}
    launched = {k: v for k, v in {**fh.launch_counts,
                                  **conv3x3.launch_counts}.items() if v}
    if launched:
        raise AssertionError(f"serve: the serving path launched {launched}")
    tree = os.path.join(root, "tree")
    for i in range(64):
        os.makedirs(os.path.join(tree, f"id{i // 2:04d}"), exist_ok=True)
        Image.fromarray(gallery[i]).save(
            os.path.join(tree, f"id{i // 2:04d}", f"{i % 2}.png"))
    out_npz = os.path.join(root, "embedded.npz")
    if cli_main(["embed", "--input", tree, "--output", out_npz,
                 "--model", artifact, "--batch-size", "16"]) != 0:
        raise AssertionError("serve: embed CLI failed")
    e_err = float(np.abs(np.load(out_npz)["embeddings"] - emb[:64]).max())
    if not e_err <= TOL_HTTP:
        raise AssertionError(f"serve: embed CLI vs direct {e_err}")
    emit({"phase": "serve", "part": "http", "clients": SERVE_CLIENTS,
          "requests_per_client": SERVE_REQUESTS,
          "gallery_images": len(gallery), "wait_ms": SERVE_WAIT_MS,
          "decoder": "PIL (PNG bodies)", "tolerance": TOL_HTTP,
          "listen_counters": "TcpExt rise over each client window, "
                             "/proc/net/netstat of the host's network",
          "kernel_launches": launched, **results,
          "embed_cli": {"images": 64, "max_abs_err_vs_direct": e_err},
          "ok": True})
    del art
    torch.cuda.empty_cache()


def identify_chunk_ms(gallery, ids, probes, calls=5):
    """CUDA-event ms of one chunk's two device steps, each over `calls`
    back-to-back calls: the [256, D] x [D, G] fp32 product (TF32 off) and
    the per-identity scatter_reduce amax of its scores; and the product's
    max abs error against a float64 product of the first 8 rows."""
    import torch

    from face_recognition_models_tpu_torch.evaluation.openset import (
        _true_fp32_matmul)

    uniq = np.unique(ids)
    index = torch.from_numpy(np.searchsorted(uniq, ids)).cuda().expand(
        256, -1)
    gal = torch.from_numpy(gallery).cuda()
    block = torch.from_numpy(probes[:256]).cuda()
    pooled = torch.empty((256, len(uniq)), device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with _true_fp32_matmul():
        out = block @ gal.T
        pooled.fill_(float("-inf")).scatter_reduce_(1, index, out, "amax")
        events[0].record()
        for _ in range(calls):
            out = block @ gal.T
        events[1].record()
        for _ in range(calls):
            pooled.fill_(float("-inf")).scatter_reduce_(1, index, out,
                                                        "amax")
        events[2].record()
        events[2].synchronize()
    want = block[:8].double() @ gal.T.double()
    err = float((out[:8].double() - want).abs().max())
    del gal, out, pooled, index
    torch.cuda.empty_cache()
    return {"product_ms": events[0].elapsed_time(events[1]) / calls,
            "fill_and_scatter_amax_ms":
                events[1].elapsed_time(events[2]) / calls,
            "product_max_abs_err_vs_float64": err,
            "tf32": torch.backends.cuda.matmul.allow_tf32}


def serve_identify():
    """pooled_scores_device on a seeded ID_GALLERY x ID_DIM unit-norm
    gallery over ID_IDENTITIES identities and ID_PROBES probes, timed;
    its first 256 probes against the host path; closed-set CMC scored on
    the card and on the CPU over a 100,000-image subset."""
    import torch

    from face_recognition_models_tpu_torch.evaluation import openset

    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(6)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    protos = torch.randn(ID_IDENTITIES, ID_DIM, generator=g, device=cuda)
    ids = (torch.arange(ID_GALLERY, device=cuda) % ID_IDENTITIES)[
        torch.randperm(ID_GALLERY, generator=g, device=cuda)]
    gallery = unit(protos[ids] + 0.5 * torch.randn(
        ID_GALLERY, ID_DIM, generator=g, device=cuda)).cpu().numpy()
    probe_ids = torch.randint(0, ID_IDENTITIES, (ID_PROBES,), generator=g,
                              device=cuda)
    probes = unit(protos[probe_ids] + 0.5 * torch.randn(
        ID_PROBES, ID_DIM, generator=g, device=cuda)).cpu().numpy()
    ids, probe_ids = ids.cpu().numpy(), probe_ids.cpu().numpy()
    del protos
    torch.cuda.empty_cache()
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pooled, uniq = openset.pooled_scores_device(gallery, ids, probes)
        seconds.append(time.perf_counter() - t0)
    chunk_ms = identify_chunk_ms(gallery, ids, probes)
    host, host_uniq = openset._best_per_identity(probes[:256] @ gallery.T,
                                                 ids)
    err = float(np.abs(pooled[:256] - host).max())
    if not (np.array_equal(uniq, host_uniq) and err <= TOL_POOLED
            and pooled.shape == (ID_PROBES, ID_IDENTITIES)):
        raise AssertionError(f"serve: pooled scores vs host {err}")
    keep = ids < ID_SUBSET_IDENTITIES
    sub = probe_ids < ID_SUBSET_IDENTITIES
    sub_probes = probes[sub][:ID_SUBSET_PROBES]
    sub_ids = probe_ids[sub][:ID_SUBSET_PROBES]
    cmc = {dev: openset.closed_set_identification(
        gallery[keep], ids[keep], sub_probes, sub_ids, ranks=(1, 5),
        device=dev).cmc for dev in ("cuda", "cpu")}
    if cmc["cuda"] != cmc["cpu"]:
        raise AssertionError(f"serve: CMC card {cmc['cuda']} vs CPU "
                             f"{cmc['cpu']}")
    flops = 2.0 * ID_PROBES * ID_GALLERY * ID_DIM
    emit({"phase": "serve", "part": "identify", "gallery": ID_GALLERY,
          "identities": ID_IDENTITIES, "probes": ID_PROBES, "dim": ID_DIM,
          "chunk": 256, "seconds": seconds,
          "probes_per_s": ID_PROBES / min(seconds),
          "bound_ms": flops / PEAK_FP32_FLOPS * 1e3, "bound_by": "operations",
          "chunk_device_ms_by_events": chunk_ms,
          "max_abs_err_first_256_vs_host": err, "tolerance": TOL_POOLED,
          "subset_images": int(keep.sum()), "subset_probes": len(sub_ids),
          "cmc_card": cmc["cuda"], "cmc_cpu": cmc["cpu"],
          "timer": "host clock around pooled_scores_device (host arrays "
                   "in and out)", "ok": True})


def serve_periodic(root):
    """`train --eval-every 1` (resnet18 ArcFace, b512, 2 epochs) against a
    synthetic LFW-size .bin, then `eval --which best_acc`; and fit with
    scan_steps=4 and the hook against the same run without it, bit for
    bit."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.cli.main import main as cli_main
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)
    from face_recognition_models_tpu_torch.evaluation import batch_eval
    from face_recognition_models_tpu_torch.evaluation.periodic import (
        PeriodicEvalHook)
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.state import (
        state_tensors as all_state_tensors)

    bench_dir = os.path.join(root, "benchmarks")
    os.makedirs(bench_dir)
    synthetic_benchmark(os.path.join(bench_dir, "synth_lfw.bin"))
    work = os.path.join(root, "periodic")
    t0 = time.perf_counter()
    rc = cli_main(["train", "--synthetic", "--synthetic-classes",
                   str(PERIODIC_CLASSES), "--synthetic-per-class",
                   str(PERIODIC_PER_CLASS), "--batch_size", str(N_MAIN),
                   "--epochs", "2", "--print_freq", "100",
                   "--working-path", work, "--eval-every", "1",
                   "--eval-data-path", bench_dir, "--benchmarks",
                   "synth_lfw"])
    train_s = time.perf_counter() - t0
    ckpt = os.path.join(work, "checkpoints")
    best = os.path.join(ckpt, "arcface", "arcface_best_acc")
    if rc != 0 or not os.path.isfile(best):
        raise AssertionError(f"serve: train --eval-every rc {rc}, "
                             f"best_acc written {os.path.isfile(best)}")
    with recorded(batch_eval, "evaluate_model_on_benchmark") as calls:
        rc = cli_main(["eval", "--checkpoint-dir", ckpt, "--eval-data-path",
                       bench_dir, "--benchmarks", "synth_lfw", "--which",
                       "best_acc", "--output-dir",
                       os.path.join(root, "eval_best_acc")])
    if rc != 0 or len(calls) != 1:
        raise AssertionError(f"serve: eval --which best_acc rc {rc}")

    images, labels = synthetic_identities(PERIODIC_CLASSES,
                                          PERIODIC_PER_CLASS, seed=0)
    cfg = cfg_lib.TrainConfig(head="arcface", num_classes=PERIODIC_CLASSES,
                              batch_size=N_MAIN, epochs=2, print_freq=100,
                              seed=0, scan_steps=4)
    runs = {}
    for name in ("plain", "hooked"):
        hook = None
        if name == "hooked":
            hook = PeriodicEvalHook(get_backbone("resnet18"), bench_dir,
                                    ["synth_lfw"], every=1,
                                    total_epochs=cfg.epochs, verbose=False,
                                    device="cuda")
        res = fit(cfg, ArrayLoader(images, labels, batch_size=N_MAIN,
                                   seed=0), device="cuda", hooks=hook)
        torch.cuda.synchronize()
        runs[name] = (res, hook)
    (plain, _), (hooked, hook) = runs["plain"], runs["hooked"]
    same = (hooked.losses == plain.losses and all(
        torch.equal(x, y) for x, y in zip(all_state_tensors(hooked.state),
                                          all_state_tensors(plain.state),
                                          strict=True)))
    chunks = cfg.epochs * (len(images) // N_MAIN // cfg.scan_steps)
    if not (hooked.replays == plain.replays == chunks
            and [e for e, _ in hook.history] == [1, 2]):
        raise AssertionError(f"serve: replays {hooked.replays} and "
                             f"{plain.replays} (want {chunks}), hook "
                             f"epochs {[e for e, _ in hook.history]}")
    if not same:
        raise AssertionError("serve: graphed fit with the hook differs "
                             "from fit without it")
    emit({"phase": "serve", "part": "periodic", "backbone": "resnet18",
          "head": "arcface", "batch": N_MAIN, "epochs": 2,
          "benchmark": "synth_lfw.bin (as the eval phase's)",
          "train_eval_every_s": train_s,
          "best_acc": calls[0].mean_accuracy,
          "hook_accuracy_by_epoch": [r["synth_lfw"].mean_accuracy
                                     for _, r in hook.history],
          "scan_steps": 4, "replays": hooked.replays,
          "graphed_with_hook_bitwise": True, "losses": hooked.losses,
          "ok": True})


def phase_serve(root, bench_embed_img_per_s):
    """Serving at full width: export, the HTTP service, identification at a
    million images, and periodic evaluation (see the module docstring).
    Returns the bf16 artifact's path (the detect phase serves it)."""
    import torch

    artifact, _ = serve_export(root, bench_embed_img_per_s)
    torch.cuda.empty_cache()
    serve_http(root, artifact)
    serve_identify()
    torch.cuda.empty_cache()
    serve_periodic(root)
    return artifact


# the detect phase: the MTCNN cascade (detection/) at its published widths
# and thresholds (0.5, 0.7, 0.7), built as `preprocess` and `serve --align`
# build it (data/preprocess.build_detector), with seeded random weights
# saved as facenet_pytorch-layout .pt files, so the loading path runs.
# Plain random weights put every P-Net probability near 0.5, where the last
# bits of the card's and the CPU's sums could flip a threshold, let half the
# windows through P-Net, reject every candidate at R-Net and throw the boxes
# far with their regressions. So the face-probability layers' weights are
# scaled by DETECT_CLS_SCALE, the box-regression layers' by
# DETECT_REG_SCALE, and the face logit of P-Net and R-Net moved by
# DETECT_FACE_BIAS: about 1% of the windows pass P-Net, a fifth of those
# R-Net, and faces come out of every photo (17 and 54 on the CPU).
DETECT_IMAGES = (("casia_raw_250x250", (250, 250), 2),   # (label, shape,
                 ("photo_640x480", (480, 640), 1))       # image seed)
DETECT_CLS_SCALE, DETECT_REG_SCALE = 8.0, 0.1
DETECT_FACE_BIAS = {"conv4_1": -0.94, "dense5_1": 1.45}
DETECT_TIMED = 3        # timed detects an image, after one warm-up
DETECT_REQUESTS = 10    # /detect and aligned /embed requests, kept alive
DETECT_TREE = (2, 2)    # preprocess: identities x 250 x 250 photos
# a net on the card against the same net on the CPU (TF32 off): max abs;
# detect on the card against the CPU: boxes and landmarks, probs
TOL_DETECT_NET, TOL_DETECT_BOX, TOL_DETECT_PROB = 1e-5, 1e-3, 1e-5


def detector_weights(directory):
    """The detect phase's seeded weights (see DETECT_CLS_SCALE) as
    pnet.pt / rnet.pt / onet.pt in `directory`: numpy draws (the same on
    any torch; torch's own initialisers draw differently from one version
    to the next), lecun-normal conv and dense weights, zero biases, PReLU
    0.25."""
    import torch

    from face_recognition_models_tpu_torch.detection.mtcnn import NETS

    rs = np.random.RandomState(0)
    scale = {"conv4_1": DETECT_CLS_SCALE, "dense5_1": DETECT_CLS_SCALE,
             "dense6_1": DETECT_CLS_SCALE, "conv4_2": DETECT_REG_SCALE,
             "dense5_2": DETECT_REG_SCALE, "dense6_2": DETECT_REG_SCALE}
    os.makedirs(directory, exist_ok=True)
    for net, module in NETS.items():
        sd = module().state_dict()
        for key, t in sd.items():
            layer, kind = key.split(".")
            if layer.startswith("prelu"):
                value = np.full(t.shape, 0.25)
            elif kind == "bias":
                value = np.zeros(t.shape)
                if layer in DETECT_FACE_BIAS:   # (no face, face) logits
                    b = DETECT_FACE_BIAS[layer]
                    value[:] = (-b, b)
            else:
                fan_in = int(np.prod(t.shape[1:]))
                value = (rs.standard_normal(t.shape) / np.sqrt(fan_in)
                         * scale.get(layer, 1.0))
            sd[key] = torch.from_numpy(value.astype(np.float32))
        torch.save(sd, os.path.join(directory, f"{net}.pt"))
    return directory


def detect_nets(card, cpu):
    """Each net of the `card` detector against the same net of the `cpu`
    one on seeded inputs at the shapes detect gives them (P-Net at the
    640 x 480 photo's first pyramid scale, R-Net and O-Net at crop batches
    of 256 and 64), TF32 off on the card."""
    import torch

    gen = torch.Generator().manual_seed(1)
    shapes = {"pnet": (1, 3, 288, 384), "rnet": (256, 3, 24, 24),
              "onet": (64, 3, 48, 48)}
    out = {}
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        for name, shape in shapes.items():
            x = torch.randn(shape, generator=gen)
            want = getattr(cpu, name)(x)
            got = getattr(card, name)(x.cuda())
            err = max(float((g.cpu() - w).abs().max())
                      for g, w in zip(got, want))
            if not err <= TOL_DETECT_NET:
                raise AssertionError(f"detect: {name} on the card vs the CPU:"
                                     f" max abs err {err} > {TOL_DETECT_NET}")
            out[name] = {"input": list(shape), "max_abs_err": err}
    return out


def instrument_detector(det):
    """Record CUDA events around `det`'s device stages (the pyramid with
    P-Net, and each R-Net / O-Net batch, their copies to and from the card
    included); returns the list of (stage, batch, start, end) they go to."""
    import torch

    log = []
    for name in ("_pnet_maps", "_run"):
        fn = getattr(det, name)

        def timed(*args, fn=fn, name=name):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            stage = ("pyramid+pnet" if name == "_pnet_maps"
                     else type(args[0]).__name__.lower())
            log.append((stage, len(args[1]), start, end))
            return out

        setattr(det, name, timed)
    return log


def timed_detects(det, log, img):
    """(result of det.detect(img), numbers): ms per detect (host clock,
    median of DETECT_TIMED after a warm-up), the card's share (the device
    stages' CUDA events) and the host's (the rest: box generation, NMS,
    crops), the box counts at each stage."""
    import torch

    det.detect(img)
    total, card = [], []
    for _ in range(DETECT_TIMED):
        log.clear()
        t0 = time.perf_counter()
        result = det.detect(img)
        total.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        card.append(sum(s.elapsed_time(e) for _, _, s, e in log))
    batches = {stage: n for stage, n, _, _ in log}
    return result, {
        "ms_per_detect": float(np.median(total)),
        "card_ms": float(np.median(card)),
        "host_ms": float(np.median(np.subtract(total, card))),
        "all_ms": total, "scales": batches["pyramid+pnet"],
        "boxes": {"pnet_candidates": batches.get("rnet", 0),
                  "rnet_kept": batches.get("onet", 0),
                  "out": len(result[0])}}


def same_detections(label, got, want):
    """Raise unless two detect results have the same box count and boxes,
    landmarks within TOL_DETECT_BOX and probs within TOL_DETECT_PROB."""
    counts = [len(r[0]) for r in (got, want)]
    errs = {}
    if counts[0] == counts[1] and counts[0]:
        errs = {k: float(np.abs(np.asarray(g) - np.asarray(w)).max())
                for k, g, w in zip(("boxes", "probs", "landmarks"), got,
                                   want)}
    if (counts[0] != counts[1] or not counts[0]
            or errs["boxes"] > TOL_DETECT_BOX
            or errs["landmarks"] > TOL_DETECT_BOX
            or errs["probs"] > TOL_DETECT_PROB):
        raise AssertionError(f"detect: {label} on the card vs the CPU: box "
                             f"counts {counts}, max abs errors {errs}")
    return {"boxes": counts[0], **{f"{k}_max_abs_err": v
                                   for k, v in errs.items()}}


def detect_preprocess(root, weights):
    """`preprocess` (crop mode) on the card over a tree of DETECT_TREE
    seeded 250 x 250 PNG photos: images/s, the counts; every output there,
    aligned ones 112 x 112, copied ones the source."""
    from PIL import Image

    from face_recognition_models_tpu_torch.data.preprocess import (
        preprocess_dataset)

    raw, out = os.path.join(root, "detect_raw"), os.path.join(root, "aligned")
    rs = np.random.RandomState(9)
    names = []
    for i in range(DETECT_TREE[0]):
        os.makedirs(os.path.join(raw, f"id_{i}"))
        for j in range(DETECT_TREE[1]):
            names.append(os.path.join(f"id_{i}", f"{j}.png"))
            Image.fromarray(rs.randint(0, 256, (250, 250, 3), np.uint8)).save(
                os.path.join(raw, names[-1]))
    t0 = time.perf_counter()
    stats = preprocess_dataset(raw, out, image_size=112,
                               mtcnn_weights=weights)
    seconds = time.perf_counter() - t0
    for name in names:
        with open(os.path.join(raw, name), "rb") as f:
            src = f.read()
        with open(os.path.join(out, name), "rb") as f:
            dst = f.read()
        with Image.open(os.path.join(out, name)) as im:
            size = im.size
        if dst != src and size != (112, 112):
            raise AssertionError(f"detect: preprocess wrote {name} at {size}")
    if stats["fallback"] or stats["aligned"] + stats["copied"] != len(names):
        raise AssertionError(f"detect: preprocess counts {stats}")
    return {"images": len(names), **stats, "seconds": seconds,
            "img_per_s": len(names) / seconds}


def detect_serve(artifact, det, photo):
    """An EmbedService with `det` in front of the bf16 ResNet-50 artifact
    on 127.0.0.1: DETECT_REQUESTS PNG requests to /detect and then to
    /embed on one kept-alive connection; /detect's boxes those of
    det.detect (2 decimals), /embed aligned and within TOL_HTTP of the
    artifact's embedding of det.extract; p50 / p99 ms of each route."""
    import http.client
    import threading

    from face_recognition_models_tpu_torch.serving.export import (
        load_embedder)
    from face_recognition_models_tpu_torch.serving.server import (
        EmbedService, make_server)

    art = load_embedder(artifact)
    service = EmbedService(art.fn, 112, batch_size=8,
                           max_wait_ms=SERVE_WAIT_MS, detector=det)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    body = _png(photo)
    boxes = det.detect(photo)[0]
    direct = art.fn(det.extract(photo)[None])[0]
    direct = direct / np.linalg.norm(direct)
    out = {}
    try:
        conn = http.client.HTTPConnection(host, port, timeout=120)
        for route in ("/detect", "/embed"):
            lat = []
            t_route = time.perf_counter()
            for _ in range(DETECT_REQUESTS):
                t0 = time.perf_counter()
                conn.request("POST", route, body=body,
                             headers={"Content-Type": "image/png"})
                resp = conn.getresponse()
                data = json.loads(resp.read())
                lat.append(time.perf_counter() - t0)
                if resp.status != 200:
                    raise AssertionError(f"detect: {route} {resp.status}: "
                                         f"{data}")
            out[route] = _latency(lat, time.perf_counter() - t_route)
            if route == "/detect":
                got = np.asarray(data["boxes"])
                if got.shape != boxes.shape or np.abs(
                        got - boxes).max() > 0.011:
                    raise AssertionError("detect: /detect's boxes are not "
                                         "det.detect's")
                out[route]["faces"] = len(got)
            else:
                err = float(np.abs(np.asarray(data["embedding"])
                                   - direct).max())
                if data.get("aligned") is not True or err > TOL_HTTP:
                    raise AssertionError(
                        f"detect: aligned /embed: aligned "
                        f"{data.get('aligned')}, max abs err {err} vs the "
                        f"artifact's embedding of the extracted face")
                out[route]["max_abs_err_vs_direct"] = err
        conn.close()
        health = service.health()
        if not health["align"]:
            raise AssertionError("detect: /healthz align is not true")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    return {"requests_per_route": DETECT_REQUESTS, "connection": "kept alive",
            "photo": list(photo.shape), "routes": out}


def detect_api():
    """api.ArcFaceNet('resnet50') on the card: one b64 batch's embed
    against the eval step (train/step.make_eval_step) on the same module."""
    import torch

    from face_recognition_models_tpu_torch import api
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    model = api.ArcFaceNet(num_classes=C_MAIN, backbone="resnet50")
    model.init(torch.Generator().manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randint(0, 256, (64, 112, 112, 3), generator=g,
                           dtype=torch.uint8, device="cuda")
    got = model.embed(images)
    want = make_eval_step(model.backbone, device="cuda")(images)
    err = float((got - want).abs().max())
    if got.shape != (64, 512) or not err <= 1e-6 * float(want.abs().max()):
        raise AssertionError(f"detect: api embed vs the eval step: shape "
                             f"{tuple(got.shape)}, max abs err {err}")
    return {"backbone": "resnet50", "num_classes": C_MAIN, "batch": 64,
            "max_abs_err": err, "bitwise": bool(torch.equal(got, want))}


def phase_detect(root, artifact=None):
    """The MTCNN cascade on the card (see DETECT_CLS_SCALE): its nets
    against the CPU's, `detect` on the card against the CPU on a 250 x 250
    and a 640 x 480 photo (timed, split into the card's and the host's
    share), `preprocess` over a small tree, an EmbedService with the
    detector in front of `artifact` (the serve phase's bf16 ResNet-50;
    with --only detect made here as that phase makes it) answering /detect
    and aligned /embed, and api.ArcFaceNet's embed. No kernel of the port
    launches."""
    import torch

    from face_recognition_models_tpu_torch.data.preprocess import (
        build_detector)
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi

    smi = nvidia_smi()
    reset_kernel_counts()
    weights = detector_weights(os.path.join(root, "mtcnn"))
    t0 = time.perf_counter()
    card = build_detector(112, weights, device="cuda")
    load_s = time.perf_counter() - t0
    cpu = build_detector(112, weights, device="cpu")
    emit({"phase": "detect", "part": "nets", "nvidia_smi": smi,
          "weights_load_s": load_s, "nets": detect_nets(card, cpu),
          "tolerance": TOL_DETECT_NET, "ok": True})
    log = instrument_detector(card)
    photos = {}
    for label, shape, seed in DETECT_IMAGES:
        photo = np.random.RandomState(seed).randint(0, 256, shape + (3,),
                                                    np.uint8)
        photos[label] = photo
        got, numbers = timed_detects(card, log, photo)
        check = same_detections(label, got, cpu.detect(photo))
        emit({"phase": "detect", "part": "detect", "image": label,
              "shape": list(shape), "thresholds": list(card.thresholds),
              "nvidia_smi": smi, **numbers, "vs_cpu": check,
              "tolerance": {"boxes_landmarks": TOL_DETECT_BOX,
                            "probs": TOL_DETECT_PROB},
              "timer": "host clock around detect; card share by CUDA "
                       "events around the device stages", "ok": True})
    emit({"phase": "detect", "part": "preprocess", "nvidia_smi": smi,
          **detect_preprocess(root, weights), "ok": True})
    if artifact is None:
        from face_recognition_models_tpu_torch.scripts import bench_embed
        from face_recognition_models_tpu_torch.serving.export import (
            export_embedder)
        model = move_bn_statistics(bench_embed.build_model(
            "resnet50", "bfloat16", 0, torch.device("cuda")))
        artifact = os.path.join(root, "detect_bf16.frte")
        export_embedder(model, model.state_dict(), artifact,
                        meta={"backbone": "resnet50"})
        del model
    emit({"phase": "detect", "part": "serve", "nvidia_smi": smi,
          **detect_serve(artifact, card, photos["casia_raw_250x250"]),
          "ok": True})
    emit({"phase": "detect", "part": "api", "nvidia_smi": smi,
          **detect_api(), "ok": True})
    no_kernel_launched("detect")


# the backbones phase: each trainable trunk of the registry beyond the
# ResNets, BACKBONE_STEPS full-width ArcFace steps (C = 10,575, b512, 112 px,
# bf16 convs, fp32 BatchNorm, SGD 0.1 / 0.9 / 5e-4, the fused head); then
# its eval-mode embedding at b512 timed, and BACKBONE_CHECK_IMAGES
# embedded on the card against the port's CPU forward of the same weights.
# inception_v3 gets the embedding checks and fit's refusal.
BACKBONE_TRUNKS = ("efficientnet_b0", "mobilenet_v2", "mobilefacenet",
                   "iresnet18", "iresnet50", "iresnet100", "vit_t", "vit_s",
                   "vit_b")
BACKBONE_STEPS = 3
BACKBONE_PROFILED = 3          # steps of the profiler's device split
BACKBONE_CHECK_IMAGES = 8
BACKBONE_TIMED_CALLS = 10      # b512 eval steps the embedding rate averages
# card against CPU, both fp32 with TF32 off (the CPU tests' bound against
# the flax modules): rtol 2e-3 with an atol of 2e-4 x the largest output
TOL_BACKBONE_RTOL, TOL_BACKBONE_ATOL_REL = 2e-3, 2e-4
# the timed module (bf16 convs and products, the trained weights) against
# the same CPU fp32 forward, row by row (bf16 rounding moves every value,
# so the check is on each embedding): the largest error relative to the
# row's norm and the least cosine. Each limit lies between the card's
# readings (H100, 700 W) of the sound forwards of the ten trunks, at most
# 0.0127 and at least 0.999919, and of the faulty ones that
# batch_statistics_in_eval makes, at least 0.329 and at most 0.980
TOL_BF16_ROW_REL, MIN_BF16_COSINE = 0.05, 0.999
# scan_steps=SCAN_K graphed against eager, bit for bit: efficientnet_b0
# (dropout and stochastic depth from the step generator) and vit_b (remat
# inside the graph), SCAN_STEPS steps each
BACKBONE_SCAN = ("efficientnet_b0", "vit_b")
# artifact against the live eval step: TOL_ARTIFACT; a batch over the
# first one's max_batch (BACKBONE_EXPORT_MAX) runs in slices
BACKBONE_EXPORT = ("iresnet50", "mobilefacenet", "vit_s")
BACKBONE_EXPORT_MAX, BACKBONE_EXPORT_ROWS = 64, 150


def forward_flops(module, size):
    """Multiply-add FLOPs (2 per MAC) of one image through `module`'s
    convolutions, Dense layers and attention products, from the shapes a
    forward of one image on the module's device gives them."""
    import torch

    from face_recognition_models_tpu_torch.models.vit import MHSA

    total = [0]

    def conv(mod, args, out):
        k = mod.weight[0].numel()        # (C_in / groups) x kh x kw
        total[0] += 2 * out.numel() * k

    def linear(mod, args, out):
        total[0] += 2 * out.numel() * mod.in_features

    def attention(mod, args, out):
        n, t, d = args[0].shape
        total[0] += 2 * 2 * n * t * t * d  # q k^T and probs v

    hooks = []
    for mod in module.modules():
        if isinstance(mod, torch.nn.Conv2d):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, torch.nn.Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, MHSA):
            hooks.append(mod.register_forward_hook(attention))
    device = next(module.parameters()).device
    module.eval()
    with torch.no_grad():
        module(torch.zeros((1, size, size, 3), device=device))
    for h in hooks:
        h.remove()
    return total[0]


def bf16_within(agreement):
    return (agreement["min_cosine"] >= MIN_BF16_COSINE
            and agreement["max_rel_err"] <= TOL_BF16_ROW_REL)


@contextlib.contextmanager
def batch_statistics_in_eval(norms):
    """A fault for embed_checks to refuse: in the block, the BatchNorms
    `norms` normalise eval forwards with the batch's statistics, as a
    module left in training mode would, instead of their running ones."""
    import torch
    import torch.nn.functional as F

    def hook(mod, args, out):
        x = args[0].to(torch.float32) if mod.dtype == torch.float32 \
            else args[0]
        return F.batch_norm(x, None, None, mod.weight, mod.bias, True, 0.0,
                            mod.eps).to(mod.dtype)

    handles = [norm.register_forward_hook(hook) for norm in norms]
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()


def embed_checks(name, module, images):
    """The eval-mode embedding of a trained (or seeded) `module` on the
    card: b512 img/s by CUDA events beside its bound; and the first
    BACKBONE_CHECK_IMAGES images through the port's CPU forward of the same
    weights in fp32, against which the card's fp32 forward (TF32 off)
    and the timed module's own forward are held, and two faulty forwards
    of the timed module (every BatchNorm, or its last one, on the batch's
    statistics) must be refused."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.models.resnet import BatchNorm
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    cuda = torch.device("cuda")
    step = make_eval_step(module, device=cuda)
    x = torch.as_tensor(images).to(cuda)
    ms = cuda_ms(lambda: step(x), warmup=3, iters=BACKBONE_TIMED_CALLS)
    flops = forward_flops(module, images.shape[1])
    bound_ms = flops * len(images) / PEAK_BF16_TC_FLOPS * 1e3
    xs = x[:BACKBONE_CHECK_IMAGES]
    out = step(xs)
    if not (out.shape == (BACKBONE_CHECK_IMAGES, module.embed_dim)
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"backbones: {name} embedding {out.shape}")
    out = out.cpu().numpy()
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    faulty = {}
    for label, chosen in (("every_batchnorm_on_batch_statistics", norms),
                          ("last_batchnorm_on_batch_statistics",
                           norms[-1:])):
        with batch_statistics_in_eval(chosen):
            faulty[label] = step(xs).cpu().numpy()
    m = get_backbone(name, embed_dim=module.embed_dim, dtype=torch.float32,
                     image_size=images.shape[1])
    m.load_state_dict({k: v.detach().cpu()
                       for k, v in module.state_dict().items()})
    fp32 = {}
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            m = to_device(m, torch.device(dev))
            fp32[dev] = make_eval_step(m, device=dev)(
                images[:BACKBONE_CHECK_IMAGES]).cpu().numpy()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    del m
    want, got = fp32["cpu"], fp32["cuda"]
    atol = TOL_BACKBONE_ATOL_REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=TOL_BACKBONE_RTOL, atol=atol):
        raise AssertionError(f"backbones: {name} card vs CPU fp32 forward: "
                             f"max abs err {err} (atol {atol})")
    timed = row_agreement(out, want)
    if not bf16_within(timed):
        raise AssertionError(f"backbones: {name} timed module vs CPU fp32 "
                             f"forward: {timed}")
    faulty = {k: row_agreement(v, want) for k, v in faulty.items()}
    passed = [k for k, v in faulty.items() if bf16_within(v)]
    if passed:
        raise AssertionError(f"backbones: {name} faulty forwards {passed} "
                             f"not refused: {faulty}")
    return {"embed_img_per_s": len(images) * 1e3 / ms,
            "embed_ms_per_batch": ms, "forward_gflop_per_image": flops / 1e9,
            "embed_bound_ms": bound_ms,
            "embed_bound_share": bound_ms / ms,
            "card_vs_cpu_fp32_max_abs_err": err,
            "card_vs_cpu_tolerance": {"rtol": TOL_BACKBONE_RTOL,
                                      "atol": atol},
            "timed_vs_cpu_fp32": timed, "faulty_vs_cpu_fp32": faulty,
            "timed_vs_cpu_limit": {"max_rel_err": TOL_BF16_ROW_REL,
                                   "min_cosine": MIN_BF16_COSINE}}


def phase_backbones():
    """The trunks of the registry beyond the ResNets at full width (module
    constants above), then graphed against eager for BACKBONE_SCAN and the
    serving artifact for BACKBONE_EXPORT. Returns {kernel: launches} of
    the fit runs, the graphed runs' replays included."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.models.resnet import init_weights
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi
    from face_recognition_models_tpu_torch.utils.profiling import (
        profile_train_step)

    smi = nvidia_smi()
    total = {k: 0 for k in PLAIN_KERNELS}
    images = train_batches(1, N_MAIN, 112, seed=5)[0]
    for name in BACKBONE_TRUNKS:
        torch.cuda.empty_cache()
        res, _, launches = train_phase("arcface", PLAIN_KERNELS,
                                       steps=BACKBONE_STEPS,
                                       phase="backbones", backbone=name)
        for k in PLAIN_KERNELS:
            total[k] += launches[k]
        module = res.state.backbone
        checks = embed_checks(name, module, images)
        del res, module
        torch.cuda.empty_cache()
        prof = profile_train_step(cfg_lib.TrainConfig(
            backbone=name, num_classes=C_MAIN), device="cuda", warmup=1,
            steps=BACKBONE_PROFILED)
        emit({"phase": "backbones", "part": "embed", "backbone": name,
              **checks, "device_ms_per_step": prof["device_ms_per_step"],
              "profiled_host_ms_per_step": prof["ms_per_step"],
              "idle_share": prof["idle_share"],
              "by_category_ms": prof["by_category_ms"],
              "bound": "forward FLOPs x 512 at 989 TFLOP/s dense bf16",
              "nvidia_smi": smi, "ok": True})
    # inception_v3: the embedding checks, and fit's refusal
    torch.cuda.empty_cache()
    module = get_backbone("inception_v3")
    init_weights(module, torch.Generator().manual_seed(0))
    checks = embed_checks("inception_v3", to_device(module, torch.device(
        "cuda")), images)
    try:
        fit(cfg_lib.TrainConfig(backbone="inception_v3", num_classes=C_MAIN,
                                batch_size=N_MAIN, epochs=1),
            ArrayLoader(images, np.zeros(N_MAIN, np.int32),
                        batch_size=N_MAIN), device="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or "loop.py:169" not in refused:
        raise AssertionError(f"backbones: fit(inception_v3) not refused: "
                             f"{refused}")
    emit({"phase": "backbones", "part": "embed", "backbone": "inception_v3",
          **checks, "fit_refused": refused, "nvidia_smi": smi, "ok": True})
    del module
    torch.cuda.empty_cache()
    for name, count in backbone_scan().items():
        total[name] += count
    backbone_export()
    return total


def backbone_scan():
    """SCAN_STEPS full-width steps of each of BACKBONE_SCAN with
    scan_steps=SCAN_K against the same steps one at a time, bit for bit
    (losses, every state tensor, the generator). Returns the graphed runs'
    {kernel: launches}, replays included."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    total = {k: 0 for k in PLAIN_KERNELS}
    images, labels = train_batches(SCAN_STEPS, N_MAIN, 112, seed=6)
    for name in BACKBONE_SCAN:
        runs = {}
        for k in (1, SCAN_K):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cfg = cfg_lib.TrainConfig(backbone=name, num_classes=C_MAIN,
                                      batch_size=N_MAIN, epochs=1,
                                      print_freq=10 ** 9, seed=0,
                                      scan_steps=k)
            fh.reset_launch_counts()
            res = fit(cfg, ArrayLoader(images, labels, batch_size=N_MAIN,
                                       seed=0), device="cuda")
            torch.cuda.synchronize()
            runs[k] = (res, dict(fh.launch_counts),
                       torch.cuda.max_memory_allocated())
        (eager, _, eager_peak), (graphed, real, graph_peak) = (runs[1],
                                                               runs[SCAN_K])
        if eager.losses != graphed.losses:
            raise AssertionError(f"backbones: {name} graphed losses "
                                 f"{graphed.losses} != eager {eager.losses}")
        n = same_state(f"backbones {name}", graphed.state, eager.state)
        launches = {k: real.get(k, 0) + graphed.replays
                    * graphed.replay_launches.get(k, 0)
                    for k in PLAIN_KERNELS}
        # the capture's eager warm-up of one chunk launches SCAN_K more
        if any(v != SCAN_STEPS + SCAN_K for v in launches.values()):
            raise AssertionError(f"backbones: {name} graphed launches "
                                 f"{launches}")
        for k in PLAIN_KERNELS:
            total[k] += launches[k]
        emit({"phase": "backbones", "part": "scan", "backbone": name,
              "steps": SCAN_STEPS, "scan_steps": SCAN_K,
              "replays": graphed.replays, "losses": graphed.losses,
              "bitwise": True, "state_tensors_compared": n,
              "launches": launches,
              "capture_seconds": graphed.capture_seconds,
              "peak_gb_eager": eager_peak / 1e9,
              "peak_gb_graphed": graph_peak / 1e9, "ok": True})
        del runs, eager, graphed
    return total


def backbone_export():
    """`export_embedder` -> `load_embedder` -> `fn` against the live eval
    step at b512 for each of BACKBONE_EXPORT (seeded weights, moved
    BatchNorm statistics), and for the first of them `fn` on
    BACKBONE_EXPORT_ROWS rows of an artifact of max_batch
    BACKBONE_EXPORT_MAX (slices joined) against the live eval step on the
    same slices."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.models.resnet import init_weights
    from face_recognition_models_tpu_torch.serving.export import (
        export_embedder, load_embedder)
    from face_recognition_models_tpu_torch.train.step import make_eval_step

    cuda = torch.device("cuda")
    host = train_batches(1, N_MAIN, 112, seed=7)[0]
    with tempfile.TemporaryDirectory() as root:
        for name in BACKBONE_EXPORT:
            torch.cuda.empty_cache()
            module = get_backbone(name)
            init_weights(module, torch.Generator().manual_seed(3))
            module = move_bn_statistics(to_device(module, cuda))
            step = make_eval_step(module, device=cuda)
            out = {}
            cases = [(N_MAIN, N_MAIN)]
            if name == BACKBONE_EXPORT[0]:
                cases.append((BACKBONE_EXPORT_ROWS, BACKBONE_EXPORT_MAX))
            for rows, max_batch in cases:
                path = os.path.join(root, f"{name}_{max_batch}.frte")
                t0 = time.perf_counter()
                header = export_embedder(module, module.state_dict(), path,
                                         meta={"backbone": name},
                                         max_batch=max_batch)
                export_s = time.perf_counter() - t0
                art = load_embedder(path)
                got = art.fn(host[:rows])
                # the live step on the same slices: cuDNN picks its bf16
                # conv algorithms by batch, so other batches round apart
                want = np.concatenate([
                    step(host[i:min(i + max_batch, rows)]).cpu().numpy()
                    for i in range(0, rows, max_batch)])
                err = float(np.abs(got - want).max())
                if (header["bn_folded"] or got.shape != (rows, 512)
                        or not np.allclose(got, want, rtol=TOL_ARTIFACT,
                                           atol=TOL_ARTIFACT)):
                    raise AssertionError(
                        f"backbones: {name} artifact (max_batch {max_batch}"
                        f", {rows} rows) vs the live eval step: max abs err "
                        f"{err}")
                out[f"rows{rows}_max_batch{max_batch}"] = {
                    "export_s": export_s, "max_abs_err_vs_live": err,
                    "bitwise_vs_live": bool(np.array_equal(got, want)),
                    "slices": -(-rows // max_batch)}
                del art
            emit({"phase": "backbones", "part": "export", "backbone": name,
                  "artifacts": out, "limit": {"rtol": TOL_ARTIFACT,
                                              "atol": TOL_ARTIFACT},
                  "ok": True})
            del module


# the convergence phase: the port's scripts/convergence_run at its
# defaults (ArcFace + resnet18, 500 identities x 16 train + 4 held-out
# copies at noise 35, b512, 15 epochs, scan_steps 8, the fused head); the
# JAX package's result on its own hardware (99.74% +- 0.22, AUC 1.0000) is
# a quality reference, not a bound
MIN_CONVERGED_ACC, MIN_CONVERGED_AUC = 98.0, 0.995


def phase_convergence():
    """The port's first trained accuracy. Returns {kernel: launches} of
    the run, its graph replays included."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.scripts import convergence_run

    args = convergence_run.parser().parse_args(["--device", "cuda"])
    torch.cuda.empty_cache()
    fh.reset_launch_counts()
    t0 = time.perf_counter()
    res, line = convergence_run.run_stage(args, args.classes, args.epochs,
                                          args.lr, args.seed)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: fh.launch_counts[k]
                + res.replays * res.replay_launches.get(k, 0)
                for k in PLAIN_KERNELS}
    steps = len(res.losses)
    # the capture's eager warm-up of one chunk launches scan_steps more
    want = steps + (args.scan_steps if res.replays else 0)
    if any(v != want for v in launches.values()):
        raise AssertionError(f"convergence: launches {launches}, {steps} "
                             "steps")
    if not (line["mean_accuracy"] >= MIN_CONVERGED_ACC
            and line["mean_auc"] >= MIN_CONVERGED_AUC):
        raise AssertionError(f"convergence: {line} below "
                             f"{MIN_CONVERGED_ACC}% / {MIN_CONVERGED_AUC}")
    emit({"phase": "convergence", **line, "steps": steps,
          "replays": res.replays, "launches": launches,
          "first_losses": res.losses[:3], "last_losses": res.losses[-3:],
          "wall_seconds": wall,
          "limit": {"mean_accuracy": MIN_CONVERGED_ACC,
                    "mean_auc": MIN_CONVERGED_AUC},
          "jax_reference": {"mean_accuracy": 99.74, "std_accuracy": 0.22,
                            "mean_auc": 1.0},
          "ok": True})
    return launches


# the partial_fc phase: ResNet-50 + ArcFace, D=512, b512, 112 px, bf16
# convs, SGD 0.1 / 0.9 / 5e-4, ratio 0.1, at C = 1,048,576 (C_s = 104,960)
# and at CASIA's C = 10,575 (C_s = 1,280)
PFC_CLASSES = 1_048_576
PFC_RATIO = 0.1
PFC_STEPS = 5
PFC_DENSE_STEPS = 3
PFC_SMALL_STEPS = 3
PFC_RESUME_STEPS = 2     # steps an epoch of the resume check
PFC_PROFILED = 10        # calls the profiler's sampler / gather readings average
PFC_PROFILED_STEPS = 3   # steps of the profiler's device split
PFC_CLI_CLASSES = 3072   # `train --partial-fc` through the CLI: 6 steps
# the one-step full-sample check: the CPU test's bounds
# (tests/test_torch_partial_fc.py)
TOL_PFC_LOSS_RTOL = 1e-6
TOL_PFC_KERNEL = dict(rtol=1e-5, atol=1e-7)
TOL_PFC_MOMENTUM = dict(rtol=1e-5, atol=1e-5)


def no_kernel_launched(label):
    """Raise if any kernel of the port ran (fused-head K1-K5, captured in a
    graph or not, and the conv K6) since the counters were reset."""
    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.ops import fused_head as fh

    ran = {k: v for k, v in {**fh.launch_counts, **conv3x3.launch_counts,
                             **{f"captured {k}": v for k, v in
                                fh.captured_counts.items()}}.items() if v}
    if ran:
        raise AssertionError(f"{label}: kernels launched: {ran}")


def reset_kernel_counts():
    from face_recognition_models_tpu_torch.ops import conv3x3
    from face_recognition_models_tpu_torch.ops import fused_head as fh

    fh.reset_launch_counts()
    conv3x3.reset_launch_counts()
    for k in fh.captured_counts:
        fh.captured_counts[k] = 0


def profiled_kernel_ms(fn, calls, tries=3):
    """{kernel: device ms per call of `fn`}: each kernel's (and copy's)
    self device time in a torch.profiler trace of `calls` calls, or None
    when `tries` traces in a row record no device time (CUPTI does not
    always deliver its records on a shared machine)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key[:120]: e.self_device_time_total / calls / 1e3
               for e in prof.key_averages() if e.self_device_time_total}
        if out:
            return out
        print(f"profiler: no device time recorded (trace {attempt + 1} of "
              f"{tries})", file=sys.stderr, flush=True)
    return None


def profiled_device_ms(fn, calls):
    """(device ms per call of `fn`, how it was timed): profiled_kernel_ms
    summed, or CUDA events around `calls` back-to-back calls (device_ms)
    when the profiler records nothing."""
    kernels = profiled_kernel_ms(fn, calls)
    if kernels is None:
        return device_ms(fn, warmup=1, iters=calls), "cuda_events"
    return sum(kernels.values()), "torch.profiler"


def pfc_cfg(num_classes, partial_fc=PFC_RATIO, **kw):
    from face_recognition_models_tpu_torch import config as cfg_lib

    kw = {"epochs": 1, "print_freq": 1, "backbone": "resnet50", **kw}
    return cfg_lib.TrainConfig(head="arcface", num_classes=num_classes,
                               batch_size=N_MAIN, seed=0,
                               partial_fc=partial_fc, **kw)


def pfc_loader(steps, num_classes, seed=8):
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader

    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (steps * N_MAIN, 112, 112, 3), np.uint8)
    labels = rs.randint(0, num_classes, steps * N_MAIN).astype(np.int32)
    return ArrayLoader(images, labels, batch_size=N_MAIN, seed=0)


def pfc_fit(cfg, loader, label, **kw):
    """`fit` on the card with every kernel counter reset before; the
    result, its peak GB and ms/step after step 1 (the loss read every
    step when cfg.print_freq is 1)."""
    import torch

    from face_recognition_models_tpu_torch.train.loop import fit

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    res = fit(cfg, loader, device="cuda", **kw)
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"partial_fc {label}: losses {res.losses}")
    ms = (1e3 * float(np.mean(res.step_seconds[1:]))
          if len(res.step_seconds) > 1 else None)
    return res, torch.cuda.max_memory_allocated() / 1e9, ms


def pfc_large():
    """C = 1,048,576: PFC_STEPS Partial-FC steps (columns written, no
    kernel, ms/step, peak GB, the sampler's and the gather + scatter's
    device ms), the dense fused head's PFC_DENSE_STEPS at the same C, and
    SCAN_STEPS graphed (K = SCAN_K) against eager, bit for bit."""
    import torch

    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train import partial_fc as pfc
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi
    from face_recognition_models_tpu_torch.utils.profiling import (
        profile_train_step)

    c = PFC_CLASSES
    c_s = pfc.num_sampled_classes(c, PFC_RATIO, N_MAIN)
    seen = {}

    def before(state):
        if state.step == 0:
            seen["w"] = state.kernel_w.detach().clone()
            seen["m"] = state.kernel_mom.clone()

    def after(state):
        if state.step == 1:
            seen["moved_w"] = (state.kernel_w.detach() != seen.pop("w")).any(0)
            seen["moved_m"] = (state.kernel_mom != seen.pop("m")).any(0)

    t0 = time.perf_counter()
    with recorded(pfc, "sample_classes") as drawn, observe_steps(
            after, before, factory="make_partial_fc_train_step"):
        res, peak, ms = pfc_fit(pfc_cfg(c), pfc_loader(PFC_STEPS, c), "1M")
    no_kernel_launched("partial_fc 1M")
    losses = res.losses
    classes, col_valid, target = drawn[0]
    sampled = torch.zeros(c, dtype=torch.bool, device="cuda")
    sampled[classes[col_valid]] = True
    for key in ("moved_w", "moved_m"):
        if not torch.equal(seen[key], sampled):
            raise AssertionError(
                f"partial_fc 1M: step 1 wrote {int(seen[key].sum())} columns "
                f"of {key[-1]}, {int((seen[key] & ~sampled).sum())} outside "
                f"the {int(sampled.sum())} sampled")
    state = res.state
    labels = torch.from_numpy(pfc_loader(1, c).labels[:N_MAIN]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    sampler_ms, sampler_timer = profiled_device_ms(
        lambda: pfc.sample_classes(gen, labels, c, c_s), PFC_PROFILED)
    cols = torch.where(col_valid, classes, classes[:1])

    def gather_scatter():
        # the step's two gathers and two write-backs (the same values, so
        # the state stays as it is)
        w_s = state.kernel_w.detach().index_select(1, cols)
        m_s = state.kernel_mom.index_select(1, cols)
        state.kernel_w.detach().index_copy_(1, cols, w_s)
        state.kernel_mom.index_copy_(1, cols, m_s)

    # CUDA events behind a spin kernel give the walk's time: traces of it
    # have come back without the gather's records (0.66 ms against 9.2)
    gather_ms = device_ms(gather_scatter, warmup=1, iters=PFC_PROFILED)
    gather_kernels = profiled_kernel_ms(gather_scatter, PFC_PROFILED)
    gather_bytes = 8 * 512 * c_s * 4   # 2 x (read + write) x gather, scatter
    written = int(seen["moved_w"].sum())
    del state, res, seen, drawn
    torch.cuda.empty_cache()
    prof = profile_train_step(pfc_cfg(c), device="cuda", warmup=1,
                              steps=PFC_PROFILED_STEPS)
    sampled_line = {
        "losses": losses, "ms_per_step_after_1": ms,
        "img_per_s_after_1": N_MAIN / ms * 1e3, "peak_gb": peak,
        "num_sampled": c_s, "sampled_classes_step1": int(sampled.sum()),
        "columns_written_step1": written,
        "sampler_device_ms": sampler_ms, "sampler_timed_by": sampler_timer,
        "gather_scatter_device_ms": gather_ms,
        "gather_scatter_by_kernel_ms": gather_kernels or "not measured",
        "gather_scatter_profiled_ms": (sum(gather_kernels.values())
                                       if gather_kernels else None),
        "gather_scatter_bound_ms": gather_bytes / PEAK_BYTES * 1e3,
        "device_ms_per_step": prof["device_ms_per_step"],
        "profiled_host_ms_per_step": prof["ms_per_step"],
        "idle_share": prof["idle_share"],
        "by_category_ms": prof["by_category_ms"],
        "seconds": time.perf_counter() - t0}
    # the yardstick: the dense fused head (K1 / K2) at the same C
    res, peak, ms = pfc_fit(pfc_cfg(c, partial_fc=0.0),
                            pfc_loader(PFC_DENSE_STEPS, c), "dense 1M")
    dense_launches = dict(fh.launch_counts)
    want = {k: PFC_DENSE_STEPS if k in PLAIN_KERNELS else 0
            for k in dense_launches}
    if dense_launches != want:
        raise AssertionError(f"partial_fc dense 1M: launches "
                             f"{dense_launches}")
    dense_line = {"losses": res.losses, "ms_per_step_after_1": ms,
                  "img_per_s_after_1": N_MAIN / ms * 1e3, "peak_gb": peak,
                  "launches": {k: v for k, v in dense_launches.items()
                               if v}}
    del res
    # graphed (K = SCAN_K) against eager, the whole state bit for bit
    runs = {}
    for k in (1, SCAN_K):
        runs[k] = pfc_fit(pfc_cfg(c, scan_steps=k, print_freq=10 ** 9),
                          pfc_loader(SCAN_STEPS, c, seed=9), f"K={k}")
        no_kernel_launched(f"partial_fc 1M K={k}")
    (eager, eager_peak, _), (graphed, graph_peak, _) = runs[1], runs[SCAN_K]
    if eager.losses != graphed.losses:
        raise AssertionError(f"partial_fc: graphed losses {graphed.losses} "
                             f"!= eager {eager.losses}")
    n = same_state("partial_fc graphed", graphed.state, eager.state)
    scan_line = {"steps": SCAN_STEPS, "scan_steps": SCAN_K,
                 "replays": graphed.replays, "bitwise": True,
                 "state_tensors_compared": n,
                 "capture_seconds": graphed.capture_seconds,
                 "peak_gb_eager": eager_peak, "peak_gb_graphed": graph_peak}
    del runs, eager, graphed
    emit({"phase": "partial_fc", "part": "1M", "backbone": "resnet50",
          "head": "arcface", "num_classes": c, "batch": N_MAIN,
          "ratio": PFC_RATIO, "sampled": sampled_line, "dense": dense_line,
          "dense_over_sampled_ms": (dense_line["ms_per_step_after_1"]
                                    / sampled_line["ms_per_step_after_1"]),
          "graphed": scan_line, "nvidia_smi": nvidia_smi(), "ok": True})


def pfc_small(root):
    """C = 10,575: two seeded runs bitwise equal; one step with the full
    sample against the dense eager step from the same state; a resumed
    Partial-FC fit against an uninterrupted one, bit for bit."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.train import partial_fc as pfc
    from face_recognition_models_tpu_torch.train.state import (
        create_train_state)
    from face_recognition_models_tpu_torch.train.step import make_train_step

    c, cuda = C_MAIN, torch.device("cuda")
    c_s = pfc.num_sampled_classes(c, PFC_RATIO, N_MAIN)
    a, _, ms = pfc_fit(pfc_cfg(c), pfc_loader(PFC_SMALL_STEPS, c), "C=10575")
    b, _, _ = pfc_fit(pfc_cfg(c), pfc_loader(PFC_SMALL_STEPS, c), "again")
    no_kernel_launched("partial_fc C=10575")
    if a.losses != b.losses:
        raise AssertionError(f"partial_fc: two seeded runs {a.losses} vs "
                             f"{b.losses}")
    n = same_state("partial_fc repeat", a.state, b.state)
    repeat = {"losses": a.losses, "ms_per_step_after_1": ms,
              "state_tensors_compared": n}
    del a, b

    # the full sample (C_s = C, 512 distinct labels) against the dense
    # eager step from the same seeded state
    cfg = pfc_cfg(c)
    head_cfg = cfg_lib.make_head_config("arcface", num_classes=c)
    _, head, sampled = create_train_state(cfg, head_cfg, cuda,
                                          partial_fc=True)
    _, _, dense = create_train_state(cfg, head_cfg, cuda)
    rs = np.random.RandomState(10)
    images = torch.from_numpy(rs.randint(0, 256, (N_MAIN, 112, 112, 3),
                                         np.uint8)).cuda()
    labels = torch.from_numpy(rs.choice(c, N_MAIN, replace=False).astype(
        np.int32)).cuda()
    _, ms_full = pfc.make_partial_fc_train_step(head, head_cfg, c,
                                                device=cuda)(
        sampled, images, labels)
    _, md = make_train_step(head, head_cfg, use_fused_head=False,
                            device=cuda)(dense, images, labels)
    loss_err = abs(float(ms_full["loss"]) - float(md["loss"]))
    if loss_err > TOL_PFC_LOSS_RTOL * abs(float(md["loss"])):
        raise AssertionError(f"partial_fc full sample: loss "
                             f"{float(ms_full['loss'])} vs dense "
                             f"{float(md['loss'])}")
    w_err = close("partial_fc full sample kernel_w", sampled.kernel_w.detach(),
                  dense.kernel_w.detach(), **TOL_PFC_KERNEL)
    m_err = close("partial_fc full sample kernel_mom", sampled.kernel_mom,
                  dense.optimizer.state[dense.kernel_w]["momentum_buffer"],
                  **TOL_PFC_MOMENTUM)
    full = {"loss": float(ms_full["loss"]), "dense_loss": float(md["loss"]),
            "loss_abs_err": loss_err, "kernel_w_max_abs_err": w_err,
            "kernel_mom_max_abs_err": m_err,
            "limits": {"loss_rtol": TOL_PFC_LOSS_RTOL,
                       "kernel_w": TOL_PFC_KERNEL,
                       "kernel_mom": TOL_PFC_MOMENTUM}}
    del sampled, dense

    # resume: 1 epoch, then a resumed one, against 2 epochs
    def run(directory, epochs, resume=None):
        mgr = CheckpointManager(directory, "arcface")
        return pfc_fit(pfc_cfg(c, epochs=epochs, continue_train=resume,
                               print_freq=100),
                       pfc_loader(PFC_RESUME_STEPS, c, seed=11),
                       "resume", checkpoint_manager=mgr)[0]

    whole = run(os.path.join(root, "pfc_a"), 2)
    first = run(os.path.join(root, "pfc_b"), 1)
    second = run(os.path.join(root, "pfc_b"), 1, "latest")
    if first.losses + second.losses != whole.losses:
        raise AssertionError(f"partial_fc resume: {first.losses} + "
                             f"{second.losses} vs {whole.losses}")
    n = same_state("partial_fc resumed", second.state, whole.state)
    size = os.path.getsize(os.path.join(root, "pfc_a", "epoch_2"))
    emit({"phase": "partial_fc", "part": "C10575", "backbone": "resnet50",
          "num_classes": c, "num_sampled": c_s, "batch": N_MAIN,
          "repeat": repeat, "full_sample_vs_dense": full,
          "resume": {"losses": whole.losses, "state_tensors_compared": n,
                     "checkpoint_bytes": size},
          "ok": True})


def pfc_cli(root):
    """`train --partial-fc 0.1` through the CLI on the card (its default
    device): resnet18 + ArcFace, b512, 112 px, PFC_CLI_CLASSES synthetic
    identities x 1 image, one epoch; the sampled path ran (no dense
    fallback), no kernel launched, and the epoch checkpoint holds
    kernel_mom."""
    import torch

    from face_recognition_models_tpu_torch.cli.main import main as cli_main

    work = os.path.join(root, "pfc_cli")
    reset_kernel_counts()
    t0 = time.perf_counter()
    rc = cli_main(["train", "--synthetic", "--synthetic-classes",
                   str(PFC_CLI_CLASSES), "--synthetic-per-class", "1",
                   "--epochs", "1", "--partial-fc", str(PFC_RATIO),
                   "--working-path", work, "--print_freq", "1000"])
    seconds = time.perf_counter() - t0
    no_kernel_launched("partial_fc CLI")
    with open(os.path.join(work, "log", "arcface.txt")) as f:
        log = f.read()
    state = torch.load(os.path.join(work, "checkpoints", "arcface",
                                    "epoch_1"), map_location="cpu",
                       weights_only=True)["state"]
    if (rc != 0 or "partial-fc head" not in log or "dense path" in log
            or state["kernel_mom"] is None
            or tuple(state["kernel_mom"].shape) != (512, PFC_CLI_CLASSES)):
        raise AssertionError(f"partial_fc CLI: rc {rc}, log {log[-400:]}")
    return {"classes": PFC_CLI_CLASSES, "steps":
            PFC_CLI_CLASSES // N_MAIN, "seconds": seconds}


def phase_partial_fc(root):
    """Partial-FC at full width (see the module docstring); it launches no
    kernel of the port."""
    t0 = time.perf_counter()
    pfc_large()
    pfc_small(root)
    cli = pfc_cli(root)
    emit({"phase": "partial_fc", "cli": cli,
          "seconds": time.perf_counter() - t0, "ok": True})


# the facenet phase: FaceNet's defaults (ResNet-50, embed 128, P = 16 x
# K = 4, margin 0.2, lr 0.05, 112 px, bf16 convs)
FACENET_STEPS = 10
FACENET_TREE = (32, 4)        # PNG identity tree of the CLI run: ids x images
INCEPTION_STEPS = 3


def timed_triplet_steps():
    """Wrap triplet.train.make_triplet_train_step so that each step waits
    for the card and its host seconds are recorded; returns the list."""
    import torch

    from face_recognition_models_tpu_torch.triplet import train as ttrain

    build = ttrain.make_triplet_train_step
    seconds = []

    @contextlib.contextmanager
    def patched():
        def make(*args, **kwargs):
            step = build(*args, **kwargs)

            def timed(state, *batch):
                t0 = time.perf_counter()
                out = step(state, *batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                return out
            return timed

        ttrain.make_triplet_train_step = make
        try:
            yield seconds
        finally:
            ttrain.make_triplet_train_step = build

    return patched()


def facenet_train(cfg, images, labels, seed=0, **kw):
    """train_facenet on the card, its steps timed, no kernel launched."""
    import torch

    from face_recognition_models_tpu_torch.triplet import train_facenet

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    with timed_triplet_steps() as seconds:
        res = train_facenet(cfg, images, labels, image_size=112, seed=seed,
                            verbose=False, device="cuda", **kw)
    no_kernel_launched(f"facenet {cfg.backbone}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"facenet {cfg.backbone}: losses {res.losses}")
    return res, seconds, torch.cuda.max_memory_allocated() / 1e9


def phase_facenet(root):
    """The triplet path at full width (see the module docstring)."""
    import torch
    from PIL import Image

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.cli.main import main as cli_main
    from face_recognition_models_tpu_torch.data.synthetic import (
        synthetic_identities)
    from face_recognition_models_tpu_torch.evaluation import batch_eval
    from face_recognition_models_tpu_torch.ops import mining
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi

    t_phase = time.perf_counter()
    cfg = cfg_lib.FaceNetConfig()
    b = cfg.p * cfg.k
    images, labels = synthetic_identities(FACENET_STEPS * cfg.p, cfg.k,
                                          image_size=112, seed=12)
    res, seconds, peak = facenet_train(cfg, images, labels)
    if len(res.losses) != FACENET_STEPS or min(res.triplets) <= 0:
        raise AssertionError(f"facenet: {len(res.losses)} steps, mined "
                             f"triplets {res.triplets}")
    ms = 1e3 * float(np.mean(seconds[1:]))
    flops = forward_flops(res.state.backbone, 112)
    bound_ms = 3 * flops * b / PEAK_BF16_TC_FLOPS * 1e3
    emb = torch.nn.functional.normalize(torch.randn(
        b, cfg.embed_dim, generator=torch.Generator().manual_seed(0)),
        dim=1).cuda()
    batch_labels = torch.from_numpy(labels[:b]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    mining_ms, mining_timer = profiled_device_ms(
        lambda: mining.semi_hard_negatives(
            mining.pairwise_sq_distances(emb), batch_labels, cfg.margin,
            gen),
        PFC_PROFILED)
    emit({"phase": "facenet", "part": "train", "backbone": cfg.backbone,
          "embed_dim": cfg.embed_dim, "p": cfg.p, "k": cfg.k,
          "margin": cfg.margin, "learning_rate": cfg.learning_rate,
          "losses": res.losses, "triplets": res.triplets,
          "step_ms": [1e3 * x for x in seconds],
          "ms_per_step_after_1": ms, "img_per_s_after_1": b / ms * 1e3,
          "peak_gb": peak, "forward_gflop_per_image": flops / 1e9,
          "fwd_bwd_bound_ms": bound_ms, "bound_share": bound_ms / ms,
          "bound": "3 x forward FLOPs x 64 at 989 TFLOP/s dense bf16",
          "mining_device_ms": mining_ms, "mining_timed_by": mining_timer,
          "nvidia_smi": nvidia_smi(),
          "ok": True})
    del res

    # the CLI over a PNG identity tree (PKLoader, PIL), then eval / embed
    tree = os.path.join(root, "facenet_tree")
    ids, per = FACENET_TREE
    tree_images, tree_labels = synthetic_identities(ids, per, image_size=112,
                                                    seed=13)
    for i, (img, lab) in enumerate(zip(tree_images, tree_labels)):
        d = os.path.join(tree, f"id_{lab:05d}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img).save(os.path.join(d, f"{i:04d}.png"))
    work = os.path.join(root, "facenet_work")
    t0 = time.perf_counter()
    rc = cli_main(["facenet", "--dataset-path", tree, "--epochs", "1",
                   "--working-path", work, "--num-workers", "4"])
    cli_s = time.perf_counter() - t0
    ckpt = os.path.join(work, "checkpoints")
    final = os.path.join(ckpt, "facenet_resnet50", "facenet_resnet50_final")
    if rc != 0 or not os.path.isfile(final):
        raise AssertionError(f"facenet CLI: rc {rc}, no {final}")
    bench_dir = os.path.join(root, "benchmarks")
    if not os.path.isfile(os.path.join(bench_dir, "synth_lfw.bin")):
        os.makedirs(bench_dir, exist_ok=True)
        synthetic_benchmark(os.path.join(bench_dir, "synth_lfw.bin"))
    with recorded(batch_eval, "evaluate_model_on_benchmark") as calls:
        rc = cli_main(["eval", "--checkpoint-dir", ckpt, "--head",
                       "facenet_resnet50", "--backbone", "resnet50",
                       "--embed-dim", "128", "--eval-data-path", bench_dir,
                       "--benchmarks", "synth_lfw", "--output-dir",
                       os.path.join(root, "facenet_eval")])
    if rc != 0 or len(calls) != 1:
        raise AssertionError(f"facenet eval: rc {rc}, {len(calls)} runs")
    npz = os.path.join(root, "facenet_embed.npz")
    rc = cli_main(["embed", "--input", tree, "--output", npz,
                   "--checkpoint-dir", os.path.join(ckpt, "facenet_resnet50"),
                   "--backbone", "resnet50", "--embed-dim", "128"])
    emb = np.load(npz)["embeddings"]
    if rc != 0 or emb.shape != (ids * per, 128) or not np.isfinite(emb).all():
        raise AssertionError(f"facenet embed: rc {rc}, {emb.shape}")
    emit({"phase": "facenet", "part": "cli", "tree": [ids, per],
          "format": "png", "cli_seconds": cli_s,
          "eval_mean_accuracy": calls[0].mean_accuracy,
          "eval_mean_auc": calls[0].mean_auc,
          "embed_rows": int(emb.shape[0]), "ok": True})

    # inception_v3: dropout from the step generator
    inc = dataclasses.replace(cfg, backbone="inception_v3")
    steps = images[:INCEPTION_STEPS * inc.p * inc.k], labels[
        :INCEPTION_STEPS * inc.p * inc.k]
    runs = [facenet_train(inc, *steps, seed=s)[0] for s in (0, 0, 1)]
    same = [torch.equal(x, y) for x, y in zip(
        runs[0].state.backbone.state_dict().values(),
        runs[1].state.backbone.state_dict().values())]
    other = [torch.equal(x, y) for x, y in zip(
        runs[0].state.backbone.state_dict().values(),
        runs[2].state.backbone.state_dict().values())]
    if (len(runs[0].losses) != INCEPTION_STEPS
            or runs[0].losses != runs[1].losses or not all(same)
            or runs[0].losses == runs[2].losses or all(other)):
        raise AssertionError(f"facenet inception_v3: losses "
                             f"{[r.losses for r in runs]}")
    emit({"phase": "facenet", "part": "inception_v3", "image_size": 112,
          "losses": [r.losses for r in runs], "same_seed_bitwise": True,
          "other_seed_differs": True, "seconds":
          time.perf_counter() - t_phase, "ok": True})


# the mesh phase: a world of MESH_WORLD ranks, each its own process, on the
# one card over gloo (NCCL refuses two ranks on one device); with two or
# more cards, the data-parallel and class-sharded checks again with one
# rank a card over NCCL
MESH_WORLD = 2
MESH_STEPS = 5
MESH_BACKBONE = "resnet50"
MESH_IMAGE = 112
MESH_TIMEOUT_S = 900         # the ranks' process group and their run
# the data=2 run against one process on the same global batches, by compute
# dtype. The two differ only in the order of sums (BatchNorm's global sums,
# the gradient all-reduce, cuDNN's algorithms at b256 and b512). The step-1
# loss is the same forward: 8.7e-8 apart in fp32 and 6.1e-5 in bf16 on an
# H100 at 700 W; the later losses 3.3e-4 at most. The
# step-1 update (the parameters' move) is ill-conditioned: each BatchNorm
# backward subtracts the means of dy and dy * xhat, a cancellation, so a
# rounding in another order grows through ResNet-50's 53 of them. In fp32
# (TF32 off) the world's update was 0.017 of itself from one process's. In
# bf16 the noise is the bf16 rounding's, measured in each run: the
# one-process bf16 update lies 1.27 of the fp32 one from it, and two such
# noisy updates lie about sqrt(2) times that apart, so the world's bf16
# drift is held to twice the yardstick (None below), a bound above 1 that
# no fault of the data path needs to cross. The classifier's step-1 update
# (kernel_w's move) sits behind the trunk's forward and no BatchNorm
# backward, so its bf16 noise is the forward's: the world's is held to twice
# the one-process bf16-vs-fp32 drift of that update (None below), which
# must be under 1 (0.12 on an H100 at 700 W; the world's 0.029). Both
# ranks' losses, parameters and BatchNorm running statistics must be
# bitwise equal: the synced statistics are the same all-reduced sums on
# every rank. Two faults
# planted in the bf16 world (MESH_FAULTS) must each break a bound: summed
# gradients move the classifier's update by 1.0 and the later losses by
# 0.25-0.34; BatchNorm on the rank's half batch moves no bf16 number past
# its noise (the step-1 loss 8.2e-4, the one-process bf16-vs-fp32 gap 4.8e-4;
# the classifier's update 0.060, under its bound) and is caught by the
# ranks' running statistics alone. Later steps compound every drift through
# a chaotic trajectory (lr 0.1, random weights), so the final drift is only
# reported.
MESH_TOL = {"float32": {"step1_loss_rtol": 1e-5, "step1_update_drift": 5e-2,
                        "step1_head_drift": 5e-2, "loss_rtol": 2e-3},
            "bfloat16": {"step1_loss_rtol": 1e-3, "step1_update_drift": None,
                         "step1_head_drift": None, "loss_rtol": 5e-3}}
MESH_BF16_DRIFT_FACTOR = 2.0
# faults planted in the bf16 world's data path: BatchNorm on the rank's own
# rows (no sums over the data group), and the gradients summed over the data
# group, not averaged
MESH_FAULTS = ("batchnorm_local", "gradients_summed")
# the class-sharded head against the one-process head: the bounds of
# tests/test_sharded_fused.py (the same kernels, only the lse combine's
# order differs)
MESH_HEAD_TOL = {"loss": dict(rtol=2e-5, atol=2e-5),
                 "grads": dict(rtol=5e-4, atol=1e-6)}
# the class-sharded eager head (train/step.eager_apply) over model=2 by
# head, with its C. The one-process reference of each runs beside the other
# rank and the smoke's main process, which still reserves ~14 GB after the
# earlier phases. Sub-center ArcFace's at C = 1,048,576 (K = 3: a [512,
# 3,145,728] kernel, 45.5 GiB at its peak, ~54 GiB reserved) ran out of
# memory there on an H100 (80 GB), where about 51 GiB was left to it; at
# 13 x 65,536 classes it needs ~44 GiB.
MESH_EAGER_CLASSES = {"adacos": 1_048_576, "subcenter_arcface": 851_968,
                      "arcface": 1_048_576}
# a rank's peak allocated memory over the one-process head's: every
# [N, C] tensor, the kernel and its gradient are halved
MESH_EAGER_PEAK_RATIO = 0.6
MESH_ADACOS_SCALE_RTOL = 1e-6
# the calls probed on CUDA tensors over gloo, in a group of their own with
# a short timeout (a call one rank refuses leaves the other waiting).
# dist.barrier and send / recv are not among them: under gloo with a CUDA
# device current each hands the socket a device pointer ("writev: Bad
# address" on an H100), which gloo's I/O thread may raise where no caller
# catches it and abort the process; collectives.barrier is an all-reduce.
MESH_COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
                    "all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_to_all_single", "reduce")
MESH_PROBE_TIMEOUT_S = 30


def fingerprint(x):
    """An exact fingerprint of a float32 tensor's bits on its device: the
    sums of the int32 words and of the words weighted by their position
    (mod 65,521), in int64."""
    import torch

    w = x.detach().contiguous().view(torch.int32).reshape(-1).long()
    pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
    return [int(w.sum()), int((w * pos).sum())]


def mesh_probe_collectives(device):
    """{collective: 'ok' or its error} on CUDA tensors, in a gloo group of
    its own."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    g = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=MESH_PROBE_TIMEOUT_S))
    x = torch.full((4,), float(rank + 1), device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=g),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=g),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x, group=g),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, device=device), x, group=g),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=device), torch.ones(2 * world,
                                                      device=device),
            group=g),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(2 * world, device=device),
            torch.ones(2 * world, device=device), group=g),
        "reduce": lambda: dist.reduce(x.clone(), dst=0, group=g),
    }
    out = {}
    for name in MESH_COLLECTIVES:
        try:
            calls[name]()
            torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the answer is the message
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def mesh_dp_cfg(**kw):
    from face_recognition_models_tpu_torch import config as cfg_lib

    return cfg_lib.TrainConfig(backbone=MESH_BACKBONE, head="arcface",
                               num_classes=C_MAIN, batch_size=N_MAIN,
                               epochs=1, print_freq=1, seed=0,
                               data=cfg_lib.DataConfig(image_size=MESH_IMAGE),
                               **kw)


def mesh_dp_batches():
    return train_batches(MESH_STEPS, N_MAIN, MESH_IMAGE, seed=11)


def params_of(state):
    """The backbone's parameters and kernel_w, in one flat host vector."""
    import torch

    return torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in state.params()])


def backbone_params(state):
    """The backbone's parameters, in one flat vector on their device."""
    import torch

    return torch.cat([p.detach().float().reshape(-1)
                      for p in state.backbone.parameters()])


@contextlib.contextmanager
def conv_tf32(allowed):
    import torch

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@contextlib.contextmanager
def mesh_fault(name):
    """Plant the fault `name` of MESH_FAULTS (None: none) in the data path
    of the block."""
    from face_recognition_models_tpu_torch.models import resnet
    from face_recognition_models_tpu_torch.parallel import collectives as coll

    if name is None:
        yield
        return
    if name == "batchnorm_local":
        target, attr = resnet.BatchNorm, "_synced"

        def planted(self, x, mesh):
            with coll.using(None):
                return self.forward(x)
    elif name == "gradients_summed":
        target, attr = coll, "average_gradients"
        average = coll.average_gradients

        def planted(params, mesh=None):
            average(params, mesh)
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(coll.data_size(mesh))
    else:
        raise ValueError(f"unknown fault {name}")
    kept = getattr(target, attr)
    setattr(target, attr, planted)
    try:
        yield
    finally:
        setattr(target, attr, kept)


def mesh_dp_run(mesh, device, dtype, fault=None):
    """(1) `fit` of ResNet-50 + ArcFace (fused head, C = 10,575, global
    b512, 112 px, convolutions in `dtype`, fp32 with TF32 off) over a
    data=2 mesh for MESH_STEPS steps, with the planted `fault` of
    MESH_FAULTS or none: this rank loads its 256 rows a step.
    Returns the losses, ms/step, peak GB, the launches, the parameters'
    fingerprints and, on rank 0, the parameters after step 1 and at the end
    (host vectors)."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.train.loop import fit

    images, labels = mesh_dp_batches()
    loader = ArrayLoader(images, labels, batch_size=N_MAIN // mesh.data,
                         shuffle=False, seed=0,
                         shard=(mesh.data_index, mesh.data))
    seen = {}

    def after(state):
        if state.step == 1:
            seen["step1"] = params_of(state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_kernel_counts()
    with observe_steps(after), conv_tf32(dtype != "float32"), \
            mesh_fault(fault):
        res = fit(mesh_dp_cfg(mesh=cfg_lib.MeshConfig(data=mesh.data,
                                                      model=1),
                              compute_dtype=dtype),
                  loader, device=device, mesh=mesh)
    torch.cuda.synchronize(device)
    launches = {k: v for k, v in fh.launch_counts.items() if v}
    out = {"losses": res.losses,
           "ms_per_step_after_1": 1e3 * float(np.mean(res.step_seconds[1:])),
           "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "launches": launches,
           "fingerprint": fingerprint(params_of(res.state)),
           "buffers": fingerprint(torch.cat([
               b.detach().reshape(-1) for b in res.state.backbone.buffers()
               if b.dtype == torch.float32]))}
    if mesh.rank == 0:
        out["step1"], out["final"] = seen["step1"], params_of(res.state)
    del res
    torch.cuda.empty_cache()
    return out


def mesh_dp_reference(dtype, device="cuda"):
    """The one-process run of mesh_dp_run: the same global batches, in the
    order of the rows, through `fit` with no mesh."""
    import torch

    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit

    images, labels = mesh_dp_batches()
    seen = {}

    def after(state):
        if state.step == 1:
            seen["step1"] = params_of(state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with observe_steps(after), conv_tf32(dtype != "float32"):
        res = fit(mesh_dp_cfg(compute_dtype=dtype),
                  ArrayLoader(images, labels, N_MAIN, shuffle=False, seed=0),
                  device=device)
    torch.cuda.synchronize()
    out = {"losses": res.losses, "step1": seen["step1"],
           "final": params_of(res.state),
           "ms_per_step_after_1": 1e3 * float(np.mean(res.step_seconds[1:])),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del res
    torch.cuda.empty_cache()
    return out


def mesh_initial_params():
    """The parameters `fit` starts the mesh_dp runs from, on the host
    (kernel_w last, as params_of lays them out)."""
    import torch

    from face_recognition_models_tpu_torch.config import make_head_config
    from face_recognition_models_tpu_torch.train.state import (
        create_train_state)

    cfg = mesh_dp_cfg()
    _, _, state = create_train_state(
        cfg, make_head_config("arcface", num_classes=C_MAIN),
        torch.device("cpu"))
    return params_of(state)


@contextlib.contextmanager
def first_calls(module, names):
    """Record ((args, kwargs), result) of the first call of each
    module.<name> in the block, by name."""
    kept = {name: getattr(module, name) for name in names}
    calls = {}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.setdefault(name, ((args, kwargs), out))
            return out
        return wrapper

    for name, fn in kept.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in kept.items():
            setattr(module, name, fn)


def check_recorded(calls, mem):
    """Each kernel's recorded output (first_calls of the fwd, bwd_dx and
    bwd_dw wrappers of the plain or the memory-blended family) against its
    plain version on the same inputs, at the kernels phase's tolerances.
    Returns ({kernel: max abs err}, rows where `higher` differs)."""
    import torch

    with torch.no_grad():
        return _check_recorded(calls, mem)


def _check_recorded(calls, mem):
    names, fns = kernel_fns(mem)
    (args, kw), out = calls[names[0]]
    ref = fns[0][1](*args, **kw)
    errs = {names[0]: max(
        close("lse", out.lse, ref.lse, **TOL_STATS),
        close("target_logit", out.target_logit, ref.target_logit,
              **TOL_STATS))}
    flips = close_higher("higher", out.higher, ref.higher)
    del ref
    (args, kw), out = calls[names[1]]
    errs[names[1]] = max(close_grad(k, a, b) for k, a, b in zip(
        ("dx", "dt", "dscale"), out, fns[1][1](*args, **kw)))
    (args, kw), out = calls[names[2]]
    errs[names[2]] = close_grad("dw", out, fns[2][1](*args, **kw))
    return errs, flips


def mesh_head_inputs(device, gen):
    """(feats, warm, labels) of the mesh head parts: ResNet-50's fp32
    embeddings (trunk initialised from `gen`, train mode, no gradient) of
    two b512 batches of seeded 112 px images, and 2 x 512 labels in
    [0, PFC_CLASSES). Leaves TF32 off for the heads' products."""
    import torch

    from face_recognition_models_tpu_torch.models import get_backbone
    from face_recognition_models_tpu_torch.models.backbones import to_device
    from face_recognition_models_tpu_torch.models.resnet import init_weights

    trunk = get_backbone(MESH_BACKBONE, embed_dim=512,
                         image_size=MESH_IMAGE)
    init_weights(trunk, gen)
    trunk = to_device(trunk, device).train()
    rs = np.random.RandomState(12)
    images = rs.randint(0, 256, (2 * N_MAIN, MESH_IMAGE, MESH_IMAGE, 3),
                        np.uint8)
    labels = rs.randint(0, PFC_CLASSES, 2 * N_MAIN)
    x = torch.as_tensor(images, device=device).float() / 127.5 - 1.0
    y = torch.as_tensor(labels, device=device)
    with torch.no_grad():
        feats = trunk(x[:N_MAIN]).float()
        warm = trunk(x[N_MAIN:]).float()
    del trunk, x
    torch.backends.cuda.matmul.allow_tf32 = False
    return feats, warm, y


def mesh_head_case(name, mesh, device):
    """(2) The class-sharded fused head at C = PFC_CLASSES (the rank's
    [512, C/2] shard) on ResNet-50's b512 features, forward and backward,
    against the one-process fused head at the same C from the same state:
    the loss, dx and the rank's slice of the kernel gradient; each called
    twice, the second call timed. Then each kernel's output in the sharded
    run (its first call) against its plain version on the same inputs: the
    rank's [512, C/2] shard, whose rows with a label in the other shard
    carry the out-of-range label C/2 + 1. VPL-ArcFace's state is
    that after one step of the one-process head on another batch."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.heads.fused_adapter import (
        fused_apply)
    from face_recognition_models_tpu_torch.ops import fused_head as fh
    from face_recognition_models_tpu_torch.parallel import sharding

    c = PFC_CLASSES
    cfg = cfg_lib.make_head_config(name, num_classes=c)
    head = get_head(name)
    gen = torch.Generator().manual_seed(5)
    feats, warm, y = mesh_head_inputs(device, gen)
    kernel = head.init_kernel(cfg, gen, device)
    state = head.init_state(cfg, device)
    if state is not None:
        state = fused_apply(cfg, kernel, warm, y[N_MAIN:], state).state
    y = y[:N_MAIN]

    def run(k, st, m):
        """(loss, dx, dw, ms of a second, warm call)."""
        k = torch.nn.Parameter(k)
        for _ in range(2):
            k.grad = None
            f = feats.clone().requires_grad_()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fused_apply(cfg, k, f, y, st, mesh=m)
            out.loss_id.backward()
            torch.cuda.synchronize(device)
        return (out.loss_id.detach(), f.grad, k.grad,
                1e3 * (time.perf_counter() - t0))

    loss_1, dx_1, dw_1, ms_1 = run(kernel, state, None)
    n = c // mesh.model
    cols = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    dw_1 = dw_1[:, cols].clone()
    spec = sharding.spec_for("kernel_w", kernel.shape, c)
    shard = sharding.shard(kernel, spec, mesh)
    st = sharding.shard_head_state(state, c, mesh)
    del kernel, state
    torch.cuda.empty_cache()
    mem = name == "vpl_arcface"
    kernels = MEM_KERNELS if mem else PLAIN_KERNELS
    reset_kernel_counts()
    with first_calls(fh, kernels) as calls:
        loss, dx, dw, ms = run(shard, st, mesh)
    launches = {k: v for k, v in fh.launch_counts.items() if v}
    if launches != {k: 2 for k in kernels}:
        raise AssertionError(f"mesh head {name}: launches {launches}")
    labels = calls[kernels[0]][0][0][4 if mem else 2]
    no_target = int((labels == n + 1).sum())
    if not 0 < no_target < N_MAIN:
        raise AssertionError(f"mesh head {name}: {no_target} of {N_MAIN} "
                             f"rows with no target column in the shard")
    plain_errs, flips = check_recorded(calls, mem)
    del calls
    torch.cuda.empty_cache()
    tol = MESH_HEAD_TOL
    return {"head": name, "num_classes": c, "shard": list(shard.shape),
            "rows_no_target_column": no_target,
            "kernel_vs_plain_max_abs_err": plain_errs,
            "kernel_vs_plain_higher_flips": flips,
            "loss": float(loss), "loss_one_process": float(loss_1),
            "loss_err": close(f"mesh head {name} loss", loss, loss_1,
                              **tol["loss"]),
            "dx_err": close(f"mesh head {name} dx", dx, dx_1,
                            **tol["grads"]),
            "dw_shard_err": close(f"mesh head {name} dw", dw, dw_1,
                                  **tol["grads"]),
            "ms_fwd_bwd": ms, "ms_fwd_bwd_one_process": ms_1,
            "launches": launches}


@contextlib.contextmanager
def count_calls(targets):
    """{name: calls} of each (module, name) in `targets` inside the
    block."""
    counts, kept = {}, {}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for module, name in targets:
        counts[name], kept[(module, name)] = 0, getattr(module, name)
        setattr(module, name, wrap(name, kept[(module, name)]))
    try:
        yield counts
    finally:
        for (module, name), fn in kept.items():
            setattr(module, name, fn)


def mesh_eager_case(name, mesh, device, feats, labels):
    """(5) The eager head of a `--head-path eager` step
    (train/step.eager_apply: head.apply, the mean CE and top-k) on the
    rank's class shard over the model=2 mesh `mesh` at C =
    MESH_EAGER_CLASSES[name], forward and backward on ResNet-50's b512
    features (row 7 labelled -1), against the one-process eager head from
    the same kernel (xavier-uniform, drawn on the card from a seed) and
    state: the loss, dx and the rank's slice of dw within MESH_HEAD_TOL,
    top-1 / top-5, and AdaCos's new scale within MESH_ADACOS_SCALE_RTOL
    relative. The ranks take turns on the one-process head, a barrier
    between turns. Each head is called twice, the second call timed; its
    peak allocated GB counts from before its kernel was made (the
    sharded run's whole kernel, cut to the shard before the run, not
    counted). The sharded run may make no call of gather_classes or
    gather_head_state, and its peak may be at most MESH_EAGER_PEAK_RATIO
    of the one-process one."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.heads import get_head
    from face_recognition_models_tpu_torch.parallel import collectives as coll
    from face_recognition_models_tpu_torch.parallel import sharding
    from face_recognition_models_tpu_torch.train.step import eager_apply

    t_case = time.perf_counter()
    c = MESH_EAGER_CLASSES[name]
    cfg = cfg_lib.make_head_config(name, num_classes=c)
    head = get_head(name)
    width = c * getattr(cfg, "k", 1)
    y = labels[:N_MAIN] % c
    y[7] = -1

    def whole_kernel():
        g = torch.Generator(device=device).manual_seed(9)
        bound = math.sqrt(6.0 / (feats.shape[1] + width))
        return torch.empty((feats.shape[1], width), device=device).uniform_(
            -bound, bound, generator=g)

    def run(kernel, m, base):
        """(loss, dx, dw, new state, acc, ms, peak GB above `base`)."""
        k = torch.nn.Parameter(kernel)
        del kernel
        state = head.init_state(cfg, device)
        for _ in range(2):
            k.grad = None
            f = feats.clone().requires_grad_()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out, loss, acc1, acc5 = eager_apply(head, cfg, k, f, y, state,
                                                mesh=m)
            loss.backward()
            torch.cuda.synchronize(device)
        ms = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated(device) - base) / 1e9
        return (loss.detach(), f.grad, k.grad, out.state,
                [float(acc1), float(acc5)], ms, peak)

    n = width // mesh.model
    cols = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    one = None
    for turn in range(mesh.model):
        if turn == mesh.model_index:
            gc.collect()
            torch.cuda.empty_cache()
            free_gb = torch.cuda.mem_get_info(device)[0] / 1e9
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            loss, dx, dw, st, acc, ms, peak = run(whole_kernel(), None, base)
            one = (loss, dx, dw[:, cols].clone(), st, acc, ms, peak)
            del dw
            torch.cuda.empty_cache()
        coll.barrier(mesh)
    loss_1, dx_1, dw_1, st_1, acc_1, ms_1, peak_1 = one
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    whole = whole_kernel()
    shard = sharding.shard(whole, sharding.spec_for("kernel_w", whole.shape,
                                                    c), mesh)
    del whole
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with count_calls([(coll, "gather_classes"),
                      (sharding, "gather_head_state")]) as gathers:
        loss, dx, dw, st, acc, ms, peak = run(shard, mesh, base)
    del shard
    tol = MESH_HEAD_TOL
    out = {"head": name, "num_classes": c, "shard": [feats.shape[1], n],
           "loss": float(loss), "loss_one_process": float(loss_1),
           "loss_err": close(f"mesh eager {name} loss", loss, loss_1,
                             **tol["loss"]),
           "dx_err": close(f"mesh eager {name} dx", dx, dx_1,
                           **tol["grads"]),
           "dw_shard_err": close(f"mesh eager {name} dw", dw, dw_1,
                                 **tol["grads"]),
           "acc": acc, "acc_one_process": acc_1,
           "ms_fwd_bwd": ms, "ms_fwd_bwd_one_process": ms_1,
           "peak_gb": peak, "peak_gb_one_process": peak_1,
           "peak_ratio": peak / peak_1, "gather_calls": gathers,
           "device_free_gb_before_one_process": free_gb}
    del dx, dw, dx_1, dw_1
    torch.cuda.empty_cache()
    if st is not None:
        rel = float(((st.s - st_1.s).abs() / st_1.s.abs()).max())
        out["scale"], out["scale_one_process"] = float(st.s), float(st_1.s)
        out["scale_rel_err"] = rel
        if not rel <= MESH_ADACOS_SCALE_RTOL:
            raise AssertionError(f"mesh eager {name}: new scale {out['scale']}"
                                 f" against {out['scale_one_process']}")
    if acc != acc_1:
        raise AssertionError(f"mesh eager {name}: top-1 / top-5 {acc} "
                             f"against {acc_1}")
    if any(gathers.values()):
        raise AssertionError(f"mesh eager {name}: class axis gathered "
                             f"{gathers}")
    if not peak <= MESH_EAGER_PEAK_RATIO * peak_1:
        raise AssertionError(f"mesh eager {name}: peak {peak:.3f} GB over "
                             f"{MESH_EAGER_PEAK_RATIO} x the one-process "
                             f"{peak_1:.3f} GB")
    out["seconds"] = time.perf_counter() - t_case
    return out


def mesh_pfc_run(mesh, device, root):
    """(3) + (4) `fit` of the class-sharded Partial-FC (ResNet-50 + ArcFace,
    ratio 0.1, C = PFC_CLASSES, b512) over a model=2 mesh for MESH_STEPS
    steps: finite losses, step 1 writes exactly the shard's sampled
    columns of kernel_w and kernel_mom (the sample replayed from a copy of
    the step generator), then the state saved by the world into
    `root`/mesh_pfc with every class shard gathered on rank 0. Returns
    the losses, ms/step, peak GB and the fingerprints of the rank's
    shards and backbone."""
    import torch

    from face_recognition_models_tpu_torch import config as cfg_lib
    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.data.pipeline import ArrayLoader
    from face_recognition_models_tpu_torch.train.loop import fit
    from face_recognition_models_tpu_torch.train.partial_fc import (
        num_sampled_classes)
    from face_recognition_models_tpu_torch.train.partial_fc_sharded import (
        local_sample_from_draws)

    c = PFC_CLASSES
    c_local = c // mesh.model
    c_s_local = num_sampled_classes(c_local, PFC_RATIO, N_MAIN)
    offset = mesh.model_index * c_local
    rs = np.random.RandomState(14)
    images = rs.randint(0, 256, (MESH_STEPS * N_MAIN, MESH_IMAGE,
                                 MESH_IMAGE, 3), np.uint8)
    labels = rs.randint(0, c, MESH_STEPS * N_MAIN).astype(np.int32)
    seen = {}

    def before(state):
        if state.step == 0:
            g = torch.Generator(device=device)
            g.set_state(state.rng.get_state())
            scores = torch.rand((mesh.model, c_local + 1), generator=g,
                                device=device)[mesh.model_index]
            shift = torch.randint(0, c_local, (mesh.model,), generator=g,
                                  device=device)[mesh.model_index]
            cls, valid, _ = local_sample_from_draws(
                torch.as_tensor(labels[:N_MAIN], device=device), c_local,
                min(N_MAIN, c_local), c_s_local, offset, scores, shift)
            seen["sampled"] = torch.zeros(c_local, dtype=torch.bool,
                                          device=device)
            seen["sampled"][cls[valid]] = True
            seen["w"] = state.kernel_w.detach().clone()
            seen["m"] = state.kernel_mom.clone()

    def after(state):
        if state.step == 1:
            for key, now in (("w", state.kernel_w.detach()),
                             ("m", state.kernel_mom)):
                moved = (now != seen.pop(key)).any(0)
                if not torch.equal(moved, seen["sampled"]):
                    raise AssertionError(
                        f"mesh partial_fc: step 1 wrote {int(moved.sum())} "
                        f"columns of kernel_{key} on shard "
                        f"{mesh.model_index}, "
                        f"{int((moved & ~seen['sampled']).sum())} outside "
                        f"the {int(seen['sampled'].sum())} sampled")

    cfg = pfc_cfg(c, mesh=cfg_lib.MeshConfig(data=1, model=mesh.model),
                  backbone=MESH_BACKBONE,
                  data=cfg_lib.DataConfig(image_size=MESH_IMAGE))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_kernel_counts()
    with observe_steps(after, before,
                       factory="make_sharded_partial_fc_train_step"):
        res = fit(cfg, ArrayLoader(images, labels, N_MAIN, shuffle=False,
                                   seed=0), device=device, mesh=mesh)
    torch.cuda.synchronize(device)
    no_kernel_launched("mesh partial_fc")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"mesh partial_fc: losses {res.losses}")
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(root, "mesh_pfc"), "arcface").save(
        res.state, 1, res.losses[-1], mesh=mesh)
    save_s = time.perf_counter() - t0
    state = res.state
    return {"num_classes": c, "shard": list(state.kernel_w.shape),
            "num_sampled_local": c_s_local, "losses": res.losses,
            "sampled_step1": int(seen["sampled"].sum()),
            "ms_per_step_after_1": 1e3 * float(np.mean(
                res.step_seconds[1:])),
            "peak_gb": peak, "save_s": save_s,
            "fingerprint": {
                "kernel_w": fingerprint(state.kernel_w),
                "kernel_mom": fingerprint(state.kernel_mom),
                "backbone": fingerprint(backbone_params(state))}}


def mesh_rank_main(rank, world, port, root, backend):
    """One rank of the mesh phase, in its own process: joins the group,
    runs the checks and writes its results to `root`/rank<r>.pkl."""
    import datetime

    import torch

    from face_recognition_models_tpu_torch.config import MeshConfig
    from face_recognition_models_tpu_torch.parallel import dist as pdist
    from face_recognition_models_tpu_torch.parallel import make_mesh

    device = pdist.initialize(
        backend=backend, device=f"cuda:{rank if backend == 'nccl' else 0}",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out = {"rank": rank, "backend": backend, "device": str(device)}
    try:
        if backend == "gloo":
            out["collectives"] = mesh_probe_collectives(device)
        dp_mesh = make_mesh(MeshConfig(data=world, model=1))
        out["dp"] = {dtype: mesh_dp_run(dp_mesh, device, dtype)
                     for dtype in MESH_TOL}
        if backend == "gloo":
            out["dp_faults"] = {"bfloat16": {
                fault: mesh_dp_run(dp_mesh, device, "bfloat16", fault)
                for fault in MESH_FAULTS}}
        head_mesh = make_mesh(MeshConfig(data=1, model=world))
        out["head"] = [mesh_head_case(name, head_mesh, device)
                       for name in ("arcface", "vpl_arcface")]
        torch.cuda.empty_cache()
        feats, _, labels = mesh_head_inputs(device,
                                            torch.Generator().manual_seed(5))
        if backend == "gloo":
            # the ranks' rows must be the same features
            torch.distributed.broadcast(feats, src=0)
        out["eager"] = [mesh_eager_case(name, head_mesh, device, feats,
                                        labels)
                        for name in MESH_EAGER_CLASSES]
        del feats, labels
        torch.cuda.empty_cache()
        if backend == "gloo":
            out["pfc"] = mesh_pfc_run(head_mesh, device, root)
    finally:
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        pdist.shutdown()
    return 0


def mesh_world(root, backend, entry=None):
    """Run the ranks of the mesh phase (`entry`, this script by default,
    with --mesh-rank) and return their results; a rank that fails or times
    out fails the phase (every rank is stopped)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, entry or os.path.abspath(__file__),
         "--mesh-rank", str(r),
         "--mesh-port", str(port), "--mesh-root", root,
         "--mesh-backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_WORLD)]
    logs = []
    try:
        deadline = time.monotonic() + MESH_TIMEOUT_S + 60
        for p in procs:
            logs.append(p.communicate(timeout=max(
                1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for log in logs:
        sys.stderr.write(log[-6000:])
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"mesh rank {r} ({backend}) exited "
                                 f"{p.returncode}")
    out = []
    for r in range(MESH_WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def mesh_dp_drifts(world, ref, init):
    """The step-1 update drifts of a world run against the one-process run
    `ref`: the whole parameter vector's and the classifier's (kernel_w, the
    last D_MAIN x C_MAIN values of params_of), each relative to the
    one-process update; and the final parameters' drift."""
    head = D_MAIN * C_MAIN

    def drift(a, b, part=slice(None)):
        return float((a[part] - b[part]).norm()
                     / (b[part] - init[part]).norm())

    return (drift(world["step1"], ref["step1"]),
            drift(world["step1"], ref["step1"], slice(-head, None)),
            drift(world["final"], ref["final"]))


def mesh_dp_verdict(worlds, ref, init, tol):
    """(metrics, [the checks that the world run breaks]) of a data=2 run
    (`worlds`: every rank's mesh_dp_run, rank 0 first) against the
    one-process run on the same batches: the bounds of `tol`, and
    "ranks_bitwise_equal" (losses, parameters, BatchNorm running
    statistics)."""
    world = worlds[0]
    rel = [abs(a - b) / abs(b) for a, b in zip(world["losses"],
                                                ref["losses"])]
    drift1, head1, drift = mesh_dp_drifts(world, ref, init)
    # a non-finite value breaks its bound
    broken = [name for name, value in (
        ("step1_loss_rtol", rel[0]), ("loss_rtol", max(rel)),
        ("step1_update_drift", drift1), ("step1_head_drift", head1))
        if not value <= tol[name]]
    keys = ("losses", "fingerprint", "buffers")
    if any(w[k] != world[k] for w in worlds for k in keys):
        broken.append("ranks_bitwise_equal")
    return {"losses": world["losses"], "loss_rel_err": rel,
            "step1_update_drift": drift1, "step1_head_drift": head1,
            "final_update_drift": drift}, broken


def mesh_check_dp(ranks, ref, init, dtype):
    """(1): both ranks' losses, parameters and BatchNorm running statistics
    equal each other bit for bit and the one-process run's within MESH_TOL;
    K1 / K2 once a step; in bf16 every planted fault (MESH_FAULTS) breaks a
    check."""
    dp = [r["dp"][dtype] for r in ranks]
    tol = dict(MESH_TOL[dtype])
    if dtype == "bfloat16":
        # the bf16 noise: the one-process bf16 step against the fp32 one
        whole, head, _ = mesh_dp_drifts(ref["bfloat16"], ref["float32"], init)
        tol["step1_update_drift"] = MESH_BF16_DRIFT_FACTOR * whole
        tol["step1_head_drift"] = MESH_BF16_DRIFT_FACTOR * head
        if tol["step1_head_drift"] >= 1.0:
            raise AssertionError(f"mesh dp bf16: the classifier's drift bound "
                                 f"{tol['step1_head_drift']} is not under 1")
    ref = ref[dtype]
    want = {k: MESH_STEPS for k in PLAIN_KERNELS}
    for r, d in enumerate(dp):
        if d["launches"] != want:
            raise AssertionError(f"mesh dp rank {r}: launches "
                                 f"{d['launches']}")
    metrics, broken = mesh_dp_verdict(dp, ref, init, tol)
    faults = {}
    for fault in ranks[0].get("dp_faults", {}).get(dtype, {}):
        metrics_f, broken_f = mesh_dp_verdict(
            [r["dp_faults"][dtype][fault] for r in ranks], ref, init, tol)
        faults[fault] = {**metrics_f, "broken": broken_f}
    out = {"compute_dtype": dtype, **metrics,
           "losses_one_process": ref["losses"], "tolerance": tol,
           "planted_faults": faults,
           "ms_per_step_after_1": [d["ms_per_step_after_1"] for d in dp],
           "ms_per_step_one_process": ref["ms_per_step_after_1"],
           "peak_gb": [d["peak_gb"] for d in dp],
           "peak_gb_one_process": ref["peak_gb"],
           "launches_per_rank": dp[0]["launches"]}
    missed = [f for f, v in faults.items() if not v["broken"]]
    if broken or missed or (dtype == "bfloat16"
                            and sorted(faults) != sorted(MESH_FAULTS)):
        emit({"phase": "mesh", "part": f"dp_{dtype}", "failed": True, **out})
        raise AssertionError(
            f"mesh dp {dtype} against one process: bounds broken {broken}, "
            f"planted faults no bound caught {missed} (of {sorted(faults)})")
    return out


def mesh_check_restore(ranks, root, device="cuda"):
    """(4): the world's checkpoint loaded in one process equals the ranks'
    shards bit for bit."""
    import torch

    from face_recognition_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from face_recognition_models_tpu_torch.config import make_head_config
    from face_recognition_models_tpu_torch.train.loop import make_recipe

    from face_recognition_models_tpu_torch.config import DataConfig

    cfg = pfc_cfg(PFC_CLASSES, backbone=MESH_BACKBONE,
                  data=DataConfig(image_size=MESH_IMAGE))
    _, state, _ = make_recipe(
        cfg, make_head_config("arcface", num_classes=PFC_CLASSES),
        torch.device(device))
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(root, "mesh_pfc"), "arcface").restore(
        state)
    restore_s = time.perf_counter() - t0
    n = PFC_CLASSES // MESH_WORLD
    for r in ranks:
        cols = slice(r["rank"] * n, (r["rank"] + 1) * n)
        got = {"kernel_w": fingerprint(state.kernel_w[:, cols]),
               "kernel_mom": fingerprint(state.kernel_mom[:, cols]),
               "backbone": fingerprint(backbone_params(state))}
        if got != r["pfc"]["fingerprint"]:
            raise AssertionError(f"mesh checkpoint: rank {r['rank']}'s "
                                 f"shards {r['pfc']['fingerprint']} != the "
                                 f"restored {got}")
    size = os.path.getsize(os.path.join(root, "mesh_pfc", "epoch_1"))
    del state
    torch.cuda.empty_cache()
    return {"bitwise": True, "file_gb": size / 1e9, "restore_s": restore_s}


def phase_mesh(root):
    """The ('data', 'model') mesh on the card (see the module docstring).
    Returns {kernel: launches} of the ranks' main-path runs."""
    import torch

    from face_recognition_models_tpu_torch.ops import _build
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi

    t0 = time.perf_counter()
    _build.build()
    init = mesh_initial_params()
    ref = {dtype: mesh_dp_reference(dtype) for dtype in MESH_TOL}
    # the ranks share the card with this process: free what earlier phases
    # left to the collector (CUDA graphs' pools, states in cycles) and the
    # cache, and record what stays
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "mesh", "part": "main_process_memory",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9,
          "device_free_gb": free / 1e9, "device_total_gb": total / 1e9})
    ranks = mesh_world(root, "gloo")
    note = ("two ranks share one card over gloo: times and memory are not "
            "a scaling figure")
    launches = {}
    for r in ranks:
        for part in [*r["dp"].values(), *r["head"]]:
            for k, v in part["launches"].items():
                launches[k] = launches.get(k, 0) + v
    emit({"phase": "mesh", "part": "collectives", "backend": "gloo",
          "tensors": "cuda", "by_rank": [r["collectives"] for r in ranks]})
    for dtype in MESH_TOL:
        emit({"phase": "mesh", "part": f"dp_{dtype}", "mesh": [MESH_WORLD, 1],
              "backbone": MESH_BACKBONE, "head": "arcface",
              "num_classes": C_MAIN, "global_batch": N_MAIN,
              "steps": MESH_STEPS,
              **mesh_check_dp(ranks, ref, init, dtype), "note": note})
    for i, name in enumerate(("arcface", "vpl_arcface")):
        emit({"phase": "mesh", "part": f"head_{name}",
              "mesh": [1, MESH_WORLD], "tolerance": MESH_HEAD_TOL,
              "kernel_vs_plain_tolerance": TOLERANCE,
              "by_rank": [r["head"][i] for r in ranks], "note": note})
    for i, name in enumerate(MESH_EAGER_CLASSES):
        emit({"phase": "mesh", "part": f"head_eager_{name}",
              "mesh": [1, MESH_WORLD], "tolerance": MESH_HEAD_TOL,
              "peak_ratio_bound": MESH_EAGER_PEAK_RATIO,
              "by_rank": [r["eager"][i] for r in ranks],
              "nvidia_smi": nvidia_smi(), "note": note})
    restore = mesh_check_restore(ranks, root)
    emit({"phase": "mesh", "part": "partial_fc", "mesh": [1, MESH_WORLD],
          "by_rank": [r["pfc"] for r in ranks], "checkpoint": restore,
          "note": note})
    if torch.cuda.device_count() >= MESH_WORLD:
        for r in mesh_world(root, "nccl"):
            emit({"phase": "mesh", "part": "nccl", "rank": r["rank"],
                  "dp": {dtype: {k: v for k, v in d.items()
                                 if k not in ("step1", "final")}
                         for dtype, d in r["dp"].items()},
                  "head": r["head"]})
    else:
        print(f"mesh: NCCL not run ({torch.cuda.device_count()} card; "
              f"it needs {MESH_WORLD})", flush=True)
    emit({"phase": "mesh", "launches": launches, "nvidia_smi": nvidia_smi(),
          "seconds": time.perf_counter() - t0, "ok": True})
    return launches


ONLY_PHASES = {"partial_fc": phase_partial_fc, "facenet": phase_facenet,
               "mesh": phase_mesh, "detect": phase_detect}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="",
                        help="run just these comma-separated phases of "
                             f"{sorted(ONLY_PHASES)} (no build, no kernels "
                             "line, no result line)")
    # a rank of the mesh phase (its own process; mesh_world starts it)
    parser.add_argument("--mesh-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-root", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-backend", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.mesh_rank is not None:
        return mesh_rank_main(args.mesh_rank, MESH_WORLD, args.mesh_port,
                              args.mesh_root, args.mesh_backend)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from face_recognition_models_tpu_torch.ops import _build
    from face_recognition_models_tpu_torch.utils.device import nvidia_smi

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if args.only:
        with tempfile.TemporaryDirectory() as root:
            for name in args.only.split(","):
                ONLY_PHASES[name](root)
        return 0

    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "entry function" in ln or "registers" in ln
                        or "spill" in ln or "wgmma" in ln]
                    for k, v in reports.items()}})

    rows = phase_kernels()
    rows += phase_conv()
    launches = phase_train()
    phase_heads()
    with tempfile.TemporaryDirectory() as root:
        phase_pretrained(root)
    for name, count in phase_scan().items():
        launches[name] += count
    with tempfile.TemporaryDirectory() as root:
        for name, count in phase_recipe(root).items():
            launches[name] += count
    launches.update(phase_head_bf16())
    launches.update(phase_conv_bench())
    f32_plain_ms = phase_conv_f32()
    device = phase_device_times()
    phase_gather()
    with tempfile.TemporaryDirectory() as root:
        run_a = phase_checkpoint(root)
        phase_eval(root, run_a)
        del run_a
        torch.cuda.empty_cache()
        phase_facenet(root)
    torch.cuda.empty_cache()
    phase_train_packed()
    phase_decode()
    torch.cuda.empty_cache()
    embed_img_per_s = phase_bench_embed()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        artifact = phase_serve(root, embed_img_per_s)
        torch.cuda.empty_cache()
        phase_detect(root, artifact)
    torch.cuda.empty_cache()
    for name, count in phase_backbones().items():
        launches[name] += count
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        phase_partial_fc(root)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        for name, count in phase_mesh(root).items():
            launches[name] = launches.get(name, 0) + count
    torch.cuda.empty_cache()
    for name, count in phase_convergence().items():
        launches[name] += count
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] == "conv3x3_same_f32":
            r["plain_ms"] = f32_plain_ms
        if r["name"] in device:
            r["device_ms"] = device[r["name"]]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
