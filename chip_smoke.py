#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (thyroid_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its lines before the final one:
1. build: compile every kernel of thyroid_tpu_torch/csrc with nvcc for
   sm_90a (one nvcc per source, in parallel; each source's nvcc time is
   printed), count the wgmma (HGMMA) instructions of the tensor-core
   libraries in cuobjdump's SASS and inside each tensor-core kernel's own
   functions (kernels 2, 3, 4, 7, 8, 9, 10, 11), the TF32 mma.sync (HMMA)
   instructions of kernels 4's and 7's attention cores and of kernels 5
   and 6 (the training attention), and the async copies (LDGSTS) of the
   depthwise kernel (17), the stencil (13) and row 8's wgmma kernel; the
   phase fails at 0 in any instantiation; then print the card's name and
   power limit as nvidia-smi reports them;
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   same inputs, at every shape the swin_tiny forward gives it at batch 32,
   in float32 (TF32 off for matmuls and convolutions) and in bfloat16; the
   block attention's two runs bit-equal, the percentile kernel bit-equal;
3. slice: InferenceEngine serves swin_tiny (bf16, full width and depth,
   seeded and perturbed weights) on raw 512x512 frames; the launch counters
   must move by 1, 15, 12 and 12 per forward, and the probabilities must
   agree with the same engine on the CPU in float32; the percentile
   kernel's launch (cluster, staging, shared memory, registers) at buckets
   32 and 128 in float32 and bf16;
4. times: each kernel's median time per forward at bucket 32 beside its
   bound, its plain version and a library yardstick (in device time, from
   CUDA-graph replays; the percentile kernel in float32, the type the
   served path resizes into), the percentile kernel at buckets 32 and 128
   in float32 and bf16 on fixed seeded batches (device and CUDA-event
   times, its library's, its launch and the SHA-256 of its output), and
   end-to-end images/s of predict at buckets 32 and 128; a profile of one
   predict;
5. train kernels: the training attention's forward and backward kernels
   against their plain versions (output, dqkv, dbias) at every shape a
   swin_tiny train step gives them at batch 32, in float32 and bfloat16;
6. train slice: one train step of full-width swin_tiny (float32, drop path
   0, batch 8) on the card against the same step on the CPU (loss and
   gradients), the bf16 step's loss against it, then Trainer.fit for one
   epoch of 256 raw 512x512 frames at batch 32 with validation on 64 and
   test(checkpoint=best): the counters must move by 12 forward and 12
   backward attention launches per train step, 15/12/12 serving launches
   per eval forward and one percentile launch per pipeline;
7. train times: each training kernel's median time per train step beside
   its bound, plain version and library yardstick, training images/s at
   batch 32 and 128, and a profile of one train step at batch 32;
8. quality kernels: the quality pipeline's kernels (statistics, stencil,
   CLAHE apply, dual-grid CLAHE apply) against their plain versions on a
   32-frame chunk of raw 512x512 synthetic frames, at grids 16x16 and
   32x32, with the dual apply on a mixed per-image grid choice; two runs
   of the statistics and the stencil bit-equal; the SHA-256 of their
   outputs and of the CLAHE applies' on the chunk and the launch of each
   (cluster, shared memory and registers of the statistics kernel; tile,
   shared memory, registers and grid of the stencil);
9. quality slice: InferenceEngine(quality=True) serves swin_tiny at buckets
   32 and 128 on frames in which every quality branch fires (counted on
   the CPU); per 32-frame chunk the statistics, stencil, dual apply and
   percentile kernels launch once each and the single apply never; the
   card's quality stage and prepared images, and its probabilities, are
   held against the CPU; quality_preprocess(merged=False) launches the
   single apply twice and gives the merged path's output; the SHA-256 of
   the statistics' and the stencil's outputs on the 8 frames held
   against the CPU, and their launches there;
10. quality times: each quality kernel's median time per 32-frame chunk
   (in device time, from CUDA-graph replays, beside the CUDA-event time;
   their launches and output hashes on the chunk) beside its bound and
   its plain version, the
   statistics also beside its library call (in device time too), images/s of predict with and
   without the quality pipeline at buckets 32 and 128, the time of
   DevicePipeline(quality_preprocessing=True) over 256 frames (its launch
   counts checked) with the histogram/LUT chain timed apart, and a profile
   of one quality predict at bucket 32;
11. token train kernels: the token backward kernels (LN + matmul dX/dgamma/
   dbeta; LN + MLP dX/dgamma/dbeta and dW1/db1/dW2) and the LN + MLP
   forward without its residual, against their plain versions at every
   shape a swin_tiny train step with train_token_kernels gives them at
   batch 32, in float32 and bfloat16;
12. token train slice: one float32 train step (batch 8, drop path 0) of
   full-width swin_tiny with train_token_kernels on the card against the
   same step on the CPU and against phase 6's card step without the flag,
   the bf16 step's loss against it, then Trainer.fit for one epoch of 256
   raw 512x512 frames at batch 32 with validation on 64 and
   test(checkpoint=best): per train step 12 launches each of the LN+QKV
   forward, the LN+MLP forward without residual, the three token backward
   kernels and the attention forward and backward; 15/12/12 per eval
   forward;
13. token train times: each token backward kernel's and each token
   training forward's median time per train step beside its bound, plain
   version and library yardstick (torch.autograd.grad through LayerNorm +
   linear (+ GELU + linear); the backward kernels and their yardsticks in
   device time, from CUDA-graph replays: for a yardstick, of forward +
   backward less the forward), training images/s at batch 32 and 128 with
   the flag on beside the flag off, and a profile of one flagged train step
   at batch 32;
14. depthwise kernel: the stride-1 depthwise kernel (Q2-17) against its
   plain version at every stride-1 depthwise shape of efficientnet_b0 at
   batch 32 and 224x224 and of efficientnet_b3 at batch 8 and 300x300 (odd
   sides), in float32 and bfloat16, bit-equal, and one backward of its
   autograd Function against autograd through the plain version;
15. efficientnet slice: with seeded, perturbed weights and running
   statistics (a train-mode forward's batch statistics, perturbed),
   InferenceEngine serves efficientnet_b0 (bf16, dw_pallas_conv) on raw
   512x512 frames at buckets 32 and 128: the depthwise kernel launches 12
   times and the percentile kernel once per forward; the probabilities
   agree with the CPU float32 engine, and with the same engine without the
   flag on the card (no depthwise launch); one float32 train step (batch
   8, dropout and drop path 0) on the card is held against the CPU (loss,
   gradients, updated statistics); then Trainer.fit (configs/training/
   cnn.yaml, the default trainer, the flag on) for one epoch of 256 frames
   at batch 32 with validation on 64, and test(checkpoint=best): 12
   depthwise launches per eval forward and none per train step;
16. efficientnet times: the depthwise kernel's device time per forward at
   bucket 32 (ten calls in one CUDA graph, replayed between CUDA events;
   beside it the CUDA-event time of one call, which its host launch
   dominates) beside its bound, its plain version
   and cuDNN's depthwise convolution (F.conv2d with groups=C) on the same
   inputs, images/s of predict at buckets 32 and 128 with the flag on and
   off, training images/s at batch 32 and 128, and a profile of one predict
   and one train step at batch 32;
17. remaining kernels: LN + QKV + W-MSA (row 7, fused_swin_ln_attention)
   and the per-window attention (row 8, fused_window_attention) against
   their plain versions at every swin_tiny serving block shape at batch 32,
   in float32 (2e-5 of max(1, max|plain|)) and bf16, row 8 also at
   swin_large's stage 4 (48 heads), with the kernel that took each shape
   (bf16 must take wgmma) and two runs bit-equal; the fused dual CLAHE
   apply (row 16) bit-equal to its plain version on phase 8's chunk, with
   the quality pipeline's per-image flags; WindowAttention(ln_kernel=True)
   against ln_kernel=False (kernels 2 + 5 + projection) in float32; then
   the main-path run, counted: the module with ln_kernel on the 12 blocks,
   the per-window attention on their windows, the CLAHE on the chunk;
18. swin_tiny as configs/model/vit/swin_tiny.yaml builds it (medical
   adaptations; bf16; seeded, bumped weights, contrast scales off 1):
   served at buckets 32 and 128 with 1, 3, 12 and 0 launches of the
   percentile, LN+matmul, LN+MLP and block-attention kernels per forward,
   the probabilities held against the CPU float32 engine; a float32 train
   step (batch 8, drop path 0) against the CPU; Trainer.fit for one epoch
   of 256 frames with validation on 64 and test(checkpoint=best);
19. swin_medical.yaml at full depth (2, 2, 18, 2) and 256², padding in
   every stage and drop_rate 0.05: served at bucket 32 (1, 3, 24 launches
   per forward) against the CPU, and one bf16 train step at batch 32 with
   the uncertainty head's output, finite;
20. times: rows 7 and 8 per swin_tiny forward at bucket 32 and row 16 per
   chunk (device time from CUDA-graph replays) beside their bounds, plain
   versions and library calls (LayerNorm + linear + SDPA; SDPA; none), row
   7 also beside kernels 2 + 5 and row 16 beside clahe_uint16_dual + where;
   images/s of predict for the YAML swin_tiny beside the registry one at
   buckets 32 and 128, its training images/s at batch 32 and 128, and a
   profile of one YAML predict;
21. tensor-core kernels: the wgmma LN + MLP forward (row 3) against its
   plain version at swin_medical.yaml's 256² shapes (float32 and bf16) and
   at the swin_base / swin_large widths 512-1536 (float32 and bf16), the
   wgmma LN + MLP dX (row 10) at width 512, the LN + matmul (row 2) at
   swin_medical's 256² merges and swin_base's and swin_large's widest QKV
   and merges, and the LN + MLP weight gradients (row 11) at swin_base's
   widths 128-512 (float32 and bf16 each), the block attention (row 4) in
   bf16 at swin_base's and swin_large's four stage shapes (widths up to
   1536; two runs bit-equal) and in float32 at their last two stages
   (widths 512-1536), the training attention forward and backward (rows 5
   and 6) in bf16 at the same eight stage shapes (two runs bit-equal in
   out, dqkv and dbias), LN + QKV + W-MSA (row 7) in bf16 at swin_large's
   stage 4 (C = 1536, 48 heads, 7x7 maps, batch 32; two runs bit-equal)
   with its device time and the SHA-256 of its output at swin_tiny's
   widths, the per-window attention (row 8) in bf16 at swin_large's stage
   4 on wgmma (two runs bit-equal; its device time beside SDPA's) and in
   float32 per swin_tiny forward and at that shape (device times), the
   SHA-256 of row 8's outputs, and row 3's time per swin_medical forward
   at bucket 32 beside the library composition's device time;
22. swin_large in float32 ({"name": "swin_large"}: no dtype, as the
   registry resolves it; stage 4 at C = 1536): InferenceEngine serves it
   on the card at bucket 4 on raw 512x512 frames with seeded, perturbed
   weights; the counters, set to 0 just before, must move by 1, 27, 24
   and 24 (percentile, LN + matmul, LN + MLP, block attention) per
   forward, and the probabilities must agree with the CPU float32 engine
   on the same weights and frames;
23. experiment: the 450-frame 512x512 synthetic corpus written by the
   port's generate_corpus (time, frames/s, its _meta.json stamp), the 16
   committed data/synthetic_tiny PNGs decoded pixel-equal to
   generate_image, the corpus decoded by load_images (frames/s), then
   launch_experiment (model=cnn/efficientnet_b0 dataset=synthetic
   training=cnn augmentation=no_aug, one epoch, 2 folds, every path under
   build/chip_smoke): the generated fold files equal data/splits', both
   folds succeed with finite averages, the summary holds the k-fold
   summary's keys, and, with every counter set to 0 just before, kernels
   12, 13, 15 and 1 launch once per 32-frame chunk of each split (32) and
   no other kernel launches; and the committed decoding fixtures of
   tests/fixtures/imageio (a 512x512 LZW uint16 TIFF, a 512x512 baseline
   gray JPEG, a 512x512 progressive 4:2:0 colour JPEG and the small TIFF,
   PNG and JPEG variants) decoded on the host, each equal to the SHA-256
   of cv2's array stored beside them, the ms per frame of each beside a
   512x512 PNG's, and a corpus of the 512x512 ones through load_images;
24. augmentation and ResNet: (a) train_augment at light, medium and heavy,
   vit_augment (m = 9) and mixup_cutmix (α 0.8 / 1.0) at batch 32, 224x224,
   on parameters drawn once on the CPU and copied to the card, card
   against CPU (at most 1e-4 of the elements more than 1e-5 apart, none
   more than 1/255 + 1e-5), and two card runs from one generator seed
   bit-equal; (b) the median time of 20 DevicePipeline.make_batch calls at
   levels none, light, medium and heavy and in vit mode, the CUDA kernels
   one augmented batch launches (torch.profiler), and a resnet50 train
   step at batch 32 with a medium-level batch and with an unaugmented one;
   (c) resnet50 (bf16, seeded and bumped weights, running statistics from a
   train-mode forward) served at bucket 32 (images/s, median of 5; one
   percentile launch per forward, no other kernel), its card float32 and
   bf16 engines against the CPU's float32 and bf16 engines (N = 8), each
   block's bf16 error on the card, and one float32 train step (batch 8,
   dropout 0) against the CPU's step on the card's ReLU decisions and
   max-pool choices (loss, gradients globally and in each leaf, updated
   running statistics), with phase 25's code; (d) launch_experiment of the
   root default composition (resnet50, dataset cars, level medium; no
   group override), then experiment=swin_baseline and
   experiment=test_resnet18_kfold_quick, each on phase 23's corpus and
   fold files, cut to 2 folds of one epoch: both folds succeed with finite
   averages and the summary's keys, the fold files stay data/splits', and,
   with every counter set to 0 just before each run, kernel 1 launches once
   per prepared split, swin_baseline's eval forwards launch 3 LN + matmul
   and 12 LN + MLP each, and no other kernel launches;
25. the rest of the zoo: (a) kernels 2 and 3 against their plain versions
   at ViT's and DeiT's token counts at bucket 32 (T = 32·197 and 32·198,
   not multiples of 64) and widths 192, 384 and 768, in float32 and bf16,
   two runs bit-equal; (b) vit_tiny, deit_tiny and vit_base (bf16, seeded
   and bumped weights) served at bucket 32 on raw 512x512 frames: exactly
   1 percentile, 12 LN + QKV and 12 LN + MLP launches per forward and no
   other kernel, none of kernels 2-3 with token_kernels false, images/s
   (median of 5), the card's float32 and bf16 engines against the CPU's
   float32 and bf16 engines (N = 8), and kernels 2 and 3 timed at the
   served shapes beside their bounds, plain versions and library calls;
   (c) densenet121 (224x224) and inception_v3 (299x299, as its YAML)
   served the same way with kernel 1 as their only kernel, the Inception
   pool branch's gradient against the CPU's, and one float32 train step
   each (batch 8, dropout 0; inception_v3's loss
   ce + 0.4·aux) against the CPU's step on the card's ReLU decisions and
   max-pool choices (loss, gradients globally and in each leaf, running
   statistics), and deit_tiny's
   float32 step with the dual loss against the CPU's; (d) the cnn_top3
   ensemble (resnet50, efficientnet_b0, densenet121, float32, seeded
   weights with running statistics) on the card against the CPU for each
   method; (e) launch_experiment for model=vit/deit_tiny training=vit and
   model=cnn/inception_v3 training=cnn on phase 23's corpus and fold files,
   cut to 2 folds of one epoch, with phase 24's checks: kernel 1 once per
   prepared split, deit_tiny's eval forwards 12 LN + QKV and 12 LN + MLP
   launches each, no other kernel; (f) the other new names (vit_small,
   deit_small, deit_base, densenet161/169/201, inception_v4 at 299x299)
   each served once at bucket 32 (1 percentile launch, 12 or 0 of kernels
   2 and 3) and stepped once in bf16 at batch 8 from seeded weights,
   finite;
26. distillation, the other experiments, the stacked trainer, on phase
   23's corpus: (a) a teacher checkpoint each of resnet50 (phase 24's root
   default fold), efficientnet_b0 and densenet121 (fold 1 of one epoch
   through KFoldExperiment.run_fold) under build/chip_smoke/distill/
   checkpoints; (b, c) the deit_tiny_distill_resnet50 and
   deit_small_distill_ensemble presets through launch_experiment from
   there (their relative teacher paths resolve), 2 folds of one epoch,
   with phase 24's checks and counts (12 + 12 of kernels 2 and 3 per eval
   forward), α per epoch, the three distillation terms in each fold's
   history, the distillation fields of the summary and each teacher's
   weights unchanged by the run; the ensemble teacher on the card against
   the CPU (float32); kernels 2 and 3 at deit_small's T = 32·198, C = 384
   against their plain versions and timed; (d) a distillation step of
   deit_tiny (float32) with the resnet50 teacher against the CPU's on the
   card's teacher logits, and resnet18 steps with SGD, with clipping by
   value and over 2 accumulated mini-steps against the CPU's optimizer
   on the card's gradients and against the CPU's step on the card's
   decisions; (e) the ablation_augmentation preset's 8 runs, cut to one
   epoch of 3 batches, with exact quality-kernel counts; (f) the
   all-models sweep over resnet18 and deit_tiny with exact counts, only
   each model's best checkpoint left; (g) test_resnet18_kfold_quick with
   kfold.stacked, 2 folds of 2 epochs, against the sequential sweep per
   epoch, its export in the sequential layout, and the fall-back at 4
   unequal folds;
27. analysis, on phase 23's corpus and phase 26's checkpoints, float32
   card against CPU at 1e-3 of max(1, max|CPU|): (a) capture forwards of
   resnet50, densenet121, efficientnet_b0 (224x224), inception_v3
   (299x299), vit_tiny, deit_tiny and the registry swin_tiny (perturbed):
   every captured tensor, the keys in the same order, no kernel launched;
   (b) GradCAM of resnet50, swin_tiny and deit_tiny (class, heatmap,
   confidence, no kernel, ms per image), vit_tiny's and deit_tiny's
   class-token heatmap and rollout, swin_tiny's stage maps, vit_tiny's
   gradient patch importance without its kernels and through kernels 2-3
   and their backward kernels (12 launches each of 2, 3, 9, 10, 11), and
   swin_tiny's serving attention refusing autograd; (c) evaluate_checkpoint
   with and without TTA of a registry swin_tiny checkpoint and the
   all-models sweep's deit_tiny checkpoint, as stored (bf16, 3e-2) and in
   float32 (1e-3), on 16 frames: exact launches (kernel 1 once for the
   pipeline; 15/12/12 or 12/12 of kernels 2/3/4 per forward, x5 with TTA),
   the reports' decisions equal but within the tolerance of 0.5, and
   images/s with and without TTA; (d) the ensemble-kfold CLI over phase
   26's three teachers (fold 1) with every mode's and member's report
   finite, and the members card against CPU on the 16 frames; (e) the
   quality-report CLI on the card and the CPU, issue lists equal; (f)
   Trainer.fit of deit_tiny with attention-map logging: the figure and
   the logged maps against the CPU's;
28. serving, the rest: (a) `python -m thyroid_tpu_torch.serving.server`'s
   server on a port checkpoint of the registry swin_tiny (bf16, phase 1's
   weights) at 127.0.0.1 and a free port, in a thread: /healthz, a
   32-frame .npy post, a 2-frame JSON post and 4 rounds of 16 concurrent
   single-frame posts through the BatchAggregator (each round in fewer
   than 16 batches); every answer equal to engine.predict on the same
   frames in the same batch within 1e-6, kernels 1-4 at 1/15/12/12
   launches per forward, requests/s and p50/p99 latency; (b) resnet50 and
   vit_base (bf16) served with quantize="int8": every int32 product of a
   forward at bucket 4 bit-equal to the CPU's on the same int8 operands,
   the probabilities within 3e-2 of the CPU port's int8 engine, top-1
   agreement with the card's bf16 engine over 32 frames, kernel 1 the only
   kernel (vit_base without kernels 2 and 3), images/s int8 beside bf16 at
   bucket 32; (c) vit_tiny float32 on prepared 224x224 frames with mean
   0.45 / std 0.25 against the CPU (1e-3), no kernel 1 launch;
29. serving export: (a) swin_tiny bf16 (phase 1's weights) on raw 512x512
   frames exported at buckets 1, 8 and 32 by serving/export.py from the
   card's engine and from a CPU engine; (b) the same with quality=True;
   all four bundles loaded on the card in a child process
   (`--export-child`) that imports no model code, 40 frames predicted (32,
   then 8): the probabilities within 1e-6 of engine.predict and the
   launches of every kernel equal to the engine's on the same frames
   (1/15/12/12 per forward; kernels 12, 13 and 15 once per quality
   forward); (c) efficientnet_b0 with dw_pallas_conv exported at bucket 32
   (12 depthwise launches per forward) and (d) int8 resnet50 at bucket 4,
   each held to its engine; (e) `serving.server --bundle` on the raw card
   bundle: a 32-frame post equal to the bundle's predict with 1/15/12/12
   launches, and predict at bucket 32 timed for the engine and the bundle;
   the host time of one kernel-1 call through its op and through its CUDA
   implementation alone;
30. wide token training: (a) rows 9, 10 and 11 against their plain
   versions at swin_base's and swin_large's stage-3 and stage-4 shapes
   (C = 512, 768, 1024, 1536; batch 8), float32 and bf16, two runs
   bit-equal (bf16 past C = 768: each sum over tokens within DBIAS_RTOL of
   the plain version, or no farther than 1.5 times the plain version's own
   distance from a float64 evaluation of the same roundings); (b) full-width
   swin_base and swin_large float32 train steps (batch 2, drop path 0)
   with train_token_kernels against the same step without it on the card,
   24 launches per step of rows 2, 3 (no residual), 5, 6, 9, 10 and 11,
   and the bf16 steps' losses; (c) swin_tiny bf16 served with
   use_pallas_attention false and attn_softmax_dtype bf16 against the CPU
   engine (only kernel 1 launches); (d) a use_checkpoint: true swin_base
   float32 step with the flag (batch 16, drop path 0.1) against the step
   without checkpointing, both peak memories; (e) rows 9-11's device times at C =
   1024 and 1536 (bf16, batch 8) beside their bounds and their
   torch.autograd.grad yardsticks.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits nonzero
before that line is printed. Needs one CUDA card; exits nonzero without one.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float32: 67e12,     # float32 outside the tensor cores
                  torch.float64: 34e12}     # float64 outside the tensor cores
BATCH = 32                     # bucket the kernels are checked and timed at
SWIN_TINY = {"name": "swin_tiny", "in_channels": 1, "num_classes": 2,
             "dtype": "bf16"}
# relative tolerance of kernel vs plain on the card, against max(1, max|plain|):
# f32 covers summation order over up to 3072 terms and rsqrtf/expf/erff vs
# PyTorch's; bf16 covers one rounding flip of a bf16 output (2^-8 relative)
RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# engine probabilities vs the CPU float32 engine on the same weights
PROB_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
# attention backward's dbias, a sum over up to 2048 windows, and the token
# backward kernels' dgamma, dbeta, dW1, db1 and dW2, sums over up to 100,352
# tokens, taken in another order than the plain version's, relative to
# max(1, max|plain|)
DBIAS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# one train step on the card vs the CPU, float32: relative loss difference,
# and |grad_card - grad_cpu| / |grad_cpu| over all parameters (global norms);
# the same bounds hold the flagged token step against the unflagged one
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-4, 1e-3
BF16_LOSS_TOL = 3e-2           # bf16 card loss vs the CPU float32 loss
TRAIN_FRAMES, VAL_FRAMES = 256, 64
# scratch of the training phases (the fit's checkpoints), removed at the end
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
# quality kernels vs their plain versions on the card: the statistics'
# mean and std (float64 sums against float32 ones), relative; the
# bilateral before the artifact chain's floor, in grey levels
STATS_RTOL, BILATERAL_TOL = 1e-5, 1e-2
# the card's quality stage vs the CPU's: share of pixels allowed to differ
# (a floor of the bilateral or of the gamma power taken on either side of
# an integer); the prepared [0, 1] images, where the quality stages agree,
# differ by the resize's and normalisation's float32 rounding
QUALITY_PIXEL_SHARE, PREPARE_TOL = 1e-4, 1e-5
QUALITY_TRAIN_FRAMES = 256
# the served efficientnet (the registry's b0 with the opt-in depthwise kernel)
EFFNET_B0 = {"name": "efficientnet_b0", "in_channels": 1, "num_classes": 2,
             "dtype": "bf16", "dw_pallas_conv": True}
# updated running statistics of the card's float32 train step against the
# CPU's: |stats diff| / |stats| over all BatchNorm buffers (global norms)
STEP_STATS_RTOL = 1e-4
# rows 7 and 8 against their plain versions, relative to max(1, max|plain|):
# float32 2e-5 (the JAX LN-kernel test's bound), bf16 one rounding flip
ATTN_RTOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# the quality pipeline's dual-grid CLAHE parameters (dark: coarse; low
# contrast: fine)
DUAL_GRIDS = {"clip_coarse": 2.0, "grid_coarse": (16, 16), "clip_fine": 0.03,
              "grid_fine": (32, 32)}


# the libraries whose bf16 kernels run on wgmma (kernels 2, 3, 4, 7, 8, 9,
# 10 and 11), each with the kernel functions that must hold HGMMA
# instructions in every instantiation; kernels 4's and 7's attention cores
# and kernels 5 and 6 (the training attention, forward and backward) must
# hold TF32 HMMA (mma.sync) instructions; the depthwise kernel (17), the
# stencil (13) and row 8's wgmma kernel must hold async copies (LDGSTS,
# cp.async) in every instantiation
TENSOR_CORE_LIBS = ("ln_mlp", "ln_mlp_bwd", "ln_matmul", "ln_matmul_bwd",
                    "swin_ln_attention", "swin_attention", "window_attention")
TENSOR_CORE_FUNCTIONS = {"ln_mlp": ("ln_mlp_tc_kernel",),
                         "ln_mlp_bwd": ("ln_mlp_dx_tc_kernel", "ln_mlp_dw_tc_kernel"),
                         "ln_matmul": ("ln_matmul_tc_kernel",),
                         "ln_matmul_bwd": ("ln_matmul_dxn_tc_kernel",),
                         "swin_ln_attention": ("swin_ln_attention_tc_kernel",),
                         "swin_attention": ("swin_block_attention_tc_kernel",),
                         "window_attention": ("window_attention_tc_kernel",)}
TF32_MMA_FUNCTIONS = {"swin_ln_attention": ("swin_ln_attention_tc_kernel",),
                      "swin_attention": ("swin_block_attention_tc_kernel",
                                         "swin_attention_tc_kernel"),
                      "swin_attention_bwd": ("swin_attention_bwd_tc_kernel",)}
ASYNC_COPY_FUNCTIONS = {"depthwise": ("depthwise_kernel",),
                        "stencil": ("median_bilateral_kernel",),
                        "window_attention": ("window_attention_tc_kernel",)}


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- shapes


def swin_tiny_shapes(batch: int):
    """Every (kernel, shape) the swin_tiny forward launches at `batch`,
    with its count per forward."""
    embed, depths, heads, res, ws = 96, (2, 2, 6, 2), (3, 6, 12, 24), 56, 7
    lnmm, mlp, attn = {}, {}, {}
    for i, depth in enumerate(depths):
        c, r = embed * 2 ** i, res // 2 ** i
        t = batch * r * r
        lnmm[(t, c, 3 * c, True)] = lnmm.get((t, c, 3 * c, True), 0) + depth
        mlp[(t, c, 4 * c)] = mlp.get((t, c, 4 * c), 0) + depth
        w = min(ws, r)
        for j in range(depth):
            shift = 0 if (j % 2 == 0 or r <= ws) else ws // 2
            key = (batch, r, c, heads[i], w, shift)
            attn[key] = attn.get(key, 0) + 1
        if i < len(depths) - 1:
            key = (batch * (r // 2) ** 2, 4 * c, 2 * c, False)
            lnmm[key] = lnmm.get(key, 0) + 1
    return {"percentile": {(batch, 224 * 224): 1}, "ln_matmul": lnmm,
            "ln_mlp_residual": mlp, "swin_block_attention": attn}


# ---------------------------------------------------------------- inputs


def make_inputs(kernel: str, shape, dtype, gen):
    """Seeded inputs of one kernel case, on the card, like the JAX tests'."""
    from thyroid_tpu_torch.models.vit.swin import shift_attention_mask

    def rn(*s, scale=1.0, dt=torch.float32):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dt)

    if kernel == "percentile":
        b, n = shape
        return (torch.rand(b, 224, 224, 1, generator=gen, device="cuda")
                * 65535).to(dtype),
    if kernel == "ln_matmul":
        t, c, o, has_bias = shape
        return (rn(t, c, dt=dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
                rn(c, o, scale=c ** -0.5, dt=dtype),
                rn(o, scale=0.1) if has_bias else None)
    if kernel == "ln_mlp_residual":
        t, c, h = shape
        return (rn(t, c, dt=dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
                rn(c, h, scale=c ** -0.5, dt=dtype), rn(h, scale=0.1),
                rn(h, c, scale=h ** -0.5, dt=dtype), rn(c, scale=0.1))
    b, r, c, heads, ws, shift = shape
    mask = shift_attention_mask(r, r, ws, shift)
    return (rn(b, r, r, 3, c, dt=dtype), rn(b, r, r, c, dt=dtype),
            rn(c, c, scale=0.05, dt=dtype), rn(c, scale=0.1),
            rn(heads, ws * ws, ws * ws, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)


def kernel_fns(kernel: str, shape):
    """(wrapper, plain version) of a kernel, as functions of its inputs."""
    from thyroid_tpu_torch.ops import attention, percentile, token_fused

    if kernel == "percentile":
        return percentile.fused_percentile_normalize, \
            percentile.percentile_normalize_plain
    if kernel == "ln_matmul":
        return token_fused.fused_ln_matmul, token_fused.ln_matmul_plain
    if kernel == "ln_mlp_residual":
        return token_fused.fused_ln_mlp_residual, \
            token_fused.ln_mlp_residual_plain
    _, _, c, heads, ws, _ = shape
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    return (lambda *a: attention.fused_swin_block_attention(*a, **kw),
            lambda *a: attention.swin_block_attention_plain(*a, **kw))


def quantile_normalize_library(x):
    """Row 1's yardstick: each image clipped to its exact 1st and 99th
    percentiles (torch.quantile, a sort) and scaled to [0, 1]."""
    xf = x.float().reshape(x.shape[0], -1)
    q = torch.tensor([0.01, 0.99], device=x.device)

    def run():
        lo, hi = torch.quantile(xf, q, dim=1)[:, :, None]
        return ((torch.minimum(torch.maximum(xf, lo), hi) - lo)
                / (hi - lo + 1e-8)).to(x.dtype)

    return run


def stats_quantile_library(x, q: float):
    """Row 12's yardstick: each image's mean, population std, max, min and
    exact quantile q (torch.quantile, a sort)."""
    xf = x.reshape(x.shape[0], -1)
    return lambda: (xf.mean(dim=1), xf.std(dim=1, correction=0), xf.amax(dim=1),
                    xf.amin(dim=1), torch.quantile(xf, q, dim=1))


def library_fn(kernel: str, shape, args):
    """One PyTorch library composition of the same function, for timing
    only (the port never calls it), or None where there is none."""
    import torch.nn.functional as F

    if kernel == "percentile":
        return quantile_normalize_library(args[0])
    if kernel == "ln_matmul":
        x, g, b, w, wb = args
        wt, gd, bd = w.t().contiguous(), g.to(x.dtype), b.to(x.dtype)
        wbd = wb.to(x.dtype) if wb is not None else None
        return lambda: F.linear(F.layer_norm(x, (x.shape[-1],), gd, bd, 1e-5),
                                wt, wbd)
    if kernel == "ln_mlp_residual":
        x, g, b, w1, b1, w2, b2 = args
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        gd, bd, b1d, b2d = (v.to(x.dtype) for v in (g, b, b1, b2))
        return lambda: x + F.linear(F.gelu(F.linear(
            F.layer_norm(x, (x.shape[-1],), gd, bd, 1e-5), w1t, b1d)), w2t, b2d)
    qkv, xres, wp, bp, bias, mask = args
    bsz, r, _, _, c = qkv.shape
    _, _, _, heads, ws, _ = shape
    n, nw, dh = ws * ws, (r // ws) ** 2, c // heads
    attn_mask = bias[None].expand(nw, heads, n, n) if mask is None \
        else bias[None] + mask[:, None]
    attn_mask = attn_mask.to(qkv.dtype)[None].expand(bsz, nw, heads, n, n) \
        .reshape(bsz * nw, heads, n, n).contiguous()
    wpt, bpd = wp.t().contiguous(), bp.to(qkv.dtype)

    def run():
        win = qkv.reshape(bsz, r // ws, ws, r // ws, ws, 3, heads, dh) \
            .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, bsz * nw, heads, n, dh)
        o = F.scaled_dot_product_attention(win[0], win[1], win[2],
                                           attn_mask=attn_mask,
                                           scale=dh ** -0.5)
        o = o.reshape(bsz, r // ws, r // ws, heads, ws, ws, dh) \
            .permute(0, 1, 4, 2, 5, 3, 6).reshape(bsz, r, r, c)
        return xres + F.linear(o, wpt, bpd)

    return run


def work(kernel: str, shape, dtype):
    """(bytes, operations, peak operations/s) of one call: each input read
    once and each output written once; the products' multiply-adds at the
    tensor-core rate of the input type, or the percentile's float32
    compares and arithmetic (2 for min/max, 2 per bisection step, 4 for
    clip and scale, per pixel) at the float32 rate."""
    s = torch.tensor([], dtype=dtype).element_size()
    if kernel == "percentile":
        b, n = shape
        return 2 * b * n * s, b * n * (2 + 2 * 22 + 4), \
            PEAK_OPS_PER_S[torch.float32]
    peak = PEAK_OPS_PER_S[dtype]
    if kernel == "ln_matmul":
        t, c, o, has_bias = shape
        return (t * c + c * o + t * o) * s + (2 * c + o * has_bias) * 4, \
            2 * t * c * o, peak
    if kernel == "ln_mlp_residual":
        t, c, h = shape
        return (2 * t * c + 2 * c * h) * s + (3 * c + h) * 4, 4 * t * c * h, \
            peak
    b, r, c, heads, ws, shift = shape
    n, nw = ws * ws, (r // ws) ** 2
    tokens = b * r * r
    nbytes = (tokens * 5 * c + c * c) * s + (c + heads * n * n
                                             + (nw * n * n if shift else 0)) * 4
    return nbytes, b * nw * 4 * n * n * c + 2 * tokens * c * c, peak


# ---------------------------------------------------------------- phases


def sass_functions(sass: str):
    """{function name: (HGMMA instructions, TF32 HMMA instructions, async
    copies: LDGSTS (cp.async) and UTMALDG (TMA loads)) in it} of
    cuobjdump's SASS dump."""
    parts = sass.split("Function : ")[1:]
    return {part.split("\n", 1)[0].strip():
            (part.count("HGMMA"), sum(1 for line in part.splitlines()
                                      if "HMMA" in line and "TF32" in line),
             part.count("LDGSTS") + part.count("UTMALDG"))
            for part in parts}


def ptxas_report(text: str):
    """[(kernel<template arguments>, registers, spill store bytes)] of each
    entry function in ptxas's -v report, names cut from their mangling."""
    out, fn, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            name = re.search(r"\d([a-z_]+kernel)(I(.*?)E)?E", fn)
            if name is None:
                out.append((fn, int(m.group(1)), spill))
            else:
                args = [{"f": "float", "13__nv_bfloat16": "bf16"}.get(t.group(0), t.group(1))
                        for t in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f",
                                             (name.group(3) or "") + "E")]
                out.append((name.group(1) + (f"<{','.join(args)}>" if args else ""),
                            int(m.group(1)), spill))
            fn = None
    return out


def phase_build() -> str:
    from thyroid_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, text in sorted(logs.items()):
        log(f"[build] {name}.cu: nvcc {_build.BUILD_SECONDS[name]:.1f} s")
        for fn, regs, spill in ptxas_report(text):
            log(f"[build] {name}: {fn}: {regs} registers, {spill} bytes spill stores")
        for line in text.splitlines():
            if "error" in line:
                log(f"[build] {name}: {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dumped = dict.fromkeys(TENSOR_CORE_LIBS + tuple(TF32_MMA_FUNCTIONS)
                           + tuple(ASYNC_COPY_FUNCTIONS))
    for name in dumped:
        path = _build.library_path(name)
        sass = subprocess.run([cuobjdump, "--dump-sass", str(path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        functions = sass_functions(sass)
        for kernel in ASYNC_COPY_FUNCTIONS.get(name, ()):
            counts = {f: n[2] for f, n in functions.items() if kernel in f}
            log(f"[build] {path.name}: {kernel}: async copies (LDGSTS, UTMALDG) "
                f"per instantiation {sorted(counts.values())}")
            if not counts or min(counts.values()) == 0:
                raise AssertionError(f"{kernel} in {path.name} stages its input "
                                     f"without async copies (counts {counts})")
        if name in TENSOR_CORE_LIBS:
            count = sass.count("HGMMA")
            log(f"[build] {path.name}: {count} HGMMA instructions")
            if count == 0:
                raise AssertionError(f"{path.name} holds no wgmma (HGMMA) instruction")
        for kernel in TENSOR_CORE_FUNCTIONS.get(name, ()):
            counts = {f: n[0] for f, n in functions.items() if kernel in f}
            log(f"[build] {path.name}: {kernel}: HGMMA per instantiation "
                f"{sorted(counts.values())}")
            if not counts or min(counts.values()) == 0:
                raise AssertionError(f"{kernel} in {path.name} runs without wgmma "
                                     f"(HGMMA counts {counts})")
        for kernel in TF32_MMA_FUNCTIONS.get(name, ()):
            counts = {f: n[1] for f, n in functions.items() if kernel in f}
            log(f"[build] {path.name}: {kernel}: TF32 HMMA per instantiation "
                f"{sorted(counts.values())}")
            if not counts or min(counts.values()) == 0:
                raise AssertionError(f"{kernel} in {path.name} runs its attention "
                                     f"without TF32 mma.sync (HMMA counts {counts})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    return card


def phase_kernels(shapes) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] float32 checks run with torch.backends.cuda.matmul."
        "allow_tf32 = False and torch.backends.cudnn.allow_tf32 = False")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, cases in shapes.items():
            for shape in cases:
                args = make_inputs(kernel, shape, dtype, gen)
                fused, plain = kernel_fns(kernel, shape)
                got_t = fused(*args)
                want_t = plain(*args)
                got, want = got_t.float(), want_t.float()
                # the block attention (kernel 4) is deterministic: a second
                # run is bit-equal; kernel 1 is bit-equal to its plain version
                same = kernel != "swin_block_attention" \
                    or torch.equal(fused(*args).float(), got)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = 0.0 if kernel == "percentile" \
                    else RTOL[dtype] * max(1.0, want.abs().max().item())
                if kernel == "percentile":
                    same = same_bits(got_t, want_t)
                ok = bool(np.isfinite(err)) and err <= tol \
                    and bool(torch.isfinite(got).all()) and same
                note = {"swin_block_attention": f" two runs bit-equal {same}",
                        "percentile": f" bit-equal {same}"}.get(kernel, "")
                log(f"[kernels] {kernel} {str(dtype)[6:]} {shape}: "
                    f"max_abs_err {err:.3e} tol {tol:.3e}{note} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append((kernel, str(dtype), shape, err))
                del args, got, want, got_t, want_t
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")


def same_bits(got, want) -> bool:
    """Bit-equal tensors, a NaN equal to any NaN."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
    eq = (got.view(ints) == want.view(ints)) | (torch.isnan(got) & torch.isnan(want))
    return got.dtype == want.dtype and got.shape == want.shape and bool(eq.all())


# kernel 1's batches: the served bucket of 32 and the largest of 128, in
# float32 (what prepare_images resizes and normalises in, on the served
# path and in DevicePipeline) and bf16
PERCENTILE_CASES = tuple((b, dt) for b in (32, 128) for dt in (torch.float32, torch.bfloat16))


def percentile_batch(b: int, dtype):
    """A fixed seeded batch of b uint16-scale 224x224 images for kernel 1:
    uniform, but image 0 constant, image 1 two-valued (90% 17, 10% 60000)
    and one pixel of image 2 +inf."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + b)
    x = torch.rand(b, 224, 224, 1, generator=gen, device="cuda") * 65535
    x[0] = 4321.0
    x[1] = torch.where(x[1] < 0.9 * 65535, 17.0, 60000.0)
    x[2, 5, 7] = float("inf")
    return x.to(dtype)


def log_percentile_launches(tag: str) -> None:
    """How kernel 1 launches on each of PERCENTILE_CASES."""
    from thyroid_tpu_torch.ops import percentile

    for b, dt in PERCENTILE_CASES:
        x = torch.empty(b, 224, 224, 1, dtype=dt, device="cuda")
        log(f"[{tag}] fused_percentile_normalize launch at {tuple(x.shape)} "
            f"{str(dt)[6:]}: {json.dumps(percentile.percentile_normalize_launch(x))}")


def perturbed_params(config, seed: int = 0):
    """Seeded swin_tiny weights as a JAX parameter tree, each leaf bumped
    by 0.01·sin(0.7·i) so that logits of a random init are not flat."""
    from thyroid_tpu_torch.models.base import create_and_init
    from thyroid_tpu_torch.models.from_jax import to_jax_params

    model = create_and_init(config, seed=seed, device="cpu")
    return bump(to_jax_params(model))


def counters():
    from thyroid_tpu_torch.ops import attention, percentile, token_fused

    return {"percentile": percentile.fused_percentile_normalize,
            "ln_matmul": token_fused.fused_ln_matmul,
            "ln_mlp_residual": token_fused.fused_ln_mlp_residual,
            "swin_block_attention": attention.fused_swin_block_attention}


def phase_slice(params):
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(SWIN_TINY, params=params)
    engine.warmup()
    rs = np.random.RandomState(0)
    sizes = (1, 8, 32, 40, 136)   # 40 pads into bucket 128; 136 = 128 + 8
    frames = {n: (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
              for n in sizes}
    for fn in counters().values():
        fn.launches = 0
    probs = {n: engine.predict(frames[n]) for n in sizes}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    forwards = sum(-(-n // engine.buckets[-1]) for n in sizes)
    per_forward = {"percentile": 1, "ln_matmul": 15, "ln_mlp_residual": 12,
                   "swin_block_attention": 12}
    log(f"[slice] swin_tiny bf16 served N={sizes} in {forwards} forwards; "
        f"launches {launches}")
    for k, per in per_forward.items():
        if launches[k] != per * forwards:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{per} x {forwards} forwards")
    for n, p in probs.items():
        if p.shape != (n, 2) or not np.isfinite(p).all() \
                or np.abs(p.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"N={n}: bad probabilities {p.shape}")
    log_percentile_launches("slice")
    # agreement: the CPU float32 engine on the same weights and frames
    cpu = InferenceEngine(dict(SWIN_TINY, dtype="f32"), params=params,
                          device="cpu").predict(frames[8])
    gpu32 = InferenceEngine(dict(SWIN_TINY, dtype="f32"),
                            params=params).predict(frames[8])
    spread = float(cpu[:, 0].max() - cpu[:, 0].min())
    for name, got, tol in (("cuda f32", gpu32, PROB_TOL[torch.float32]),
                           ("cuda bf16", probs[8], PROB_TOL[torch.bfloat16])):
        err = float(np.abs(got - cpu).max())
        log(f"[slice] N=8 probabilities, {name} vs cpu f32: max_abs_err "
            f"{err:.3e} tol {tol:.0e} (spread of p0 over the batch {spread:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name} probabilities disagree with the CPU")
    return engine, launches


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# kernels whose time and library time per call are device times (CUDA-graph
# replays, device_ms): a call of a few tens of microseconds on the device,
# whose host launches CUDA events around one call would measure instead
DEVICE_TIMED = ("percentile", "ln_matmul", "ln_mlp_residual", "swin_block_attention",
                "ln_matmul_bwd", "ln_mlp_bwd_dx", "ln_mlp_bwd_dw")


def phase_times(shapes, engine, launches):
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = torch.bfloat16
    names = {"percentile": "ops/percentile.py:183",
             "ln_matmul": "ops/token_fused.py:172",
             "ln_mlp_residual": "ops/token_fused.py:379",
             "swin_block_attention": "ops/attention.py:417"}
    sources = {"percentile": "percentile.cu", "ln_matmul": "ln_matmul.cu",
               "ln_mlp_residual": "ln_mlp.cu",
               "swin_block_attention": "swin_attention.cu"}
    entries = []
    for kernel, cases in shapes.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}
        has_lib = True
        # kernel 1 takes the resized float32 frames on the served path
        dt = torch.float32 if kernel == "percentile" else dtype
        for shape, count in cases.items():
            args = make_inputs(kernel, shape, dt, gen)
            fused, plain = kernel_fns(kernel, shape)
            ms = median_ms(lambda: fused(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=5, warm=1)
            lib = library_fn(kernel, shape, args)
            lib_ms = median_ms(lib) if lib is not None else None
            timing = "events"
            if kernel in DEVICE_TIMED:
                timing = f"device; events {ms:.4f} and {lib_ms:.4f}"
                ms, lib_ms = device_ms(lambda: fused(*args)), device_ms(lib)
            err = (fused(*args).float() - plain(*args).float()).abs().max().item()
            nbytes, ops, peak = work(kernel, shape, dt)
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / peak * 1e3
            log(f"[times] {kernel} {str(dt)[6:]} {shape} x{count}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} ({timing}), bound "
                f"{max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["bound_ms"] += count * max(t_bytes, t_ops)
            tot["bytes_ms"] += count * t_bytes
            tot["ops_ms"] += count * t_ops
            tot["err"] = max(tot["err"], err)
            if lib_ms is None:
                has_lib = False
            else:
                tot["library_ms"] += count * lib_ms
            del args
        entries.append({
            "name": f"fused_{kernel}" if kernel != "percentile"
            else "fused_percentile_normalize",
            "route": "cuda",
            "source": f"thyroid_tpu_torch/csrc/{sources[kernel]}",
            "replaces": f"thyroid_tpu/{names[kernel]}",
            "launches": launches[kernel],
            "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            "library_ms": tot["library_ms"] if has_lib else None})
        log(f"[times] {entries[-1]['name']} per forward at bucket {BATCH}: "
            f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms)")
    percentile_sweep()

    rs = np.random.RandomState(1)
    for n in (32, 128):
        frames = (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
        engine.predict(frames)
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.predict(frames)
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs)
        log(f"[times] predict bucket {n}: median {med * 1e3:.2f} ms over 5, "
            f"{n / med:.1f} images/s (raw 512x512 frames from host memory)")
    return entries


def percentile_sweep() -> None:
    """Kernel 1 at each of PERCENTILE_CASES on its fixed seeded batch:
    device time (CUDA-graph replays) beside the CUDA-event time of one
    call, the library's (torch.quantile) likewise, the plain version and
    the bound; its launch and output hash."""
    from thyroid_tpu_torch.ops import percentile

    log_percentile_launches("times")
    for (b, dt), digest in zip(PERCENTILE_CASES, percentile_hashes().values()):
        x = percentile_batch(b, dt)
        run = lambda: percentile.fused_percentile_normalize(x)  # noqa: E731
        lib = quantile_normalize_library(x)
        events, lib_events = median_ms(run), median_ms(lib)
        ms, lib_ms = device_ms(run), device_ms(lib)
        plain_ms = median_ms(lambda: percentile.percentile_normalize_plain(x), reps=5, warm=1)
        nbytes, ops, peak = work("percentile", (b, 224 * 224), dt)
        bound = max(nbytes / H100_BYTES_PER_S, ops / peak) * 1e3
        log(f"[times] fused_percentile_normalize {str(dt)[6:]} ({b}, 224, 224, 1): "
            f"kernel {ms:.5f} ms (device; events {events:.4f}), library {lib_ms:.5f} ms "
            f"(device; events {lib_events:.4f}), plain {plain_ms:.4f} ms, bound "
            f"{bound:.5f} ms; sha256 {digest}")


def phase_profile(engine, n: int = BATCH, top: int = 12, frames=None,
                  what: str = "predict") -> None:
    """Where the time of one predict call at bucket `n` goes: device time
    by kernel name from torch.profiler, and the device's busy share of the
    call's wall time. Random raw frames unless `frames` are given."""
    from torch.profiler import ProfilerActivity, profile

    if frames is None:
        frames = (np.random.RandomState(2).rand(n, 512, 512, 1) * 65535) \
            .astype(np.float32)
    engine.predict(frames)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(frames)
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"{what} bucket {n}", top)


def report_profile(prof, wall_us: float, what: str, top: int) -> None:
    """Device busy share of `what`'s wall time and its top kernels."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        log("[profile] torch.profiler recorded no device time: not measured")
        return
    log(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"idle {100 * (1 - busy_us / wall_us):.1f}%")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy_us:5.1f}% "
            f"x{e.count:<4d} {e.key[:90]}")


# ---------------------------------------------------------------- training


def swin_tiny_train_shapes(batch: int):
    """Every (kernel, shape) of the training attention's forward and
    backward in one swin_tiny train step at `batch`, with its count per
    step: the serving attention's shapes, one launch each way per block."""
    attn = swin_tiny_shapes(batch)["swin_block_attention"]
    return {"swin_attention": dict(attn), "swin_attention_bwd": dict(attn)}


def make_train_inputs(kernel: str, shape, dtype, gen):
    """Seeded (qkv, bias, mask) or (qkv, dout, bias, mask) on the card."""
    from thyroid_tpu_torch.models.vit.swin import shift_attention_mask

    b, r, c, heads, ws, shift = shape
    mask = shift_attention_mask(r, r, ws, shift)
    mask = torch.from_numpy(mask).cuda() if mask is not None else None
    qkv = torch.randn(b, r, r, 3, c, generator=gen, device="cuda").to(dtype)
    bias = torch.randn(heads, ws * ws, ws * ws, generator=gen,
                       device="cuda") * 0.1
    if kernel == "swin_attention":
        return qkv, bias, mask
    dout = torch.randn(b, r, r, c, generator=gen, device="cuda").to(dtype)
    return qkv, dout, bias, mask


def train_kernel_fns(shape):
    """{kernel: (wrapper, plain version)} of the training attention, each
    returning a tuple of outputs."""
    from thyroid_tpu_torch.ops import attention

    _, _, c, heads, ws, _ = shape
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    return {
        "swin_attention": (
            lambda *a: (attention.fused_swin_attention(*a, **kw),),
            lambda *a: (attention.swin_attention_plain(*a, **kw),)),
        "swin_attention_bwd": (
            lambda *a: attention.fused_swin_attention_bwd(*a, **kw),
            lambda *a: attention.swin_attention_bwd_plain(*a, **kw)),
    }


def train_library_device_ms(kernel: str, shape, args) -> float:
    """Device time of rows 5-6's yardstick (train_library_fn): the forward
    composition's CUDA-graph replays; for the backward, replays of forward +
    torch.autograd.grad less those of the forward, since a backward of a
    forward run outside the capture cannot be captured."""
    forward, inputs, dout = train_library_fn(kernel, shape, args)
    if inputs is None:
        return device_ms(forward)
    both = device_ms(lambda: torch.autograd.grad(forward(), inputs, dout))
    return both - device_ms(forward)


def train_library_fn(kernel: str, shape, args):
    """(forward, inputs, dout): SDPA with the bias (+ mask) as attn_mask
    between window partition and reverse, as a function of nothing; for the
    backward, the leaves qkv and bias that torch.autograd.grad takes the
    gradient to with the output gradient dout (None for the forward).
    Timing only: the port never calls it."""
    import torch.nn.functional as F

    qkv, bias, mask = args[0], args[-2], args[-1]
    b, r, _, _, c = qkv.shape
    _, _, _, heads, ws, _ = shape
    n, nw, dh = ws * ws, (r // ws) ** 2, c // heads

    def attend(qkv, bias):
        win = qkv.reshape(b, r // ws, ws, r // ws, ws, 3, heads, dh) \
            .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw, heads, n, dh)
        am = bias[None].expand(nw, heads, n, n) if mask is None \
            else bias[None] + mask[:, None]
        am = am.to(qkv.dtype)[None].expand(b, nw, heads, n, n) \
            .reshape(b * nw, heads, n, n)
        o = F.scaled_dot_product_attention(win[0], win[1], win[2],
                                           attn_mask=am, scale=dh ** -0.5)
        return o.reshape(b, r // ws, r // ws, heads, ws, ws, dh) \
            .permute(0, 1, 4, 2, 5, 3, 6).reshape(b, r, r, c)

    if kernel == "swin_attention":
        return lambda: attend(qkv, bias), None, None
    q = qkv.detach().requires_grad_()
    bb = bias.detach().requires_grad_()
    return lambda: attend(q, bb), (q, bb), args[1]


def train_work(kernel: str, shape, dtype):
    """(bytes, operations, peak operations/s) of one call. Forward:
    4·N²·C operations per window, read 3C and write C elements per token,
    plus bias and mask. Backward: 10·N²·C per window, read 3C + C and write
    3C per token, plus bias, mask and dbias (f32)."""
    s = torch.tensor([], dtype=dtype).element_size()
    b, r, c, heads, ws, shift = shape
    n, nw = ws * ws, (r // ws) ** 2
    tokens = b * r * r
    side = heads * n * n * 4 + (nw * n * n * 4 if shift else 0)
    if kernel == "swin_attention":
        return tokens * 4 * c * s + side, b * nw * 4 * n * n * c, \
            PEAK_OPS_PER_S[dtype]
    return tokens * 7 * c * s + side + heads * n * n * 4, \
        b * nw * 10 * n * n * c, PEAK_OPS_PER_S[dtype]


def compare_train(kernel: str, got, want, dtype):
    """[(name, max_abs_err, tol, ok)] of a training kernel's outputs."""
    names = ("out",) if kernel == "swin_attention" else ("dqkv", "dbias")
    rows = []
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        rtol = DBIAS_RTOL[dtype] if name == "dbias" else RTOL[dtype]
        tol = rtol * max(1.0, w.abs().max().item())
        ok = bool(np.isfinite(err)) and err <= tol and bool(torch.isfinite(g).all())
        rows.append((name, err, tol, ok))
    return rows


def phase_train_kernels(train_shapes) -> None:
    gen = torch.Generator(device="cuda").manual_seed(3)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, cases in train_shapes.items():
            for shape in cases:
                args = make_train_inputs(kernel, shape, dtype, gen)
                fused, plain = train_kernel_fns(shape)[kernel]
                got, want = fused(*args), plain(*args)
                torch.cuda.synchronize()
                for name, err, tol, ok in compare_train(kernel, got, want, dtype):
                    log(f"[train-kernels] {kernel} {name} {str(dtype)[6:]} "
                        f"{shape}: max_abs_err {err:.3e} tol {tol:.3e} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failed.append((kernel, name, str(dtype), shape, err))
                del args, got, want
    if failed:
        raise AssertionError(f"training kernels disagree with their plain "
                             f"versions: {failed}")


def train_counters():
    from thyroid_tpu_torch.ops import attention

    return {**counters(), "swin_attention": attention.fused_swin_attention}


def read_train_counts():
    from thyroid_tpu_torch.ops import attention

    got = {k: fn.launches for k, fn in train_counters().items()}
    got["swin_attention_bwd"] = attention.fused_swin_attention.bwd_launches
    return got


def reset_train_counts() -> None:
    from thyroid_tpu_torch.ops import attention

    for fn in train_counters().values():
        fn.launches = 0
    attention.fused_swin_attention.bwd_launches = 0


def make_trainer(config, params, out: str, device=None, token: bool = False,
                 **training):
    """A Trainer of `config`; with `token`, its model built from the same
    arguments with train_token_kernels on (build_swin ignores the key, as
    JAX's does)."""
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.models.vit.swin import SwinTransformer, swin_arguments
    from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
    from thyroid_tpu_torch.training.engine import Trainer

    tcfg = dict(TRAINING_VIT, **training)
    model = SwinTransformer(**swin_arguments(config), train_token_kernels=True) \
        if token else ModelRegistry.create_model(config)
    return Trainer(model, config, tcfg,
                   dict(TRAINER_DEFAULT, max_epochs=tcfg["epochs"]),
                   steps_per_epoch=TRAIN_FRAMES // BATCH,
                   output_dir=WORK / out, params=params, device=device)


def step_loss_grads(config, params, batch, device=None, token: bool = False):
    """(loss, {name: float32 CPU gradient}) of one training forward and
    backward of `config` on `batch` (numpy x, y, w) on `device`."""
    trainer = make_trainer(config, params, "step", device=device, token=token)
    dev = trainer.device
    loss, _, grads, _ = trainer.loss_and_grads(
        *(torch.from_numpy(a).to(dev) for a in batch))
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}


def step_agreement(got, want):
    """(relative loss difference, |grad diff| / |grad|, |grad|) of two
    (loss, grads) steps, `want` the reference."""
    diff = sum(float(((got[1][n] - g) ** 2).sum()) for n, g in want[1].items())
    norm = sum(float((g ** 2).sum()) for g in want[1].values())
    return abs(got[0] - want[0]) / abs(want[0]), (diff / norm) ** 0.5, norm ** 0.5


def phase_train_slice(params):
    """The card's train step against the CPU's, then Trainer.fit and
    test(checkpoint=best) with the launch counts checked. Returns the
    launch counts, the step's batch and the card's float32 step."""
    from thyroid_tpu_torch.data.pipeline import DevicePipeline

    rs = np.random.RandomState(4)
    batch = (rs.randn(8, 224, 224, 1).astype(np.float32),
             (np.arange(8) % 2).astype(np.int64), np.ones(8, np.float32))
    f32 = dict(SWIN_TINY, dtype="f32", drop_path_rate=0.0)
    cpu = step_loss_grads(f32, params, batch, "cpu")
    card = step_loss_grads(f32, params, batch)
    bf16_loss, _ = step_loss_grads(dict(f32, dtype="bf16"), params, batch)
    torch.cuda.empty_cache()
    loss_rel, grad_rel, norm = step_agreement(card, cpu)
    log(f"[train] swin_tiny f32 step, batch 8, card vs cpu: loss {card[0]:.7f} "
        f"vs {cpu[0]:.7f} (relative {loss_rel:.3e}, tol {STEP_LOSS_RTOL:.0e}); "
        f"|grad diff| / |grad| {grad_rel:.3e} (tol {STEP_GRAD_RTOL:.0e}, "
        f"|grad| {norm:.4e})")
    log(f"[train] swin_tiny bf16 step on the card: loss {bf16_loss:.7f}, "
        f"{abs(bf16_loss - cpu[0]):.3e} from the cpu f32 loss "
        f"(tol {BF16_LOSS_TOL:.0e})")
    if not (loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL
            and abs(bf16_loss - cpu[0]) <= BF16_LOSS_TOL):
        raise AssertionError("the card's train step disagrees with the CPU's")

    frames = (rs.rand(TRAIN_FRAMES + VAL_FRAMES, 512, 512, 1) * 65535) \
        .astype(np.float32)
    labels = rs.permutation(np.arange(TRAIN_FRAMES + VAL_FRAMES) % 2)
    reset_train_counts()
    t0 = time.perf_counter()
    train = DevicePipeline(frames[:TRAIN_FRAMES], labels[:TRAIN_FRAMES],
                           batch_size=BATCH, train=True)
    val = DevicePipeline(frames[TRAIN_FRAMES:], labels[TRAIN_FRAMES:],
                         batch_size=BATCH)
    trainer = make_trainer(SWIN_TINY, params, "fit", epochs=1)
    fit = trainer.fit(train, val)
    test = trainer.test(val, checkpoint=fit.best_checkpoint)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_train_counts()
    steps = train.steps_per_epoch()
    forwards = 2 * val.steps_per_epoch()          # validation + test
    log(f"[train] Trainer.fit swin_tiny bf16 (drop path 0.2): 1 epoch, "
        f"{steps} steps of {BATCH} + {forwards} eval forwards + test in "
        f"{secs:.2f} s; launches {launches}")
    want = {"percentile": 2, "ln_matmul": 15 * forwards,
            "ln_mlp_residual": 12 * forwards,
            "swin_block_attention": 12 * forwards,
            "swin_attention": 12 * steps, "swin_attention_bwd": 12 * steps}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    metrics = {**fit.history[-1], **test}
    log("[train] " + json.dumps({k: v for k, v in metrics.items()
                                 if k.startswith(("train_", "val_", "test_"))}))
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or fit.best_checkpoint is None:
        raise AssertionError(f"non-finite metrics {bad} or no checkpoint")
    return launches, batch, card


def train_step_seconds(params, n: int, gen, token: bool = False,
                       trainer=None):
    """Median wall time of Trainer.train_step at batch n (bf16 swin_tiny,
    drop path 0.2, unless `trainer` is given), 5 steps after 3 warm-up
    steps, each up to a synchronize; returns it with the trainer and its
    batch."""
    from thyroid_tpu_torch.training.metrics import zero_metric_state

    if trainer is None:
        trainer = make_trainer(SWIN_TINY, params, "speed", token=token)
    x = torch.randn(n, 224, 224, 1, generator=gen, device="cuda")
    y = torch.arange(n, device="cuda") % 2
    w = torch.ones(n, device="cuda")

    def step():
        trainer.train_step(zero_metric_state(device="cuda"), x, y, w)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), trainer, (x, y, w)


def phase_train_times(train_shapes, launches, params):
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype = torch.bfloat16
    meta = {"swin_attention": ("fused_swin_attention", "swin_attention.cu",
                               "ops/attention.py:441"),
            "swin_attention_bwd": ("fused_swin_attention_bwd",
                                   "swin_attention_bwd.cu",
                                   "ops/attention.py:776")}
    entries = []
    for kernel, cases in train_shapes.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}
        for shape, count in cases.items():
            args = make_train_inputs(kernel, shape, dtype, gen)
            fused, plain = train_kernel_fns(shape)[kernel]
            events_ms = median_ms(lambda: fused(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=5, warm=1)
            # kernel and yardstick in device time, as rows 2 and 7-11
            ms = device_ms(lambda: fused(*args))
            lib_ms = train_library_device_ms(kernel, shape, args)
            err = max(row[1] for row in compare_train(
                kernel, fused(*args), plain(*args), dtype))
            nbytes, ops, peak = train_work(kernel, shape, dtype)
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / peak * 1e3
            log(f"[train-times] {kernel} bf16 {shape} x{count}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
                f"(device; kernel events {events_ms:.4f}), "
                f"bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["library_ms"] += count * lib_ms
            tot["bound_ms"] += count * max(t_bytes, t_ops)
            tot["bytes_ms"] += count * t_bytes
            tot["ops_ms"] += count * t_ops
            tot["err"] = max(tot["err"], err)
            del args
        name, src, replaces = meta[kernel]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"thyroid_tpu_torch/csrc/{src}",
            "replaces": f"thyroid_tpu/{replaces}",
            "launches": launches[kernel],
            "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            "library_ms": tot["library_ms"]})
        log(f"[train-times] {name} per train step at batch {BATCH}: "
            f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms)")

    for n in (BATCH, 128):
        torch.cuda.reset_peak_memory_stats()
        med, trainer, batch = train_step_seconds(params, n, gen)
        log(f"[train-times] train step batch {n}: median {med * 1e3:.2f} ms "
            f"over 5, {n / med:.1f} images/s (bf16, drop path 0.2, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)")
        if n == BATCH:
            phase_train_profile(trainer, *batch)
        del trainer, batch
        torch.cuda.empty_cache()
    return entries


def phase_train_profile(trainer, x, y, w, top: int = 14,
                        what: str = "train step") -> None:
    """Where the time of one train step at x's batch goes: device time by
    kernel, the device's busy share, the number of kernel launches and the
    host's heaviest operators; then forward + backward and the optimizer
    update timed apart, each up to a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thyroid_tpu_torch.training.metrics import zero_metric_state

    n = x.shape[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(zero_metric_state(device="cuda"), x, y, w)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"{what} batch {n}", top)
    events = prof.key_averages()
    kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    log(f"[profile] {what} batch {n}: {kernels} device kernel launches; "
        f"heaviest host operators by self time:")
    for e in host[:8]:
        log(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms x{e.count:<5d} "
            f"{e.key[:80]}")

    def timed(fn) -> float:
        secs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs) * 1e3

    _, _, grads, _ = trainer.loss_and_grads(x, y, w)
    fb = timed(lambda: trainer.loss_and_grads(x, y, w))
    opt = timed(lambda: trainer.state.apply_gradients(grads))
    log(f"[profile] {what} batch {n} apart, median of 5: forward + "
        f"backward {fb:.2f} ms, optimizer update {opt:.2f} ms")


# ---------------------------------------------------------------- quality


def frame_kind(frame: np.ndarray) -> str:
    """The quality branch a (H, W) uint16-scale frame takes, by the port's
    issue masks: extreme_dark, low_contrast, artifacts or clean."""
    from thyroid_tpu_torch.ops.image import quality_issue_masks

    masks = quality_issue_masks(torch.from_numpy(frame[None, ..., None]))
    for k in ("extreme_dark", "low_contrast", "artifacts"):
        if bool(masks[k][0]):
            return k
    return "clean"


def quality_frames(n: int = BATCH, side: int = 512) -> np.ndarray:
    """(n, side, side) float32 raw frames: the port's synthetic generator
    with seeds 0, 1, 2, … (label seed % 2), two frames of each kind first,
    then three crafted frames: an artifact frame with a saturated 32x32
    block (its median keeps values above 250: the bilateral branch), a flat
    frame (span 0: CLAHE passes it through) and a dim frame with two bright
    spikes, whose 8-bit artifact frame is all 0 (darkened below 0.1x: the
    guard blends it back); the rest are the next seeds' frames in order.
    A near-black frame with brighter rows, the JAX test's guard frame,
    stays under the 10x limit at 512x512."""
    from thyroid_tpu_torch.data.synthetic import generate_image

    kinds = ("extreme_dark", "low_contrast", "artifacts", "clean")
    picked = {k: [] for k in kinds}
    rest, seed = [], 0
    while len(rest) + 2 * len(kinds) + 3 < n or \
            min(len(v) for v in picked.values()) < 2:
        frame = generate_image(seed, seed % 2, side).astype(np.float32)
        kind = frame_kind(frame)
        (picked[kind] if len(picked[kind]) < 2 else rest).append(frame)
        seed += 1
    block = picked["artifacts"][0].copy()
    block[200:232, 300:332] = 65535.0
    flat = np.full((side, side), 4321.0, np.float32)
    dim = np.floor(np.random.RandomState(7).rand(side, side) * 200 + 20) \
        .astype(np.float32)
    dim[5, 5], dim[400, 70] = 60000.0, 50000.0
    frames = [f for k in kinds for f in picked[k]] + [block, flat, dim] + rest
    return np.stack(frames[:n])


def quality_counters():
    from thyroid_tpu_torch.ops import clahe, percentile, stencil

    return {"stats_quantile": percentile.fused_stats_quantile,
            "median_bilateral": stencil.fused_median_bilateral,
            "apply_luts": clahe.apply_luts,
            "apply_luts_dual": clahe.apply_luts_dual,
            "percentile": percentile.fused_percentile_normalize}


def quality_cases(frames: np.ndarray):
    """The quality kernels' calls on one 32-frame chunk, with the inputs
    the pipeline gives them: the raw frames (statistics), their 8-bit
    artifact frames (stencil), and the 8-bit frames of the CLAHE round trip
    with LUTs from the plain histogram chain at (clip 2.0, 16x16) and
    (clip 0.03, 32x32), the dual apply choosing the coarse grid for every
    third image. Each case: kernel, label, wrapper and plain calls,
    (bytes, float32 operations, float64 operations) of one call, and the
    kernel's input tensor. Bytes and operations: each input
    read once, each output written once; the statistics do 3 + 2·22
    float32 and 4 float64 operations per pixel, the stencil 38 (median) +
    6 per bilateral tap in float32 and 3 per tap in float64 (13 taps), the
    apply about 20 per pixel (two tile coordinates and three blends)."""
    from thyroid_tpu_torch.ops import clahe, percentile, stencil

    x = torch.from_numpy(frames[..., None]).cuda()
    b, h, w = frames.shape
    n = b * h * w
    q = percentile.stats_quantile_plain(x, 0.999)["quantile"]
    x8 = torch.floor(torch.minimum(torch.clamp(x, min=0.0),
                                   q.reshape(-1, 1, 1, 1)) / 256.0)
    x8c, luts, luts_c, luts_f, sel = clahe_inputs(x)
    n_sel = int(sel.sum())
    dual_lut_bytes = (n_sel * luts_c[0].numel() + (b - n_sel) * luts_f[0].numel()) * 4
    cases = [
        ("stats_quantile", "512x512 x32",
         lambda: percentile.fused_stats_quantile(x, 0.999),
         lambda: percentile.stats_quantile_plain(x, 0.999),
         (n * 4 + 5 * b * 4, n * (3 + 2 * 22), n * 4), x),
        ("median_bilateral", "512x512 x32 d=5",
         lambda: stencil.fused_median_bilateral(x8),
         lambda: stencil.median_bilateral_plain(x8),
         (3 * n * 4, n * (38 + 13 * 6), n * (13 * 3 + 1)), x8),
    ]
    for grid, lut in luts.items():
        cases.append(("apply_luts", f"grid {grid[0]}x{grid[1]}",
                      lambda lut=lut, grid=grid: clahe.apply_luts(x8c, lut, grid),
                      lambda lut=lut, grid=grid: clahe._interp_luts(x8c, lut, grid),
                      (2 * n * 4 + lut.numel() * 4, n * 20, 0), x8c))
    cases.append((
        "apply_luts_dual", f"grids 16x16 / 32x32, {n_sel} of {b} coarse",
        lambda: clahe.apply_luts_dual(x8c, luts_c, luts_f, sel, (16, 16), (32, 32)),
        lambda: torch.where(sel.reshape(b, 1, 1),
                            clahe._interp_luts(x8c, luts_c, (16, 16)),
                            clahe._interp_luts(x8c, luts_f, (32, 32))),
        (2 * n * 4 + dual_lut_bytes, n * 20, 0), x8c))
    return cases


def clahe_inputs(x):
    """The CLAHE applies' inputs on raw frames x (B, H, W, 1) on the card,
    as the quality pipeline makes them: the 8-bit frames of the round trip,
    LUTs from the plain histogram chain at (clip 2.0, 16x16) and (clip
    0.03, 32x32), the dual pair, and the dual apply's choice of the coarse
    grid for every third image."""
    from thyroid_tpu_torch.ops import clahe

    b, h, w, _ = x.shape
    flat = x[..., 0].reshape(b, -1)
    lo = flat.amin(1).reshape(b, 1, 1)
    span = flat.amax(1).reshape(b, 1, 1) - lo
    x8c = torch.floor((x[..., 0] - lo) / (span + 1e-8) * 255.0)
    luts = {grid: clahe._luts_from_hists(clahe._tile_hists(x8c, grid),
                                         (h // grid[0]) * (w // grid[1]), clip)
            for grid, clip in (((16, 16), 2.0), ((32, 32), 0.03))}
    luts_c, luts_f = clahe._dual_luts(x8c, 2.0, (16, 16), 0.03, (32, 32))
    sel = torch.arange(b, device=x.device) % 3 == 0
    return x8c, luts, luts_c, luts_f, sel


def compare_quality(kernel: str, got, want):
    """(max error, differing elements, ok, note) of a quality kernel against
    its plain version, with the tolerances above."""
    if kernel == "stats_quantile":
        exact = all(torch.equal(got[k], want[k]) for k in ("quantile", "max", "min"))
        rel = max(((got[k] - want[k]).abs() / want[k].abs().clamp(min=1e-30))
                  .max().item() for k in ("mean", "std"))
        diff = sum(int((got[k] != want[k]).sum()) for k in got)
        err = max((got[k] - want[k]).abs().max().item() for k in got)
        return err, diff, exact and rel <= STATS_RTOL, \
            f"quantile/max/min exact: {exact}; mean/std max relative {rel:.3e}"
    if kernel == "median_bilateral":
        med_exact = torch.equal(got[0], want[0])
        err = (got[1] - want[1]).abs().max().item()
        flips = int((torch.floor(got[1]) != torch.floor(want[1])).sum())
        diff = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
        return err, diff, med_exact and err <= BILATERAL_TOL, \
            f"median exact: {med_exact}; bilateral floor flips {flips}"
    err = (got - want).abs().max().item()
    diff = int((got != want).sum())
    return err, diff, diff == 0, "exact"


def sha(*ts) -> str:
    """SHA-256 of the tensors' bytes."""
    return hashlib.sha256(b"".join(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()
                                   for t in ts)).hexdigest()


def output_hashes(x):
    """SHA-256 of the output bytes of the quality kernels on the raw frames
    x (B, H, W, 1) on the card: kernel 12's quantile, max and min, its mean
    and std, kernel 13's median and bilateral of the 8-bit artifact frames
    cut at that quantile, as the quality pipeline makes them; the CLAHE
    applies' blends on clahe_inputs(x) (kernel 14 at both grids, kernel 15
    with its per-image choice) and kernel 16's round trip with the
    pipeline's flags (dual_fused_case)."""
    from thyroid_tpu_torch.ops import clahe, percentile, stencil

    st = percentile.fused_stats_quantile(x, 0.999)
    x8 = torch.floor(torch.minimum(torch.clamp(x, min=0.0),
                                   st["quantile"].reshape(-1, 1, 1, 1)) / 256.0)
    med, bil = stencil.fused_median_bilateral(x8)
    x8c, luts, luts_c, luts_f, sel = clahe_inputs(x)
    xc, use_coarse, apply = dual_fused_case(x[..., 0].cpu().numpy())
    return {"stats quantile/max/min": sha(st["quantile"], st["max"], st["min"]),
            "stats mean/std": sha(st["mean"], st["std"]),
            "stencil median": sha(med), "stencil bilateral": sha(bil),
            **{f"apply_luts {g[0]}x{g[1]}": sha(clahe.apply_luts(x8c, lut, g))
               for g, lut in luts.items()},
            "apply_luts_dual": sha(clahe.apply_luts_dual(x8c, luts_c, luts_f, sel,
                                                         (16, 16), (32, 32))),
            "apply_luts_dual_fused": sha(clahe.clahe_uint16_dual_fused(
                xc, use_coarse, apply, **DUAL_GRIDS))}


def percentile_hashes():
    """SHA-256 of kernel 1's output on percentile_batch at each of
    PERCENTILE_CASES."""
    from thyroid_tpu_torch.ops import percentile

    return {f"percentile {str(dt)[6:]} ({b}, 224, 224, 1)":
            sha(percentile.fused_percentile_normalize(percentile_batch(b, dt)))
            for b, dt in PERCENTILE_CASES}


def ln_attention_hashes():
    """SHA-256 of kernel 7's bf16 output at swin_tiny's four block shapes
    at batch 32, on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    out = {}
    for shape in sorted(set(swin_tiny_shapes(BATCH)["swin_block_attention"])):
        args = ln_attention_inputs(shape, torch.bfloat16, gen)
        out[f"swin_ln_attention bf16 {shape}"] = sha(remaining_fns("swin_ln_attention",
                                                                   shape)[0](*args))
    return out


def window_shapes():
    """Row 8's block shapes: swin_tiny's four at batch 32 and swin_large's
    stage 4 (48 heads)."""
    return sorted(set(swin_tiny_shapes(BATCH)["swin_block_attention"])) \
        + [WIDE_LN_ATTENTION_SHAPE]


def window_hashes():
    """SHA-256 of row 8's output at window_shapes(), in bf16 and float32,
    on seeded inputs."""
    from thyroid_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(88)
    return {f"window_attention {str(dt)[6:]} {shape}":
            sha(attention.fused_window_attention(*window_inputs(shape, dt, gen)))
            for dt in (torch.bfloat16, torch.float32) for shape in window_shapes()}


def swin_attention_hashes():
    """SHA-256 of kernels 4's, 5's and 6's bf16 outputs at swin_tiny's four
    block shapes at batch 32, on seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(46)
    out = {}
    for shape in sorted(set(swin_tiny_shapes(BATCH)["swin_block_attention"])):
        args = make_inputs("swin_block_attention", shape, torch.bfloat16, gen)
        out[f"swin_block_attention bf16 {shape}"] = sha(
            kernel_fns("swin_block_attention", shape)[0](*args))
        fns = train_kernel_fns(shape)
        for kernel in ("swin_attention", "swin_attention_bwd"):
            args = make_train_inputs(kernel, shape, torch.bfloat16, gen)
            out[f"{kernel} bf16 {shape}"] = sha(*fns[kernel][0](*args))
    return out


def log_hashes(tag: str, what: str, x) -> None:
    for name, digest in output_hashes(x).items():
        log(f"[{tag}] sha256 {name} on {what}: {digest}")


def log_launches(tag: str, x) -> None:
    """How kernels 12 and 13 launch on the chunk x."""
    from thyroid_tpu_torch.ops import percentile, stencil

    log(f"[{tag}] fused_stats_quantile launch at {tuple(x.shape)}: "
        f"{json.dumps(percentile.stats_quantile_launch(x))}")
    log(f"[{tag}] fused_median_bilateral launch, d=5: "
        f"{json.dumps(stencil.median_bilateral_launch(5))}")


def phase_quality_kernels(cases) -> None:
    failed = []
    for kernel, label, fused, plain, *_ in cases:
        got, want = fused(), plain()
        torch.cuda.synchronize()
        err, diff, ok, note = compare_quality(kernel, got, want)
        log(f"[quality-kernels] {kernel} {label}: max_abs_err {err:.3e}, "
            f"{diff} elements differ ({note}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((kernel, label, err, diff))
        del got, want
    # kernel 12's sums are combined in a fixed order and kernel 13 has no
    # sum across threads: two runs give the same bits
    for kernel, label, fused, *_ in cases[:2]:
        a, b = fused(), fused()
        torch.cuda.synchronize()
        pairs = zip(a.values(), b.values()) if isinstance(a, dict) else zip(a, b)
        same = all(torch.equal(u, v) for u, v in pairs)
        log(f"[quality-kernels] {kernel} {label}: two runs bit-equal {same}")
        if not same:
            failed.append((kernel, label, "two runs differ"))
    chunk = cases[0][5]
    log_hashes("quality-kernels", f"the {chunk.shape[0]}-frame chunk", chunk)
    log_launches("quality-kernels", chunk)
    if failed:
        raise AssertionError(f"quality kernels disagree with their plain "
                             f"versions: {failed}")


def quality_branch_counts(frames: np.ndarray):
    """How many frames take each branch, on the CPU with the plain
    versions: the issue masks, clean, the bilateral select (an artifact
    frame whose 8-bit median keeps a value above 250), flat (span 0) and
    the two guards."""
    from thyroid_tpu_torch.ops.image import median_filter_3x3
    from thyroid_tpu_torch.ops.quality import over_correction, quality_branches

    x = torch.from_numpy(frames[..., None])
    processed, stats, masks = quality_branches(x)
    bright, dark = over_correction(processed, stats["mean"])
    x8 = torch.floor(torch.minimum(torch.clamp(x, min=0.0),
                                   stats["quantile"].reshape(-1, 1, 1, 1)) / 256.0)
    bilateral = masks["artifacts"] & (
        median_filter_3x3(x8).reshape(len(x), -1).amax(1) > 250)
    any_issue = masks["extreme_dark"] | masks["low_contrast"] | masks["artifacts"]
    counts = {k: int(v.sum()) for k, v in masks.items()}
    counts.update(clean=int((~any_issue).sum()), bilateral=int(bilateral.sum()),
                  flat=int((stats["max"] == stats["min"]).sum()),
                  guard_bright=int(bright.sum()), guard_dark=int(dark.sum()))
    return counts


def phase_quality_slice(params, frames: np.ndarray):
    """Serve with the quality pipeline, check the launches per chunk, the
    card against the CPU, and the classic path against the merged one."""
    from thyroid_tpu_torch.data.pipeline import prepare_images
    from thyroid_tpu_torch.ops.quality import quality_preprocess
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    counts = quality_branch_counts(frames)
    log(f"[quality-slice] branches over the {len(frames)} frames (CPU): "
        f"{json.dumps(counts)}")
    missing = [k for k, v in counts.items()
               if v == 0 and k not in ("guard_bright", "guard_dark")]
    if missing or counts["guard_bright"] + counts["guard_dark"] == 0:
        raise AssertionError(f"quality branches that never fired: {missing}")

    engine = InferenceEngine(SWIN_TINY, params=params, quality=True)
    engine.warmup()
    batches = {32: frames[..., None], 128: np.tile(frames, (4, 1, 1))[..., None]}
    watched = {**counters(), **quality_counters()}
    for fn in watched.values():
        fn.launches = 0
    probs = {n: engine.predict(x) for n, x in batches.items()}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in watched.items()}
    chunks = sum(n // BATCH for n in batches)
    want = {"stats_quantile": chunks, "median_bilateral": chunks,
            "apply_luts": 0, "apply_luts_dual": chunks, "percentile": chunks,
            "ln_matmul": 15 * len(batches), "ln_mlp_residual": 12 * len(batches),
            "swin_block_attention": 12 * len(batches)}
    log(f"[quality-slice] swin_tiny bf16 with quality=True served N=(32, 128) "
        f"in {chunks} chunks of {BATCH}; launches {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    for n, p in probs.items():
        if p.shape != (n, 2) or not np.isfinite(p).all() \
                or np.abs(p.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"N={n}: bad probabilities {p.shape}")

    # the card against the CPU on 8 frames (two of each kind)
    x8 = torch.from_numpy(frames[:8, ..., None])
    q_cpu = quality_preprocess(x8)
    q_card = quality_preprocess(x8.cuda()).cpu()
    share = float((q_card != q_cpu).float().mean())
    p_cpu = prepare_images(x8, 224, quality=True)
    p_card = prepare_images(x8.cuda(), 224, quality=True).cpu()
    p_err = float((p_card - p_cpu).abs().max())
    log(f"[quality-slice] card vs cpu on 8 frames: quality stage "
        f"{int((q_card != q_cpu).sum())} pixels differ (share {share:.3e}, "
        f"allowed {QUALITY_PIXEL_SHARE:.0e}), max {float((q_card - q_cpu).abs().max()):.3e}; "
        f"prepare_images max_abs_err {p_err:.3e} (tol {PREPARE_TOL:.0e} where the "
        f"quality stages agree), {int((p_card != p_cpu).sum())} of "
        f"{p_cpu.numel()} values differ")
    if share > QUALITY_PIXEL_SHARE or (share == 0 and p_err > PREPARE_TOL):
        raise AssertionError("the card's quality preprocessing disagrees "
                             "with the CPU's")
    cpu = InferenceEngine(dict(SWIN_TINY, dtype="f32"), params=params,
                          quality=True, device="cpu").predict(frames[:8])
    gpu32 = InferenceEngine(dict(SWIN_TINY, dtype="f32"), params=params,
                            quality=True).predict(frames[:8])
    gpu16 = engine.predict(frames[:8])
    spread = float(cpu[:, 0].max() - cpu[:, 0].min())
    for name, got, tol in (("cuda f32", gpu32, PROB_TOL[torch.float32]),
                           ("cuda bf16", gpu16, PROB_TOL[torch.bfloat16])):
        err = float(np.abs(got - cpu).max())
        log(f"[quality-slice] N=8 probabilities with quality, {name} vs cpu "
            f"f32: max_abs_err {err:.3e} tol {tol:.0e} (spread of p0 {spread:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name} probabilities disagree with the CPU")

    # the classic path: two single-grid applies per chunk, the same output
    x = torch.from_numpy(frames[..., None]).cuda()
    merged = quality_preprocess(x)
    for fn in quality_counters().values():
        fn.launches = 0
    classic = quality_preprocess(x, merged=False)
    torch.cuda.synchronize()
    classic_launches = {k: fn.launches for k, fn in quality_counters().items()}
    same = torch.equal(classic, merged)
    log(f"[quality-slice] quality_preprocess(merged=False) on one chunk: "
        f"launches {classic_launches}; equal to the merged path: {same}")
    if classic_launches != {"stats_quantile": 1, "median_bilateral": 1,
                            "apply_luts": 2, "apply_luts_dual": 0,
                            "percentile": 0} or not same:
        raise AssertionError("the classic quality path disagrees")
    launches["apply_luts"] = classic_launches["apply_luts"]
    log_hashes("quality-slice", "the 8 frames held against the CPU",
               torch.from_numpy(frames[:8, ..., None]).cuda())
    log_launches("quality-slice", torch.from_numpy(frames[:8, ..., None]).cuda())
    return engine, launches


# quality kernels timed in device time (CUDA-graph replays, device_ms), and
# their library calls with them: a call of tens of microseconds whose
# wrapper's host time CUDA events around one call would add
QUALITY_DEVICE_TIMED = ("stats_quantile", "median_bilateral", "apply_luts", "apply_luts_dual")


def phase_quality_times(cases, launches, engine, params, frames):
    from thyroid_tpu_torch.data.pipeline import DevicePipeline
    from thyroid_tpu_torch.ops import clahe
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    meta = {"stats_quantile": ("fused_stats_quantile", "percentile.cu",
                               "ops/percentile.py:133"),
            "median_bilateral": ("fused_median_bilateral", "stencil.cu",
                                 "ops/stencil.py:127"),
            "apply_luts": ("apply_luts", "clahe.cu", "ops/clahe.py:268"),
            "apply_luts_dual": ("apply_luts_dual", "clahe.cu", "ops/clahe.py:473")}
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0, "err": 0.0, "library_ms": None} for k in meta}
    chunk = torch.from_numpy(frames[..., None]).cuda()
    libraries = {"stats_quantile": stats_quantile_library(chunk, 0.999)}
    log_launches("quality-times", chunk)
    log_hashes("quality-times", f"the {len(frames)}-frame chunk", chunk)
    for kernel, label, fused, plain, (nbytes, f32_ops, f64_ops), _ in cases:
        ms = median_ms(fused)
        lib = libraries.get(kernel)
        lib_ms = median_ms(lib) if lib is not None else None
        timing = "events"
        if kernel in QUALITY_DEVICE_TIMED:
            timing = f"device; events {ms:.4f}"
            ms = device_ms(fused)
            if lib is not None:
                timing += f" and {lib_ms:.4f}"
                lib_ms = device_ms(lib)
        plain_ms = median_ms(plain, reps=5, warm=1)
        err = compare_quality(kernel, fused(), plain())[0]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = (f32_ops / PEAK_OPS_PER_S[torch.float32]
                 + f64_ops / PEAK_OPS_PER_S[torch.float64]) * 1e3
        lib_text = f"{lib_ms:.4f} ms" if lib_ms is not None else \
            "none (no PyTorch call computes it)"
        log(f"[quality-times] {kernel} {label}: kernel {ms:.4f} ms, library "
            f"{lib_text} ({timing}), plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        t = tot[kernel]
        if lib_ms is not None:
            t["library_ms"] = (t["library_ms"] or 0.0) + lib_ms
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["bound_ms"] += max(t_bytes, t_ops)
        t["bytes_ms"] += t_bytes
        t["ops_ms"] += t_ops
        t["err"] = max(t["err"], err)
    entries = []
    for kernel, (name, src, replaces) in meta.items():
        t = tot[kernel]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"thyroid_tpu_torch/csrc/{src}",
            "replaces": f"thyroid_tpu/{replaces}",
            "launches": launches[kernel], "max_abs_err": t["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"]})
        log(f"[quality-times] {name} per 32-frame chunk: {t['ms']:.4f} ms "
            f"(bound {t['bound_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms)")

    plain_engine = InferenceEngine(SWIN_TINY, params=params)
    for n in (32, 128):
        x = np.tile(frames, (n // len(frames), 1, 1))[..., None]
        for name, eng in (("quality=True", engine), ("quality=False", plain_engine)):
            eng.predict(x)
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.predict(x)
                secs.append(time.perf_counter() - t0)
            med = statistics.median(secs)
            log(f"[quality-times] predict {name} bucket {n}: median "
                f"{med * 1e3:.2f} ms over 5, {n / med:.1f} images/s (raw "
                f"512x512 synthetic frames from host memory)")
    del plain_engine

    raw = np.tile(frames, (QUALITY_TRAIN_FRAMES // len(frames), 1, 1))[..., None]
    labels = np.arange(len(raw)) % 2
    for fn in quality_counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = DevicePipeline(raw, labels, batch_size=BATCH, train=True,
                          quality_preprocessing=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in quality_counters().items()}
    chunks = len(raw) // BATCH
    want = {"stats_quantile": chunks, "median_bilateral": chunks,
            "apply_luts": 0, "apply_luts_dual": chunks, "percentile": chunks}
    x = torch.from_numpy(frames[..., None]).cuda()
    flat = x[..., 0].reshape(len(frames), -1)
    lo = flat.amin(1).reshape(-1, 1, 1)
    x8c = torch.floor((x[..., 0] - lo) / (flat.amax(1).reshape(-1, 1, 1) - lo
                                          + 1e-8) * 255.0)
    lut_ms = median_ms(lambda: clahe._dual_luts(x8c, 2.0, (16, 16), 0.03, (32, 32)))
    k1213 = tot["stats_quantile"]["ms"] + tot["median_bilateral"]["ms"]
    log(f"[quality-times] DevicePipeline(quality_preprocessing=True) over "
        f"{len(raw)} raw 512x512 frames: {secs * 1e3:.2f} ms "
        f"({len(raw) / secs:.1f} frames/s, host->card copy included); "
        f"launches {got}; histogram/LUT chain {lut_ms:.4f} ms per chunk, "
        f"{chunks * lut_ms:.2f} ms over the {chunks} chunks; kernels 12 + 13 "
        f"{k1213:.4f} ms of device time per chunk, {chunks * k1213:.3f} ms "
        f"over the {chunks} chunks")
    if got != want or pipe.cache.shape != (len(raw), 224, 224, 1) \
            or not bool(torch.isfinite(pipe.cache).all()):
        raise AssertionError(f"quality DevicePipeline: launches {got}, "
                             f"expected {want}")
    del pipe, raw
    phase_profile(engine, frames=frames[..., None], what="quality predict")
    return entries


# ---------------------------------------------------------------- token training

TOKEN_SUMS = ("dgamma", "dbeta", "dW1", "db1", "dW2")   # sums over tokens
TOKEN_OUTPUTS = {"ln_matmul_bwd": ("dx", "dgamma", "dbeta"),
                 "ln_mlp_bwd_dx": ("dx", "dgamma", "dbeta"),
                 "ln_mlp_bwd_dw": ("dW1", "db1", "dW2"),
                 "ln_mlp": ("y",), "ln_matmul_train": ("y",)}


def token_train_shapes(batch: int):
    """{(T, C): blocks} of a swin_tiny train step at `batch`: each block runs
    every token kernel once on its stage's T = batch·56²/4^s tokens of width
    C = 96·2^s."""
    return {(batch * (56 // 2 ** i) ** 2, 96 * 2 ** i): depth
            for i, depth in enumerate((2, 2, 6, 2))}


def make_token_inputs(kernel: str, shape, dtype, gen):
    """Seeded inputs of one token-kernel case on the card: x and dY in
    `dtype`, weights in `dtype` scaled by fan-in^-1/2, LN and bias vectors
    float32."""
    t, c = shape

    def rn(*s, scale=1.0, dt=torch.float32):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dt)

    ln = (rn(t, c, dt=dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1))
    if kernel in ("ln_matmul_bwd", "ln_matmul_train"):
        w = rn(c, 3 * c, scale=c ** -0.5, dt=dtype)
        if kernel == "ln_matmul_train":
            return ln + (w, rn(3 * c, scale=0.1))
        return ln[0], ln[1], w, rn(t, 3 * c, dt=dtype)
    mlp = (rn(c, 4 * c, scale=c ** -0.5, dt=dtype), rn(4 * c, scale=0.1),
           rn(4 * c, c, scale=(4 * c) ** -0.5, dt=dtype))
    if kernel == "ln_mlp":
        return ln + mlp + (rn(c, scale=0.1),)
    return ln + mlp + (rn(t, c, dt=dtype),)


def token_fns(kernel: str):
    """(wrapper, plain version) of a token kernel, each returning a tuple
    of the outputs named in TOKEN_OUTPUTS."""
    from thyroid_tpu_torch.ops import token_fused as tf

    if kernel == "ln_matmul_bwd":
        return tf.fused_ln_matmul_bwd, tf.ln_matmul_bwd_plain
    if kernel == "ln_mlp_bwd_dx":
        return (lambda *a: tf.fused_ln_mlp_bwd_dx(*a, residual=False),
                lambda *a: tf.ln_mlp_bwd_plain(*a, False)[:3])
    if kernel == "ln_mlp_bwd_dw":
        return (tf.fused_ln_mlp_bwd_dw,
                lambda *a: tf.ln_mlp_bwd_plain(*a, False)[3:])
    if kernel == "ln_mlp":
        return (lambda *a: (tf.fused_ln_mlp(*a),),
                lambda *a: (tf.ln_mlp_plain(*a),))
    return (lambda *a: (tf.fused_ln_matmul(*a),),
            lambda *a: (tf.ln_matmul_plain(*a),))


def token_library_parts(kernel: str, args):
    """(forward, inputs, dY) of one PyTorch library composition of the same
    function, for timing only (the port never calls it): LayerNorm + linear
    (+ GELU + linear) as `forward`; a backward kernel's yardstick is
    torch.autograd.grad of it to the same `inputs` (x, γ, β for dX; W1, b1,
    W2 for the weight gradients) with the output gradient dY."""
    import torch.nn.functional as F

    x, c = args[0], args[0].shape[1]
    if kernel == "ln_matmul_bwd":
        _, g, w, dy = args
        xr = x.detach().requires_grad_()
        gd, bd = g.to(x.dtype).requires_grad_(), torch.zeros_like(
            g, dtype=x.dtype).requires_grad_()
        wt = w.t().contiguous()
        return (lambda: F.linear(F.layer_norm(xr, (c,), gd, bd, 1e-5), wt),
                (xr, gd, bd), dy)
    _, g, b, w1, b1, w2 = args[:6]
    need_x = kernel == "ln_mlp_bwd_dx"
    xr = x.detach().requires_grad_(need_x)
    gd = g.to(x.dtype).requires_grad_(need_x)
    bd = b.to(x.dtype).requires_grad_(need_x)
    need_w = kernel == "ln_mlp_bwd_dw"
    w1t = w1.t().contiguous().requires_grad_(need_w)
    b1d = b1.to(x.dtype).requires_grad_(need_w)
    w2t = w2.t().contiguous().requires_grad_(need_w)
    b2d = args[6].to(x.dtype) if kernel == "ln_mlp" else None

    def mlp():
        return F.linear(F.gelu(F.linear(F.layer_norm(xr, (c,), gd, bd, 1e-5),
                                        w1t, b1d)), w2t, b2d)

    return mlp, (xr, gd, bd) if need_x else (w1t, b1d, w2t), args[6]


def token_library_fn(kernel: str, args):
    """The library composition of a token training forward (kernels 2 and
    3 without the residual), as a function of nothing."""
    if kernel == "ln_matmul_train":
        return library_fn("ln_matmul", None, args)
    return token_library_parts(kernel, args)[0]


def token_library_device_ms(kernel: str, args) -> float:
    """Device time of autograd's backward of a token backward kernel's
    library composition (rows 9-11's yardstick): CUDA-graph replays of
    forward + backward less those of the forward, since a backward of a
    forward run outside the capture cannot be captured."""
    forward, inputs, dy = token_library_parts(kernel, args)
    both = device_ms(lambda: torch.autograd.grad(forward(), inputs, dy))
    return both - device_ms(forward)


def token_work(kernel: str, shape, dtype):
    """(bytes, operations, peak operations/s) of one call: each input read
    once, each output written once; the products' multiply-adds at the
    tensor-core rate of the input type. LN + matmul backward: dXn = dY Wᵀ
    (2·T·C·3C). LN + MLP backward dX: fc1 again, dA and dH W1ᵀ
    (3 × 2·T·C·4C); dW: fc1 again, dA, xnᵀ dH and aᵀ dY (4 × 2·T·C·4C)."""
    s = torch.tensor([], dtype=dtype).element_size()
    t, c = shape
    h, peak = 4 * c, PEAK_OPS_PER_S[dtype]
    if kernel == "ln_matmul_train":
        return work("ln_matmul", (t, c, 3 * c, True), dtype)
    if kernel == "ln_mlp":
        return work("ln_mlp_residual", (t, c, h), dtype)
    if kernel == "ln_matmul_bwd":
        o = 3 * c
        return (2 * t * c + t * o + c * o) * s + 3 * c * 4, 2 * t * c * o, peak
    vectors = (2 * c + h) * 4
    if kernel == "ln_mlp_bwd_dx":
        return (3 * t * c + 2 * c * h) * s + vectors + 2 * c * 4, 6 * t * c * h, peak
    return (2 * t * c + 2 * c * h) * s + vectors + (2 * c * h + h) * 4, \
        8 * t * c * h, peak


def compare_token(kernel: str, got, want, dtype):
    """[(name, max_abs_err, tol, ok)] of a token kernel's outputs, relative
    to max(1, max|plain|): RTOL, or DBIAS_RTOL for the sums over tokens."""
    rows = []
    for name, g, w in zip(TOKEN_OUTPUTS[kernel], got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        rtol = DBIAS_RTOL[dtype] if name in TOKEN_SUMS else RTOL[dtype]
        tol = rtol * max(1.0, w.abs().max().item())
        ok = bool(np.isfinite(err)) and err <= tol and bool(torch.isfinite(g).all())
        rows.append((name, err, tol, ok))
    return rows


def phase_token_kernels(shapes) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(9)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("ln_matmul_bwd", "ln_mlp_bwd_dx", "ln_mlp_bwd_dw", "ln_mlp"):
            for shape in shapes:
                args = make_token_inputs(kernel, shape, dtype, gen)
                fused, plain = token_fns(kernel)
                got, want = fused(*args), plain(*args)
                torch.cuda.synchronize()
                for name, err, tol, ok in compare_token(kernel, got, want, dtype):
                    log(f"[token-kernels] {kernel} {name} {str(dtype)[6:]} "
                        f"{shape}: max_abs_err {err:.3e} tol {tol:.3e} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failed.append((kernel, name, str(dtype), shape, err))
                if kernel != "ln_mlp":  # the backward kernels: sums without atomics
                    again = fused(*args)
                    equal = all(torch.equal(a, b) for a, b in zip(got, again))
                    log(f"[token-kernels] {kernel} {str(dtype)[6:]} {shape}: a "
                        f"second run {'bit-equal' if equal else 'DIFFERS'}")
                    if not equal:
                        failed.append((kernel, "rerun", str(dtype), shape))
                    del again
                del args, got, want
    if failed:
        raise AssertionError(f"token kernels disagree with their plain "
                             f"versions: {failed}")


def token_counters():
    from thyroid_tpu_torch.ops import token_fused as tf

    return {"ln_mlp": tf.fused_ln_mlp, "ln_matmul_bwd": tf.fused_ln_matmul_bwd,
            "ln_mlp_bwd_dx": tf.fused_ln_mlp_bwd_dx,
            "ln_mlp_bwd_dw": tf.fused_ln_mlp_bwd_dw}


def phase_token_slice(params, batch, card_off):
    """The flagged float32 step on the card against the CPU's and against
    the unflagged card step `card_off` on the same `batch`, the bf16
    flagged loss, then Trainer.fit and test(checkpoint=best) with the flag
    on and the launch counts checked."""
    from thyroid_tpu_torch.data.pipeline import DevicePipeline

    f32 = dict(SWIN_TINY, dtype="f32", drop_path_rate=0.0)
    cpu = step_loss_grads(f32, params, batch, "cpu", token=True)
    for fn in token_counters().values():
        fn.launches = 0
    card = step_loss_grads(f32, params, batch, token=True)
    torch.cuda.synchronize()
    step_launches = {k: fn.launches for k, fn in token_counters().items()}
    bf16_loss, _ = step_loss_grads(dict(f32, dtype="bf16"), params, batch,
                                   token=True)
    torch.cuda.empty_cache()
    ok = step_launches == {k: 12 for k in token_counters()}
    for what, ref in (("cpu (flag on)", cpu), ("card (flag off)", card_off)):
        loss_rel, grad_rel, norm = step_agreement(card, ref)
        log(f"[token-train] swin_tiny f32 step with train_token_kernels, batch "
            f"8, card vs {what}: loss {card[0]:.7f} vs {ref[0]:.7f} (relative "
            f"{loss_rel:.3e}, tol {STEP_LOSS_RTOL:.0e}); |grad diff| / |grad| "
            f"{grad_rel:.3e} (tol {STEP_GRAD_RTOL:.0e}, |grad| {norm:.4e})")
        ok &= loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL
    log(f"[token-train] swin_tiny bf16 step with train_token_kernels on the "
        f"card: loss {bf16_loss:.7f}, {abs(bf16_loss - card[0]):.3e} from the "
        f"card's f32 loss (tol {BF16_LOSS_TOL:.0e}); f32 step launches "
        f"{step_launches}")
    if not (ok and abs(bf16_loss - card[0]) <= BF16_LOSS_TOL):
        raise AssertionError("the flagged train step disagrees")

    rs = np.random.RandomState(8)
    frames = (rs.rand(TRAIN_FRAMES + VAL_FRAMES, 512, 512, 1) * 65535) \
        .astype(np.float32)
    labels = rs.permutation(np.arange(TRAIN_FRAMES + VAL_FRAMES) % 2)
    reset_train_counts()
    for fn in token_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    train = DevicePipeline(frames[:TRAIN_FRAMES], labels[:TRAIN_FRAMES],
                           batch_size=BATCH, train=True)
    val = DevicePipeline(frames[TRAIN_FRAMES:], labels[TRAIN_FRAMES:],
                         batch_size=BATCH)
    trainer = make_trainer(SWIN_TINY, params, "token_fit", token=True, epochs=1)
    fit = trainer.fit(train, val)
    test = trainer.test(val, checkpoint=fit.best_checkpoint)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**read_train_counts(),
                **{k: fn.launches for k, fn in token_counters().items()}}
    steps = train.steps_per_epoch()
    forwards = 2 * val.steps_per_epoch()          # validation + test
    log(f"[token-train] Trainer.fit swin_tiny bf16 with train_token_kernels "
        f"(drop path 0.2): 1 epoch, {steps} steps of {BATCH} + {forwards} eval "
        f"forwards + test in {secs:.2f} s; launches {launches}")
    want = {"percentile": 2, "ln_matmul": 15 * forwards + 12 * steps,
            "ln_mlp_residual": 12 * forwards,
            "swin_block_attention": 12 * forwards,
            "swin_attention": 12 * steps, "swin_attention_bwd": 12 * steps,
            **{k: 12 * steps for k in token_counters()}}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    metrics = {**fit.history[-1], **test}
    log("[token-train] " + json.dumps({k: v for k, v in metrics.items()
                                       if k.startswith(("train_", "val_", "test_"))}))
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or fit.best_checkpoint is None:
        raise AssertionError(f"non-finite metrics {bad} or no checkpoint")
    return launches


def phase_token_times(shapes, launches, params):
    gen = torch.Generator(device="cuda").manual_seed(10)
    dtype = torch.bfloat16
    meta = {"ln_matmul_bwd": ("fused_ln_matmul_bwd", "ln_matmul_bwd.cu",
                              "ops/token_fused.py:239"),
            "ln_mlp_bwd_dx": ("fused_ln_mlp_bwd_dx", "ln_mlp_bwd.cu",
                              "ops/token_fused.py:529"),
            "ln_mlp_bwd_dw": ("fused_ln_mlp_bwd_dw", "ln_mlp_bwd.cu",
                              "ops/token_fused.py:560")}
    entries = []
    for kernel in ("ln_matmul_bwd", "ln_mlp_bwd_dx", "ln_mlp_bwd_dw",
                   "ln_matmul_train", "ln_mlp"):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}
        for shape, count in shapes.items():
            args = make_token_inputs(kernel, shape, dtype, gen)
            fused, plain = token_fns(kernel)
            ms = median_ms(lambda: fused(*args))
            plain_ms = median_ms(lambda: plain(*args), reps=5, warm=1)
            # the backward kernels and their yardsticks in device time, so
            # that the host's launches (autograd's above all) do not set them
            timing = "events"
            if kernel in DEVICE_TIMED:
                timing = f"device; kernel events {ms:.4f}"
                ms = device_ms(lambda: fused(*args))
                lib_ms = token_library_device_ms(kernel, args)
            else:
                lib_ms = median_ms(token_library_fn(kernel, args))
            err = max(row[1] for row in compare_token(
                kernel, fused(*args), plain(*args), dtype))
            nbytes, ops, peak = token_work(kernel, shape, dtype)
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = ops / peak * 1e3
            log(f"[token-times] {kernel} bf16 {shape} x{count}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
                f"({timing}), bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain_ms
            tot["library_ms"] += count * lib_ms
            tot["bound_ms"] += count * max(t_bytes, t_ops)
            tot["bytes_ms"] += count * t_bytes
            tot["ops_ms"] += count * t_ops
            tot["err"] = max(tot["err"], err)
            del args
        log(f"[token-times] {kernel} per train step at batch {BATCH}: "
            f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms)")
        if kernel not in meta:
            continue
        name, src, replaces = meta[kernel]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"thyroid_tpu_torch/csrc/{src}",
            "replaces": f"thyroid_tpu/{replaces}",
            "launches": launches[kernel],
            "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations",
            "library_ms": tot["library_ms"]})

    for n in (BATCH, 128):
        for token in (True, False):
            torch.cuda.reset_peak_memory_stats()
            med, trainer, batch = train_step_seconds(params, n, gen, token=token)
            log(f"[token-times] train step batch {n}, train_token_kernels "
                f"{'on' if token else 'off'}: median {med * 1e3:.2f} ms over 5, "
                f"{n / med:.1f} images/s (bf16, drop path 0.2, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)")
            if n == BATCH and token:
                phase_train_profile(trainer, *batch,
                                    what="train step with train_token_kernels")
            del trainer, batch
            torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------- efficientnet


def dw_inputs(shape, dtype, gen):
    """Seeded x (B, H, W, C) and weights (C, 1, k, k) on the card."""
    b, h, w, c, k = shape
    x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn(c, 1, k, k, generator=gen, device="cuda") * 0.2).to(dtype)
    return x, wt


def dw_work(shape, dtype):
    """(bytes, operations, peak operations/s) of one depthwise call: x read
    and y written once, the weights read once; a float32 multiply and add
    per tap and output, at the float32 rate."""
    b, h, w, c, k = shape
    s = torch.tensor([], dtype=dtype).element_size()
    n = b * h * w * c
    return (2 * n + c * k * k) * s, 2 * n * k * k, PEAK_OPS_PER_S[torch.float32]


def dw_library(x, w):
    """cuDNN's depthwise convolution of the same NHWC input, as a
    channels-last view (what the port runs without dw_pallas_conv); timing
    only."""
    import torch.nn.functional as F

    xc, k = x.permute(0, 3, 1, 2), int(w.shape[-1])
    return lambda: F.conv2d(xc, w, padding=k // 2, groups=x.shape[-1])


def dw_compare(got, want, dtype, rtol=RTOL):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = rtol[dtype] * max(1.0, want.abs().max().item())
    ok = bool(np.isfinite(err)) and err <= tol and bool(torch.isfinite(got).all())
    return err, tol, ok


def phase_dw_kernels(cases) -> None:
    """Q2-17 against its plain version at every case, in float32 and
    bfloat16, bit-equal (its stated contract), then one backward of its autograd Function against autograd
    through the plain version (float32; dw is a sum over B·H·W, DBIAS_RTOL)."""
    from thyroid_tpu_torch.ops import depthwise_pallas as dp

    gen = torch.Generator(device="cuda").manual_seed(11)
    failed = []
    for model, shapes in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in shapes:
                x, w = dw_inputs(shape, dtype, gen)
                got = dp.depthwise_conv2d_pallas(x, w)
                want = dp.depthwise_conv2d_plain(x, w)
                torch.cuda.synchronize()
                err, tol, ok = dw_compare(got, want, dtype)
                equal = torch.equal(got, want)
                ok = ok and equal
                log(f"[dw-kernels] {model} {str(dtype)[6:]} {shape}: max_abs_err "
                    f"{err:.3e} bit-equal {equal} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append((model, str(dtype), shape, err))
                del x, w, got, want
    shape = (8, 28, 28, 240, 5)
    x, w = dw_inputs(shape, torch.float32, gen)
    g = torch.randn(x.shape, generator=gen, device="cuda")
    grads = []
    for fn in (dp.depthwise_conv2d_pallas, dp.depthwise_conv2d_plain):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xa, wa).backward(g)
        grads.append((xa.grad, wa.grad))
    torch.cuda.synchronize()
    for name, got, want, rtol in (("dx", grads[0][0], grads[1][0], RTOL),
                                  ("dw", grads[0][1], grads[1][1], DBIAS_RTOL)):
        err, tol, ok = dw_compare(got, want, torch.float32, rtol)
        log(f"[dw-kernels] backward {name} float32 {shape}: Function vs autograd "
            f"through the plain version, max_abs_err {err:.3e} tol {tol:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(("backward", name, shape, err))
    if failed:
        raise AssertionError(f"the depthwise kernel disagrees with its plain "
                             f"version: {failed}")


def bump(tree, scale_var: bool = False):
    """Each leaf plus 0.01·sin(0.7·i); with scale_var, a leaf named var
    times (1 + 0.01·sin(0.7·i)) instead, so it stays positive."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = bump(v, scale_var)
            continue
        wave = 0.01 * np.sin(np.arange(v.size, dtype=np.float32) * 0.7) \
            .reshape(v.shape).astype(np.float32)
        out[k] = v * (1 + wave) if scale_var and k == "var" else v + wave
    return out


def effnet_variables(config, seed: int = 0):
    """Seeded efficientnet variables as a JAX tree: the port's initial
    weights bumped by 0.01·sin(0.7·i); running statistics equal to the batch
    statistics of one float32 train-mode forward on the card (momentum 0)
    on 32 prepared, standardized raw 512x512 frames, then perturbed likewise.
    (The initial mean 0, var 1 would make the eval forward all but blind to
    its input.)"""
    from thyroid_tpu_torch.data.pipeline import prepare_images
    from thyroid_tpu_torch.models.base import create_and_init
    from thyroid_tpu_torch.models.from_jax import (load_jax_variables,
                                                   to_jax_variables)
    from thyroid_tpu_torch.models.layers import BatchNorm
    from thyroid_tpu_torch.ops.image import standardize

    model = create_and_init(dict(config, dtype="f32", dropout_rate=0.0,
                                 drop_path_rate=0.0), seed=seed)
    init = to_jax_variables(model)
    load_jax_variables(model, {"params": bump(init["params"]),
                               "batch_stats": init["batch_stats"]})
    rs = np.random.RandomState(seed + 100)
    raw = torch.from_numpy((rs.rand(BATCH, 512, 512, 1) * 65535)
                           .astype(np.float32)).cuda()
    x = standardize(prepare_images(raw, 224), (0.5,), (0.5,))
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = 0.0
    with torch.no_grad():
        model(x, train=True)
    variables = to_jax_variables(model)
    variables["batch_stats"] = bump(variables["batch_stats"], scale_var=True)
    del model, raw, x
    torch.cuda.empty_cache()
    return variables


def effnet_counters():
    from thyroid_tpu_torch.ops import depthwise_pallas, percentile

    return {"depthwise": depthwise_pallas.depthwise_conv2d_pallas,
            "percentile": percentile.fused_percentile_normalize}


def effnet_trainer(config, variables, out: str, device=None, epochs: int = 100):
    """A Trainer of `config` with configs/training/cnn.yaml and the default
    trainer, from `variables`."""
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_CNN
    from thyroid_tpu_torch.training.engine import Trainer

    return Trainer(ModelRegistry.create_model(config), config,
                   dict(TRAINING_CNN, epochs=epochs),
                   dict(TRAINER_DEFAULT, max_epochs=epochs),
                   steps_per_epoch=TRAIN_FRAMES // BATCH,
                   output_dir=WORK / out, variables=variables, device=device)


def effnet_step(config, variables, batch, device=None):
    """(loss, {name: float32 CPU gradient}, {name: float32 CPU running
    statistic after the step's forward}) of one training forward and
    backward of `config` on `batch` (numpy x, y, w) on `device`."""
    trainer = effnet_trainer(config, variables, "effnet_step", device)
    dev = trainer.device
    loss, _, grads, _ = trainer.loss_and_grads(
        *(torch.from_numpy(a).to(dev) for a in batch))
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}, \
        {n: b.float().cpu() for n, b in trainer.state.batch_stats.items()}


def phase_effnet_slice(variables):
    """Serve efficientnet_b0 with the kernel and check the launches and the
    probabilities; the card's float32 train step against the CPU's; then
    Trainer.fit and test(checkpoint=best) with the launches checked.
    Returns the serving engine, the serving launch counts and the fit's."""
    from thyroid_tpu_torch.data.pipeline import DevicePipeline
    from thyroid_tpu_torch.serving.engine import InferenceEngine
    from thyroid_tpu_torch.training.configs import MODEL_EFFICIENTNET_B0

    engine = InferenceEngine(EFFNET_B0, variables=variables)
    engine.warmup()
    rs = np.random.RandomState(12)
    sizes = (8, 32, 40, 136)      # 40 pads into bucket 128; 136 = 128 + 8
    frames = {n: (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
              for n in sizes}
    for fn in effnet_counters().values():
        fn.launches = 0
    probs = {n: engine.predict(frames[n]) for n in sizes}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in effnet_counters().items()}
    forwards = sum(-(-n // engine.buckets[-1]) for n in sizes)
    log(f"[effnet-slice] efficientnet_b0 bf16 with dw_pallas_conv served N={sizes} "
        f"in {forwards} forwards; launches {launches}")
    if launches != {"depthwise": 12 * forwards, "percentile": forwards}:
        raise AssertionError(f"launches {launches}, expected 12 and 1 per "
                             f"forward over {forwards} forwards")
    for n, p in probs.items():
        if p.shape != (n, 2) or not np.isfinite(p).all() \
                or np.abs(p.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"N={n}: bad probabilities {p.shape}")
    f32 = dict(EFFNET_B0, dtype="f32")
    cpu = InferenceEngine(f32, variables=variables, device="cpu").predict(frames[8])
    gpu32 = InferenceEngine(f32, variables=variables).predict(frames[8])
    off = InferenceEngine(dict(EFFNET_B0, dw_pallas_conv=False), variables=variables)
    effnet_counters()["depthwise"].launches = 0
    off_probs = off.predict(frames[8])
    off_launches = effnet_counters()["depthwise"].launches
    del off
    spread = float(cpu[:, 0].max() - cpu[:, 0].min())
    ok = off_launches == 0
    for name, got, ref, tol in (
            ("cuda f32 (flag on) vs cpu f32", gpu32, cpu, PROB_TOL[torch.float32]),
            ("cuda bf16 (flag on) vs cpu f32", probs[8], cpu, PROB_TOL[torch.bfloat16]),
            ("cuda bf16 (flag off) vs cpu f32", off_probs, cpu, PROB_TOL[torch.bfloat16]),
            ("cuda bf16, flag on vs off", probs[8], off_probs, PROB_TOL[torch.bfloat16])):
        err = float(np.abs(got - ref).max())
        log(f"[effnet-slice] N=8 probabilities, {name}: max_abs_err {err:.3e} "
            f"tol {tol:.0e} (spread of p0 over the batch {spread:.3e})")
        ok &= err <= tol
    log(f"[effnet-slice] the flag-off engine launched the depthwise kernel "
        f"{off_launches} times")
    if not ok:
        raise AssertionError("efficientnet_b0 probabilities disagree")

    # one float32 train step, card against CPU
    rs = np.random.RandomState(13)
    batch = (rs.randn(8, 224, 224, 1).astype(np.float32),
             (np.arange(8) % 2).astype(np.int64), np.ones(8, np.float32))
    step_cfg = dict(f32, dropout_rate=0.0, drop_path_rate=0.0)
    cpu_step = effnet_step(step_cfg, variables, batch, "cpu")
    effnet_counters()["depthwise"].launches = 0
    card_step = effnet_step(step_cfg, variables, batch)
    torch.cuda.synchronize()
    step_dw = effnet_counters()["depthwise"].launches
    torch.cuda.empty_cache()
    loss_rel, grad_rel, norm = step_agreement(card_step[:2], cpu_step[:2])
    sdiff = sum(float(((card_step[2][n] - v) ** 2).sum()) for n, v in cpu_step[2].items())
    snorm = sum(float((v ** 2).sum()) for v in cpu_step[2].values())
    stats_rel = (sdiff / snorm) ** 0.5
    log(f"[effnet-train] efficientnet_b0 f32 step, batch 8, card vs cpu: loss "
        f"{card_step[0]:.7f} vs {cpu_step[0]:.7f} (relative {loss_rel:.3e}, tol "
        f"{STEP_LOSS_RTOL:.0e}); |grad diff| / |grad| {grad_rel:.3e} (tol "
        f"{STEP_GRAD_RTOL:.0e}, |grad| {norm:.4e}); updated running statistics "
        f"|diff| / |stats| {stats_rel:.3e} (tol {STEP_STATS_RTOL:.0e}); depthwise "
        f"launches in the step {step_dw}")
    if not (loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL
            and stats_rel <= STEP_STATS_RTOL and step_dw == 0):
        raise AssertionError("the card's efficientnet_b0 train step disagrees "
                             "with the CPU's")

    rs = np.random.RandomState(14)
    raw = (rs.rand(TRAIN_FRAMES + VAL_FRAMES, 512, 512, 1) * 65535).astype(np.float32)
    labels = rs.permutation(np.arange(TRAIN_FRAMES + VAL_FRAMES) % 2)
    cfg = dict(MODEL_EFFICIENTNET_B0, dw_pallas_conv=True)
    for fn in effnet_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    train = DevicePipeline(raw[:TRAIN_FRAMES], labels[:TRAIN_FRAMES],
                           batch_size=BATCH, train=True)
    val = DevicePipeline(raw[TRAIN_FRAMES:], labels[TRAIN_FRAMES:], batch_size=BATCH)
    trainer = effnet_trainer(cfg, variables, "effnet_fit", epochs=1)
    fit = trainer.fit(train, val)
    after_fit = {k: fn.launches for k, fn in effnet_counters().items()}
    test = trainer.test(val, checkpoint=fit.best_checkpoint)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fit_launches = {k: fn.launches for k, fn in effnet_counters().items()}
    steps = train.steps_per_epoch()
    evals = val.steps_per_epoch()
    log(f"[effnet-train] Trainer.fit efficientnet_b0 bf16 (cnn.yaml, dropout 0.2, "
        f"drop path 0.2, dw_pallas_conv): 1 epoch, {steps} steps of {BATCH} + "
        f"{evals} eval forwards + test ({evals} forwards) in {secs:.2f} s; "
        f"launches after fit {after_fit}, after test {fit_launches}")
    want = {"depthwise": 12 * 2 * evals, "percentile": 2}
    if fit_launches != want or after_fit["depthwise"] != 12 * evals:
        raise AssertionError(f"launches {fit_launches}, expected {want} "
                             f"(12 per eval forward, none per train step)")
    metrics = {**fit.history[-1], **test}
    log("[effnet-train] " + json.dumps({k: v for k, v in metrics.items()
                                        if k.startswith(("train_", "val_", "test_"))}))
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or fit.best_checkpoint is None:
        raise AssertionError(f"non-finite metrics {bad} or no checkpoint")
    return engine, launches


def device_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one call of fn: `reps` calls captured in one CUDA
    graph, the graph replayed between CUDA events, the median replay over
    reps. Unlike median_ms it leaves out the host's time between launches,
    which a call of a few tens of microseconds on the device does not hide.
    It reads no torch.profiler trace: the profiler's device activity can
    come back empty late in a process that has profiled before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return statistics.median(times) / reps


def phase_effnet_times(shapes, launches, engine, variables):
    from thyroid_tpu_torch.ops import depthwise_pallas as dp
    from thyroid_tpu_torch.serving.engine import InferenceEngine
    from thyroid_tpu_torch.training.configs import MODEL_EFFICIENTNET_B0

    gen = torch.Generator(device="cuda").manual_seed(15)
    dtype = torch.bfloat16
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0}
    events = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for shape, count in shapes.items():
        x, w = dw_inputs(shape, dtype, gen)
        fns = {"ms": lambda: dp.depthwise_conv2d_pallas(x, w),
               "plain_ms": lambda: dp.depthwise_conv2d_plain(x, w),
               "library_ms": dw_library(x, w)}
        on_host = {k: median_ms(f) if k != "plain_ms" else median_ms(f, reps=5, warm=1)
                   for k, f in fns.items()}
        dev = {k: device_ms(f) for k, f in fns.items()}
        ms, plain_ms, lib_ms = dev["ms"], dev["plain_ms"], dev["library_ms"]
        err = (dp.depthwise_conv2d_pallas(x, w).float()
               - dp.depthwise_conv2d_plain(x, w).float()).abs().max().item()
        nbytes, ops, peak = dw_work(shape, dtype)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        log(f"[effnet-times] depthwise bf16 {shape} x{count}: device time kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms; one call "
            f"between CUDA events (host launch included) kernel {on_host['ms']:.4f} ms, "
            f"plain {on_host['plain_ms']:.4f} ms, cuDNN {on_host['library_ms']:.4f} ms; "
            f"bound {max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        for k in events:
            events[k] += count * on_host[k]
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain_ms
        tot["library_ms"] += count * lib_ms
        tot["bound_ms"] += count * max(t_bytes, t_ops)
        tot["bytes_ms"] += count * t_bytes
        tot["ops_ms"] += count * t_ops
        tot["err"] = max(tot["err"], err)
        del x, w
    entry = {
        "name": "depthwise_conv2d_pallas", "route": "cuda",
        "source": "thyroid_tpu_torch/csrc/depthwise.cu",
        "replaces": "thyroid_tpu/ops/depthwise_pallas.py:126",
        "launches": launches["depthwise"], "max_abs_err": tot["err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        "library_ms": tot["library_ms"]}
    log(f"[effnet-times] depthwise_conv2d_pallas per forward at bucket {BATCH}, "
        f"device time: {tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, cuDNN {tot['library_ms']:.4f} ms); one call at "
        f"a time between CUDA events: kernel {events['ms']:.4f} ms, plain "
        f"{events['plain_ms']:.4f} ms, cuDNN {events['library_ms']:.4f} ms")

    off = InferenceEngine(dict(EFFNET_B0, dw_pallas_conv=False), variables=variables)
    rs = np.random.RandomState(16)
    for n in (32, 128):
        frames = (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
        for name, eng in (("on", engine), ("off", off), ("on", engine), ("off", off)):
            eng.predict(frames)
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.predict(frames)
                secs.append(time.perf_counter() - t0)
            med = statistics.median(secs)
            log(f"[effnet-times] predict efficientnet_b0 bf16, dw_pallas_conv {name}, "
                f"bucket {n}: median {med * 1e3:.2f} ms over 5, {n / med:.1f} "
                f"images/s (raw 512x512 frames from host memory)")
    del off
    phase_profile(engine, what="efficientnet_b0 predict (dw_pallas_conv)")

    cfg = dict(MODEL_EFFICIENTNET_B0, dw_pallas_conv=True)
    for n in (BATCH, 128):
        torch.cuda.reset_peak_memory_stats()
        trainer = effnet_trainer(cfg, variables, "effnet_speed")
        med, trainer, batch = train_step_seconds(None, n, gen, trainer=trainer)
        log(f"[effnet-times] train step efficientnet_b0 batch {n}: median "
            f"{med * 1e3:.2f} ms over 5, {n / med:.1f} images/s (bf16, cnn.yaml, "
            f"dropout 0.2, drop path 0.2, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)")
        if n == BATCH:
            phase_train_profile(trainer, *batch, what="efficientnet_b0 train step")
        del trainer, batch
        torch.cuda.empty_cache()
    return [entry]



# ---------------------------------------------------------------- remaining kernels


def ln_attention_inputs(shape, dtype, gen):
    """Seeded inputs of row 7 at a block shape: x (B, r, r, C), γ, β,
    W (C, 3C), the QKV bias, the bias (heads, N, N) and the shift mask."""
    from thyroid_tpu_torch.models.vit.swin import shift_attention_mask

    b, r, c, heads, ws, shift = shape
    mask = shift_attention_mask(r, r, ws, shift)

    def rn(*s, scale=1.0, dt=torch.float32):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(dt)

    return (rn(b, r, r, c, dt=dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
            rn(c, 3 * c, scale=c ** -0.5), rn(3 * c, scale=0.1),
            rn(heads, ws * ws, ws * ws, scale=0.1),
            torch.from_numpy(mask).cuda() if mask is not None else None)


def window_inputs(shape, dtype, gen):
    """Seeded inputs of row 8 at the same block: q, k, v (B·nW, heads, N,
    C/heads), the bias and the shift mask (nW, N, N) or None."""
    from thyroid_tpu_torch.models.vit.swin import shift_attention_mask

    b, r, c, heads, ws, shift = shape
    n, nw = ws * ws, (r // ws) ** 2
    mask = shift_attention_mask(r, r, ws, shift)
    q, k, v = (torch.randn(b * nw, heads, n, c // heads, generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    bias = torch.randn(heads, n, n, generator=gen, device="cuda") * 0.1
    return q, k, v, bias, torch.from_numpy(mask).cuda() if mask is not None else None


def remaining_fns(kernel: str, shape):
    """(wrapper, plain version) of row 7 or row 8 at a block shape."""
    from thyroid_tpu_torch.ops import attention

    _, _, c, heads, ws, _ = shape
    if kernel == "window_attention":
        return attention.fused_window_attention, attention.window_attention_reference
    kw = dict(window_size=ws, num_heads=heads, scale=(c // heads) ** -0.5)
    return (lambda *a: attention.fused_swin_ln_attention(*a, **kw),
            lambda *a: attention.swin_ln_attention_plain(*a, **kw))


def dual_fused_case(frames: np.ndarray):
    """Row 16's call on the quality chunk: the raw frames on the card, and
    the per-image flags the quality pipeline gives it, from the CPU's issue
    masks: the coarse grid for the extremely dark frames, equalisation for
    the dark and the low-contrast ones."""
    from thyroid_tpu_torch.ops.image import quality_issue_masks

    x = torch.from_numpy(frames[..., None])
    masks = quality_issue_masks(x)
    use_coarse = masks["extreme_dark"]
    apply = masks["extreme_dark"] | masks["low_contrast"]
    return x.cuda(), use_coarse.cuda(), apply.cuda()


def remaining_counters():
    from thyroid_tpu_torch.ops import attention, clahe, token_fused

    return {"swin_ln_attention": attention.fused_swin_ln_attention,
            "window_attention": attention.fused_window_attention,
            "apply_luts_dual_fused": clahe.apply_luts_dual_fused,
            "ln_matmul": token_fused.fused_ln_matmul,
            "swin_attention": attention.fused_swin_attention}


def ln_module_pair(shape, gen):
    """WindowAttention(ln_kernel=True) on the card with seeded weights
    (kernels N(0, 1/C), biases N(0, 0.1²), a bias table N(0, 0.1²)), and
    its twin without the flag, which takes kernels 2 + 5 and the
    projection; γ and β of the block's norm1."""
    from thyroid_tpu_torch.models.vit.swin import WindowAttention

    _, _, c, heads, ws, _ = shape
    mod = WindowAttention(c, ws, heads, ln_kernel=True).cuda().eval()
    with torch.no_grad():
        for name, t in mod.named_parameters():
            scale = t.shape[0] ** -0.5 if name.endswith("kernel") else 0.1
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * scale)
    twin = WindowAttention(c, ws, heads).cuda().eval()
    twin.load_state_dict(mod.state_dict())
    ln = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
          0.1 * torch.randn(c, generator=gen, device="cuda"))
    return mod, twin, ln


def phase_remaining_kernels(attn_shapes, frames):
    """Rows 7 and 8 against their plain versions at every swin_tiny serving
    block shape at batch 32, float32 and bf16; row 16 bit-equal on the
    quality chunk; WindowAttention(ln_kernel=True) against ln_kernel=False
    in float32. Then the main-path run of the three, counted: the module
    with ln_kernel serves each of the 12 blocks once, fused_window_attention
    takes each block's windows once, clahe_uint16_dual_fused the chunk
    once. Returns its launch counts."""
    from thyroid_tpu_torch.models.vit.swin import shift_attention_mask
    from thyroid_tpu_torch.ops import attention, clahe

    gen = torch.Generator(device="cuda").manual_seed(17)
    failed = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for kernel, make in (("swin_ln_attention", ln_attention_inputs),
                                 ("window_attention", window_inputs)):
                # row 8 also at swin_large's stage 4 (48 heads); in bf16 on
                # wgmma, two runs bit-equal
                shapes = window_shapes() if kernel == "window_attention" \
                    else list(attn_shapes)
                for shape in shapes:
                    args = make(shape, dtype, gen)
                    fused, plain = remaining_fns(kernel, shape)
                    got, want = fused(*args), plain(*args).float()
                    route, same = "", True
                    if kernel == "window_attention":
                        route = attention.window_attention_route(*args[:3])
                        same = torch.equal(got, fused(*args))
                        if dtype == torch.bfloat16 and route != "wgmma":
                            failed.append((kernel, shape, route))
                    got = got.float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    tol = ATTN_RTOL[dtype] * max(1.0, want.abs().max().item())
                    ok = bool(np.isfinite(err)) and err <= tol and same \
                        and bool(torch.isfinite(got).all())
                    log(f"[remaining-kernels] {kernel} {str(dtype)[6:]} {shape}: "
                        f"max_abs_err {err:.3e} tol {tol:.3e}"
                        + (f", kernel {route}, two runs bit-equal {same}" if route else "")
                        + f" {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failed.append((kernel, str(dtype), shape, err, same))
                    del args, got, want
        x, use_coarse, apply = dual_fused_case(frames)
        got = clahe.clahe_uint16_dual_fused(x, use_coarse, apply, **DUAL_GRIDS)
        want = clahe.clahe_uint16_dual_fused_plain(x, use_coarse, apply,
                                                   **DUAL_GRIDS)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        err = (got - want).abs().max().item()
        log(f"[remaining-kernels] apply_luts_dual_fused (clahe_uint16_dual_fused) "
            f"on {len(frames)} raw 512x512 frames, {int(use_coarse.sum())} coarse, "
            f"{int(apply.sum())} equalised: {diff} elements differ, max_abs_err "
            f"{err:.3e} (bit-equal required) {'ok' if diff == 0 else 'FAIL'}")
        if diff:
            failed.append(("apply_luts_dual_fused", diff))
        for shape in attn_shapes:
            b, r, c, heads, ws, shift = shape
            mod, twin, ln = ln_module_pair(shape, gen)
            xs = torch.randn(b, r, r, c, generator=gen, device="cuda")
            mask = shift_attention_mask(r, r, ws, shift)
            mask = torch.from_numpy(mask).cuda() if mask is not None else None
            got = mod(xs, mask, spatial=True, ln=ln)
            want = twin(xs, mask, spatial=True, ln=ln)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = RTOL[torch.float32] * max(1.0, want.abs().max().item())
            ok = err <= tol and bool(torch.isfinite(got).all())
            log(f"[remaining-kernels] WindowAttention float32 {shape}: ln_kernel=True "
                f"vs False (kernels 2 + 5 + projection) max_abs_err {err:.3e} "
                f"tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(("WindowAttention ln_kernel", shape, err))
            del mod, twin, xs, got, want
    if failed:
        raise AssertionError(f"rows 7, 8, 16 disagree with their plain "
                             f"versions: {failed}")

    # the main path of the three, counted
    blocks = [shape for shape, count in attn_shapes.items() for _ in range(count)]
    inputs = []
    for shape in blocks:
        b, r, c, heads, ws, shift = shape
        mod, _, ln = ln_module_pair(shape, gen)
        mask = shift_attention_mask(r, r, ws, shift)
        inputs.append((mod, ln, torch.randn(b, r, r, c, generator=gen,
                                            device="cuda").bfloat16(),
                       torch.from_numpy(mask).cuda() if mask is not None else None,
                       window_inputs(shape, torch.bfloat16, gen)))
    for fn in remaining_counters().values():
        fn.launches = 0
    with torch.inference_mode():
        outs = [mod(xs, mask, spatial=True, ln=ln) for mod, ln, xs, mask, _ in inputs]
        outs += [attention.fused_window_attention(*w) for *_, w in inputs]
        outs.append(clahe.clahe_uint16_dual_fused(x, use_coarse, apply, **DUAL_GRIDS))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in remaining_counters().items()}
    want = {"swin_ln_attention": len(blocks), "window_attention": len(blocks),
            "apply_luts_dual_fused": 1, "ln_matmul": 0, "swin_attention": 0}
    log(f"[remaining-kernels] main path: WindowAttention(ln_kernel=True) bf16 "
        f"served on the {len(blocks)} swin_tiny blocks at batch {BATCH}, "
        f"fused_window_attention on their windows, clahe_uint16_dual_fused on the "
        f"chunk; launches {launches}")
    if launches != want or not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"launches {launches}, expected {want}")
    del inputs, outs
    return launches


# ---------------------------------------------------------------- Swin YAMLs


def yaml_config(name: str, **over):
    """configs/model/vit/<name>.yaml as yaml.safe_load reads it, with
    `over` on top."""
    import yaml

    path = Path(__file__).resolve().parent / "configs" / "model" / "vit" / f"{name}.yaml"
    return dict(yaml.safe_load(path.read_text()), **over)


def medical_params(config, seed: int = 0):
    """perturbed_params of a YAML Swin, every contrast_scale set to
    1 + 0.3·sin(1.3·i + 0.5) so that the per-head contrast scaling is not
    near the identity."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "contrast_scale":
                tree[k] = (1 + 0.3 * np.sin(np.arange(v.size) * 1.3 + 0.5)) \
                    .astype(np.float32)
        return tree

    return walk(perturbed_params(config, seed))


def serve_yaml(name: str, config, params, sizes, per_forward, side: int = 512):
    """Serve `config` (bf16) on raw frames of `sizes`, check the launches
    per forward and the probabilities against the CPU float32 engine on 8
    frames (the card in float32 and in bf16). Returns the engine and the
    launch counts."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(config, params=params)
    engine.warmup()
    rs = np.random.RandomState(18)
    frames = {n: (rs.rand(n, side, side, 1) * 65535).astype(np.float32)
              for n in sizes + (8,)}
    watched = train_counters()
    for fn in watched.values():
        fn.launches = 0
    probs = {n: engine.predict(frames[n]) for n in sizes}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in watched.items()}
    forwards = sum(-(-n // engine.buckets[-1]) for n in sizes)
    log(f"[{name}] {config['name']} bf16 (medical_adaptations) served N={sizes} "
        f"in {forwards} forwards; launches {launches}")
    want = {k: per_forward.get(k, 0) * forwards for k in watched}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    for n, p in probs.items():
        if p.shape != (n, 2) or not np.isfinite(p).all() \
                or np.abs(p.sum(-1) - 1).max() > 1e-3:
            raise AssertionError(f"N={n}: bad probabilities {p.shape}")
    f32 = dict(config, dtype="f32")
    cpu = InferenceEngine(f32, params=params, device="cpu").predict(frames[8])
    gpu32 = InferenceEngine(f32, params=params).predict(frames[8])
    gpu16 = engine.predict(frames[8])
    spread = float(cpu[:, 0].max() - cpu[:, 0].min())
    for what, got, tol in (("cuda f32", gpu32, PROB_TOL[torch.float32]),
                           ("cuda bf16", gpu16, PROB_TOL[torch.bfloat16])):
        err = float(np.abs(got - cpu).max())
        log(f"[{name}] N=8 probabilities, {what} vs cpu f32: max_abs_err {err:.3e} "
            f"tol {tol:.0e} (spread of p0 over the batch {spread:.3e})")
        if not err <= tol:
            raise AssertionError(f"{what} probabilities disagree with the CPU")
    return engine, launches


def phase_yaml_slice():
    """swin_tiny as configs/model/vit/swin_tiny.yaml builds it: served at
    buckets 32 and 128, a float32 train step on the card against the CPU,
    then Trainer.fit for one epoch and test(checkpoint=best), with the
    launches checked (the windows attention is plain: no attention kernel
    on either path; PatchMerging's norm + reduction and the MLP take their
    kernels when serving, none in training)."""
    from thyroid_tpu_torch.data.pipeline import DevicePipeline

    cfg = yaml_config("swin_tiny", dtype="bf16")
    params = medical_params(cfg)
    engine, _ = serve_yaml("yaml-slice", cfg, params, (32, 128),
                           {"percentile": 1, "ln_matmul": 3, "ln_mlp_residual": 12})

    rs = np.random.RandomState(19)
    batch = (rs.randn(8, 224, 224, 1).astype(np.float32),
             (np.arange(8) % 2).astype(np.int64), np.ones(8, np.float32))
    f32 = dict(cfg, dtype="f32", drop_path_rate=0.0)
    cpu = step_loss_grads(f32, params, batch, "cpu")
    card = step_loss_grads(f32, params, batch)
    torch.cuda.empty_cache()
    loss_rel, grad_rel, norm = step_agreement(card, cpu)
    zero = [n for n in cpu[1] if n.startswith("uncertainty")
            and (cpu[1][n].abs().max() > 0 or card[1][n].abs().max() > 0)]
    log(f"[yaml-slice] swin_tiny.yaml f32 step, batch 8, card vs cpu: loss "
        f"{card[0]:.7f} vs {cpu[0]:.7f} (relative {loss_rel:.3e}, tol "
        f"{STEP_LOSS_RTOL:.0e}); |grad diff| / |grad| {grad_rel:.3e} (tol "
        f"{STEP_GRAD_RTOL:.0e}, |grad| {norm:.4e}); uncertainty head gradients "
        f"zero: {not zero}")
    if not (loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL) or zero:
        raise AssertionError("the card's swin_tiny.yaml train step disagrees "
                             "with the CPU's")

    frames = (rs.rand(TRAIN_FRAMES + VAL_FRAMES, 512, 512, 1) * 65535) \
        .astype(np.float32)
    labels = rs.permutation(np.arange(TRAIN_FRAMES + VAL_FRAMES) % 2)
    reset_train_counts()
    t0 = time.perf_counter()
    train = DevicePipeline(frames[:TRAIN_FRAMES], labels[:TRAIN_FRAMES],
                           batch_size=BATCH, train=True)
    val = DevicePipeline(frames[TRAIN_FRAMES:], labels[TRAIN_FRAMES:],
                         batch_size=BATCH)
    trainer = make_trainer(cfg, params, "yaml_fit", epochs=1)
    fit = trainer.fit(train, val)
    test = trainer.test(val, checkpoint=fit.best_checkpoint)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_train_counts()
    steps = train.steps_per_epoch()
    forwards = 2 * val.steps_per_epoch()
    log(f"[yaml-slice] Trainer.fit swin_tiny.yaml bf16 (drop path 0.2): 1 epoch, "
        f"{steps} steps of {BATCH} + {forwards} eval forwards + test in "
        f"{secs:.2f} s; launches {launches}")
    want = {"percentile": 2, "ln_matmul": 3 * forwards,
            "ln_mlp_residual": 12 * forwards, "swin_block_attention": 0,
            "swin_attention": 0, "swin_attention_bwd": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    metrics = {**fit.history[-1], **test}
    log("[yaml-slice] " + json.dumps({k: v for k, v in metrics.items()
                                      if k.startswith(("train_", "val_", "test_"))}))
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or fit.best_checkpoint is None:
        raise AssertionError(f"non-finite metrics {bad} or no checkpoint")
    del trainer, train, val
    return engine, cfg, params


def phase_medical_slice():
    """swin_medical.yaml at full depth (2, 2, 18, 2) and 256², padding in
    every stage, drop_rate 0.05: served at bucket 32 against the CPU, then
    one bf16 train step at batch 32 and the uncertainty head's output,
    finite."""
    from thyroid_tpu_torch.training.metrics import zero_metric_state

    cfg = yaml_config("swin_medical", dtype="bf16")
    params = medical_params(cfg, seed=1)
    engine, _ = serve_yaml("medical-slice", cfg, params, (32,),
                           {"percentile": 1, "ln_matmul": 3, "ln_mlp_residual": 24},
                           side=256)
    del engine
    trainer = make_trainer(cfg, params, "medical_step")
    gen = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(BATCH, 256, 256, 1, generator=gen, device="cuda")
    y = torch.arange(BATCH, device="cuda") % 2
    w = torch.ones(BATCH, device="cuda")
    t0 = time.perf_counter()
    mstate, _ = trainer.train_step(zero_metric_state(device="cuda"), x, y, w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    loss = float(mstate["loss_sum"]) / float(mstate["w_sum"])
    with torch.no_grad():
        logits, u = trainer.model(x[:8], return_uncertainty=True)
    finite = np.isfinite(loss) and all(bool(torch.isfinite(p).all())
                                       for p in trainer.state.params.values())
    log(f"[medical-slice] swin_medical.yaml bf16 train step, batch {BATCH} at 256² "
        f"(drop 0.05, drop path 0.25): loss {loss:.5f}, {secs * 1e3:.1f} ms with "
        f"the first call's set-up; parameters finite: {finite}; uncertainty head "
        f"output {tuple(u.shape)} finite: {bool(torch.isfinite(u).all())}")
    if not finite or u.shape != (8, 2) or not bool(torch.isfinite(u).all()) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("swin_medical's train step is not finite")
    del trainer, x


def ln_attention_library(shape, args):
    """F.layer_norm + F.linear + SDPA with the bias (+ mask) as a float
    attn_mask between window partition and reverse; timing only."""
    import torch.nn.functional as F

    x, g, beta, w, bq, bias, mask = args
    b, r, _, c = x.shape
    _, _, _, heads, ws, _ = shape
    n, nw, dh = ws * ws, (r // ws) ** 2, c // heads
    am = bias[None].expand(nw, heads, n, n) if mask is None \
        else bias[None] + mask[:, None]
    am = am.to(x.dtype)[None].expand(b, nw, heads, n, n) \
        .reshape(b * nw, heads, n, n).contiguous()
    wt, gd, bd, bqd = (w.t().to(x.dtype).contiguous(), g.to(x.dtype),
                       beta.to(x.dtype), bq.to(x.dtype))

    def run():
        qkv = F.linear(F.layer_norm(x, (c,), gd, bd, 1e-5), wt, bqd)
        win = qkv.reshape(b, r // ws, ws, r // ws, ws, 3, heads, dh) \
            .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw, heads, n, dh)
        o = F.scaled_dot_product_attention(win[0], win[1], win[2],
                                           attn_mask=am, scale=dh ** -0.5)
        return o.reshape(b, r // ws, r // ws, heads, ws, ws, dh) \
            .permute(0, 1, 4, 2, 5, 3, 6).reshape(b, r, r, c)

    return run


def ln_attention_replaced(shape, args):
    """What row 7 would replace on the same inputs: kernel 2 (LN + QKV)
    then kernel 5 (W-MSA)."""
    from thyroid_tpu_torch.ops import attention, token_fused

    x, g, beta, w, bq, bias, mask = args
    b, r, _, c = x.shape
    _, _, _, heads, ws, _ = shape
    wd = w.to(x.dtype)

    def run():
        qkv = token_fused.fused_ln_matmul(x, g, beta, wd, bq)
        return attention.fused_swin_attention(
            qkv.reshape(b, r, r, 3, c), bias, mask, window_size=ws,
            num_heads=heads, scale=(c // heads) ** -0.5)

    return run


def window_library(args):
    """SDPA with the bias (+ the window's mask) as a float attn_mask;
    timing only."""
    import torch.nn.functional as F

    q, k, v, bias, mask = args
    bw, heads, n, d = q.shape
    if mask is None:
        am = bias[None].expand(bw, heads, n, n)
    else:
        nw = mask.shape[0]
        am = (bias[None] + mask[:, None])[None].expand(bw // nw, nw, heads, n, n) \
            .reshape(bw, heads, n, n)
    am = am.to(q.dtype).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                  scale=d ** -0.5)


def remaining_work(kernel: str, shape, dtype):
    """(bytes, operations, peak operations/s) of one row 7 or row 8 call:
    each input read once, each output written once. Row 7: x, W (3C·C),
    γ, β, the QKV bias, bias and mask in, the output out; 2·3C·C per token
    for the projection and 4·N²·C per window for attention. Row 8: q, k, v
    in and O out, bias and mask; 4·N²·C per window. At the tensor-core
    rate of the input type."""
    s = torch.tensor([], dtype=dtype).element_size()
    b, r, c, heads, ws, shift = shape
    n, nw = ws * ws, (r // ws) ** 2
    tokens = b * r * r
    side = heads * n * n * 4 + (nw * n * n * 4 if shift else 0)
    attn_ops = b * nw * 4 * n * n * c
    if kernel == "window_attention":
        return 4 * tokens * c * s + side, attn_ops, PEAK_OPS_PER_S[dtype]
    return 2 * tokens * c * s + 3 * c * c * s + (2 * c + 3 * c) * 4 + side, \
        2 * tokens * c * 3 * c + attn_ops, PEAK_OPS_PER_S[dtype]


def phase_remaining_times(attn_shapes, launches, frames):
    """Rows 7 and 8 per 12-block swin_tiny forward at bucket 32 (bf16) and
    row 16 per 32-frame chunk: device time (CUDA-graph replays) beside the
    bound, the plain version and the library call; row 7 also beside
    kernels 2 + 5 on the same inputs, row 16 beside the composition
    clahe_uint16_dual + where. Returns their JSON entries."""
    from thyroid_tpu_torch.ops import clahe

    gen = torch.Generator(device="cuda").manual_seed(21)
    dtype = torch.bfloat16
    meta = {"swin_ln_attention": ("fused_swin_ln_attention", "swin_ln_attention.cu",
                                  "ops/attention.py:580"),
            "window_attention": ("fused_window_attention", "window_attention.cu",
                                 "ops/attention.py:130")}
    entries = []
    with torch.inference_mode():
        for kernel, make in (("swin_ln_attention", ln_attention_inputs),
                             ("window_attention", window_inputs)):
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0, "err": 0.0, "replaced_ms": 0.0}
            for shape, count in attn_shapes.items():
                args = make(shape, dtype, gen)
                fused, plain = remaining_fns(kernel, shape)
                lib = ln_attention_library(shape, args) \
                    if kernel == "swin_ln_attention" else window_library(args)
                ms = device_ms(lambda: fused(*args))
                plain_ms = device_ms(lambda: plain(*args), reps=3, replays=3)
                lib_ms = device_ms(lib)
                replaced = ""
                if kernel == "swin_ln_attention":
                    rep_ms = device_ms(ln_attention_replaced(shape, args))
                    tot["replaced_ms"] += count * rep_ms
                    replaced = f", kernels 2 + 5 {rep_ms:.4f} ms"
                err = (fused(*args).float() - plain(*args).float()).abs().max().item()
                nbytes, ops, peak = remaining_work(kernel, shape, dtype)
                t_bytes = nbytes / H100_BYTES_PER_S * 1e3
                t_ops = ops / peak * 1e3
                log(f"[remaining-times] {kernel} bf16 {shape} x{count}: device time "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                    f"{lib_ms:.4f} ms{replaced}; bound {max(t_bytes, t_ops):.4f} ms "
                    f"({'bytes' if t_bytes >= t_ops else 'operations'})")
                tot["ms"] += count * ms
                tot["plain_ms"] += count * plain_ms
                tot["library_ms"] += count * lib_ms
                tot["bound_ms"] += count * max(t_bytes, t_ops)
                tot["bytes_ms"] += count * t_bytes
                tot["ops_ms"] += count * t_ops
                tot["err"] = max(tot["err"], err)
                del args
            name, src, replaces = meta[kernel]
            entries.append({
                "name": name, "route": "cuda",
                "source": f"thyroid_tpu_torch/csrc/{src}",
                "replaces": f"thyroid_tpu/{replaces}",
                "launches": launches[kernel], "max_abs_err": tot["err"],
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                else "operations",
                "library_ms": tot["library_ms"]})
            log(f"[remaining-times] {name} per swin_tiny forward at bucket {BATCH}, "
                f"device time: {tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms, "
                f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms"
                + (f", kernels 2 + 5 {tot['replaced_ms']:.4f} ms"
                   if kernel == "swin_ln_attention" else "") + ")")

        # row 16: the kernel on the wrapper's own inputs, per chunk
        x, use_coarse, apply = dual_fused_case(frames)
        img, lo, span, x8 = clahe._to_8bit(x)
        luts_c, luts_f = clahe._dual_luts(x8, **DUAL_GRIDS)
        kargs = (x8, img.contiguous(), luts_c, luts_f, use_coarse, apply,
                 lo.reshape(-1), span.reshape(-1), DUAL_GRIDS["grid_coarse"],
                 DUAL_GRIDS["grid_fine"])
        ms = device_ms(lambda: clahe.apply_luts_dual_fused(*kargs))
        plain_ms = median_ms(lambda: clahe.apply_luts_dual_fused_plain(*kargs),
                             reps=5, warm=1)
        full_ms = median_ms(lambda: clahe.clahe_uint16_dual_fused(
            x, use_coarse, apply, **DUAL_GRIDS))
        comp_ms = median_ms(lambda: torch.where(
            apply.reshape(-1, 1, 1, 1),
            clahe.clahe_uint16_dual(x, use_coarse, **DUAL_GRIDS), x))
        err = (clahe.apply_luts_dual_fused(*kargs)
               - clahe.apply_luts_dual_fused_plain(*kargs)).abs().max().item()
    b, h, w = x8.shape
    equalised = apply & (span.reshape(-1) > 0)
    n_eq = int(equalised.sum())
    lut_bytes = sum((luts_c[i] if use_coarse[i] else luts_f[i]).numel() * 4
                    for i in range(b) if equalised[i])
    # bytes this run's data needs: per pixel one input (x8 where the frame is
    # equalised, the frame itself elsewhere) and the output, plus the LUTs
    # of the equalised frames; operations about 20 float32 per equalised
    # pixel (tile coordinates, three blends, round, scale) and 2 float64
    nbytes = 2 * b * h * w * 4 + lut_bytes
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (n_eq * h * w * 20 / PEAK_OPS_PER_S[torch.float32]
             + n_eq * h * w * 2 / PEAK_OPS_PER_S[torch.float64]) * 1e3
    log(f"[remaining-times] apply_luts_dual_fused per {b}-frame chunk of 512x512 "
        f"({n_eq} equalised): device time kernel {ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms (CUDA events, its host copies included); library none; "
        f"clahe_uint16_dual_fused whole {full_ms:.4f} ms beside the composition "
        f"clahe_uint16_dual + where {comp_ms:.4f} ms (CUDA events, histogram/LUT "
        f"chain included); bound {max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    entries.append({
        "name": "apply_luts_dual_fused", "route": "cuda",
        "source": "thyroid_tpu_torch/csrc/clahe.cu",
        "replaces": "thyroid_tpu/ops/clahe.py:540",
        "launches": launches["apply_luts_dual_fused"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None})
    return entries


def medical_mlp_shapes(batch: int):
    """{(T, C, Hd): launches per forward} of the LN + MLP kernel in
    swin_medical.yaml's forward at 256²: maps 64, 32, 16, 8 (the MLP runs
    on the unpadded tokens), depths (2, 2, 18, 2)."""
    return {(batch * (64 // 2 ** i) ** 2, 96 * 2 ** i, 384 * 2 ** i): depth
            for i, depth in enumerate((2, 2, 18, 2))}


# widths of swin_base (128·2^k) and swin_large (192·2^k) at their last two
# stages' tokens at bucket 32: kernel 3 takes them in both types (the
# scalar float32 kernel in blocks of 16 rows above C = 1024)
WIDE_MLP_SHAPES = ((6272, 512, 2048), (1568, 1024, 4096), (6272, 768, 3072),
                   (1568, 1536, 6144))


# (T, C, O, bias) of the LN + matmul kernel that phase 2 does not reach:
# swin_medical.yaml's merges at 256² and bucket 32 (maps 64, 32, 16 halved),
# and at bucket 32 and 224² swin_base's (embed 128) and swin_large's (embed
# 192) widest QKV and last merge
MEDICAL_MERGE_SHAPES = ((32768, 384, 192, False), (8192, 768, 384, False),
                        (2048, 1536, 768, False))
WIDE_LN_MATMUL_SHAPES = ((1568, 1024, 3072, True), (1568, 1536, 4608, True),
                         (1568, 2048, 1024, False), (1568, 3072, 1536, False))
# (B, H, C, heads, ws, shift) of the LN + QKV + W-MSA kernel (row 7) in bf16
# at swin_large's stage 4 (C = 1536, 48 heads of 32, 7x7 maps) at batch 32,
# where its normalised rows stream from a workspace
WIDE_LN_ATTENTION_SHAPE = (BATCH, 7, 1536, 48, 7, 0)
# (B, H, C, heads, ws, shift) of the block attention (kernel 4) at
# swin_base's (embed 128, heads 4-32) and swin_large's (embed 192, heads
# 6-48) four stages at batch 32 and 224², shifted where the map allows:
# widths up to 1536, which the bf16 kernel takes in column blocks
WIDE_BLOCK_ATTENTION_SHAPES = tuple(
    (BATCH, 56 // 2 ** i, embed * 2 ** i, heads * 2 ** i, 7, 3 if i < 3 else 0)
    for embed, heads in ((128, 4), (192, 6)) for i in range(4))
# (T, C) of swin_base's first three stages at batch 32: the LN + MLP
# backward's widths 128-512 (it takes C up to 768)
SWIN_BASE_TOKEN_SHAPES = ((100352, 128), (25088, 256), (6272, 512))


def medical_token_shapes(batch: int):
    """(T, C) of swin_medical.yaml's four stages at 256² and `batch` (maps
    64, 32, 16, 8): kernel 9's step shapes beyond swin_tiny's."""
    return tuple((batch * (64 // 2 ** i) ** 2, 96 * 2 ** i) for i in range(4))


def phase_tensor_core():
    """The wgmma kernels against their plain versions at the shapes phases
    2 and 11 do not take: kernel 3 (LN + MLP forward) at swin_medical.yaml's
    256² forward and the swin_base and swin_large widths up to 1536, kernel
    10 (its dX) at width 512, kernel 2 (LN + matmul) at swin_medical's
    merges and swin_base's and swin_large's widest QKV and merges (C up to
    3072, O up to 4608), kernel 11 (the LN + MLP weight gradients) at
    swin_base's widths 128-512, kernel 9 (the LN + QKV backward) at
    swin_medical's 256² step, kernel 4 (the block attention) in bf16 at
    swin_base's and swin_large's stage shapes (two runs bit-equal) and in
    float32 at their last two, kernels 5 and 6 (the training attention) in
    bf16 at the same stage shapes (two runs bit-equal), kernel 7 (LN + QKV +
    W-MSA) in bf16 at swin_large's stage 4 (C = 1536; two runs bit-equal;
    its device time) and the hashes of its output at swin_tiny's widths;
    then kernel 3's time per swin_medical forward."""
    from thyroid_tpu_torch.ops import token_fused as tf

    gen = torch.Generator(device="cuda").manual_seed(21)
    failed = []
    med = medical_mlp_shapes(BATCH)
    cases = [(shape, dt) for shape in med for dt in (torch.float32, torch.bfloat16)]
    cases += [(shape, dt) for shape in WIDE_MLP_SHAPES
              for dt in (torch.float32, torch.bfloat16)]
    def hold(kernel, fused, plain, shape, dtype):
        args = make_inputs(kernel, shape, dtype, gen)
        got, want = fused(*args).float(), plain(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = RTOL[dtype] * max(1.0, want.abs().max().item())
        ok = bool(np.isfinite(err)) and err <= tol and bool(torch.isfinite(got).all())
        log(f"[tensor-core] {kernel} {str(dtype)[6:]} {shape}: max_abs_err "
            f"{err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((kernel, str(dtype), shape, err))

    for shape, dtype in cases:
        hold("ln_mlp_residual", tf.fused_ln_mlp_residual, tf.ln_mlp_residual_plain,
             shape, dtype)
    for dtype in (torch.float32, torch.bfloat16):
        shape = (6272, 512)                         # swin_base stage 3
        args = make_token_inputs("ln_mlp_bwd_dx", shape, dtype, gen)
        fused, plain = token_fns("ln_mlp_bwd_dx")
        for name, err, tol, ok in compare_token("ln_mlp_bwd_dx", fused(*args),
                                                plain(*args), dtype):
            log(f"[tensor-core] ln_mlp_bwd_dx {str(dtype)[6:]} {shape} {name}: "
                f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(("ln_mlp_bwd_dx", str(dtype), shape, name, err))
        del args
    for shape in MEDICAL_MERGE_SHAPES + WIDE_LN_MATMUL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            hold("ln_matmul", tf.fused_ln_matmul, tf.ln_matmul_plain, shape, dtype)
    for kernel, shapes in (("ln_mlp_bwd_dw", SWIN_BASE_TOKEN_SHAPES),
                           ("ln_matmul_bwd", medical_token_shapes(BATCH))):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                args = make_token_inputs(kernel, shape, dtype, gen)
                fused, plain = token_fns(kernel)
                for name, err, tol, ok in compare_token(kernel, fused(*args),
                                                        plain(*args), dtype):
                    log(f"[tensor-core] {kernel} {str(dtype)[6:]} {shape} {name}: "
                        f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failed.append((kernel, str(dtype), shape, name, err))
                del args
    for shape in WIDE_BLOCK_ATTENTION_SHAPES:
        args = make_inputs("swin_block_attention", shape, torch.bfloat16, gen)
        fused, plain = kernel_fns("swin_block_attention", shape)
        got, again = fused(*args), fused(*args)
        want = plain(*args).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = RTOL[torch.bfloat16] * max(1.0, want.abs().max().item())
        same = torch.equal(got, again)
        ok = bool(np.isfinite(err)) and err <= tol and same
        log(f"[tensor-core] swin_block_attention bfloat16 {shape}: max_abs_err "
            f"{err:.3e} tol {tol:.3e} two runs bit-equal {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(("swin_block_attention", shape, err, same))
        del args, got, again, want
    for shape in WIDE_BLOCK_ATTENTION_SHAPES:
        if shape[2] >= 512:   # the last two stages: C = 512-1536
            fused, plain = kernel_fns("swin_block_attention", shape)
            hold("swin_block_attention", fused, plain, shape, torch.float32)
        for kernel in ("swin_attention", "swin_attention_bwd"):
            args = make_train_inputs(kernel, shape, torch.bfloat16, gen)
            fused, plain = train_kernel_fns(shape)[kernel]
            got, again = fused(*args), fused(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            for name, err, tol, ok in compare_train(kernel, got, want, torch.bfloat16):
                log(f"[tensor-core] {kernel} {name} bfloat16 {shape}: max_abs_err "
                    f"{err:.3e} tol {tol:.3e} two runs bit-equal {same} "
                    f"{'ok' if ok and same else 'FAIL'}")
                if not (ok and same):
                    failed.append((kernel, name, shape, err, same))
            del args, got, again, want
    shape = WIDE_LN_ATTENTION_SHAPE
    args = ln_attention_inputs(shape, torch.bfloat16, gen)
    fused, plain = remaining_fns("swin_ln_attention", shape)
    got, again = fused(*args), fused(*args)
    want = plain(*args).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    tol = ATTN_RTOL[torch.bfloat16] * max(1.0, want.abs().max().item())
    same = torch.equal(got, again)
    ok = bool(np.isfinite(err)) and err <= tol and same and bool(torch.isfinite(got).all())
    ms, lib_ms = device_ms(lambda: fused(*args)), device_ms(ln_attention_library(shape, args))
    nbytes, ops, peak = remaining_work("swin_ln_attention", shape, torch.bfloat16)
    log(f"[tensor-core] swin_ln_attention bfloat16 {shape}: max_abs_err {err:.3e} tol "
        f"{tol:.3e} two runs bit-equal {same} {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
        f"library {lib_ms:.4f} ms (device), bound "
        f"{max(nbytes / H100_BYTES_PER_S, ops / peak) * 1e3:.4f} ms; sha256 {sha(got)}")
    if not ok:
        failed.append(("swin_ln_attention", shape, err, same))
    del args, got, again, want
    for name, digest in ln_attention_hashes().items():
        log(f"[tensor-core] sha256 {name}: {digest}")
    phase_window_wide(gen, failed)
    if failed:
        raise AssertionError(f"tensor-core kernels disagree: {failed}")
    tot = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for shape, count in med.items():
        args = make_inputs("ln_mlp_residual", shape, torch.bfloat16, gen)
        ms = median_ms(lambda: tf.fused_ln_mlp_residual(*args))
        lib_ms = device_ms(library_fn("ln_mlp_residual", shape, args))
        nbytes, ops, peak = work("ln_mlp_residual", shape, torch.bfloat16)
        bound = max(nbytes / H100_BYTES_PER_S, ops / peak) * 1e3
        log(f"[tensor-core] ln_mlp_residual bf16 {shape} x{count}: kernel {ms:.4f} ms, "
            f"library {lib_ms:.4f} ms (device), bound {bound:.4f} ms")
        for k, v in (("ms", ms), ("library_ms", lib_ms), ("bound_ms", bound)):
            tot[k] += count * v
        del args
    log(f"[tensor-core] ln_mlp_residual per swin_medical forward at bucket {BATCH}: "
        f"{tot['ms']:.4f} ms (library {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms)")


def phase_window_wide(gen, failed) -> None:
    """Row 8 in bf16 at swin_large's stage 4 (48 heads) on wgmma against
    its plain version, two runs bit-equal, its device time beside SDPA's and
    its bound; row 8 in float32 (the scalar kernel) per swin_tiny forward
    at bucket 32 and at swin_large's stage 4; the SHA-256 of row 8's
    outputs. Appends what disagrees to `failed`."""
    from thyroid_tpu_torch.ops import attention

    shape = WIDE_LN_ATTENTION_SHAPE
    args = window_inputs(shape, torch.bfloat16, gen)
    fused, plain = remaining_fns("window_attention", shape)
    got, again = fused(*args), fused(*args)
    want = plain(*args).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    tol = ATTN_RTOL[torch.bfloat16] * max(1.0, want.abs().max().item())
    same = torch.equal(got, again)
    route = attention.window_attention_route(*args[:3])
    ok = bool(np.isfinite(err)) and err <= tol and same and route == "wgmma" \
        and bool(torch.isfinite(got).all())
    ms, lib_ms = device_ms(lambda: fused(*args)), device_ms(window_library(args))
    nbytes, ops, peak = remaining_work("window_attention", shape, torch.bfloat16)
    log(f"[tensor-core] window_attention bfloat16 {shape}: kernel {route}, max_abs_err "
        f"{err:.3e} tol {tol:.3e} two runs bit-equal {same} {'ok' if ok else 'FAIL'}; "
        f"kernel {ms:.4f} ms, library (SDPA) {lib_ms:.4f} ms (device), bound "
        f"{max(nbytes / H100_BYTES_PER_S, ops / peak) * 1e3:.4f} ms")
    if not ok:
        failed.append(("window_attention", shape, err, same, route))
    del args, got, again, want
    shapes = dict(swin_tiny_shapes(BATCH)["swin_block_attention"])
    tot = {"ms": 0.0, "bound_ms": 0.0}
    for shape, count in list(shapes.items()) + [(WIDE_LN_ATTENTION_SHAPE, 0)]:
        args = window_inputs(shape, torch.float32, gen)
        ms = device_ms(lambda: attention.fused_window_attention(*args))
        nbytes, ops, peak = remaining_work("window_attention", shape, torch.float32)
        bound = max(nbytes / H100_BYTES_PER_S, ops / peak) * 1e3
        log(f"[tensor-core] window_attention float32 {shape} x{count}: kernel "
            f"{attention.window_attention_route(*args[:3])} {ms:.4f} ms (device), bound "
            f"{bound:.4f} ms")
        tot["ms"] += count * ms
        tot["bound_ms"] += count * bound
        del args
    log(f"[tensor-core] window_attention float32 per swin_tiny forward at bucket "
        f"{BATCH}: {tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms)")
    for name, digest in window_hashes().items():
        log(f"[tensor-core] sha256 {name}: {digest}")


# the registry's swin_large with no dtype: float32 (embed 192, depths (2,
# 2, 18, 2), heads (6, 12, 24, 48); stage 4 at C = 1536)
SWIN_LARGE_F32 = {"name": "swin_large", "in_channels": 1, "num_classes": 2}


def phase_large_f32() -> None:
    """swin_large in float32 served on the card at bucket 4: the launches
    per forward (1 percentile, 24 QKV + 3 merges LN + matmul, 24 LN + MLP,
    24 block attention) and the probabilities against the CPU float32
    engine on the same weights and frames; then predict's median time."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    params = perturbed_params(SWIN_LARGE_F32)
    engine = InferenceEngine(SWIN_LARGE_F32, params=params, buckets=(4,))
    frames = (np.random.RandomState(24).rand(4, 512, 512, 1) * 65535) \
        .astype(np.float32)
    for fn in counters().values():
        fn.launches = 0
    probs = engine.predict(frames)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"percentile": 1, "ln_matmul": 27, "ln_mlp_residual": 24,
            "swin_block_attention": 24}
    log(f"[large-f32] swin_large float32 served N=4 in one forward; "
        f"launches {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if probs.shape != (4, 2) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(-1) - 1).max() > 1e-3:
        raise AssertionError(f"bad probabilities {probs.shape}")
    cpu = InferenceEngine(SWIN_LARGE_F32, params=params, buckets=(4,),
                          device="cpu").predict(frames)
    err = float(np.abs(probs - cpu).max())
    tol = PROB_TOL[torch.float32]
    log(f"[large-f32] N=4 probabilities, cuda f32 vs cpu f32: max_abs_err "
        f"{err:.3e} tol {tol:.0e} (spread of p0 over the batch "
        f"{float(cpu[:, 0].max() - cpu[:, 0].min()):.3e})")
    if not err <= tol:
        raise AssertionError("swin_large float32 probabilities disagree with "
                             "the CPU")
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict(frames)
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    log(f"[large-f32] predict swin_large float32 bucket 4: median "
        f"{med * 1e3:.2f} ms over 3, {4 / med:.1f} images/s (raw 512x512 "
        f"frames from host memory)")


def phase_yaml_times(engine, cfg, params, registry_params):
    """images/s of predict for the YAML swin_tiny beside the registry
    swin_tiny (with `registry_params`) at buckets 32 and 128 (in turns),
    training images/s of the YAML swin_tiny at batch 32 and 128, and a
    profile of one YAML predict."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    registry = InferenceEngine(SWIN_TINY, params=registry_params)
    rs = np.random.RandomState(22)
    for n in (32, 128):
        frames = (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
        for name, eng in (("swin_tiny.yaml", engine), ("registry swin_tiny", registry),
                          ("swin_tiny.yaml", engine), ("registry swin_tiny", registry)):
            eng.predict(frames)
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.predict(frames)
                secs.append(time.perf_counter() - t0)
            med = statistics.median(secs)
            log(f"[yaml-times] predict {name} bf16 bucket {n}: median "
                f"{med * 1e3:.2f} ms over 5, {n / med:.1f} images/s (raw 512x512 "
                f"frames from host memory)")
    del registry
    gen = torch.Generator(device="cuda").manual_seed(23)
    for n in (BATCH, 128):
        torch.cuda.reset_peak_memory_stats()
        trainer = make_trainer(cfg, params, "yaml_speed")
        med, trainer, batch = train_step_seconds(None, n, gen, trainer=trainer)
        log(f"[yaml-times] train step swin_tiny.yaml batch {n}: median "
            f"{med * 1e3:.2f} ms over 5, {n / med:.1f} images/s (bf16, drop path "
            f"0.2, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)")
        del trainer, batch
        torch.cuda.empty_cache()
    phase_profile(engine, what="swin_tiny.yaml predict")


# phase 23: the k-fold experiment from a corpus on disk, at full width
EXPERIMENT_META = {"n_images": 450, "size": 512, "seed": 42,
                   "difficulty": 0.0, "label_noise": 0.0}
# the keys kfold_summary_*.json holds beside avg_/std_ of each number of
# the fold rows (aggregate_results + log_results)
SUMMARY_KEYS = {"num_successful_folds", "total_folds", "raw_fold_results",
                "experiment_name", "model_name"}
FOLD_NUMBERS = {"fold", "best_val_metric", "epochs_trained", "train_time_s",
                *(f"{split}_{m}" for split in ("val", "test")
                  for m in ("acc", "auc", "f1", "loss", "npv", "ppv",
                            "sensitivity", "specificity"))}


def all_counters():
    """Every kernel wrapper's launch counter, by name."""
    return {**train_counters(), **quality_counters(), **token_counters(),
            **effnet_counters(), **remaining_counters()}


def phase_experiment(card: str) -> None:
    """The k-fold experiment from a corpus on disk: the 450-frame 512²
    synthetic corpus written by the port's generator and PNG writer, the
    16 committed data/synthetic_tiny PNGs decoded pixel-equal to the
    generator, then launch_experiment (efficientnet_b0 at 224², 2 folds,
    one epoch, quality preprocessing on, checkpoints on) with every path
    under WORK; its fold files must equal the committed data/splits ones,
    both folds succeed with finite averages, and the quality kernels 12,
    13, 15 and 1 launch once per 32-frame chunk of each split."""
    import math

    from thyroid_tpu_torch.data.corpus import load_split_file
    from thyroid_tpu_torch.data.dataset import CARSThyroidDataset
    from thyroid_tpu_torch.data.imageio import decode_image
    from thyroid_tpu_torch.data.synthetic import generate_corpus, generate_image
    from thyroid_tpu_torch.experiment import launch_experiment

    root = Path(__file__).resolve().parent
    work = WORK / "experiment"
    shutil.rmtree(work, ignore_errors=True)
    corpus = work / "synthetic"
    t0 = time.perf_counter()
    generate_corpus(corpus, **EXPERIMENT_META)
    secs = time.perf_counter() - t0
    log(f"[experiment] generate_corpus 450 frames 512x512 uint16 PNG: "
        f"{secs:.2f} s, {450 / secs:.1f} frames/s")
    meta = json.loads((corpus / "_meta.json").read_text())
    if meta != EXPERIMENT_META:
        raise AssertionError(f"_meta.json {meta}, expected {EXPERIMENT_META}")

    tiny = sorted((root / "data" / "synthetic_tiny").glob("*/*.png"))
    if len(tiny) != 16:
        raise AssertionError(f"{len(tiny)} committed synthetic_tiny PNGs, expected 16")
    for path in tiny:
        label = 0 if path.parent.name == "normal" else 1
        i = int(path.stem.split("_")[-1])
        want = generate_image(42 * 1_000_003 + label * 100_000 + i, label, 512)
        got = decode_image(path)
        if got.dtype != np.uint16 or not np.array_equal(got, want):
            raise AssertionError(f"{path.name} does not decode to the generator's frame")
    log("[experiment] the 16 committed data/synthetic_tiny PNGs decode "
        "pixel-equal to generate_image")
    decode_fixtures(root, tiny[0])
    ds = CARSThyroidDataset({"data_path": str(corpus)}, split="all")
    t0 = time.perf_counter()
    frames = ds.load_images()
    secs = time.perf_counter() - t0
    log(f"[experiment] load_images (8 threads) {frames.shape} {frames.dtype}: "
        f"{secs:.3f} s, {len(frames) / secs:.1f} frames/s")
    for j in (0, 1, 224, 225, 226, 449):
        label, i = int(ds.all_labels[j]), int(ds.all_paths[j].stem.split("_")[-1])
        want = generate_image(42 * 1_000_003 + label * 100_000 + i, label, 512)
        if not np.array_equal(frames[j, ..., 0], want):
            raise AssertionError(f"{ds.all_paths[j].name} decodes to other pixels")
    del frames, ds

    overrides = ["model=cnn/efficientnet_b0", "dataset=synthetic",
                 "training=cnn", "augmentation=no_aug", "trainer.max_epochs=1",
                 "kfold.num_folds=2", f"dataset.data_path={corpus}",
                 f"dataset.split_dir={work / 'splits'}",
                 f"kfold.split_dir={work / 'splits'}",
                 f"output_dir={work / 'out'}"]
    log(f"[experiment] launch_experiment {' '.join(overrides)}")
    for fn in all_counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    summary = launch_experiment(overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in all_counters().items()}
    rows = summary.get("raw_fold_results", [])
    for row in rows:
        log(f"[experiment] fold {row.get('fold')}: train_time_s "
            f"{row.get('train_time_s')} test_acc {row.get('test_acc')} "
            f"val_acc {row.get('val_acc')} error {row.get('error')}")
    log(f"[experiment] wall time {wall:.2f} s for 2 folds of one epoch "
        f"(efficientnet_b0 bf16 224x224, batch 32, quality preprocessing); "
        f"card {card}")

    failed = [r for r in rows if "error" in r]
    if failed or summary.get("num_successful_folds") != 2:
        raise AssertionError(f"folds failed: {failed or summary.get('status')}")
    for n in (1, 2):
        got = json.loads((work / "splits" / f"split_fold_{n}.json").read_text())
        want = json.loads((root / "data" / "splits" / f"split_fold_{n}.json").read_text())
        if got != want:
            raise AssertionError(f"split_fold_{n}.json differs from data/splits'")
    log("[experiment] generated split_fold_{1,2}.json equal data/splits'")
    bad = {k: v for k, v in summary.items()
           if k.startswith("avg_") and not math.isfinite(v)}
    if bad or not 0 <= summary["avg_test_acc"] <= 1:
        raise AssertionError(f"averages not finite or accuracy out of [0, 1]: "
                             f"{bad or summary['avg_test_acc']}")
    paths = list((work / "out").rglob("kfold_summary_*.json"))
    if len(paths) != 1:
        raise AssertionError(f"kfold summaries {paths}")
    written = json.loads(paths[0].read_text())
    numbers = {k for r in rows for k, v in r.items()
               if isinstance(v, (int, float)) and math.isfinite(v)}
    want_keys = SUMMARY_KEYS | {f"{p}_{k}" for p in ("avg", "std") for k in numbers}
    if numbers != FOLD_NUMBERS or set(written) != want_keys:
        raise AssertionError(f"summary keys {sorted(set(written) ^ want_keys)} "
                             f"differ; fold numbers "
                             f"{sorted(numbers ^ FOLD_NUMBERS)} differ")
    log(f"[experiment] {paths[0].name}: {len(written)} keys, avg_test_acc "
        f"{summary['avg_test_acc']:.4f}, avg_val_acc {summary['avg_val_acc']:.4f}")

    chunks = sum(math.ceil(len(v) / 32)
                 for n in (1, 2)
                 for v in load_split_file(work / "splits" / f"split_fold_{n}.json").values())
    quality = ("stats_quantile", "median_bilateral", "apply_luts_dual", "percentile")
    want = {k: (chunks if k in quality else 0) for k in launches}
    log(f"[experiment] launches over the run {launches} ({chunks} chunks of "
        f"at most 32 frames)")
    if launches != want or chunks != 32:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"({chunks} chunks, 32 expected)")


def array_digest(arr: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes: the digest
    tests/fixtures/imageio/make_fixtures.py stores for cv2's arrays."""
    arr = np.ascontiguousarray(arr)
    return hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode() + arr.tobytes()).hexdigest()


def decode_fixtures(root: Path, png: Path) -> None:
    """Phase 23's decoding fixtures: each committed file decoded on the
    host equal to the SHA-256 of cv2's array (channels in cv2's order) and
    of JAX's decode_image stored in hashes.json; ms per frame (best of 3)
    beside a 512x512 PNG's; the 512x512 ones as a corpus through
    load_images (the k-fold experiment's decode path)."""
    from thyroid_tpu_torch.data.dataset import CARSThyroidDataset
    from thyroid_tpu_torch.data.imageio import decode_file, decode_image

    fixtures = root / "tests" / "fixtures" / "imageio"
    hashes = json.loads((fixtures / "hashes.json").read_text())

    def best_ms(path):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            decode_image(path)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    bad = []
    for name, want in sorted(hashes.items()):
        arr = decode_file(fixtures / name)
        if arr.ndim == 3:
            arr = arr[..., [2, 1, 0] + ([3] if arr.shape[-1] == 4 else [])]
        ok = (array_digest(arr) == want["cv2"]
              and array_digest(decode_image(fixtures / name)) == want["decode_image"])
        log(f"[decode] {name} {arr.shape} {arr.dtype}: "
            f"{'equal to cv2' if ok else 'DIFFERS from cv2'}; "
            f"{best_ms(fixtures / name):.2f} ms per frame")
        if not ok:
            bad.append(name)
    log(f"[decode] a 512x512 uint16 PNG ({png.name}): {best_ms(png):.2f} ms per frame")
    corpus = WORK / "decode_corpus"
    big = [n for n, v in sorted(hashes.items()) if v["shape"][:2] == [512, 512]]
    for i, name in enumerate(big):
        cls = corpus / ("normal" if i % 2 == 0 else "cancerous")
        cls.mkdir(parents=True, exist_ok=True)
        shutil.copy(fixtures / name, cls / name)
    ds = CARSThyroidDataset({"data_path": str(corpus)}, split="all")
    frames = ds.load_images()
    got = sorted(array_digest(f[..., 0]) for f in frames)
    want = sorted(hashes[n]["decode_image"] for n in big)
    log(f"[decode] load_images over {len(big)} 512x512 fixtures {frames.shape}: "
        f"{'equal to decode_image' if got == want else 'DIFFERS'}")
    shutil.rmtree(corpus, ignore_errors=True)
    if bad or got != want:
        raise AssertionError(f"fixtures decode to other arrays: {bad}")


# phase 24: augmentation and ResNet
RESNET50 = {"name": "resnet50", "in_channels": 1, "num_classes": 2,
            "dtype": "bf16"}
# augmentation on the card against the CPU on the same drawn parameters:
# elements further apart than AUG_TOL at most AUG_SHARE of them (a warp's
# coordinate rounds on either side of a pixel or of a floor onto the
# 8-bit grid), none further than one 8-bit level
AUG_TOL, AUG_SHARE, AUG_MAX = 1e-5, 1e-4, 1 / 255 + 1e-5
AUG_LEVELS = ("light", "medium", "heavy")
# resnet50 with seeded weights amplifies a perturbation of its float32
# activations in every block, most at each stage's first, while bf16 adds
# a rounding or two in each: its bf16 probabilities stand far past
# PROB_TOL from float32's, on the CPU as on the card (phase 24 logs both,
# block by block, with each block's gain). So the card's bf16 engine is
# held to the CPU's bf16 engine (the same roundings, summed in another
# order) at PROB_TOL, and each block on the card in bf16, fed the CPU's
# float32 input, to the CPU's float32 output within this (a few bf16
# roundings)
RESNET_BLOCK_BF16_TOL = 2e-2
# a seeded deep CNN's float32 gradient turns on its ReLU decisions and
# max-pool choices: a few hundred of resnet50's 77 million in a step at
# batch 8 flip when the same sums run in another order, and those alone
# move the gradient by a few per cent. So the CPU's reference step takes
# the card's decisions (step_decisions) and is held to the card at phase
# 15's limits, each leaf within STEP_GRAD_RTOL too; the decisions that the
# CPU would have taken the other way are at most this share
STEP_FLIP_SHARE = 1e-4
# leaves whose float32 gradient no order of summation holds to
# STEP_GRAD_RTOL, logged and not held. densenet121's stem reaches the loss
# only through train-mode BatchNorms, which all but cancel a common growth
# of norm0's scale and bias, so ∂L/∂(norm0.scale) is a sum over every stem
# position whose terms cancel about 4e6-fold (median over channels; two
# CPU thread counts give float32 sums 3.6e-2 apart at 224², batch 2:
# scripts/torch_grad_condition.py). norm0's bias and conv0's kernel, which
# carry the same upstream gradient, are held
STEP_FREE_LEAVES = {"densenet121": ("norm0.scale",)}


def aug_cases(shape):
    """{case: (draw(generator), apply(x, params) → tuple of tensors)} of
    phase 24's augmentation checks."""
    from thyroid_tpu_torch.ops import augment as A

    cases = {}
    for level in AUG_LEVELS:
        cases[f"train_augment {level}"] = (
            lambda g, level=level: A.draw_train_augment(g, shape, level),
            lambda x, p, level=level: (A.apply_train_augment(x, p, level),))
    cases["vit_augment m=9"] = (
        lambda g: A.draw_vit_augment(g, shape),
        lambda x, p: (A.apply_vit_augment(x, p, randaugment_m=9.0),))

    def mix(x, p):
        labels = torch.arange(x.shape[0], device=x.device)
        mixed, _, labels_b, lam = A.apply_mixup_cutmix(x, labels, p)
        return mixed, labels_b.float(), lam.reshape(1)

    cases["mixup_cutmix 0.8/1.0"] = (
        lambda g: A.draw_mixup_cutmix(g, shape, 0.8, 1.0), mix)
    return cases


def phase_augment() -> None:
    """(a) of phase 24: each augmentation case card against CPU on the
    same drawn parameters, and two card runs from one seed bit-equal."""
    from thyroid_tpu_torch.ops.augment import params_to

    shape = (BATCH, 224, 224, 1)
    x_cpu = torch.from_numpy(np.random.RandomState(24).rand(*shape)
                             .astype(np.float32))
    x = x_cpu.cuda()
    failed = []
    for i, (name, (draw, apply)) in enumerate(aug_cases(shape).items()):
        params = draw(torch.Generator().manual_seed(100 + i))
        want = apply(x_cpu, params)
        got = apply(x, params_to(params, "cuda"))
        torch.cuda.synchronize()
        err = torch.cat([(g.cpu() - w).abs().reshape(-1)
                         for g, w in zip(got, want)])
        share = float((err > AUG_TOL).float().mean())
        runs = [apply(x, draw(torch.Generator(device="cuda").manual_seed(7)))
                for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        moved = float((runs[0][0] - x).abs().max())
        log(f"[augment] {name} B={BATCH} 224x224 card vs cpu: max_abs_err "
            f"{float(err.max()):.3e} (tol {AUG_MAX:.3e}), share > {AUG_TOL:.0e} "
            f"{share:.3e} (tol {AUG_SHARE:.0e}); two card runs of one seed "
            f"bit-equal: {same}; max change of the batch {moved:.3f}")
        if not (float(err.max()) <= AUG_MAX and share <= AUG_SHARE and same
                and moved > 0):
            failed.append(name)
    if failed:
        raise AssertionError(f"augmentation on the card disagrees: {failed}")


def aug_pipeline(n: int = TRAIN_FRAMES):
    """A training DevicePipeline of `n` random raw 512x512 frames at 224²,
    batch 32."""
    from thyroid_tpu_torch.data.pipeline import DevicePipeline

    rs = np.random.RandomState(25)
    raw = (rs.rand(n, 512, 512, 1) * 65535).astype(np.float32)
    labels = rs.permutation(np.arange(n) % 2)
    return DevicePipeline(raw, labels, batch_size=BATCH, train=True)


def kernel_count(fn) -> str:
    """CUDA kernels one call of fn launches, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    return str(n) if n else "not measured (the profile holds no device time)"


def phase_augment_cost(variables, card: str) -> None:
    """(b) of phase 24: make_batch's time at each level and in vit mode,
    the kernels an augmented batch launches, and a resnet50 train step with
    a medium-level batch and with an unaugmented one."""
    from thyroid_tpu_torch.training import metrics as tmetrics

    pipe = aug_pipeline()
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.arange(BATCH, device="cuda")
    times = {}
    for level, mode in (("none", "standard"), ("light", "standard"),
                        ("medium", "standard"), ("heavy", "standard"),
                        ("medium", "vit")):
        pipe.augmentation_level, pipe.augment_mode = level, mode
        what = f"{level} {mode}"
        times[what] = median_ms(lambda: pipe.make_batch(idx, gen))
        log(f"[augment-cost] make_batch {what} B={BATCH} 224x224: "
            f"{times[what]:.3f} ms (median of 20 after 3); kernels launched "
            f"{kernel_count(lambda: pipe.make_batch(idx, gen))}; card {card}")
    trainer = effnet_trainer(dict(RESNET50), variables, "resnet_cost")
    labels = pipe.labels[:BATCH]
    weights = torch.ones(BATCH, device="cuda")
    for level in ("medium", "none"):
        pipe.augmentation_level, pipe.augment_mode = level, "standard"

        def step():
            trainer.train_step(tmetrics.zero_metric_state(device="cuda"),
                               pipe.make_batch(idx, gen), labels, weights)

        ms = median_ms(step, reps=5, warm=2)
        log(f"[augment-cost] resnet50 bf16 make_batch ({level}) + train_step "
            f"B={BATCH}: {ms:.2f} ms (median of 5 after 2), "
            f"{BATCH / ms * 1e3:.1f} images/s; card {card}")
    del trainer, pipe
    torch.cuda.empty_cache()


def phase_resnet(variables, card: str) -> None:
    """(c) of phase 24: resnet50 served (launches, images/s, probabilities
    against the CPU, and block by block its bf16 forward against float32)
    and its float32 train step against the CPU's, as phase 25 serves and
    steps the rest of the zoo."""
    ok = zoo_serve("resnet50", variables, {"percentile": 1}, card, blocks=True,
                   seed=26)[1]
    torch.cuda.empty_cache()
    if not ok & zoo_step("resnet50", variables, decisions=True, seed=27):
        raise AssertionError("resnet50 served or stepped on the card "
                             "disagrees with the CPU")


def block_io(model, run, n: int):
    """{block name: (input, output)} of the first n images at each of a
    ResNet's blocks in one call of run(), as float32 CPU tensors."""
    got, hooks = {}, []
    for name in model.blocks:
        hooks.append(getattr(model, name).register_forward_hook(
            lambda mod, args, out, name=name: got.__setitem__(
                name, (args[0][:n].float().cpu(), out[:n].float().cpu()))))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return got


def resnet_blocks(engines, blocks) -> bool:
    """Log resnet50's bf16 forward block by block against the CPU's float32
    one: the distance |a − b| / |b| of its input and output on the card
    and on the CPU, the error bf16 adds inside the block on the card (the
    block in bf16 fed the CPU's float32 input; held to
    RESNET_BLOCK_BF16_TOL), and the block's gain (the CPU's float32 block
    fed the card's bf16 input: its distance over the input's). True when
    every block holds."""
    def rel(a, b):
        return float((a - b).norm() / b.norm())

    card = engines["cuda bf16"].model
    cpu32 = engines["cpu f32"].model
    ok = True
    for name in card.blocks:
        x32, y32 = blocks["cpu f32"][name]
        x16, y16 = blocks["cuda bf16"][name]
        with torch.no_grad():
            local = getattr(card, name)(x32.cuda(), False, torch.bfloat16)
            prop = getattr(cpu32, name)(x16, False, torch.float32)
        local = rel(local.float().cpu(), y32)
        d_in = rel(x16, x32)
        log(f"[resnet-bf16] {name}: card bf16 vs cpu f32 in {d_in:.3e} out "
            f"{rel(y16, y32):.3e}; cpu bf16 vs cpu f32 out "
            f"{rel(blocks['cpu bf16'][name][1], y32):.3e}; bf16 inside the "
            f"block on the card {local:.3e} (tol {RESNET_BLOCK_BF16_TOL:.0e}); "
            f"float32 gain {rel(prop, y32) / d_in:.3f}")
        ok &= local <= RESNET_BLOCK_BF16_TOL
    return ok


# phase 24 (d): each run's overrides beyond the corpus, split and output
# paths and the cuts, and its eval forwards' launches of the YAML Swin's
# kernels (swin_tiny.yaml: 3 merges, 12 MLPs; no kernel in a train step)
AUG_EXPERIMENTS = {
    "root default": ([], {}),
    "swin_baseline": (["experiment=swin_baseline",
                       "experiment.kfold.num_folds=2"],
                      {"ln_matmul": 3, "ln_mlp_residual": 12}),
    "test_resnet18_kfold_quick": (["experiment=test_resnet18_kfold_quick"], {}),
}


def phase_aug_experiments(card: str) -> None:
    """(d) of phase 24: the root default composition and two presets on
    phase 23's corpus and fold files, 2 folds of one epoch each, with the
    launches counted."""
    run_experiments(AUG_EXPERIMENTS, "aug-experiment", card)


def corpus_paths(out: Path, splits: str = "splits"):
    """Overrides that point a composition at phase 23's corpus and fold
    files, writing under `out`."""
    work = WORK / "experiment"
    return [f"dataset.data_path={work / 'synthetic'}",
            f"dataset.split_dir={work / splits}",
            f"kfold.split_dir={work / splits}", f"output_dir={out}"]


def fold_counts():
    """(kernel 1's launches over the two folds' prepared splits without
    quality preprocessing (at most 512 frames a chunk), eval forwards (the
    val split after one epoch and the test split, batch 32), the splits'
    32-frame chunks (quality preprocessing))."""
    import math

    from thyroid_tpu_torch.data.corpus import load_split_file

    splits = [load_split_file(WORK / "experiment" / "splits" / f"split_fold_{n}.json")
              for n in (1, 2)]
    return (sum(math.ceil(len(v) / 512) for s in splits for v in s.values()),
            sum(math.ceil(len(s["val"]) / BATCH) + math.ceil(len(s["test"]) / BATCH)
                for s in splits),
            sum(math.ceil(len(v) / 32) for s in splits for v in s.values()))


def run_experiments(experiments, tag: str, card: str, summary_keys=()):
    """launch_experiment of each {name: (overrides, launches per eval
    forward)} on phase 23's corpus and fold files, cut to 2 folds of one
    epoch: both folds succeed with finite averages and the summary's keys
    (with `summary_keys` beside the usual ones), the fold files stay
    data/splits', and, with every counter set to 0 just before each run,
    kernel 1 launches once per prepared split, each eval forward launches
    the kernels given and nothing else launches. Returns {name:
    summary}."""
    import math

    from thyroid_tpu_torch.experiment import launch_experiment

    root = Path(__file__).resolve().parent
    work = WORK / "experiment"
    chunks, evals, _ = fold_counts()
    summaries = {}
    for name, (extra, per_eval) in experiments.items():
        out = work / f"out_{name.replace(' ', '_')}"
        overrides = [*extra, *corpus_paths(out), "kfold.num_folds=2",
                     "trainer.max_epochs=1", "training.epochs=1"]
        log(f"[{tag}] {name}: launch_experiment {' '.join(overrides)}")
        watched = all_counters()
        for fn in watched.values():
            fn.launches = 0
        t0 = time.perf_counter()
        summary = launch_experiment(overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in watched.items()}
        rows = summary.get("raw_fold_results", [])
        for row in rows:
            log(f"[{tag}] {name} fold {row.get('fold')}: train_time_s "
                f"{row.get('train_time_s')} test_acc {row.get('test_acc')} "
                f"error {row.get('error')}")
        log(f"[{tag}] {name}: wall time {wall:.2f} s for 2 folds of one "
            f"epoch (bf16, batch 32, level medium); card {card}")
        failed = [r for r in rows if "error" in r]
        if failed or summary.get("num_successful_folds") != 2:
            raise AssertionError(f"{name}: folds failed: "
                                 f"{failed or summary.get('status')}")
        for n in (1, 2):
            got = (work / "splits" / f"split_fold_{n}.json").read_text()
            if json.loads(got) != json.loads(
                    (root / "data" / "splits" / f"split_fold_{n}.json").read_text()):
                raise AssertionError(f"split_fold_{n}.json differs from data/splits'")
        bad = {k: v for k, v in summary.items()
               if k.startswith("avg_") and not math.isfinite(v)}
        written = json.loads(next(out.rglob("kfold_summary_*.json")).read_text())
        numbers = {k for r in rows for k, v in r.items()
                   if isinstance(v, (int, float)) and math.isfinite(v)}
        want_keys = SUMMARY_KEYS | set(summary_keys) | {
            f"{p}_{k}" for p in ("avg", "std") for k in numbers}
        if bad or numbers != FOLD_NUMBERS or set(written) != want_keys:
            raise AssertionError(f"{name}: averages {bad}, summary keys "
                                 f"{sorted(set(written) ^ want_keys)}, fold "
                                 f"numbers {sorted(numbers ^ FOLD_NUMBERS)}")
        want = {k: per_eval.get(k, 0) * evals for k in launches}
        want["percentile"] = chunks
        log(f"[{tag}] {name}: launches {launches} ({chunks} prepared "
            f"splits, {evals} eval forwards); avg_test_acc "
            f"{summary['avg_test_acc']:.4f}")
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        summaries[name] = summary
    return summaries


def phase_aug_resnet(card: str) -> None:
    """Phase 24: augmentation and ResNet, (a) to (d); float32 matmuls and
    convolutions without TF32, as phase 2 sets them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_augment()
    variables = effnet_variables(RESNET50)
    phase_augment_cost(variables, card)
    phase_resnet(variables, card)
    del variables
    torch.cuda.empty_cache()
    phase_aug_experiments(card)


# phase 25: the rest of the zoo
# the token counts ViT (197 tokens an image) and DeiT (198) give kernels 2
# and 3 at bucket 32, and the ViT/DeiT widths
ZOO_TOKENS = (BATCH * 197, BATCH * 198)
ZOO_WIDTHS = (192, 384, 768)
ZOO_VITS = ("vit_tiny", "deit_tiny", "vit_base")
ZOO_STEP_BATCH = 8
# the CNNs as their YAMLs size them: densenet121 at 224², inception_v3 at
# 299² with its aux head
ZOO_CNNS = {"densenet121": 224, "inception_v3": 299}
ZOO_EXPERIMENTS = {
    "deit_tiny": (["model=vit/deit_tiny", "training=vit"],
                  {"ln_matmul": 12, "ln_mlp_residual": 12}),
    "inception_v3": (["model=cnn/inception_v3", "training=cnn"], {}),
}


def zoo_config(name: str, dtype: str = "bf16", **over):
    cfg = {"name": name, "in_channels": 1, "num_classes": 2, "dtype": dtype}
    if name in ZOO_CNNS:
        cfg["img_size"] = ZOO_CNNS[name]
    return dict(cfg, **over)


def token_kernel_cases(cases, gen, tag: str):
    """Kernels 2 and 3 against their plain versions at each (T, C) of
    `cases`, in float32 and bf16 (RTOL of max(1, max|plain|)), two runs
    bit-equal; → the failures."""
    failed = []
    for t, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for kernel, shape in (("ln_matmul", (t, c, 3 * c, True)),
                                  ("ln_mlp_residual", (t, c, 4 * c))):
                args = make_inputs(kernel, shape, dtype, gen)
                fused, plain = kernel_fns(kernel, shape)
                got, again = fused(*args), fused(*args)
                want = plain(*args).float()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                tol = RTOL[dtype] * max(1.0, want.abs().max().item())
                same = torch.equal(got, again)
                ok = bool(np.isfinite(err)) and err <= tol and same
                log(f"[{tag}] {kernel} {str(dtype)[6:]} {shape}: "
                    f"max_abs_err {err:.3e} tol {tol:.3e}, two runs "
                    f"bit-equal: {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append((kernel, str(dtype), shape, err, same))
    return failed


def zoo_token_kernels() -> None:
    """(a) of phase 25: kernels 2 and 3 against their plain versions at
    T = 32·197 and 32·198 (not multiples of 64: a partial last tile),
    C = 192, 384 and 768, in float32 and bf16, two runs bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    failed = token_kernel_cases([(t, c) for t in ZOO_TOKENS for c in ZOO_WIDTHS],
                                gen, "zoo-kernels")
    if failed:
        raise AssertionError(f"kernels 2-3 at ViT shapes disagree: {failed}")


def zoo_counts(run):
    """{counter: launches} over one call of run(), every counter set to 0
    just before."""
    watched = all_counters()
    for fn in watched.values():
        fn.launches = 0
    run()
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in watched.items()}


def zoo_probs(name: str, variables, frames, blocks: bool = False) -> bool:
    """The card's float32 engine against the CPU's float32 engine at
    PROB_TOL 1e-3, the card's bf16 engine against the CPU's bf16 engine at
    3e-2, on the first 8 frames; bf16 against float32 logged. With
    `blocks` (a ResNet), each block's bf16 error on the card is held too
    (resnet_blocks). True when all hold."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    engines = {f"{dev} {dt}": InferenceEngine(zoo_config(name, dt), device=dev,
                                              variables=variables)
               for dt in ("f32", "bf16") for dev in ("cuda", "cpu")}
    probs, io = {}, {}
    for what, eng in engines.items():
        def run(what=what, eng=eng):
            probs[what] = eng.predict(frames[:8])
        if blocks:
            io[what] = block_io(eng.model, run, 8)
        else:
            run()
    ok = resnet_blocks(engines, io) if blocks else True
    spread = float(probs["cpu f32"][:, 0].max() - probs["cpu f32"][:, 0].min())
    for what, ref, tol in (("cuda f32", "cpu f32", PROB_TOL[torch.float32]),
                           ("cuda bf16", "cpu bf16", PROB_TOL[torch.bfloat16]),
                           ("cuda bf16", "cpu f32", None),
                           ("cpu bf16", "cpu f32", None)):
        err = float(np.abs(probs[what] - probs[ref]).max())
        log(f"[serve] {name} N=8 probabilities, {what} vs {ref}: max_abs_err "
            f"{err:.3e} " + (f"tol {tol:.3e}" if tol else "(logged, not held: "
                             "bf16 against float32)")
            + f" (spread of p0 over the batch {spread:.3e})")
        ok &= tol is None or err <= tol
    return ok


def zoo_serve(name: str, variables, per_forward, card: str, blocks: bool = False,
              seed: int = 250):
    """Serve `name` in bf16 at bucket 32 on raw 512² frames drawn from
    `seed`: the launches of one forward (counters set to 0 just before)
    against `per_forward`, images/s (median of 5), the probabilities
    against the CPU (zoo_probs). Returns (frames, ok)."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine(zoo_config(name), variables=variables)
    engine.warmup()
    rs = np.random.RandomState(seed)
    frames = (rs.rand(BATCH, 512, 512, 1) * 65535).astype(np.float32)
    probs = {}
    launches = zoo_counts(lambda: probs.setdefault("p", engine.predict(frames)))
    want = {k: per_forward.get(k, 0) for k in launches}
    ok = launches == want and probs["p"].shape == (BATCH, 2) \
        and bool(np.isfinite(probs["p"]).all())
    log(f"[serve] {name} bf16 served N={BATCH}: launches {launches}; "
        f"expected {want}")
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.predict(frames)
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    log(f"[serve] {name} predict bucket {BATCH}: {med * 1e3:.2f} ms, "
        f"{BATCH / med:.1f} images/s (median of 5); card {card}")
    del engine
    torch.cuda.empty_cache()
    return frames, ok & zoo_probs(name, variables, frames, blocks)


def zoo_vit_times(name: str, card: str) -> None:
    """Kernels 2 and 3 at the served model's shapes (bucket 32, bf16):
    device time per call and per forward (12 calls each) beside the bound,
    the plain version and the library composition."""
    from thyroid_tpu_torch.models.vit.deit import DEIT_PARAMS
    from thyroid_tpu_torch.models.vit.vit import VIT_PARAMS

    c = {**VIT_PARAMS, **DEIT_PARAMS}[name][0]
    t = BATCH * (198 if name.startswith("deit") else 197)
    gen = torch.Generator(device="cuda").manual_seed(26)
    for kernel, shape in (("ln_matmul", (t, c, 3 * c, True)),
                          ("ln_mlp_residual", (t, c, 4 * c))):
        args = make_inputs(kernel, shape, torch.bfloat16, gen)
        fused, plain = kernel_fns(kernel, shape)
        ms = device_ms(lambda: fused(*args))
        plain_ms = device_ms(lambda: plain(*args))
        lib_ms = device_ms(library_fn(kernel, shape, args))
        nbytes, ops, peak = work(kernel, shape, torch.bfloat16)
        bound = max(nbytes / H100_BYTES_PER_S, ops / peak) * 1e3
        by = "bytes" if nbytes / H100_BYTES_PER_S >= ops / peak else "operations"
        log(f"[zoo-times] {name} {kernel} bf16 {shape}: {ms:.5f} ms a call, "
            f"{12 * ms:.4f} per forward (12 calls); bound {bound:.5f} "
            f"({by}; {12 * bound:.4f} per forward); plain {plain_ms:.4f}; "
            f"library {lib_ms:.5f} (factor {ms / lib_ms:.3f}); card {card}")


def zoo_vits(card: str) -> bool:
    """(b) of phase 25: vit_tiny, deit_tiny and vit_base served through
    kernels 1, 2 and 3 (1/12/12 per forward, no other kernel), and with
    token_kernels false through kernel 1 only."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    ok = True
    for name in ZOO_VITS:
        variables = {"params": perturbed_params(zoo_config(name, "f32"))}
        frames, good = zoo_serve(
            name, variables, {"percentile": 1, "ln_matmul": 12,
                              "ln_mlp_residual": 12}, card)
        plain = InferenceEngine(zoo_config(name, token_kernels=False),
                                variables=variables)
        launches = zoo_counts(lambda: plain.predict(frames))
        want = {k: int(k == "percentile") for k in launches}
        log(f"[serve] {name} token_kernels false N={BATCH}: launches "
            f"{launches}")
        ok &= good and launches == want
        del plain
        zoo_vit_times(name, card)
        torch.cuda.empty_cache()
    return ok


@contextlib.contextmanager
def step_decisions(record=None, impose=None, flips=None):
    """Within the block, torch.nn.functional.relu and max_pool2d (which the
    port's CNNs call) append each call's decisions (x > 0; the input
    position of each window's maximum) to `record` as CPU tensors, or take
    them from `impose` in call order (x times the decision; x gathered at
    the positions) and append (differing, all) against the call's own to
    `flips`."""
    import torch.nn.functional as F

    relu, max_pool2d, calls = F.relu, F.max_pool2d, iter(impose or ())

    def decide(x, inplace=False):
        own = x > 0
        if record is not None:
            record.append(own.cpu())
        if impose is None:
            return relu(x)
        d = next(calls).to(x.device)
        flips.append((int((d != own).sum()), d.numel()))
        return x * d

    def pick(x, *args, **kw):
        out, idx = max_pool2d(x, *args, return_indices=True, **kw)
        if record is not None:
            record.append(idx.cpu())
        if impose is None:
            return out
        d = next(calls).to(x.device)
        flips.append((int((d != idx).sum()), d.numel()))
        return x.flatten(2).gather(2, d.flatten(2)).view(out.shape)

    F.relu, F.max_pool2d = decide, pick
    try:
        yield
    finally:
        F.relu, F.max_pool2d = relu, max_pool2d


def zoo_step(name: str, variables, decisions: bool, seed: int = 28) -> bool:
    """One float32 train step (batch ZOO_STEP_BATCH drawn from `seed`,
    dropout 0) on the card against the CPU's: with `decisions`, the CPU's
    step on the card's ReLU decisions and max-pool choices (at most
    STEP_FLIP_SHARE of them the CPU's own arithmetic takes the other way;
    the CPU's step on its own decisions logged beside it); loss
    STEP_LOSS_RTOL, gradients STEP_GRAD_RTOL globally and in each leaf but
    STEP_FREE_LEAVES, running statistics STEP_STATS_RTOL. deit_tiny's loss
    is the dual 0.5 / 0.5 CE, inception_v3's ce + 0.4·aux."""
    side = ZOO_CNNS.get(name, 224)
    rs = np.random.RandomState(seed)
    batch = (rs.randn(ZOO_STEP_BATCH, side, side, 1).astype(np.float32),
             (np.arange(ZOO_STEP_BATCH) % 2).astype(np.int64),
             np.ones(ZOO_STEP_BATCH, np.float32))
    cfg = zoo_config(name, "f32", dropout_rate=0.0, drop_path_rate=0.0)
    record, flips = ([], []) if decisions else (None, None)
    with step_decisions(record=record):
        card = effnet_step(cfg, variables, batch)
    torch.cuda.empty_cache()
    with step_decisions(impose=record, flips=flips):
        cpu = effnet_step(cfg, variables, batch, "cpu")
    loss_rel, grad_rel, norm = step_agreement(card[:2], cpu[:2])
    leaves = {n: float((card[1][n] - g).norm() / g.norm())
              for n, g in cpu[1].items() if float(g.norm()) > 0}
    free = STEP_FREE_LEAVES.get(name, ())
    held = {n: r for n, r in leaves.items() if n not in free}
    worst = max(held, key=held.get)
    sdiff = sum(float(((card[2][n] - v) ** 2).sum()) for n, v in cpu[2].items())
    snorm = sum(float((v ** 2).sum()) for v in cpu[2].values())
    stats_rel = (sdiff / snorm) ** 0.5 if snorm else 0.0
    ok = loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL \
        and leaves[worst] <= STEP_GRAD_RTOL and stats_rel <= STEP_STATS_RTOL
    what = own = ""
    if decisions:
        flipped, total = sum(f for f, _ in flips), sum(n for _, n in flips)
        ok &= len(flips) == len(record) and flipped <= STEP_FLIP_SHARE * total
        what = (f" on the card's ReLU decisions and max-pool choices "
                f"({len(record)} calls; the CPU's own take {flipped} of "
                f"{total} the other way, tol share {STEP_FLIP_SHARE:.0e})")
        own_grad = step_agreement(
            card[:2], effnet_step(cfg, variables, batch, "cpu")[:2])[1]
        own = (f"; against the CPU on its own decisions |grad diff| / |grad| "
               f"{own_grad:.3e} (logged, not held)")
    log(f"[step] {name} f32 step, batch {ZOO_STEP_BATCH} at {side}x{side}, "
        f"card vs cpu{what}: loss {card[0]:.7f} vs {cpu[0]:.7f} (relative "
        f"{loss_rel:.3e}, tol {STEP_LOSS_RTOL:.0e}); |grad diff| / |grad| "
        f"{grad_rel:.3e} (tol {STEP_GRAD_RTOL:.0e}; |grad| {norm:.4e}); worst "
        f"of {len(held)} held leaves {worst} {leaves[worst]:.3e} (tol "
        f"{STEP_GRAD_RTOL:.0e})"
        + "".join(f"; {n} {leaves[n]:.3e} (logged, not held: STEP_FREE_LEAVES)"
                  for n in free)
        + f"; running statistics {stats_rel:.3e} (tol "
        f"{STEP_STATS_RTOL:.0e}){own} {'ok' if ok else 'FAIL'}")
    return ok


def zoo_pool_grads() -> bool:
    """The Inception pool branch's input gradient on the card against the
    CPU's at the map sizes inception_v3 gives it at 299² (35, 17, 8), both
    count_include_pad modes, within STEP_GRAD_RTOL; beside it, logged and
    not held, F.avg_pool2d on the channels-last view, whose backward the
    port avoids."""
    import torch.nn.functional as F

    from thyroid_tpu_torch.models.cnn.inception import branch_pool

    def channels_last(x, cip):
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1,
                            count_include_pad=cip).permute(0, 2, 3, 1)

    ok = True
    for side, c in ((35, 192), (17, 768), (8, 1280)):
        gen = torch.Generator().manual_seed(side)
        x = torch.randn(8, side, side, c, generator=gen)
        dy = torch.randn(8, side, side, c, generator=gen)
        for cip in (True, False):
            rel = {}
            for name, fn in (("branch_pool", branch_pool),
                             ("channels-last view", channels_last)):
                grads = []
                for dev in ("cpu", "cuda"):
                    xd = x.to(dev).requires_grad_(True)
                    (g,) = torch.autograd.grad(fn(xd, cip), xd, dy.to(dev))
                    grads.append(g.cpu())
                rel[name] = float((grads[1] - grads[0]).norm() / grads[0].norm())
            log(f"[zoo-pool] 3x3 SAME average pool, count_include_pad {cip}, "
                f"(8, {side}, {side}, {c}): input gradient card vs cpu "
                f"{rel['branch_pool']:.3e} (tol {STEP_GRAD_RTOL:.0e}); on the "
                f"channels-last view {rel['channels-last view']:.3e} (logged)")
            ok &= rel["branch_pool"] <= STEP_GRAD_RTOL
    return ok


def zoo_cnns(card: str) -> bool:
    """(c) of phase 25: densenet121 and inception_v3 served with kernel 1
    as their only kernel, their float32 steps against the CPU's; and
    deit_tiny's float32 step with the dual loss."""
    ok = zoo_pool_grads()
    for name in ZOO_CNNS:
        variables = effnet_variables(zoo_config(name, "f32"))
        ok &= zoo_serve(name, variables, {"percentile": 1}, card)[1]
        torch.cuda.empty_cache()
        ok &= zoo_step(name, variables, decisions=True)
        torch.cuda.empty_cache()
    variables = {"params": perturbed_params(zoo_config("deit_tiny", "f32"))}
    return ok & zoo_step("deit_tiny", variables, decisions=False)


def zoo_ensemble(card: str) -> bool:
    """(d) of phase 25: configs/model/ensemble/cnn_top3.yaml's members
    (resnet50, efficientnet_b0, densenet121) in float32 on seeded weights
    with running statistics, combined on the card and on the CPU on the
    same 8 prepared frames, for each method: probabilities within
    PROB_TOL (float32)."""
    from thyroid_tpu_torch.data.pipeline import prepare_images
    from thyroid_tpu_torch.models.ensemble import build_ensemble_from_members
    from thyroid_tpu_torch.models.ensemble.cnn_ensemble import METHODS
    from thyroid_tpu_torch.ops.image import standardize

    names = ("resnet50", "efficientnet_b0", "densenet121")
    cfgs = [zoo_config(n, "f32") for n in names]
    variables = [effnet_variables(c) for c in cfgs]
    rs = np.random.RandomState(29)
    raw = torch.from_numpy((rs.rand(8, 512, 512, 1) * 65535).astype(np.float32))
    x = standardize(prepare_images(raw, 224), (0.5,), (0.5,))
    ens = {dev: build_ensemble_from_members(cfgs, variables, device=dev)
           for dev in ("cuda", "cpu")}
    ok = True
    for method in METHODS:
        got = {}
        for dev, e in ens.items():
            e.method = method
            t0 = time.perf_counter()
            with torch.no_grad():
                got[dev] = e(x.to(dev)).cpu()
            secs = time.perf_counter() - t0
        err = float((got["cuda"] - got["cpu"]).abs().max())
        tol = PROB_TOL[torch.float32]
        log(f"[zoo-ensemble] cnn_top3 {method} N=8 float32 card vs cpu: "
            f"max_abs_err {err:.3e} tol {tol:.0e}; weights "
            f"{ens['cuda'].weights().tolist()}; card p0 "
            f"{[round(v, 4) for v in got['cuda'][:, 0].tolist()]}; cpu call "
            f"{secs:.2f} s; card {card}")
        ok &= err <= tol and bool(torch.isfinite(got["cuda"]).all())
    del ens
    torch.cuda.empty_cache()
    return ok


# the registry's other new names, each served once and stepped once on the
# card from its seeded initial weights (the same code as the checked
# models above, at other widths and depths)
ZOO_OTHERS = {"vit_small": 12, "deit_small": 12, "deit_base": 12,
              "densenet161": 0, "densenet169": 0, "densenet201": 0,
              "inception_v4": 0}


def zoo_others(card: str) -> bool:
    """(f) of phase 25: each of ZOO_OTHERS served in bf16 at bucket 32 on
    raw 512² frames (launches 1 percentile and 12 or 0 each of kernels 2
    and 3 per forward, finite probabilities) and one bf16 train step at
    batch 8 (finite loss and gradients), from its seeded initial
    weights."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    rs = np.random.RandomState(251)
    frames = (rs.rand(BATCH, 512, 512, 1) * 65535).astype(np.float32)
    ok = True
    for name, tokens in ZOO_OTHERS.items():
        t0 = time.perf_counter()
        cfg = zoo_config(name, img_size=299 if name == "inception_v4" else 224)
        engine = InferenceEngine(cfg)
        probs = {}
        launches = zoo_counts(lambda: probs.setdefault("p", engine.predict(frames)))
        want = {k: {"percentile": 1, "ln_matmul": tokens,
                    "ln_mlp_residual": tokens}.get(k, 0) for k in launches}
        del engine
        side = cfg["img_size"]
        x = torch.from_numpy(rs.randn(ZOO_STEP_BATCH, side, side, 1)
                             .astype(np.float32)).cuda()
        y = torch.arange(ZOO_STEP_BATCH, device="cuda") % 2
        trainer = effnet_trainer(cfg, None, "zoo_others")
        loss, _, grads, _ = trainer.loss_and_grads(
            x, y, torch.ones(ZOO_STEP_BATCH, device="cuda"))
        gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values())))
        good = launches == want and bool(np.isfinite(probs["p"]).all()) \
            and probs["p"].shape == (BATCH, 2) and bool(torch.isfinite(loss)) \
            and np.isfinite(gnorm) and gnorm > 0
        log(f"[zoo-others] {name} {side}x{side}: served N={BATCH} bf16, kernels "
            f"2/3 {launches['ln_matmul']}/{launches['ln_mlp_residual']} "
            f"(expected {tokens}), percentile {launches['percentile']}; bf16 "
            f"step batch {ZOO_STEP_BATCH}: loss {float(loss):.5f}, |grad| "
            f"{gnorm:.4e}; {time.perf_counter() - t0:.1f} s "
            f"{'ok' if good else 'FAIL'}; card {card}")
        ok &= good
        del trainer, grads
        torch.cuda.empty_cache()
    return ok


def phase_zoo(card: str) -> None:
    """Phase 25: the rest of the zoo, (a) to (f); float32 matmuls and
    convolutions without TF32, as phase 2 sets them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    zoo_token_kernels()
    ok = {"vits": zoo_vits(card), "cnns": zoo_cnns(card),
          "ensemble": zoo_ensemble(card), "others": zoo_others(card)}
    log(f"[zoo] checks {ok}; (a)-(d), (f) {time.perf_counter() - t0:.1f} s")
    if not all(ok.values()):
        raise AssertionError(f"phase 25 checks failed: {ok}")
    run_experiments(ZOO_EXPERIMENTS, "zoo-experiment", card)
    log(f"[zoo] phase 25 {time.perf_counter() - t0:.1f} s")


# phase 26: distillation, the ablation and all-models sweeps, the stacked
# trainer, SGD, accumulation and clipping by value
DISTILL_TEACHERS = ("resnet50", "efficientnet_b0", "densenet121")
# the summary's distillation fields, beside SUMMARY_KEYS
DISTILL_KEYS = ("family", "student_model_name", "teacher_model_name",
                "student_param_count")
DISTILL_EXPERIMENTS = {
    "deit_tiny_distill_resnet50": (
        ["experiment=deit_tiny_distill_resnet50", "experiment.kfold.num_folds=2"],
        {"ln_matmul": 12, "ln_mlp_residual": 12}),
    "deit_small_distill_ensemble": (
        ["experiment=deit_small_distill_ensemble", "experiment.kfold.num_folds=2"],
        {"ln_matmul": 12, "ln_mlp_residual": 12}),
}
# the presets' α at epoch 0: deit_tiny_distill_resnet50's schedule starts
# at 0.3; deit_small_distill_ensemble is progressive without a schedule,
# so α stays its 0.7
DISTILL_ALPHA = {"deit_tiny_distill_resnet50": 0.3,
                 "deit_small_distill_ensemble": 0.7}
# the ensemble teacher in float32 (TF32 off) on the card against the CPU:
# max abs logit difference over max(1, max|cpu logit|)
TEACHER_RTOL = 1e-3
# deit_small's tokens and width at bucket 32 (kernels 2 and 3)
DEIT_SMALL_SHAPE = (BATCH * 198, 384)
# the optimizer steps card vs CPU: resnet18 in float32 at this side, SGD
# (momentum 0.9, lr 1e-2, no warmup), one update each. The card's update
# against the CPU's optimizer on the same gradients, in each leaf: the
# chain is elementwise float32 (equal bits under clipping by value) but
# for the clip by norm's float32 sum of 11 million squares, which each
# side takes in its own order (6.7e-6 apart on the card)
OPT_SIDE = 112
OPT_RTOL = 1e-4
OPT_CASES = {"sgd": {}, "sgd, clip by value 1e-3": {
    "gradient_clip_algorithm": "value", "gradient_clip_val": 1e-3},
    "sgd, accumulate_grad_batches 2": {"accumulate_grad_batches": 2}}
# the stacked trainer's folds against sequential Trainers on the card, per
# epoch (JAX's own bands in tests/unit/test_stacked.py): the card's
# backward sums are not deterministic, and bf16 carries them over 2 epochs
STACKED_TOL = {"train_loss": 2e-2, "val_loss": 5e-2, "val_acc": 0.13}
ALL_MODELS_CLASS = ("thyroid_tpu_torch.experiment.all_models_experiment."
                    "AllModelsFullKFoldExperiment")


def teacher_sha(teacher) -> str:
    return sha(*(t for m in teacher.members for t in m.state_dict().values()))


@contextlib.contextmanager
def distill_spy(record):
    """Within the block, every Trainer.train_epoch appends (loss mode,
    epoch, α) to record["alpha"], and every teacher the k-fold experiment
    builds is appended with the SHA-256 of its weights to
    record["teachers"]."""
    from thyroid_tpu_torch.experiment import kfold_experiment
    from thyroid_tpu_torch.training.engine import Trainer

    make, train_epoch = kfold_experiment.create_teacher_from_config, Trainer.train_epoch

    def teacher(*args, **kw):
        t = make(*args, **kw)
        record["teachers"].append((t, teacher_sha(t)))
        return t

    def epoch(self, pipeline, e):
        record["alpha"].append((self.loss_mode, e, self._alpha_for_epoch(e)))
        return train_epoch(self, pipeline, e)

    kfold_experiment.create_teacher_from_config, Trainer.train_epoch = teacher, epoch
    try:
        yield
    finally:
        kfold_experiment.create_teacher_from_config = make
        Trainer.train_epoch = train_epoch


def distill_teachers(card: str) -> Path:
    """(a): a checkpoint of each DISTILL_TEACHERS model as
    `WORK/distill/checkpoints/<name>-best.ckpt`, where the presets' teacher
    paths point from WORK/distill: resnet50's from phase 24's root default
    run (fold 1), the others trained for fold 1 of one epoch through the
    port's k-fold (phase 23's corpus and fold files)."""
    from thyroid_tpu_torch.config import compose
    from thyroid_tpu_torch.experiment import ExperimentManager
    from thyroid_tpu_torch.training.checkpoint import get_best_checkpoint

    ckdir = WORK / "distill" / "checkpoints"
    shutil.rmtree(ckdir.parent, ignore_errors=True)
    ckdir.mkdir(parents=True)
    for name in DISTILL_TEACHERS:
        t0 = time.perf_counter()
        src = get_best_checkpoint(WORK / "experiment" / "out_root_default" / name
                                  / "fold_1" / "checkpoints", name)
        how = "phase 24's root default run, fold 1"
        if src is None:
            exp = ExperimentManager(compose(overrides=[
                f"model=cnn/{name}", "training=cnn", "augmentation=no_aug",
                "kfold.num_folds=2", "trainer.max_epochs=1", "training.epochs=1",
                *corpus_paths(WORK / "distill" / "teachers")])).build_experiment()
            exp.setup()
            row = exp.run_fold(1)
            src = get_best_checkpoint(Path(row["best_checkpoint"]).parent, name)
            how = (f"fold 1 of one epoch through KFoldExperiment.run_fold, "
                   f"test_acc {row['test_acc']:.4f}")
        shutil.copytree(src, ckdir / f"{name}-best.ckpt")
        log(f"[distill] teacher {name}: {how}; {time.perf_counter() - t0:.1f} s; "
            f"card {card}")
    return ckdir


def distill_presets(card: str) -> bool:
    """(b) and (c): the two presets through the CLI from WORK/distill (their
    relative teacher paths resolve there), 2 folds of one epoch, with
    run_experiments' checks and counts (kernel 1 once per prepared split,
    12 + 12 of kernels 2 and 3 per eval forward, nothing else), the
    summary's distillation fields, α per epoch, the three distillation
    terms in every fold's history, and each teacher's weights unchanged
    by the run."""
    import os

    ok = True
    here = Path.cwd()
    os.chdir(WORK / "distill")
    try:
        for name, spec in DISTILL_EXPERIMENTS.items():
            record = {"alpha": [], "teachers": []}
            with distill_spy(record):
                summary = run_experiments({name: spec}, "distill", card,
                                          DISTILL_KEYS)[name]
            alphas = sorted({(m, e, a) for m, e, a in record["alpha"]})
            log(f"[distill] {name}: alpha per epoch {alphas}; family "
                f"{summary['family']}, student {summary['student_model_name']}, "
                f"teacher {summary['teacher_model_name']}, student_param_count "
                f"{summary['student_param_count']}")
            ok &= alphas == [("distillation", 0, DISTILL_ALPHA[name])]
            ok &= summary["family"] == "distilled_vit" and \
                isinstance(summary["student_param_count"], int)
            terms = ("train_class_loss", "train_distillation_loss",
                     "train_teacher_agreement")
            out = WORK / "experiment" / f"out_{name}"
            for path in sorted(out.rglob("history.json")):
                row = json.loads(path.read_text())[0]
                have = {k: row.get(k) for k in terms}
                log(f"[distill] {name} {path.parent.name} epoch 0: {have}")
                ok &= all(isinstance(v, float) and np.isfinite(v)
                          for v in have.values())
            kept = [teacher_sha(t) == h for t, h in record["teachers"]]
            log(f"[distill] {name}: {len(kept)} teachers built, weights "
                f"unchanged after the run (SHA-256): {kept}")
            ok &= len(kept) == 2 and all(kept)
    finally:
        os.chdir(here)
    return ok


def distill_ensemble_teacher(card: str) -> bool:
    """(c): deit_small_distill_ensemble's teacher (the three checkpoints,
    weights 0.4 / 0.3 / 0.3, float32) on the card against the CPU on 8
    prepared frames, within TEACHER_RTOL; kernels 2 and 3 at deit_small's
    shape against their plain versions, and their times."""
    import os

    from thyroid_tpu_torch.config import compose
    from thyroid_tpu_torch.data.pipeline import prepare_images
    from thyroid_tpu_torch.ops.image import standardize
    from thyroid_tpu_torch.training.checkpoint import create_teacher_from_config

    node = compose(overrides=["experiment=deit_small_distill_ensemble"]).experiment.distillation
    here = Path.cwd()
    os.chdir(WORK / "distill")
    try:
        teachers = {dev: create_teacher_from_config(node, device=dev)
                    for dev in ("cuda", "cpu")}
    finally:
        os.chdir(here)
    rs = np.random.RandomState(260)
    raw = torch.from_numpy((rs.rand(8, 512, 512, 1) * 65535).astype(np.float32))
    x = standardize(prepare_images(raw, 224), (0.5,), (0.5,))
    got = {dev: t(x.to(dev)).cpu() for dev, t in teachers.items()}
    err = float((got["cuda"] - got["cpu"]).abs().max())
    tol = TEACHER_RTOL * max(1.0, float(got["cpu"].abs().max()))
    ok = err <= tol and bool(torch.isfinite(got["cuda"]).all())
    log(f"[distill] ensemble teacher {[type(m).__name__ for m in teachers['cuda'].members]} "
        f"weights {teachers['cuda'].weights} float32, N=8 logits card vs cpu: "
        f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}; card {card}")
    gen = torch.Generator(device="cuda").manual_seed(26)
    failed = token_kernel_cases([DEIT_SMALL_SHAPE], gen, "distill-kernels")
    zoo_vit_times("deit_small", card)
    return ok and not failed


def distill_step(teacher_ck: Path, card: str) -> bool:
    """(d): one distillation step (soft, T 4, α 0.3) of deit_tiny in
    float32 (seeded, bumped weights, drop path 0) with the resnet50
    teacher, batch ZOO_STEP_BATCH at 224², on the card against the CPU, the
    card's teacher logits fed to both: loss and its three terms within
    STEP_LOSS_RTOL, gradients within STEP_GRAD_RTOL globally and in each
    leaf."""
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.training.checkpoint import create_teacher_from_config
    from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
    from thyroid_tpu_torch.training.engine import Trainer

    rs = np.random.RandomState(262)
    x = rs.randn(ZOO_STEP_BATCH, 224, 224, 1).astype(np.float32)
    y = (np.arange(ZOO_STEP_BATCH) % 2).astype(np.int64)
    w = np.ones(ZOO_STEP_BATCH, np.float32)
    teacher = create_teacher_from_config(
        {"teacher_checkpoint": str(teacher_ck), "teacher_model": {"name": "resnet50"}},
        device="cuda")
    logits = teacher(torch.from_numpy(x).cuda())
    cfg = zoo_config("deit_tiny", "f32", drop_path_rate=0.0)
    params = perturbed_params(cfg)
    dcfg = {"alpha": 0.3, "temperature": 4.0, "distillation_type": "soft"}
    out = {}
    for dev in ("cuda", "cpu"):
        t = logits.to(dev)
        trainer = Trainer(ModelRegistry.create_model(cfg), cfg, TRAINING_VIT,
                          TRAINER_DEFAULT, steps_per_epoch=TRAIN_FRAMES // BATCH,
                          output_dir=WORK / "distill_step", params=params,
                          device=dev, teacher_fn=lambda im, t=t: t,
                          distillation_config=dcfg)
        loss, _, grads, aux = trainer.loss_and_grads(
            *(torch.from_numpy(a).to(dev) for a in (x, y, w)), None, None, t,
            torch.tensor(0.3, device=dev))
        out[dev] = (float(loss), {n: g.float().cpu() for n, g in grads.items()},
                    {k: float(v) for k, v in aux.items()})
        del trainer
    card_, cpu = out["cuda"], out["cpu"]
    loss_rel, grad_rel, norm = step_agreement(card_[:2], cpu[:2])
    leaves = {n: float((card_[1][n] - g).norm() / g.norm())
              for n, g in cpu[1].items() if float(g.norm()) > 0}
    worst = max(leaves, key=leaves.get)
    terms = {k: abs(card_[2][k] - v) / max(abs(v), 1e-6) for k, v in cpu[2].items()}
    ok = loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL \
        and leaves[worst] <= STEP_GRAD_RTOL and set(terms) == {
            "class_loss", "distillation_loss", "teacher_agreement"} \
        and max(terms.values()) <= STEP_LOSS_RTOL
    log(f"[distill-step] deit_tiny f32 + resnet50 teacher, batch "
        f"{ZOO_STEP_BATCH} at 224x224, card vs cpu on the card's teacher "
        f"logits: loss {card_[0]:.7f} vs {cpu[0]:.7f} (relative {loss_rel:.3e}, "
        f"tol {STEP_LOSS_RTOL:.0e}); terms card {card_[2]} cpu {cpu[2]}; "
        f"|grad diff| / |grad| {grad_rel:.3e} (tol {STEP_GRAD_RTOL:.0e}; "
        f"|grad| {norm:.4e}); worst of {len(leaves)} leaves {worst} "
        f"{leaves[worst]:.3e} {'ok' if ok else 'FAIL'}; card {card}")
    return ok


def opt_trainer(variables, cfg, trainer_over, device):
    """A resnet18 Trainer for the optimizer steps: SGD (momentum 0.9, lr
    1e-2, no warmup) with configs/training/cnn.yaml's other keys and the
    default trainer's, `trainer_over` on top."""
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_CNN
    from thyroid_tpu_torch.training.engine import Trainer

    training = dict(TRAINING_CNN, optimizer_params={"name": "sgd", "lr": 1e-2},
                    scheduler_params={"name": "cosine", "warmup_epochs": 0})
    return Trainer(ModelRegistry.create_model(cfg), cfg, training,
                   dict(TRAINER_DEFAULT, **trainer_over),
                   steps_per_epoch=TRAIN_FRAMES // BATCH,
                   output_dir=WORK / "opt_step", variables=variables,
                   device=device)


def opt_updates(trainer):
    """[each update the trainer's optimizer returns from now on, as float32
    CPU tensors ({} where accumulation makes none)]. The updates
    themselves, not the parameters' change: a BatchNorm scale near 1 moved
    by 1e-5 keeps two or three significant digits of its update."""
    seen = []
    update = trainer.state.tx.update

    def keep(grads, state, params):
        out = update(grads, state, params)
        seen.append({n: u.detach().float().cpu().clone() for n, u in out.items()})
        return out

    trainer.state.tx.update = keep
    return seen


def opt_step(variables, cfg, trainer_over, batches, device, record=None,
             impose=None, flips=None):
    """Trainer.train_step over `batches` on `device` → ([each mini-step's
    update], the running statistics after, [each mini-step's gradients]),
    with step_decisions recording or imposing."""
    from thyroid_tpu_torch.training import metrics as tmetrics

    trainer = opt_trainer(variables, cfg, trainer_over, device)
    grads = []
    loss_and_grads = trainer.loss_and_grads

    def keep(*args):
        out = loss_and_grads(*args)
        grads.append({n: g.detach().float().cpu().clone() for n, g in out[2].items()})
        return out

    trainer.loss_and_grads = keep
    updates = opt_updates(trainer)
    dev = trainer.device
    with step_decisions(record=record, impose=impose, flips=flips):
        for b in batches:
            trainer.train_step(tmetrics.zero_metric_state(device=dev),
                               *(torch.from_numpy(a).to(dev) for a in b))
    stats = {n: t.float().cpu() for n, t in trainer.state.batch_stats.items()}
    return updates, stats, grads


def rel_diff(got, want):
    """(|got − want| / |want| over every leaf, {leaf: its own}) of two
    {name: tensor} dicts, leaves with |want| 0 left out of the second."""
    num = sum(float(((got[n] - v) ** 2).sum()) for n, v in want.items())
    den = sum(float((v ** 2).sum()) for v in want.values())
    leaves = {n: float((got[n] - v).norm() / v.norm())
              for n, v in want.items() if float(v.norm()) > 0}
    return ((num / den) ** 0.5 if den else float("inf")), leaves


def distill_opt_steps(card: str) -> bool:
    """(d): resnet18 in float32 at OPT_SIDE², batch ZOO_STEP_BATCH, one
    update each of SGD, SGD with clipping by value and SGD over 2
    accumulated mini-steps (no update after the first). The optimizer: the
    card's update against the CPU's optimizer on the card's own gradients
    within OPT_RTOL in every leaf. The whole step: the card against the
    CPU on the card's ReLU decisions and max-pool choices, the update
    within STEP_GRAD_RTOL globally and in every leaf, the running
    statistics within STEP_STATS_RTOL."""
    cfg = zoo_config("resnet18", "f32", img_size=OPT_SIDE)
    variables = effnet_variables(cfg)
    rs = np.random.RandomState(263)
    batches = [(rs.randn(ZOO_STEP_BATCH, OPT_SIDE, OPT_SIDE, 1).astype(np.float32),
                (np.arange(ZOO_STEP_BATCH) % 2).astype(np.int64),
                np.ones(ZOO_STEP_BATCH, np.float32)) for _ in range(2)]
    ok = True
    for name, over in OPT_CASES.items():
        k = over.get("accumulate_grad_batches", 1)
        record, flips = [], []
        card_up, card_stats, card_grads = opt_step(variables, cfg, over,
                                                   batches[:k], "cuda",
                                                   record=record)
        cpu_up, cpu_stats, _ = opt_step(variables, cfg, over, batches[:k], "cpu",
                                        impose=record, flips=flips)
        replay = opt_trainer(variables, cfg, over, "cpu")
        replay_up = opt_updates(replay)
        for g in card_grads:
            replay.state.apply_gradients(g)
        counts = [[len(u) for u in ups] for ups in (card_up, replay_up, cpu_up)]
        opt_rel, opt_leaves = rel_diff(card_up[-1], replay_up[-1])
        opt_worst = max(opt_leaves, key=opt_leaves.get)
        rel, leaves = rel_diff(card_up[-1], cpu_up[-1])
        worst = max(leaves, key=leaves.get)
        stats_rel = rel_diff(card_stats, cpu_stats)[0]
        flipped, total = sum(f for f, _ in flips), sum(n for _, n in flips)
        n_leaves = len(card_grads[0])
        good = counts == [[0] * (k - 1) + [n_leaves]] * 3 \
            and opt_leaves[opt_worst] <= OPT_RTOL and rel <= STEP_GRAD_RTOL \
            and leaves[worst] <= STEP_GRAD_RTOL and stats_rel <= STEP_STATS_RTOL \
            and flipped <= STEP_FLIP_SHARE * total
        clipped = ""
        if "gradient_clip_val" in over:
            # the trace's first step is g itself: the update is −lr·clip(g),
            # and its elements at ±lr·v were clipped
            lim = 1e-2 * over["gradient_clip_val"]
            at = sum(int((v.abs() >= lim * (1 - 1e-6)).sum())
                     for v in replay_up[-1].values())
            size = sum(v.numel() for v in replay_up[-1].values())
            clipped = f"; {at} of {size} elements clipped"
        log(f"[opt-step] resnet18 f32 {OPT_SIDE}x{OPT_SIDE} {name}: updates "
            f"a mini-step card/replay/cpu {counts}; the card's update vs the "
            f"CPU's optimizer on the card's gradients {opt_rel:.3e}, worst "
            f"leaf {opt_worst} {opt_leaves[opt_worst]:.3e} (tol {OPT_RTOL:.0e}); "
            f"the whole step card vs cpu (the card's decisions, the CPU's own "
            f"take {flipped} of {total} the other way) |diff| / |update| "
            f"{rel:.3e}, worst of {len(leaves)} leaves {worst} "
            f"{leaves[worst]:.3e} (tol {STEP_GRAD_RTOL:.0e}); running "
            f"statistics {stats_rel:.3e}{clipped} {'ok' if good else 'FAIL'}; "
            f"card {card}")
        ok &= good
    torch.cuda.empty_cache()
    return ok


def distill_ablation(card: str) -> bool:
    """(e): ablation_augmentation through the CLI on phase 23's corpus (its
    split_info split), cut to 1 epoch of 3 train batches, 2 val and 2 test
    batches a run: 8 runs, none an "error" row, ablation_summary.json with
    all 8 and the best by test_acc; with the counters set to 0 just
    before, rows 12, 13, 15 and 1 once per 32-frame chunk of each split of
    the 4 quality runs, row 1 once per split of the 4 others, nothing
    else."""
    import math

    from thyroid_tpu_torch.data.corpus import load_split_file
    from thyroid_tpu_torch.experiment import launch_experiment

    out = WORK / "ablation"
    overrides = ["experiment=ablation_augmentation", *corpus_paths(out),
                 "experiment.trainer.max_epochs=1", "experiment.training.epochs=1",
                 "trainer.limit_train_batches=3", "trainer.limit_val_batches=2",
                 "trainer.limit_test_batches=2"]
    t0 = time.perf_counter()
    got = {}
    launches = zoo_counts(lambda: got.setdefault("s", launch_experiment(overrides)))
    wall = time.perf_counter() - t0
    summary = got["s"]
    sizes = [len(v) for v in load_split_file(
        WORK / "experiment" / "splits" / "split_info.json").values()]
    chunks = sum(math.ceil(n / 32) for n in sizes)
    quality = ("stats_quantile", "median_bilateral", "apply_luts_dual")
    want = {k: 4 * chunks if k in quality else 0 for k in launches}
    want["percentile"] = 4 * chunks + 4 * len(sizes)
    written = json.loads((out / "ablation_augmentation" / "ablation_summary.json").read_text())
    runs = written["all_runs"]
    errors = [r for r in runs if "error" in r]
    for r in runs:
        log(f"[ablation] {r.get('run')}: test_acc {r.get('test_acc')} error "
            f"{r.get('error')}")
    ok = len(runs) == 8 and not errors and summary["num_successful"] == 8 \
        and launches == want and written["best_run"]["run"] == max(
            runs, key=lambda r: r["test_acc"])["run"]
    log(f"[ablation] 8 runs in {wall:.2f} s (resnet50 bf16, splits {sizes}); "
        f"launches {launches}, expected {want}; best {written['best_run']['run']} "
        f"{'ok' if ok else 'FAIL'}; card {card}")
    return ok


def distill_all_models(card: str) -> bool:
    """(f): the all-models sweep through the CLI's experiment_class_path,
    model_names cnn/resnet18 and vit/deit_tiny, 2 folds of one epoch,
    quality forced on: a summary per model with its best fold, only
    `{model}/best_checkpoint` left, all_models_summary.json; with the
    counters set to 0 just before, rows 12, 13, 15 and 1 once per 32-frame
    chunk of each split of both models' folds, deit_tiny's eval forwards
    12 + 12 of kernels 2 and 3, nothing else."""
    from thyroid_tpu_torch.experiment import launch_experiment

    out = WORK / "all_models"
    overrides = [f"+experiment_class_path={ALL_MODELS_CLASS}",
                 "+model_names=[cnn/resnet18,vit/deit_tiny]", *corpus_paths(out),
                 "kfold.num_folds=2", "trainer.max_epochs=1", "training.epochs=1"]
    t0 = time.perf_counter()
    got = {}
    launches = zoo_counts(lambda: got.setdefault("s", launch_experiment(overrides)))
    wall = time.perf_counter() - t0
    results = got["s"]
    _, evals, chunks = fold_counts()
    want = {k: 0 for k in launches}
    for k in ("stats_quantile", "median_bilateral", "apply_luts_dual", "percentile"):
        want[k] = 2 * chunks
    want["ln_matmul"] = want["ln_mlp_residual"] = 12 * evals
    root = out / "all_models_kfold"
    ok = launches == want
    for name in ("resnet18", "deit_tiny"):
        res = results.get(name, {})
        left = sorted(p.name for p in (root / name).iterdir())
        log(f"[all-models] {name}: folds {res.get('num_successful_folds')}, "
            f"avg_accuracy {res.get('avg_accuracy')}, best_fold "
            f"{res.get('best_fold')}, error {res.get('error')}; left {left}")
        ok &= res.get("num_successful_folds") == 2 and res.get("best_fold") in (1, 2) \
            and (root / name / "best_checkpoint" / "state.pt").exists() \
            and not any(n.startswith("fold_") for n in left)
    summary = json.loads((root / "all_models_summary.json").read_text())
    ok &= set(summary) == {"resnet18", "deit_tiny"}
    log(f"[all-models] {wall:.2f} s; launches {launches}, expected {want} "
        f"{'ok' if ok else 'FAIL'}; card {card}")
    return ok


def distill_stacked(card: str) -> bool:
    """(g): test_resnet18_kfold_quick with `+kfold.stacked=true`, 2 folds ×
    2 epochs (bf16, no augmentation): each fold's history against a
    sequential run of the same overrides within STACKED_TOL per epoch, the
    stacked trainer's export in the sequential layout (each checkpoint the
    fold's best parameters); then 4 folds (unequal splits of 450 frames,
    fold files in splits4, 1 epoch of 2 batches): StackedShapeError sends
    the sweep to the sequential path once."""
    from thyroid_tpu_torch.experiment import KFoldExperiment, launch_experiment
    from thyroid_tpu_torch.models.from_jax import load_jax_variables
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.training import stacked as stacked_mod
    from thyroid_tpu_torch.training.checkpoint import load_checkpoint

    base = ["experiment=test_resnet18_kfold_quick", "augmentation=no_aug",
            "experiment.trainer.max_epochs=2", "experiment.training.epochs=2"]
    captured = []
    fit = stacked_mod.StackedKFoldTrainer.fit

    def spy(self):
        rows = fit(self)
        captured.append((self, rows))
        return rows

    stacked_mod.StackedKFoldTrainer.fit = spy
    t0 = time.perf_counter()
    try:
        stacked = launch_experiment([*base, "+kfold.stacked=true",
                                     *corpus_paths(WORK / "stacked" / "on")])
    finally:
        stacked_mod.StackedKFoldTrainer.fit = fit
    t_stacked = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch_experiment([*base, *corpus_paths(WORK / "stacked" / "off")])
    t_seq = time.perf_counter() - t0
    ok = len(captured) == 1 and stacked["num_successful_folds"] == 2 and all(
        r.get("stacked") is True for r in stacked["raw_fold_results"])
    st, rows = captured[0]
    for f, row in enumerate(rows, start=1):
        seq = json.loads((WORK / "stacked" / "off" / "resnet18" / f"fold_{f}"
                          / "history.json").read_text())
        diffs = {k: max(abs(a[k] - b[k]) for a, b in zip(row["history"], seq))
                 for k in STACKED_TOL}
        good = len(seq) == len(row["history"]) == 2 and all(
            diffs[k] <= tol for k, tol in STACKED_TOL.items())
        log(f"[stacked] fold {f}: best_epoch {row['best_epoch']}, per-epoch "
            f"stacked vs sequential {[(round(a['train_loss'], 5), round(b['train_loss'], 5)) for a, b in zip(row['history'], seq)]} "
            f"train_loss; largest differences {diffs} (tol {STACKED_TOL}) "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    paths = st.export_fold_checkpoints(WORK / "stacked" / "export", "resnet18",
                                       st.model_config)
    for f, path in enumerate(paths, start=1):
        variables, meta = load_checkpoint(path)
        model = ModelRegistry.create_model(st.model_config)
        load_jax_variables(model, variables)
        live = st.trainers[f - 1].state.params
        same = all(torch.equal(t, live[n].detach().cpu())
                   for n, t in model.named_parameters())
        where = path.relative_to(WORK / "stacked" / "export")
        log(f"[stacked] export fold {f}: {where}, fold {meta['fold']}, "
            f"stacked_export {meta['stacked_export']}, the fold's best "
            f"parameters: {same}")
        ok &= same and str(where) == f"resnet18/fold_{f}/checkpoints/resnet18-best.ckpt"
    calls = {"stacked": 0, "sequential": 0}
    run_stacked, run_fold = KFoldExperiment.run_stacked, KFoldExperiment.run_fold

    def count(kind, fn):
        def wrapped(self, arg):
            calls[kind] += 1
            return fn(self, arg)
        return wrapped

    KFoldExperiment.run_stacked = count("stacked", run_stacked)
    KFoldExperiment.run_fold = count("sequential", run_fold)
    t0 = time.perf_counter()
    try:
        back = launch_experiment([
            "experiment=test_resnet18_kfold_quick", "augmentation=no_aug",
            "+kfold.stacked=true", "experiment.kfold.num_folds=4",
            "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
            "trainer.limit_test_batches=1",
            *corpus_paths(WORK / "stacked" / "back", splits="splits4")])
    finally:
        KFoldExperiment.run_stacked, KFoldExperiment.run_fold = run_stacked, run_fold
    t_back = time.perf_counter() - t0
    good = calls == {"stacked": 1, "sequential": 4} and \
        back["num_successful_folds"] == 4 and \
        not any("stacked" in r for r in back["raw_fold_results"])
    log(f"[stacked] 4 unequal folds: calls {calls}, folds "
        f"{back['num_successful_folds']}, rows stacked "
        f"{[r.get('stacked') for r in back['raw_fold_results']]} "
        f"{'ok' if good else 'FAIL'}")
    log(f"[stacked] stacked 2 folds x 2 epochs {t_stacked:.2f} s, sequential "
        f"{t_seq:.2f} s, fall-back {t_back:.2f} s; card {card}")
    return ok and good


def phase_distill(card: str) -> None:
    """Phase 26: distillation, the ablation and all-models sweeps, the
    stacked trainer, SGD, accumulation and clipping by value, (a) to (g),
    on phase 23's corpus; float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ckdir = distill_teachers(card)
    ok = {"presets": distill_presets(card),
          "ensemble teacher": distill_ensemble_teacher(card),
          "distillation step": distill_step(ckdir / "resnet50-best.ckpt", card),
          "optimizer steps": distill_opt_steps(card),
          "ablation": distill_ablation(card),
          "all models": distill_all_models(card),
          "stacked": distill_stacked(card)}
    log(f"[distill] checks {ok}; phase 26 {time.perf_counter() - t0:.1f} s")
    if not all(ok.values()):
        raise AssertionError(f"phase 26 checks failed: {ok}")


# phase 27: analysis
# the captures' models and sides (float32, TF32 off): seeded weights, the
# registry swin_tiny's perturbed as in phase 1
ANALYSIS_MODELS = {"resnet50": 224, "densenet121": 224, "efficientnet_b0": 224,
                   "inception_v3": 299, "vit_tiny": 224, "deit_tiny": 224,
                   "swin_tiny": 224}
# the card against the CPU on the same float32 weights and inputs: captured
# tensors, heatmaps and maps, GradCAM confidences, relative to max(1, max|CPU|)
ANALYSIS_RTOL = 1e-3
# frames of phase 23's corpus (half of each class) that the card-vs-CPU
# evaluations run on, at batch 8
EVAL_FRAMES, EVAL_BATCH = 16, 8
# the images/s pipeline: prepared raw 512² frames at the served bucket
TIMED_FRAMES = 128
# rows 2, 3, 4 per eval forward of the registry swin_tiny and of deit_tiny
EVAL_PER_FORWARD = {"swin_tiny": {"ln_matmul": 15, "ln_mlp_residual": 12,
                                  "swin_block_attention": 12},
                    "deit_tiny": {"ln_matmul": 12, "ln_mlp_residual": 12}}


def all_launches(run):
    """{counter: launches} of every kernel, rows 1-17 (kernel 6 as
    swin_attention_bwd), over one call of run(), every counter 0 before."""
    from thyroid_tpu_torch.ops import attention

    attention.fused_swin_attention.bwd_launches = 0
    got = zoo_counts(run)
    got["swin_attention_bwd"] = attention.fused_swin_attention.bwd_launches
    return got


def rel_err(got, want) -> float:
    """max|got − want| / max(1, max|want|), over numpy arrays or tensors."""
    got = np.asarray(got.float().cpu() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want.float().cpu() if torch.is_tensor(want) else want,
                      np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@contextlib.contextmanager
def spy(module, name: str, seen: list):
    """Within the block, every call of module.<name> appends its result to
    `seen`."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        seen.append(fn(*args, **kw))
        return seen[-1]

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def analysis_pair(name: str, seed: int = 27, **over):
    """(the float32 model on the CPU, a copy on the card): the registry
    swin_tiny with phase 1's perturbed weights, the others seeded."""
    import copy

    from thyroid_tpu_torch.models.base import create_and_init
    from thyroid_tpu_torch.models.from_jax import load_jax_params

    cfg = {"name": name, "in_channels": 1, "num_classes": 2, "dtype": "f32",
           **over}
    cpu = create_and_init(cfg, seed=seed, device="cpu")
    if name == "swin_tiny":
        load_jax_params(cpu, perturbed_params(dict(SWIN_TINY, dtype="f32")))
    return cpu, copy.deepcopy(cpu).to("cuda").eval()


def analysis_captures(card: str) -> bool:
    """(a): each model's capture forward (N = 2) on the card against the
    CPU's: the output and every captured tensor within ANALYSIS_RTOL, the
    same keys in the same order, no kernel launched."""
    ok = True
    for name, side in ANALYSIS_MODELS.items():
        cpu, dev = analysis_pair(name)
        x = torch.from_numpy(np.random.RandomState(270).randn(2, side, side, 1)
                             .astype(np.float32))
        got = {}
        with torch.no_grad():
            t0 = time.perf_counter()
            launches = all_launches(lambda: got.setdefault(
                "c", dev(x.cuda(), capture=True)))
            secs = time.perf_counter() - t0
            want = cpu(x, capture=True)
        (out, inter), (want_out, want_inter) = got["c"], want
        errs = {k: rel_err(inter[k], v) for k, v in want_inter.items()
                if k in inter}
        worst = max(errs, key=errs.get)
        keys_ok = list(inter) == list(want_inter)
        fired = {k: v for k, v in launches.items() if v}
        out_err = rel_err(out, want_out)
        good = keys_ok and not fired and out_err <= ANALYSIS_RTOL \
            and errs[worst] <= ANALYSIS_RTOL
        log(f"[analysis] (a) {name} capture {side}x{side} N=2: {len(inter)} "
            f"tensors, keys {'equal' if keys_ok else 'DIFFER'} (first "
            f"{list(inter)[:2]}, last {list(inter)[-1]}), output err "
            f"{out_err:.3e}, worst {worst} err {errs[worst]:.3e} (tol "
            f"{ANALYSIS_RTOL:.0e}), kernels launched {fired or 'none'}, "
            f"{secs * 1e3:.1f} ms with the first call; card {card}")
        ok &= good
        del cpu, dev
    torch.cuda.empty_cache()
    return ok


def analysis_gradcam(card: str) -> bool:
    """(b): GradCAM on resnet50, swin_tiny and deit_tiny (the same class,
    heatmap and confidence within ANALYSIS_RTOL, no kernel launched, its
    time per image); the class-token heatmap and rollout of vit_tiny and
    deit_tiny and swin_tiny's stage maps; gradient patch importance of
    vit_tiny built without its kernels, card against CPU, and with them
    (through kernels 2-3 and their backward kernels 9-11) against the CPU's
    plain path; with the kernels, swin_tiny's serving attention refuses
    autograd."""
    from thyroid_tpu_torch.analysis import attention as att
    from thyroid_tpu_torch.analysis.gradcam import gradcam

    ok = True
    x = torch.from_numpy(np.random.RandomState(271).randn(1, 224, 224, 1)
                         .astype(np.float32))
    xc = x.cuda()
    for name in ("resnet50", "swin_tiny", "deit_tiny"):
        cpu, dev = analysis_pair(name)
        got = {}
        launches = all_launches(lambda: got.setdefault("g", gradcam(dev, None, xc)))
        heat, cls, conf = got["g"]
        w_heat, w_cls, w_conf = gradcam(cpu, None, x)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            gradcam(dev, None, xc)
            secs.append(time.perf_counter() - t0)
        err = rel_err(heat, w_heat)
        fired = {k: v for k, v in launches.items() if v}
        good = cls == w_cls and heat.shape == w_heat.shape and \
            err <= ANALYSIS_RTOL and abs(conf - w_conf) <= ANALYSIS_RTOL \
            and not fired
        log(f"[analysis] (b) gradcam {name}: class {cls} (CPU {w_cls}), "
            f"heatmap {heat.shape} err {err:.3e}, confidence {conf:.6f} (CPU "
            f"{w_conf:.6f}), kernels launched {fired or 'none'}, "
            f"{statistics.median(secs) * 1e3:.2f} ms per image (median of 3); "
            f"card {card}")
        ok &= good
        if name == "swin_tiny":
            maps = att.swin_stage_feature_maps(dev, None, xc)
            want = att.swin_stage_feature_maps(cpu, None, x)
            errs = [rel_err(g, w) for g, w in zip(maps, want)]
            good = len(maps) == len(want) == 4 and max(errs) <= ANALYSIS_RTOL
            log(f"[analysis] (b) swin_stage_feature_maps: "
                f"{[m.shape for m in maps]}, max err {max(errs):.3e}")
            ok &= good
    for name in ("vit_tiny", "deit_tiny"):
        cpu, dev = analysis_pair(name)
        maps, want = (att.collect_attention_maps(m, None, xx)
                      for m, xx in ((dev, xc), (cpu, x)))
        errs = {"cls heatmap": rel_err(att.cls_attention_heatmap(maps[-1]),
                                       att.cls_attention_heatmap(want[-1])),
                "rollout": rel_err(att.attention_rollout(maps),
                                   att.attention_rollout(want))}
        good = len(maps) == 12 and max(errs.values()) <= ANALYSIS_RTOL
        log(f"[analysis] (b) {name} 12 maps {maps[0].shape}: errors {errs}")
        ok &= good
    cpu, dev = analysis_pair("vit_tiny", token_kernels=False)
    plain = att.gradient_patch_importance(cpu, None, x)
    imp = att.gradient_patch_importance(dev, None, xc)
    err = rel_err(imp, plain)
    log(f"[analysis] (b) gradient_patch_importance vit_tiny token_kernels "
        f"false: {imp.shape} err {err:.3e}")
    ok &= err <= ANALYSIS_RTOL
    _, fused = analysis_pair("vit_tiny")
    got = {}
    launches = all_launches(lambda: got.setdefault(
        "i", att.gradient_patch_importance(fused, None, xc)))
    err = rel_err(got["i"], plain)
    want = {k: 0 for k in launches}
    want.update(ln_matmul=12, ln_mlp_residual=12, ln_matmul_bwd=12,
                ln_mlp_bwd_dx=12, ln_mlp_bwd_dw=12)
    log(f"[analysis] (b) gradient_patch_importance vit_tiny with kernels 2-3 "
        f"(backward kernels 9-11): err {err:.3e} against the CPU's plain path; "
        f"launches {launches}, expected {want}")
    ok &= err <= ANALYSIS_RTOL and launches == want
    _, swin = analysis_pair("swin_tiny")
    try:
        att.gradient_patch_importance(swin, None, xc)
        log("[analysis] (b) gradient_patch_importance swin_tiny with its "
            "kernels did not raise: FAIL")
        ok = False
    except RuntimeError as e:
        log(f"[analysis] (b) gradient_patch_importance swin_tiny with its "
            f"kernels raises: {e}")
        ok &= "has no backward" in str(e)
    torch.cuda.empty_cache()
    return ok


def eval_frames():
    """EVAL_FRAMES raw frames of phase 23's corpus, the first half of each
    class, with their labels."""
    from thyroid_tpu_torch.data.dataset import CARSThyroidDataset

    ds = CARSThyroidDataset({"data_path": str(WORK / "experiment" / "synthetic")},
                            split="all")
    half = EVAL_FRAMES // 2
    idx = np.concatenate([np.nonzero(ds.all_labels == c)[0][:half]
                          for c in (0, 1)])
    ds.paths = [ds.all_paths[i] for i in idx]
    return ds.load_images(), ds.all_labels[idx]


def eval_pipelines(frames, labels):
    """The 16-frame eval pipelines (224², batch 8) on the card and the CPU,
    and the launches of the card's preparation."""
    from thyroid_tpu_torch.data.pipeline import DevicePipeline

    got = {}
    launches = all_launches(lambda: got.setdefault("p", DevicePipeline(
        frames, labels, batch_size=EVAL_BATCH, img_size=224)))
    cpu = DevicePipeline(frames, labels, batch_size=EVAL_BATCH, img_size=224,
                         device="cpu")
    return got["p"], cpu, launches


def compare_probs(tag: str, got, want, tol: float) -> bool:
    """Card against CPU probabilities (N, 2) within `tol`, and the binary
    reports' predictions equal but for frames whose CPU probability lies
    within `tol` of 0.5 (counted)."""
    err = float(np.abs(got - want).max())
    near = np.abs(want[:, 1] - 0.5) <= tol
    flips = (got[:, 1] >= 0.5) != (want[:, 1] >= 0.5)
    good = got.shape == want.shape and err <= tol and not (flips & ~near).any()
    log(f"[analysis] {tag}: probabilities max_abs_err {err:.3e} (tol "
        f"{tol:.0e}); {int(near.sum())} frames within tol of 0.5 "
        f"{np.nonzero(near)[0].tolist()}, {int(flips.sum())} decisions "
        f"differ ({int((flips & ~near).sum())} outside that band)")
    return good


def analysis_checkpoints(card: str, pipes) -> bool:
    """(c): evaluate_checkpoint with and without TTA on a registry swin_tiny
    checkpoint written from phase 1's perturbed parameters and on the
    all-models sweep's deit_tiny fold checkpoint, each as stored (bf16)
    and in float32: exact launches per call (rows 2-4 per forward, ×5 with
    TTA), probabilities card vs CPU, the reports' counts; images/s with
    and without TTA."""
    from types import SimpleNamespace

    from thyroid_tpu_torch.analysis import evaluation
    from thyroid_tpu_torch.models.from_jax import (batch_stats, jax_layout,
                                                   load_jax_params)
    from thyroid_tpu_torch.models.registry import ModelRegistry, resolve_dtype
    from thyroid_tpu_torch.training.checkpoint import save_checkpoint

    model = ModelRegistry.create_model(SWIN_TINY)
    load_jax_params(model, perturbed_params(SWIN_TINY))
    swin_ckpt = save_checkpoint(
        WORK / "analysis" / "swin_tiny.ckpt",
        SimpleNamespace(params=dict(model.named_parameters()),
                        batch_stats=batch_stats(model),
                        layout=jax_layout(model), step=0),
        {"model_config": SWIN_TINY})
    deit_ckpt = WORK / "all_models" / "all_models_kfold" / "deit_tiny" / "best_checkpoint"
    stored = json.loads((deit_ckpt / "metadata.json").read_text())["model_config"]
    card_pipe, cpu_pipe = pipes
    forwards = -(-EVAL_FRAMES // EVAL_BATCH)
    ok = True
    for name, ckpt, cfg in (("swin_tiny", swin_ckpt, SWIN_TINY),
                            ("deit_tiny", deit_ckpt, stored)):
        for dtype in ("as stored", "f32"):
            mcfg = None if dtype == "as stored" else dict(cfg, dtype="f32")
            tol = PROB_TOL[resolve_dtype(mcfg or cfg)]
            for tta in (False, True):
                seen, got = [], {}
                with spy(evaluation, "predict_probs", seen):
                    launches = all_launches(lambda: got.setdefault(
                        "r", evaluation.evaluate_checkpoint(
                            ckpt, mcfg, card_pipe, tta=tta)))
                    evaluation.evaluate_checkpoint(ckpt, mcfg, cpu_pipe,
                                                   tta=tta, device="cpu")
                n = forwards * (5 if tta else 1)
                want = {k: EVAL_PER_FORWARD[name].get(k, 0) * n for k in launches}
                tag = (f"(c) evaluate_checkpoint {name} {dtype} "
                       f"({str(resolve_dtype(mcfg or cfg))[6:]}) tta={tta}")
                good = compare_probs(tag, seen[0][0], seen[1][0], tol)
                rep = got["r"]
                log(f"[analysis] {tag}: accuracy {rep['accuracy']:.4f}, auc "
                    f"{rep['auc']:.4f}, confusion {rep['confusion_matrix']}; "
                    f"launches {launches}, expected {want}")
                ok &= good and launches == want
    ok &= analysis_times(card, swin_ckpt)
    return ok


def analysis_times(card: str, ckpt) -> bool:
    """Evaluation images/s of the registry swin_tiny (bf16) over TIMED_FRAMES
    prepared frames at bucket 32, without and with TTA, median of 3."""
    from thyroid_tpu_torch.analysis import evaluation
    from thyroid_tpu_torch.data.pipeline import DevicePipeline

    rs = np.random.RandomState(272)
    frames = (rs.rand(TIMED_FRAMES, 512, 512, 1) * 65535).astype(np.float32)
    pipe = DevicePipeline(frames, np.arange(TIMED_FRAMES) % 2, batch_size=BATCH,
                          img_size=224)
    model, _ = evaluation.load_model(ckpt)
    rates = {}
    for tta in (False, True):
        evaluation.predict_probs(model, None, pipe, tta=tta)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            evaluation.predict_probs(model, None, pipe, tta=tta)
            secs.append(time.perf_counter() - t0)
        rates[tta] = TIMED_FRAMES / statistics.median(secs)
    log(f"[analysis] (c) predict_probs swin_tiny bf16, {TIMED_FRAMES} frames "
        f"at bucket {BATCH}: {rates[False]:.1f} images/s without TTA, "
        f"{rates[True]:.1f} with (5 views), ratio "
        f"{rates[False] / rates[True]:.2f} (median of 3); card {card}")
    return all(np.isfinite(list(rates.values())))


def analysis_ensemble(card: str, pipes) -> bool:
    """(d): the `ensemble-kfold` CLI on the card over phase 26's teachers
    (resnet50, efficientnet_b0, densenet121; fold 1, weights 0.5 / 0.25 /
    0.25) in the sequential-training layout, on fold 1's test split of
    phase 23's corpus (quality preprocessing on): every mode's and member's
    report present and finite; then the same members on the 16-frame
    pipelines, card against CPU."""
    import math

    from thyroid_tpu_torch.analysis import cli, evaluation
    from thyroid_tpu_torch.models.registry import resolve_dtype

    root = WORK / "analysis" / "ensemble"
    for name in DISTILL_TEACHERS:
        dst = root / name / "fold_1" / "checkpoints" / f"{name}-best.ckpt"
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copytree(WORK / "distill" / "checkpoints" / f"{name}-best.ckpt", dst)
    work = WORK / "experiment"
    args = ["ensemble-kfold", "--members", *DISTILL_TEACHERS, "--folds", "1",
            "--checkpoint-root", str(root), "--output", str(root / "ensemble.json"),
            "--override", f"dataset.data_path={work / 'synthetic'}",
            "--override", f"dataset.split_dir={work / 'splits'}"]
    log(f"[analysis] (d) python -m thyroid_tpu_torch.analysis.cli {' '.join(args)}")
    got = {}
    t0 = time.perf_counter()
    launches = all_launches(lambda: got.setdefault("s", cli.main(args)))
    secs = time.perf_counter() - t0
    summary = got["s"]
    reports = [summary["folds"]["fold_1"]] + [
        d["folds"]["fold_1"] for group in ("modes", "members")
        for d in summary[group].values()]
    finite = all(math.isfinite(r[k]) for r in reports
                 for k in ("accuracy", "auc", "sensitivity", "specificity"))
    ok = set(summary["modes"]) == {"weighted_average", "simple_average",
                                   "weighted_voting"} \
        and set(summary["members"]) == set(DISTILL_TEACHERS) and finite \
        and summary["weights"] == [0.5, 0.25, 0.25]
    log(f"[analysis] (d) ensemble fold 1: weighted_average accuracy "
        f"{summary['mean_accuracy']:.4f} auc {summary['mean_auc']}; "
        f"members {{{', '.join(f'{k}: {v['mean_accuracy']:.4f}' for k, v in summary['members'].items())}}}; "
        f"{len(reports)} reports finite {finite}; {secs:.2f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    specs = [{"model": cli.stored_config(root / n / "fold_1" / "checkpoints"
                                         / f"{n}-best.ckpt", n),
              "checkpoints": {1: str(root / n / "fold_1" / "checkpoints"
                                     / f"{n}-best.ckpt")}}
             for n in DISTILL_TEACHERS]
    runs = []
    for pipe, device in zip(pipes, ("cuda", "cpu")):
        seen = []
        with spy(evaluation, "predict_probs", seen):
            summary = evaluation.evaluate_ensemble_kfold(specs, {1: pipe},
                                                         device=device)
        runs.append(([s[0] for s in seen], summary))
    (card_p, card_s), (cpu_p, cpu_s) = runs
    tols = [PROB_TOL[resolve_dtype(s["model"])] for s in specs]
    for name, g, w, tol in zip(DISTILL_TEACHERS, card_p, cpu_p, tols):
        ok &= compare_probs(f"(d) member {name} (16 frames)", g, w, tol)
    wts = np.array([0.5, 0.25, 0.25]).reshape(-1, 1, 1)
    ok &= compare_probs("(d) weighted average (16 frames)",
                        (np.stack(card_p) * wts).sum(0),
                        (np.stack(cpu_p) * wts).sum(0), max(tols))
    return ok


def analysis_quality(card: str) -> bool:
    """(e): the `quality-report` CLI over phase 23's corpus on the card and
    on the CPU: the issue index lists equal, the means within 1e-5
    relative, minima and maxima equal."""
    from thyroid_tpu_torch.analysis import cli

    out = WORK / "analysis" / "quality"
    reports, secs = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        reports[device] = cli.main([
            "quality-report", "--data-path", str(WORK / "experiment" / "synthetic"),
            "--split-dir", str(out / "splits"), "--output",
            str(out / f"quality_report_{device}.json"), "--device", device])
        secs[device] = time.perf_counter() - t0
    card_report, cpu_report = reports["cuda"], reports["cpu"]
    ok = card_report["summary"] == cpu_report["summary"]
    for split, entry in card_report["dataset_stats"].items():
        g, w = entry["metrics"], cpu_report["dataset_stats"][split]["metrics"]
        rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                  for k in ("mean_intensity", "std_intensity"))
        good = g["quality_issues"] == w["quality_issues"] and rel <= 1e-5 \
            and (g["min"], g["max"]) == (w["min"], w["max"])
        log(f"[analysis] (e) quality report {split}: {g['num_images']} frames, "
            f"issues {{{', '.join(f'{k}: {len(v)}' for k, v in g['quality_issues'].items())}}} "
            f"{'equal' if g['quality_issues'] == w['quality_issues'] else 'DIFFER'}, "
            f"means rel err {rel:.2e}")
        ok &= good
    card_secs, cpu_secs = secs["cuda"], secs["cpu"]
    log(f"[analysis] (e) summary {card_report['summary']}; {card_secs:.2f} s "
        f"on the card, {cpu_secs:.2f} s on the CPU (decoding included); "
        f"card {card}")
    return ok


def analysis_logging(card: str, have_matplotlib: bool) -> bool:
    """(f): deit_tiny (float32) for one epoch of 3 batches with
    log_attention_every_n_epochs 1: the figure written, the logged maps
    equal to the CPU's on the same weights and images. Without matplotlib
    the Trainer refuses to log, and the maps are checked alone."""
    from thyroid_tpu_torch.analysis import attention as att
    from thyroid_tpu_torch.data.dataset import CARSThyroidDataset
    from thyroid_tpu_torch.data.pipeline import DevicePipeline
    from thyroid_tpu_torch.models.registry import ModelRegistry
    from thyroid_tpu_torch.training.configs import TRAINER_DEFAULT, TRAINING_VIT
    from thyroid_tpu_torch.training.engine import Trainer

    cfg = {"name": "deit_tiny", "in_channels": 1, "num_classes": 2, "dtype": "f32"}
    trainer_cfg = dict(TRAINER_DEFAULT, max_epochs=1, enable_checkpointing=False,
                       log_attention_every_n_epochs=1)
    out = WORK / "analysis" / "trainer"
    ds = CARSThyroidDataset({"data_path": str(WORK / "experiment" / "synthetic")},
                            split="all")
    ds.paths = ds.all_paths[::4][:4 * BATCH]
    frames, labels = ds.load_images(), ds.all_labels[::4][:4 * BATCH]
    train = DevicePipeline(frames[:3 * BATCH], labels[:3 * BATCH],
                           batch_size=BATCH, img_size=224, train=True)
    val = DevicePipeline(frames[3 * BATCH:], labels[3 * BATCH:],
                         batch_size=BATCH, img_size=224)
    if have_matplotlib:
        trainer = Trainer(ModelRegistry.create_model(cfg), cfg, TRAINING_VIT,
                          trainer_cfg, steps_per_epoch=3, output_dir=out)
        seen = []
        with spy(Trainer, "attention_maps", seen):
            t0 = time.perf_counter()
            launches = all_launches(lambda: trainer.fit(train, val))
            secs = time.perf_counter() - t0
        png = out / "logs" / "images" / "attention_maps_00000.png"
        ok = len(seen) == 1 and png.exists()
        log(f"[analysis] (f) Trainer.fit deit_tiny f32, 3 batches of {BATCH} "
            f"with log_attention_every_n_epochs 1: {secs:.2f} s, figure "
            f"{png.name} {'written' if png.exists() else 'MISSING'} "
            f"({png.stat().st_size if png.exists() else 0} bytes); launches "
            f"{ {k: v for k, v in launches.items() if v} }; card {card}")
        images, _, heatmaps = seen[0]
    else:
        try:
            Trainer(ModelRegistry.create_model(cfg), cfg, TRAINING_VIT,
                    trainer_cfg, steps_per_epoch=3, output_dir=out)
            ok = False
        except ImportError as e:
            log(f"[analysis] (f) no matplotlib on this machine; the Trainer "
                f"asked to log refuses: {e}")
            ok = True
        trainer = Trainer(ModelRegistry.create_model(cfg), cfg, TRAINING_VIT,
                          dict(trainer_cfg, log_attention_every_n_epochs=0),
                          steps_per_epoch=3, output_dir=out)
        trainer.fit(train, val)
        images, _, heatmaps = trainer.attention_maps(val)
    cpu = ModelRegistry.create_model(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    maps = att.collect_attention_maps(cpu.eval(), None, torch.from_numpy(images))
    errs = [rel_err(hm, att.cls_attention_heatmap(maps[-1][i:i + 1]))
            for i, hm in enumerate(heatmaps)]
    log(f"[analysis] (f) logged maps {len(heatmaps)} x {heatmaps[0].shape} "
        f"against the CPU's on the same weights: max err {max(errs):.3e}")
    return ok and len(heatmaps) == 4 and max(errs) <= ANALYSIS_RTOL


def phase_analysis(card: str) -> None:
    """Phase 27: the analysis on the card against the CPU, (a) to (f), on
    phase 23's corpus and phase 26's checkpoints; float32 matmuls and
    convolutions without TF32."""
    import importlib.util

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    have_matplotlib = importlib.util.find_spec("matplotlib") is not None
    log(f"[analysis] matplotlib {'is' if have_matplotlib else 'is not'} "
        f"installed on this machine")
    frames, labels = eval_frames()
    card_pipe, cpu_pipe, launches = eval_pipelines(frames, labels)
    want = {k: int(k == "percentile") for k in launches}
    log(f"[analysis] the {EVAL_FRAMES}-frame eval pipeline's preparation on "
        f"the card: launches {launches}, expected {want}")
    ok = {"pipeline": launches == want,
          "captures": analysis_captures(card),
          "gradcam": analysis_gradcam(card),
          "checkpoints": analysis_checkpoints(card, (card_pipe, cpu_pipe)),
          "ensemble": analysis_ensemble(card, (card_pipe, cpu_pipe)),
          "quality report": analysis_quality(card),
          "logging": analysis_logging(card, have_matplotlib)}
    log(f"[analysis] checks {ok}; phase 27 {time.perf_counter() - t0:.1f} s")
    if not all(ok.values()):
        raise AssertionError(f"phase 27 checks failed: {ok}")


# phase 28: the served swin_tiny through the HTTP front end, from a port
# checkpoint; rounds of SERVE_CLIENTS concurrent single-frame posts
SERVE_BUCKETS = (1, 8, 32)
SERVE_CLIENTS, SERVE_ROUNDS, SERVE_DELAY_MS = 16, 4, 20.0
SERVE_PER_FORWARD = {"percentile": 1, "ln_matmul": 15, "ln_mlp_residual": 12,
                     "swin_block_attention": 12}
# the server rounds probabilities to 6 decimals
SERVE_TOL = 1e-6
# int8 engines at full width, card vs the CPU port's int8 engine on
# INT8_FRAMES frames (bucket INT8_FRAMES): every int32 product is held bit
# for bit, so what is left is the bf16 model around the products, which
# PROB_TOL[bf16] bounds card vs CPU (phases 24-25); an activation that the
# two devices' bf16 roundings put on either side of an int8 step moves its
# layer's output by one step, 1/127 of the tensor's max, below a bf16
# value's own 2^-8 relative step at a tenth of the max and above it at the
# max, so the same bound is kept
INT8_MODELS = ("resnet50", "vit_base")
INT8_FRAMES = 4
INT8_PROB_TOL = PROB_TOL[torch.bfloat16]
# share of BATCH frames whose class the int8 engine gives as the card's
# bf16 engine does (JAX's own model-level bound, tests/unit/test_quantize.py)
INT8_TOP1 = 0.75
# quantized layers per forward: resnet50's convs but the 1-channel stem;
# vit_base's qkv, proj and the two MLP layers of 12 blocks
INT8_LAYERS = {"resnet50": 52, "vit_base": 48}


def serve_checkpoint(params) -> Path:
    """A port checkpoint of the registry swin_tiny (bf16) on phase 1's
    perturbed weights, with its model_config metadata."""
    from types import SimpleNamespace

    from thyroid_tpu_torch.models.base import create_and_init
    from thyroid_tpu_torch.models.from_jax import (batch_stats, jax_layout,
                                                   load_jax_params)
    from thyroid_tpu_torch.training.checkpoint import save_checkpoint

    model = create_and_init(SWIN_TINY, device="cpu", pretrained=False)
    load_jax_params(model, params)
    state = SimpleNamespace(params=dict(model.named_parameters()),
                            batch_stats=batch_stats(model),
                            layout=jax_layout(model), step=0)
    return save_checkpoint(WORK / "serve" / "swin_tiny", state,
                           {"model_config": SWIN_TINY})


def http_call(port: int, method: str, path: str, body=None,
              ctype: str = "application/octet-stream"):
    """(status, decoded JSON answer, seconds) of one request on loopback."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out + (time.perf_counter() - t0,)


def npy_bytes(arr) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return buf.getvalue()


def serving_front_end(card: str, params) -> bool:
    """(a) of phase 28: `python -m thyroid_tpu_torch.serving.server` on a
    port checkpoint of swin_tiny bf16, at 127.0.0.1 and a free port in a
    thread: /healthz, a 32-frame .npy post, a 2-frame JSON post and
    SERVE_ROUNDS rounds of SERVE_CLIENTS concurrent single-frame posts.
    Every answer against engine.predict on the same frames in the same
    batch (re-run) within SERVE_TOL; kernels 1-4 at their exact counts
    per forward over the requests; each round in fewer batches than
    posts; requests/s and p50/p99 latency of the single-frame clients."""
    import threading

    from thyroid_tpu_torch.serving import server as srv

    ck = serve_checkpoint(params)
    t0 = time.perf_counter()
    server, engine, agg = srv.build_server([
        "--checkpoint", str(ck), "--port", "0", "--buckets",
        *map(str, SERVE_BUCKETS), "--max-delay-ms", str(SERVE_DELAY_MS)])
    log(f"[front end] checkpoint {ck.name} restored and buckets "
        f"{SERVE_BUCKETS} warmed in {time.perf_counter() - t0:.2f} s")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    calls, predict = [], engine.predict

    def recorded(images):
        probs = predict(images)
        calls.append((np.array(images, np.float32), probs))
        return probs

    engine.predict = recorded
    rs = np.random.RandomState(280)
    frames = rs.randint(0, 65536, (BATCH, 512, 512, 1)).astype(np.float32)
    singles = rs.randint(0, 65536, (SERVE_ROUNDS, SERVE_CLIENTS, 512, 512)) \
        .astype(np.float32)
    answers, latencies, rounds = [], [], []
    watched = all_counters()
    try:
        code, health, _ = http_call(port, "GET", "/healthz")
        ok = code == 200 and health["buckets"] == list(SERVE_BUCKETS)
        log(f"[front end] GET /healthz on port {port}: {code} {health}")
        for fn in watched.values():
            fn.launches = 0
        code, body, secs = http_call(port, "POST", "/predict", npy_bytes(frames))
        answers.append((frames, body, code))
        log(f"[front end] POST {BATCH}-frame .npy ({frames.nbytes / 1e6:.1f} MB): "
            f"{code} in {secs * 1e3:.1f} ms")
        code, body, secs = http_call(
            port, "POST", "/predict",
            json.dumps({"images": frames[:2, ..., 0].astype(int).tolist()}),
            ctype="application/json")
        answers.append((frames[:2], body, code))
        log(f"[front end] POST 2-frame JSON: {code} in {secs * 1e3:.1f} ms")
        for r in range(SERVE_ROUNDS):
            out = [None] * SERVE_CLIENTS
            before = agg.batches_dispatched

            def client(i, r=r, out=out):
                out[i] = http_call(port, "POST", "/predict",
                                   npy_bytes(singles[r, i]))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            rounds.append((time.perf_counter() - t0,
                           agg.batches_dispatched - before))
            for i, (code, body, secs) in enumerate(out):
                answers.append((singles[r, i][None, ..., None], body, code))
                latencies.append(secs)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in watched.items()}
    finally:
        server.shutdown()
        server.server_close()
        agg.close()
        thread.join(timeout=30)
        engine.predict = predict
    forwards = len(calls)
    want = {k: SERVE_PER_FORWARD.get(k, 0) * forwards for k in launches}
    ok &= launches == want and forwards == 2 + sum(b for _, b in rounds)
    log(f"[front end] {forwards} forwards ({len(calls) - 2} aggregated batches "
        f"for {SERVE_ROUNDS * SERVE_CLIENTS} single frames); launches "
        f"{ {k: v for k, v in launches.items() if v} }, expected "
        f"{ {k: v for k, v in want.items() if v} }")
    for r, (secs, batches) in enumerate(rounds):
        log(f"[front end] round {r}: {SERVE_CLIENTS} concurrent posts in "
            f"{batches} batches, {secs * 1e3:.1f} ms")
        ok &= batches < SERVE_CLIENTS
    # every batch re-runs to the same bits; a multi-frame answer is its own
    # call's, a single frame's the row of the aggregated batch that held it
    # (the same frame in another bucket rounds differently in bf16)
    worst = 0.0
    for images, probs in calls:
        worst = max(worst, float(np.abs(engine.predict(images) - probs).max()))
    rerun = worst
    for images, body, code in answers:
        ok &= code == 200
        if len(images) > 1:
            want = [p for im, p in calls if np.array_equal(im, images)]
        else:
            want = [p[i:i + 1] for im, p in calls[2:] for i in range(len(im))
                    if np.array_equal(im[i], images[0])]
        ok &= len(want) == 1
        worst = max(worst, float(np.abs(np.asarray(body["probs"]) - want[0]).max()))
    ok &= worst <= SERVE_TOL
    lat = np.asarray(latencies) * 1e3
    total = sum(secs for secs, _ in rounds)
    log(f"[front end] answers vs engine.predict on the same frames and batch: "
        f"max_abs_err {worst:.3e} (re-runs {rerun:.3e}) tol {SERVE_TOL:.0e}")
    log(f"[front end] single-frame clients: {len(lat) / total:.1f} requests/s "
        f"over {SERVE_ROUNDS} rounds of {SERVE_CLIENTS}, latency p50 "
        f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms, "
        f"max {lat.max():.1f} ms (max_delay_ms {SERVE_DELAY_MS}); card {card}")
    del engine
    torch.cuda.empty_cache()
    return bool(ok)


def int8_products(engine, frames):
    """Probabilities of the card's int8 engine on `frames`, with every
    int32 product's operands and result recorded: [(a, b, y) on the
    card]."""
    from thyroid_tpu_torch.serving.quantize import observing

    seen = []
    with observing(lambda kernel, a, b, y: seen.append((a, b, y))):
        probs = engine.predict(frames)
    return probs, seen


def int8_operands(name: str, card_seen, cpu_seen) -> None:
    """Where the card's int8 forward leaves the CPU's: per quantized layer
    in order, the share of int8 activations (operand a) that differ and by
    how many steps, logged (the products on equal operands are held bit
    for bit apart)."""
    diffs = []
    for i, ((a, _, _), (c, _, _)) in enumerate(zip(card_seen, cpu_seen)):
        d = (a.cpu().int() - c.int()).abs()
        diffs.append((i, float((d > 0).float().mean()), int(d.max())))
    moved = [x for x in diffs if x[1] > 0]
    log(f"[int8] {name} card vs CPU int8 activations, layer by layer: "
        f"{len(moved)} of {len(diffs)} layers differ, the first at layer "
        f"{moved[0][0] if moved else None}; largest share "
        f"{max((x[1] for x in diffs), default=0):.3e}, largest step "
        f"{max((x[2] for x in diffs), default=0)}; (layer, share, step) of the "
        f"first five that differ {[(i, f'{s:.2e}', m) for i, s, m in moved[:5]]}")


def int8_times(engines, frames, card: str, name: str) -> None:
    """images/s of `predict` at bucket BATCH for each engine, in turns
    (median of 5)."""
    secs = {k: [] for k in engines}
    for _ in range(5):
        for k, eng in engines.items():
            t0 = time.perf_counter()
            eng.predict(frames)
            secs[k].append(time.perf_counter() - t0)
    log(f"[int8] {name} predict bucket {BATCH}, raw 512² frames: " + ", ".join(
        f"{k} {BATCH / statistics.median(v):.1f} images/s "
        f"({statistics.median(v) * 1e3:.2f} ms)" for k, v in secs.items())
        + f" (median of 5, in turns); card {card}")


def serving_int8(card: str) -> bool:
    """(b) of phase 28: resnet50 and vit_base bf16 served with
    quantize="int8". Each quantized layer's int32 product on the card
    against the CPU's on the same int8 operands, bit for bit; the
    probabilities against the CPU port's int8 engine on the same
    INT8_FRAMES frames within INT8_PROB_TOL; top-1 agreement with the
    card's bf16 engine over BATCH frames; vit_base's int8 forward without
    kernels 2 and 3; images/s int8 beside bf16."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine
    from thyroid_tpu_torch.serving.quantize import int_matmul

    ok = True
    rs = np.random.RandomState(281)
    frames = (rs.rand(BATCH, 512, 512, 1) * 65535).astype(np.float32)
    buckets = (INT8_FRAMES, BATCH)
    for name in INT8_MODELS:
        t0 = time.perf_counter()
        cfg = zoo_config(name)
        variables = effnet_variables(RESNET50) if name == "resnet50" \
            else {"params": perturbed_params(cfg)}
        engines = {k: InferenceEngine(cfg, variables=variables, buckets=buckets,
                                      quantize=k if k == "int8" else None)
                   for k in ("bf16", "int8")}
        card_q, seen = int8_products(engines["int8"], frames[:INT8_FRAMES])
        mismatched = [i for i, (a, b, y) in enumerate(seen)
                      if not torch.equal(int_matmul(a.cpu(), b.cpu()), y.cpu())]
        shapes = sorted({(a.shape[0], a.shape[1], b.shape[1]) for a, b, _ in seen})
        log(f"[int8] {name}: {len(seen)} int32 products in one forward at "
            f"bucket {INT8_FRAMES} (expected {INT8_LAYERS[name]}), card vs CPU on "
            f"the same int8 operands: {len(seen) - len(mismatched)} bit-equal, "
            f"mismatched {mismatched}; (M, K, N) from {shapes[0]} to {shapes[-1]}")
        ok &= not mismatched and len(seen) == INT8_LAYERS[name]
        cpu = {"bf16": InferenceEngine(cfg, variables=variables, buckets=buckets,
                                       device="cpu").predict(frames[:INT8_FRAMES])}
        cpu["int8"], cpu_seen = int8_products(
            InferenceEngine(cfg, variables=variables, buckets=buckets,
                            quantize="int8", device="cpu"), frames[:INT8_FRAMES])
        int8_operands(name, seen, cpu_seen)
        del seen, cpu_seen
        err = float(np.abs(card_q - cpu["int8"]).max())
        bf16_err = float(np.abs(engines["bf16"].predict(frames[:INT8_FRAMES])
                                - cpu["bf16"]).max())
        log(f"[int8] {name} N={INT8_FRAMES} probabilities, card int8 vs CPU int8: "
            f"max_abs_err {err:.3e} tol {INT8_PROB_TOL:.0e} (card bf16 vs CPU "
            f"bf16 on the same frames {bf16_err:.3e}, logged; p0 card "
            f"{[f'{v:.5f}' for v in card_q[:, 0]]})")
        ok &= err <= INT8_PROB_TOL
        launches = zoo_counts(lambda: engines["int8"].predict(frames))
        want = {k: int(k == "percentile") for k in launches}
        log(f"[int8] {name} int8 forward at bucket {BATCH}: launches "
            f"{ {k: v for k, v in launches.items() if v} }, expected "
            f"{ {k: v for k, v in want.items() if v} }")
        ok &= launches == want
        probs = {k: eng.predict(frames) for k, eng in engines.items()}
        agree = float((probs["int8"].argmax(-1) == probs["bf16"].argmax(-1)).mean())
        log(f"[int8] {name} top-1 agreement int8 vs bf16 on the card over {BATCH} "
            f"frames: {agree:.3f} (at least {INT8_TOP1}); max |p int8 - p bf16| "
            f"{float(np.abs(probs['int8'] - probs['bf16']).max()):.3e}, spread of "
            f"bf16 p0 {float(np.ptp(probs['bf16'][:, 0])):.3e}")
        ok &= agree >= INT8_TOP1
        int8_times(engines, frames, card, name)
        log(f"[int8] {name}: {time.perf_counter() - t0:.1f} s")
        del engines
        torch.cuda.empty_cache()
    return bool(ok)


def serving_prepared(card: str) -> bool:
    """(c) of phase 28: vit_tiny float32 on prepared 224² frames
    (raw_inputs=False) with mean 0.45 / std 0.25, card vs CPU within
    PROB_TOL[float32]; no kernel 1 launch (nothing to prepare), 12 each of
    kernels 2 and 3; the override moves the answer."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    cfg = zoo_config("vit_tiny", "f32")
    params = perturbed_params(cfg)
    kw = dict(params=params, raw_inputs=False, mean=(0.45,), std=(0.25,),
              buckets=(8,))
    frames = np.random.RandomState(282).rand(8, 224, 224, 1).astype(np.float32)
    card_engine = InferenceEngine(cfg, **kw)
    card_engine.warmup()
    probs = {}
    launches = zoo_counts(lambda: probs.setdefault("card", card_engine.predict(frames)))
    cpu = InferenceEngine(cfg, device="cpu", **kw).predict(frames)
    default = InferenceEngine(cfg, device="cpu", params=params, raw_inputs=False,
                              buckets=(8,)).predict(frames)
    err = float(np.abs(probs["card"] - cpu).max())
    moved = float(np.abs(cpu - default).max())
    want = {k: 12 if k in ("ln_matmul", "ln_mlp_residual") else 0 for k in launches}
    log(f"[prepared] vit_tiny f32, raw_inputs=False, mean 0.45 std 0.25, N=8: card "
        f"vs CPU max_abs_err {err:.3e} tol {PROB_TOL[torch.float32]:.0e}; against "
        f"the default statistics {moved:.3e}; launches "
        f"{ {k: v for k, v in launches.items() if v} }, expected "
        f"{ {k: v for k, v in want.items() if v} }; card {card}")
    return err <= PROB_TOL[torch.float32] and moved > 1e-4 and launches == want


def phase_serving(card: str, params) -> None:
    """Phase 28: serving, the rest: (a) the HTTP front end on a port
    checkpoint of swin_tiny, (b) int8 resnet50 and vit_base at full
    width, (c) prepared inputs and statistics overrides; float32 matmuls
    and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ok = {"front end": serving_front_end(card, params),
          "int8": serving_int8(card),
          "prepared": serving_prepared(card)}
    log(f"[serving] checks {ok}; phase 28 {time.perf_counter() - t0:.1f} s")
    if not all(ok.values()):
        raise AssertionError(f"phase 28 checks failed: {ok}")


# phase 29: serving export. swin_tiny bf16 bundles on raw 512x512 frames,
# exported from the card's engine and from a CPU engine, loaded in a child
# process that must not import the model code; EXPORT_FRAMES frames are a
# chunk of 32, then 8 at bucket 8 (no padding, so the bundle's zero padding
# and the engine's repeated frame never differ)
EXPORT_BUCKETS = SERVE_BUCKETS
EXPORT_FRAMES = 40
# a bundle is the engine's own program: the same kernels on the same inputs
EXPORT_TOL = 1e-6
EXPORT_TIMED = 10
# modules a bundle's process must not load
MODEL_CODE = ("thyroid_tpu_torch.models", "thyroid_tpu_torch.config",
              "thyroid_tpu_torch.serving.engine")


def counted(run):
    """(run(), {counter: launches}) with every counter set to 0 just before."""
    held = {}
    launches = zoo_counts(lambda: held.update(out=run()))
    return held["out"], {k: v for k, v in launches.items() if v}


def export_child(pairs) -> int:
    """`python3 chip_smoke.py --export-child BUNDLE:FRAMES ...`: load each
    bundle on the card with load_exported, predict its frames with every
    counter counted, save the probabilities beside the frames, and print
    one `CHILD {...}` line with the launches, the load seconds and the
    model-code modules this process imported (none expected)."""
    from thyroid_tpu_torch.serving import load_exported

    out = {}
    for pair in pairs:
        bundle, frames = pair.split(":")
        t0 = time.perf_counter()
        engine = load_exported(bundle)
        engine.warmup()
        loaded = time.perf_counter() - t0
        probs, launches = counted(lambda: engine.predict(np.load(frames)))
        np.save(frames.replace(".npy", f"_{Path(bundle).name}.npy"), probs)
        out[Path(bundle).name] = {"launches": launches, "load_s": loaded}
    out["model_code"] = sorted(m for m in sys.modules if m.startswith(MODEL_CODE))
    print("CHILD " + json.dumps(out), flush=True)
    return 0


def graph_ops(path: Path):
    """{op: calls} of the thyroid_tpu_torch ops in one exported program."""
    exported = torch.export.load(str(path))
    found = {}
    for node in exported.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("thyroid_tpu_torch."):
            found[name.split(".")[1]] = found.get(name.split(".")[1], 0) + 1
    return found


def export_swin(card: str, params, root: Path):
    """(a) and (b) of phase 29: swin_tiny bf16, without and with the
    quality pipeline, exported at EXPORT_BUCKETS from the card's engine and
    from a CPU engine; every bundle loaded on the card in one child process
    (no model code imported), EXPORT_FRAMES frames predicted: the
    probabilities within EXPORT_TOL of engine.predict and the launches equal
    to the engine's on the same frames → (ok, the raw card engine)."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine
    from thyroid_tpu_torch.serving.export import export_engine

    rs = np.random.RandomState(290)
    frames = {"raw": (rs.rand(EXPORT_FRAMES, 512, 512, 1) * 65535).astype(np.float32),
              "quality": quality_frames(EXPORT_FRAMES)[..., None]}
    ok, wants, pairs, kept = True, {}, [], None
    for tag in ("raw", "quality"):
        engine = InferenceEngine(SWIN_TINY, params=params, buckets=EXPORT_BUCKETS,
                                 quality=tag == "quality")
        engine.warmup()
        wants[tag] = counted(lambda: engine.predict(frames[tag]))
        log(f"[export] engine {tag}: {EXPORT_FRAMES} frames in 2 forwards, "
            f"launches {wants[tag][1]}")
        np.save(root / f"{tag}.npy", frames[tag])
        for where in ("card", "cpu"):
            source = engine if where == "card" else InferenceEngine(
                SWIN_TINY, params=params, buckets=EXPORT_BUCKETS,
                quality=tag == "quality", device="cpu")
            t0 = time.perf_counter()
            export_engine(source, str(root / f"{tag}_{where}"))
            log(f"[export] {tag} bundle exported from the {where} engine at "
                f"buckets {EXPORT_BUCKETS} in {time.perf_counter() - t0:.1f} s; "
                f"bucket 32 holds {graph_ops(root / f'{tag}_{where}' / 'bucket_32.pt2')}")
            pairs.append(f"{root / f'{tag}_{where}'}:{root / f'{tag}.npy'}")
        if tag == "raw":
            kept = engine
        else:
            del engine
    per_forward = {k: 2 * v for k, v in SERVE_PER_FORWARD.items()}
    ok &= wants["raw"][1] == per_forward
    ok &= all(wants["quality"][1].get(k) == 2 for k in (
        "stats_quantile", "median_bilateral", "apply_luts_dual"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--export-child", *pairs], capture_output=True,
                          text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CHILD ")]
    if proc.returncode != 0 or not lines:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"the bundle process failed (exit {proc.returncode})")
    child = json.loads(lines[-1][len("CHILD "):])
    log(f"[export] child process: {len(pairs)} bundles loaded and served in "
        f"{time.perf_counter() - t0:.1f} s; model code imported: {child['model_code']}")
    ok &= child["model_code"] == []
    for tag in ("raw", "quality"):
        for where in ("card", "cpu"):
            name = f"{tag}_{where}"
            got = np.load(root / f"{tag}_{name}.npy")
            err = float(np.abs(got - wants[tag][0]).max())
            same = child[name]["launches"] == wants[tag][1]
            log(f"[export] {name} bundle on the card: max_abs_err {err:.3e} vs "
                f"engine.predict (tol {EXPORT_TOL:.0e}), launches "
                f"{child[name]['launches']} {'equal to' if same else 'DIFFER from'} "
                f"the engine's; loaded and warmed in {child[name]['load_s']:.1f} s")
            ok &= err <= EXPORT_TOL and same and got.shape == (EXPORT_FRAMES, 2)
    return bool(ok), kept


def export_one(card: str, root: Path, name: str, engine, frames, want_launches) -> bool:
    """Export `engine` at its buckets, load the bundle in this process and
    hold its predict to the engine's on `frames` (EXPORT_TOL) with the
    launches `want_launches`."""
    from thyroid_tpu_torch.serving import export_engine, load_exported

    t0 = time.perf_counter()
    export_engine(engine, str(root / name))
    bundle = load_exported(str(root / name))
    secs = time.perf_counter() - t0
    want = engine.predict(frames)
    got, launches = counted(lambda: bundle.predict(frames))
    err = float(np.abs(got - want).max())
    log(f"[export] {name}: exported and loaded in {secs:.1f} s; bucket "
        f"{engine.buckets[-1]} holds {graph_ops(root / name / f'bucket_{engine.buckets[-1]}.pt2')}; "
        f"max_abs_err {err:.3e} vs engine.predict (tol {EXPORT_TOL:.0e}); "
        f"launches {launches}, expected {want_launches}")
    return err <= EXPORT_TOL and launches == want_launches


def export_front_end(card: str, root: Path, engine) -> bool:
    """(e) of phase 29: `serving.server --bundle` on the card-exported raw
    bundle at 127.0.0.1 and a free port: one 32-frame post equal to the
    bundle's own predict within SERVE_TOL, with 1/15/12/12 launches; then
    the predict time at bucket 32 of the engine and of the bundle, in turns."""
    import threading

    from thyroid_tpu_torch.serving import server as srv

    server, bundle, agg = srv.build_server([
        "--bundle", str(root / "raw_card"), "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    frames = (np.random.RandomState(291).rand(BATCH, 512, 512, 1) * 65535) \
        .astype(np.float32)
    try:
        (code, body, secs), launches = counted(lambda: http_call(
            server.server_address[1], "POST", "/predict", npy_bytes(frames)))
    finally:
        server.shutdown()
        server.server_close()
        agg.close()
        thread.join(timeout=30)
    err = float(np.abs(np.asarray(body.get("probs", np.nan)) - bundle.predict(frames)).max())
    log(f"[export] front end --bundle: {code} in {secs * 1e3:.1f} ms, "
        f"max_abs_err {err:.3e} vs the bundle's predict (tol {SERVE_TOL:.0e}), "
        f"launches {launches}, expected {SERVE_PER_FORWARD}")
    ok = code == 200 and err <= SERVE_TOL and launches == SERVE_PER_FORWARD
    times = {"engine": [], "bundle": []}
    for _ in range(EXPORT_TIMED):
        for name, run in (("engine", engine), ("bundle", bundle)):
            t0 = time.perf_counter()
            run.predict(frames)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    log(f"[export] predict at bucket {BATCH} (median of {EXPORT_TIMED}, in turns): "
        f"engine {statistics.median(times['engine']):.2f} ms, bundle "
        f"{statistics.median(times['bundle']):.2f} ms; card {card}")
    return bool(ok)


def dispatch_cost(card: str, calls: int = 400) -> None:
    """Host time of one call of kernel 1 on a tiny batch, where the launch
    and not the device bounds the loop: through the op
    (thyroid_tpu_torch::percentile_normalize, the dispatcher, then its CUDA
    implementation) and through the CUDA implementation alone, in turns;
    the difference is what the op adds to each of a forward's launches."""
    from thyroid_tpu_torch.ops import percentile

    x = torch.rand(1, 8, 8, 1, device="cuda")
    runs = {"op": lambda: percentile.fused_percentile_normalize(x),
            "direct": lambda: percentile._percentile_cuda(x, 1.0, 99.0, 22, 1e-8)}
    us = {k: [] for k in runs}
    for _ in range(5):
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            us[name].append((time.perf_counter() - t0) / calls * 1e6)
    op, direct = (statistics.median(us[k]) for k in ("op", "direct"))
    log(f"[export] dispatch: kernel 1 on (1, 8, 8, 1), host time a call (median "
        f"of 5 x {calls}): through the op {op:.2f} us, its CUDA implementation "
        f"alone {direct:.2f} us, the op adds {op - direct:.2f} us; card {card}")


def phase_export(card: str, params) -> None:
    """Phase 29: serving export on the card: (a, b) swin_tiny bf16 bundles
    with and without the quality pipeline, from the card and from the CPU,
    served in a process without the model code; (c) efficientnet_b0 with
    dw_pallas_conv at bucket 32 (12 depthwise launches per forward); (d)
    int8 resnet50 at bucket INT8_FRAMES; (e) the front end on a bundle and
    the predict times."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    root = WORK / "export"
    root.mkdir(parents=True, exist_ok=True)
    ok = {}
    ok["swin_tiny"], engine = export_swin(card, params, root)
    rs = np.random.RandomState(292)
    frames = (rs.rand(BATCH, 512, 512, 1) * 65535).astype(np.float32)
    effnet = InferenceEngine(EFFNET_B0, variables=effnet_variables(EFFNET_B0),
                             buckets=(BATCH,))
    ok["efficientnet_b0"] = export_one(card, root, "efficientnet_b0", effnet, frames,
                                       {"depthwise": 12, "percentile": 1})
    del effnet
    resnet = InferenceEngine(RESNET50, variables=effnet_variables(RESNET50),
                             buckets=(INT8_FRAMES,), quantize="int8")
    ok["int8 resnet50"] = export_one(card, root, "int8_resnet50", resnet,
                                     frames[:INT8_FRAMES], {"percentile": 1})
    del resnet
    torch.cuda.empty_cache()
    ok["front end"] = export_front_end(card, root, engine)
    dispatch_cost(card)
    log(f"[export] checks {ok}; phase 29 {time.perf_counter() - t0:.1f} s")
    if not all(ok.values()):
        raise AssertionError(f"phase 29 checks failed: {ok}")


# phase 30: wide token training
SWIN_BASE_F32 = {"name": "swin_base", "in_channels": 1, "num_classes": 2,
                 "dtype": "f32", "drop_path_rate": 0.0}
SWIN_LARGE_F32 = dict(SWIN_BASE_F32, name="swin_large")
WIDE_BATCH = 8                 # rows 9-11 checked and timed at this batch
WIDE_STEP_BATCH = 2            # the full-width swin_base/large steps
CKPT_BATCH = 16                # the checkpointed swin_base step: activations dominate


def wide_token_shapes(batch: int):
    """{(T, C): (model, stage)} of swin_base's and swin_large's last two
    stages at 224², window 7: T = batch·14² at stage 3, batch·7² at 4."""
    return {(batch * 196, 512): ("swin_base", 3), (batch * 49, 1024): ("swin_base", 4),
            (batch * 196, 768): ("swin_large", 3), (batch * 49, 1536): ("swin_large", 4)}


def compare_wide(kernel: str, args, got, want, dtype):
    """compare_token, and for bf16 past C = 768 each sum over tokens of
    rows 10 and 11 that stands past DBIAS_RTOL held instead to the float64
    evaluation of the same roundings: no farther from it than 1.5 times the
    plain float32 version's own distance (a C-deep float32 contraction
    flips some bf16 roundings of the hidden layer in either order)."""
    from thyroid_tpu_torch.ops import token_fused as tf

    rows = compare_token(kernel, got, want, dtype)
    if dtype != torch.bfloat16 or args[0].shape[1] <= 768 or kernel == "ln_matmul_bwd":
        return rows
    exact = tf.ln_mlp_bwd_plain(*args, False, acc=torch.float64)
    exact = exact[:3] if kernel == "ln_mlp_bwd_dx" else exact[3:]
    out = []
    for (name, err, tol, ok), g, w, e in zip(rows, got, want, exact):
        if not ok and name in TOKEN_SUMS:
            own = (w.double() - e).abs().max().item()
            mine = (g.double() - e).abs().max().item()
            ok = mine <= 1.5 * own and bool(torch.isfinite(g).all())
            name = f"{name} (vs float64: {mine:.3e}, plain's own {own:.3e})"
        out.append((name, err, tol, ok))
    return out


def wide_counters():
    from thyroid_tpu_torch.ops import attention, token_fused as tf

    class Bwd:       # kernel 6's count lives beside kernel 5's
        @property
        def launches(self):
            return attention.fused_swin_attention.bwd_launches

        @launches.setter
        def launches(self, n):
            attention.fused_swin_attention.bwd_launches = n

    return {"ln_matmul": tf.fused_ln_matmul, "ln_mlp": tf.fused_ln_mlp,
            "swin_attention": attention.fused_swin_attention,
            "swin_attention_bwd": Bwd(), "ln_matmul_bwd": tf.fused_ln_matmul_bwd,
            "ln_mlp_bwd_dx": tf.fused_ln_mlp_bwd_dx, "ln_mlp_bwd_dw": tf.fused_ln_mlp_bwd_dw}


def wide_kernels(failed) -> None:
    """(a): rows 9-11 against their plain versions, two runs bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("ln_matmul_bwd", "ln_mlp_bwd_dx", "ln_mlp_bwd_dw"):
            for shape, (model, stage) in wide_token_shapes(WIDE_BATCH).items():
                args = make_token_inputs(kernel, shape, dtype, gen)
                fused, plain = token_fns(kernel)
                got, want = fused(*args), plain(*args)
                torch.cuda.synchronize()
                for name, err, tol, ok in compare_wide(kernel, args, got, want, dtype):
                    log(f"[wide-token] {kernel} {name} {str(dtype)[6:]} {shape} "
                        f"({model} stage {stage}): max_abs_err {err:.3e} tol "
                        f"{tol:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failed.append((kernel, name, str(dtype), shape))
                again = fused(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    log(f"[wide-token] {kernel} {str(dtype)[6:]} {shape}: a second "
                        f"run DIFFERS")
                    failed.append((kernel, "rerun", str(dtype), shape))
                del args, got, want, again
    torch.cuda.empty_cache()


def wide_steps(card: str, failed) -> None:
    """(b): swin_base and swin_large f32 steps with the flag against
    without, 24 launches per step; the bf16 steps' losses."""
    rs = np.random.RandomState(30)
    batch = ((rs.rand(WIDE_STEP_BATCH, 224, 224, 1) * 65535).astype(np.float32),
             rs.randint(0, 2, WIDE_STEP_BATCH).astype(np.int64),
             np.ones(WIDE_STEP_BATCH, np.float32))
    for config in (SWIN_BASE_F32, SWIN_LARGE_F32):
        name = config["name"]
        t0 = time.perf_counter()
        params = perturbed_params(config)
        off = step_loss_grads(config, params, batch)
        counts = wide_counters()
        for fn in counts.values():
            fn.launches = 0
        on = step_loss_grads(config, params, batch, token=True)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counts.items()}
        bf16_loss, _ = step_loss_grads(dict(config, dtype="bf16"), params, batch,
                                       token=True)
        loss_rel, grad_rel, norm = step_agreement(on, off)
        ok = (launches == {k: 24 for k in counts} and loss_rel <= STEP_LOSS_RTOL
              and grad_rel <= STEP_GRAD_RTOL and np.isfinite(bf16_loss)
              and abs(bf16_loss - on[0]) <= BF16_LOSS_TOL)
        log(f"[wide-token] {name} f32 step (batch {WIDE_STEP_BATCH}, drop path 0) "
            f"with train_token_kernels vs without on the card: loss {on[0]:.7f} vs "
            f"{off[0]:.7f} (relative {loss_rel:.3e}, tol {STEP_LOSS_RTOL:.0e}); "
            f"|grad diff| / |grad| {grad_rel:.3e} (tol {STEP_GRAD_RTOL:.0e}, "
            f"|grad| {norm:.4e}); launches {launches} (24 each expected); bf16 "
            f"step loss {bf16_loss:.7f} ({abs(bf16_loss - on[0]):.3e} from f32, "
            f"tol {BF16_LOSS_TOL:.0e}); {time.perf_counter() - t0:.1f} s; "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((name, "step"))
        if name == "swin_base":
            wide_checkpoint(card, config, params, failed)
        del params, off, on
        torch.cuda.empty_cache()


def wide_checkpoint(card: str, config, params, failed) -> None:
    """(d): the flagged swin_base f32 step at batch CKPT_BATCH with
    use_checkpoint against the same step without it (drop path 0.1, so
    that the recompute must draw the first run's masks), peak memories of
    both."""
    rs = np.random.RandomState(301)
    batch = ((rs.rand(CKPT_BATCH, 224, 224, 1) * 65535).astype(np.float32),
             rs.randint(0, 2, CKPT_BATCH).astype(np.int64),
             np.ones(CKPT_BATCH, np.float32))
    steps, peaks = {}, {}
    for ckpt in (False, True):
        cfg = dict(config, drop_path_rate=0.1, use_checkpoint=ckpt)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steps[ckpt] = step_loss_grads(cfg, params, batch, token=True)
        torch.cuda.synchronize()
        peaks[ckpt] = torch.cuda.max_memory_allocated() / 2 ** 20
    loss_rel, grad_rel, norm = step_agreement(steps[True], steps[False])
    equal = steps[True][0] == steps[False][0] and all(
        torch.equal(g, steps[False][1][n]) for n, g in steps[True][1].items())
    ok = loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL
    log(f"[wide-token] swin_base f32 step with train_token_kernels, drop path "
        f"0.1, batch {CKPT_BATCH}: use_checkpoint vs without: loss relative "
        f"{loss_rel:.3e}, |grad diff| / |grad| {grad_rel:.3e} (tols "
        f"{STEP_LOSS_RTOL:.0e}, {STEP_GRAD_RTOL:.0e}; bit-equal {equal}); peak "
        f"memory {peaks[False]:.0f} MiB without, {peaks[True]:.0f} MiB with; card "
        f"{card}; {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(("swin_base", "use_checkpoint"))


def wide_softmax_serve(failed) -> None:
    """(c): swin_tiny bf16 with use_pallas_attention false and
    attn_softmax_dtype bf16 served on the card against the CPU engine."""
    from thyroid_tpu_torch.serving.engine import InferenceEngine

    config = dict(SWIN_TINY, use_pallas_attention=False, attn_softmax_dtype="bf16")
    params = perturbed_params(SWIN_TINY)
    rs = np.random.RandomState(300)
    frames = (rs.rand(4, 512, 512, 1) * 65535).astype(np.float32)
    engine = InferenceEngine(config, params=params)
    for fn in all_counters().values():
        fn.launches = 0
    got = engine.predict(frames)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in all_counters().items() if fn.launches}
    want = InferenceEngine(config, params=params, device="cpu").predict(frames)
    err = float(np.abs(got - want).max())
    ok = err <= PROB_TOL[torch.bfloat16] and launches == {"percentile": 1}
    log(f"[wide-token] swin_tiny bf16, use_pallas_attention false, "
        f"attn_softmax_dtype bf16, N=4: card vs CPU engine probabilities "
        f"max_abs_err {err:.3e} (tol {PROB_TOL[torch.bfloat16]:.0e}); launches "
        f"{launches}; {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(("swin_tiny", "bf16 softmax serve"))
    del engine
    torch.cuda.empty_cache()


def wide_times(card: str) -> None:
    """(e): rows 9-11 at C = 1024 and 1536, bf16, batch 8: device time
    beside the bound and autograd's yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    dtype = torch.bfloat16
    for kernel in ("ln_matmul_bwd", "ln_mlp_bwd_dx", "ln_mlp_bwd_dw"):
        for shape, (model, stage) in wide_token_shapes(WIDE_BATCH).items():
            if shape[1] <= 768:
                continue
            args = make_token_inputs(kernel, shape, dtype, gen)
            fused, plain = token_fns(kernel)
            ms = device_ms(lambda: fused(*args))
            lib_ms = token_library_device_ms(kernel, args)
            plain_ms = median_ms(lambda: plain(*args), reps=5, warm=1)
            nbytes, ops, peak = token_work(kernel, shape, dtype)
            t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
            log(f"[wide-times] {kernel} bf16 {shape} ({model} stage {stage}): "
                f"kernel {ms:.4f} ms (device), plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms (device), bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}); card {card}")
            del args
    torch.cuda.empty_cache()


def phase_wide_token(card: str) -> None:
    """Phase 30: wide token training (see the module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    failed = []
    wide_kernels(failed)
    wide_steps(card, failed)
    wide_softmax_serve(failed)
    wide_times(card)
    log(f"[wide-token] phase 30 {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"phase 30 checks failed: {failed}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = phase_build()
    shapes = swin_tiny_shapes(BATCH)
    phase_kernels(shapes)
    params = perturbed_params(SWIN_TINY)
    engine, launches = phase_slice(params)
    entries = phase_times(shapes, engine, launches)
    phase_profile(engine)
    del engine
    torch.cuda.empty_cache()
    train_shapes = swin_tiny_train_shapes(BATCH)
    phase_train_kernels(train_shapes)
    try:
        train_launches, batch, card_step = phase_train_slice(params)
        entries += phase_train_times(train_shapes, train_launches, params)
        torch.cuda.empty_cache()
        frames = quality_frames()
        cases = quality_cases(frames)
        phase_quality_kernels(cases)
        q_engine, q_launches = phase_quality_slice(params, frames)
        entries += phase_quality_times(cases, q_launches, q_engine, params,
                                       frames)
        del q_engine, cases
        torch.cuda.empty_cache()
        token_shapes = token_train_shapes(BATCH)
        phase_token_kernels(token_shapes)
        token_launches = phase_token_slice(params, batch, card_step)
        entries += phase_token_times(token_shapes, token_launches, params)
        torch.cuda.empty_cache()
        from thyroid_tpu_torch.models.cnn.efficientnet import \
            stride1_depthwise_shapes
        dw_shapes = stride1_depthwise_shapes("efficientnet_b0", BATCH, 224)
        phase_dw_kernels({"efficientnet_b0": dw_shapes,
                          "efficientnet_b3": stride1_depthwise_shapes("efficientnet_b3", 8, 300)})
        variables = effnet_variables(EFFNET_B0)
        e_engine, e_launches = phase_effnet_slice(variables)
        entries += phase_effnet_times(dw_shapes, e_launches, e_engine, variables)
        del e_engine, variables
        torch.cuda.empty_cache()
        attn_shapes = shapes["swin_block_attention"]
        r_launches = phase_remaining_kernels(attn_shapes, frames)
        y_engine, y_cfg, y_params = phase_yaml_slice()
        phase_medical_slice()
        torch.cuda.empty_cache()
        phase_tensor_core()
        entries += phase_remaining_times(attn_shapes, r_launches, frames)
        phase_yaml_times(y_engine, y_cfg, y_params, params)
        del y_engine
        torch.cuda.empty_cache()
        phase_large_f32()
        torch.cuda.empty_cache()
        phase_experiment(card)
        torch.cuda.empty_cache()
        phase_aug_resnet(card)
        torch.cuda.empty_cache()
        phase_zoo(card)
        torch.cuda.empty_cache()
        phase_distill(card)
        torch.cuda.empty_cache()
        phase_analysis(card)
        torch.cuda.empty_cache()
        phase_serving(card, params)
        torch.cuda.empty_cache()
        phase_export(card, params)
        torch.cuda.empty_cache()
        phase_wide_token(card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(export_child(sys.argv[2:]) if sys.argv[1:2] == ["--export-child"]
             else main())
