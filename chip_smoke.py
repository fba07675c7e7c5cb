#!/usr/bin/env python3
"""Drive fac_fake_torch on one NVIDIA H100: build the hand-written kernels,
hold each against its plain PyTorch version, score videos end to end with the
full-width base CViT and the flagship cvit_repbn8 in fp32 and under int8
post-training quantization, score S3D clips, train both CViTs at full width,
detect with MTCNN and serve, score videos with the ResNet/KAN resvitkan, train
the S3D family from its plans and score the msca family, and print what it
measured.

    python3 chip_smoke.py [--seed N] [--profile]     # all phases, one card

``--profile`` adds a torch.profiler breakdown, by kernel, of one fp32 and
one int8_full CViT forward at batch 96 to phase 9 and to F3 (the flagship),
of one fp32 and one int8 S3D `predict_batch` at batch 32 to phase 13, and of
one train step and one eval step of each CViT at batch 32 to T2 and T4;
the int8 breakdowns must name K4's and K5's `wgmma` kernels (`dense_wgmma`,
`conv_wgmma`, which K3 runs on too), their quantize pass
(`qwg::quantize_rows`) and K2's `normalize_table`, the S3D one K6's
`max_pool3d_i8_sep`, and the CViTs' no `qmma::` kernel; the train steps
K7's `clahe_subset` (traced in every run, for the device's busy share), the
eval steps K2's `normalize_table`, and of one S3D train step of each plan of
S3 (traced in every run; plan1_2's must name K10's `jpeg_bands`).

Phases, in order (any failure exits non-zero; no phase's exception is caught):
  1. environment: require CUDA, print the card's name and power limit, turn
     TF32 off for matmul and cuDNN;
  2. build the ten kernels (K1-K10; K3 and K5 are one kernel, nine sources;
     K7 one kernel, the whole CLAHE subset step in one launch) from
     fac_fake_torch/csrc, in parallel;
  3. K2 (`k2_phase`) in its five modes against their plain versions: the
     normalize to fp32 and bf16 (within K2_TOL), the CViT walk's int8 entry
     of both (bit-equal to the normalize and quantize pass it replaces) at
     (96|256, 224, 224, 3), and the raw int8 entry of S3D's stem at
     (32, 20, 224, 224, 3) (bit-equal to the cast and quantize pass); each
     on an image of every byte in every channel too; timed cold (launches
     rotating over buffers beyond the L2) and warm, beside a yardstick of
     the same bytes (the u8 cast for the fp modes, copy_ of the output's
     bytes for the int8 ones) and the bound;
  4. K1 (frame detections) against its plain version on real BlazeFace dets
     of seeded 1920x1080 frames and on planted dets (F=16, T=3: clusters,
     exact score ties, a zero-area box), timed on the planted chunk
     (`k1_phase`);
  5. main path: `VideoScorer` with the full-width `cvit` (seeded weights) and
     the packaged BlazeFace over an in-memory reader of seeded 1080p noise
     frames, most videos with a synthetic face the detector finds (made by
     gradient ascent on BlazeFace, `synth_face`):
     `score_videos_batched` over 8 videos, `score_video` over 1, then 29
     seeded crops through `score_crops` and 8 x 29 through
     `score_crop_stacks`; launch counts of K1 and K2 must both be > 0;
  6. full-width logits on the card against the same module on the CPU;
  7. K3 (int8 3x3 conv) against its plain versions at each distinct conv of
     the quantized base stem at batch 96, fp32 and bf16 (bit-equal): as
     JAX's layer and as the stem's int8 walk runs it (ReLU, and the next
     conv's quantize, in the epilogue); timed as the walk runs the 17 convs
     of one forward (its input from K2's int8 entry), the bound counted with
     and without the fused edges, torch._int_mm beside the deep convs;
  8. K4 (int8 dense) against its plain version at the 26 denses of one
     int8_full forward at batch 96 (bit-equal), each timed beside
     torch._int_mm on the same int8 operands (the GEMM alone);
  9. int8 main path: `VideoScorer` with infer.quantize="int8_full" (it
     calibrates on its first batch) runs `score_videos_batched` over the 8
     videos, `score_video`, `score_crops` and `score_crop_stacks`; launch
     counts of K1-K4 must all be > 0 and K3's whole walks; then
     infer.quantize="int8" through `score_crops` and `score_crop_stacks`;
     in each mode one forward from the uint8 crops at batch 96 must run the
     stem's planned walk (K2's int8 entry, no K2 fp launch, 17 K3 launches,
     0 quantize passes, no fp ReLU, 1 fp pool; 26 K4 launches under
     int8_full), and under int8_full every K3 call of one such forward, and
     its K2 int8 entry, is held bit-equal to its plain version on the real
     crops and activations; int8 vs fp32 logits for information;
 10. full-width int8_full logits on the card against the same quantized
     module on the CPU (plain versions);
 F1-F4. the flagship cvit_repbn8 at its published widths (seeded weights,
     each DEConv at He scale): F1 its fp32 path as phase 5 runs the base's;
     F2 its fp32 logits card vs CPU; F3 int8_full and int8 as phase 9, one
     forward from the crops running FLAGSHIP_INT8_WALK (1 K2 int8 entry, 18
     K3 launches over its two stems, 16 fused, one of them the 56^2 conv ->
     deconv edge with no ReLU, 1 quantize pass for stem 2's fp input, 3
     int8 and 2 fp pools; 26 K4 under int8_full), every K3 call of an
     int8_full forward held bit-equal, and K3 at every distinct conv of the
     flagship's walk (timed as one forward's 18 convs and its quantize pass);
     F4 its int8_full logits card vs CPU;
 11. S3D fp32 main path: `S3DEvaluator` with the full-width `ca_s3d` (seeded
     weights, one logit, 20 x 224^2 clips): `predict_batch` on 32 seeded
     uint8 clips (clips/s), `predict_video` on one clip (no degradation: the
     card's machine has no cv2), `evaluate` over an in-memory dataset;
 12. K5 (quantize + int8 3D conv) against its plain versions at every
     conv and quantize of one ca_s3d int8 forward from uint8 clips (77
     convs, 39 of them quantizing their output for the next conv, 10
     quantize passes, 1 K2 raw entry for the stem conv's input, 9 pools:
     asserted), the shapes recorded from the wrapper calls, at
     batches 2 and 32, fp32 and bf16 (bit-equal; a fused conv against
     quantize_pad_plain(int8_conv3d_plain(...))); timed over the calls of a
     forward at batch 32, beside torch._int_mm on the 1x1x1 convs'
     pre-quantized operands; the bound counted with and without the fused
     epilogue (`k5_phase`). K6 (int8 max-pool) at the 9 pools of the spec
     (`s3d_pool_shapes`, which the recorded pools must equal), at batches 2
     and 32 (bit-equal), timed at batch 32 cold (its launches rotating over
     buffers beyond the L2) and warm (`k6_phase`);
 13. S3D int8 main path: `S3DEvaluator(quantize="int8")` (its first batch
     calibrates), then `predict_batch` at batch 32 (clips/s),
     `predict_video` and `evaluate`; K5 and K6 must launch; int8 vs fp32
     logits for information; the launches are whole forwards of 77 convs,
     10 quantize passes, 1 K2 raw entry and 9 pools; then one more int8
     forward at batch 32 in which every K5 and K6 call, fused ones
     included, and the K2 raw entry are held bit-equal to their plain
     versions on the same real clips and activations;
 14. full-width ca_s3d on the card against the same module on the CPU,
     fp32 and int8 (plain versions; int8 from the uint8 clip), batch 1: the
     logits, and the head's input features (int8: against the
     int8-vs-fp32 difference);
 T1. K7 (the strong_aug chain's CLAHE step) against its plain versions,
     bit-equal: `clahe_luma` at (8|32, 224, 224, 3) on seeded images, a flat
     image, an image of every byte and two grid-1 images; the in-place
     `clahe_subset_` at the trainer's 32 images with 8 takers and a budget
     of 8, over budget, at a budget of n, at grid 1 and on a flat image,
     untaken images unchanged; timed cold and warm at (8, 224, 224, 3) all
     taken and at the trainer's step (32 images, 8 taken), each beside its
     plain version, copy_ of the same bytes and its bound (`k7_phase`); the
     strong_aug chain, `augment_batch` at (32, 224, 224, 3) uint8, timed,
     with a digest of seeded outputs (`augment_phase`);
 T2. base cvit training at full width (`train_phase`): seeded weights, 256
     seeded crops (the synthetic face on those of label 1) cached on the
     card, batch 32, the default strong_aug chain and plateau schedule:
     train crops/s and ms a step after a warm-up step, the device's busy
     share over one traced step, peak memory; `fit` for one epoch (7 steps)
     and an eval pass, with periodic and best checkpoints: finite losses, 1
     K7 call a train step and 1 K2 fp32 launch an eval batch; 10 steps on a
     fixed batch with the augmentation off: the loss falls;
 T3. one base cvit train step at full width, batch 2, card (TF32 off) vs
     CPU from the same weights: the loss, each parameter's gradient, the
     BatchNorm running stats and the parameters after the Adam step, within
     the TRAIN_* bounds it prints (`train_vs_cpu`);
 T4. the flagship cvit_repbn8 as T2 and T3; LinearNorm's iter must fall by
     the number of training forwards and no warm go below 0;
 M1. K8 (MTCNN's greedy NMS) against its plain version, bit-equal in every
     idx and keep slot, on the real candidate sets of one `MTCNN.run` on a
     seeded 1920x1080 frame at thresholds (0.6, 0.7, 0.7) and (0, 0, 0) (the
     cascade's 4 calls a frame, recorded at the wrapper: 12 pyramid calls of
     128 -> 128 in one launch, 1536 -> 64, 64 -> 64, 64 -> 32 min) and on
     planted cases (exact ties, NaN score and box, zero-area and inverted
     boxes, none valid, max_out above the live count, min mode, max_out 0;
     at the edges of K8's 32-candidate tiles: 31, 32 and 33 live, 1024 live
     with max_out 4, NaN scores and ties across a tile boundary, one box
     that suppresses all, exactly max_out survivors, a G-batched call with
     one call of no live candidate and one all live); the frame's 4 launches
     timed cold and warm beside the plain version, the bound and the launch
     floor (4 empty kernels) (`k8_phase`);
 M2. the MTCNN video path: `VideoScorer` with the full-width base `cvit`
     (seeded) and infer.detector="mtcnn" (the seeded MTCNN it builds on the
     card) over the 9 in-memory videos, at (0.6, 0.7, 0.7) and at (0, 0, 0):
     `score_videos_batched` over 8, `score_video` over 1; K8 launched 4 times
     a detected frame; at (0, 0, 0) crops come out and K2 launches; then one
     frame card vs CPU: every net call, every stage patch and every K8 call
     on the same inputs (`mtcnn_path`, `mtcnn_vs_cpu`);
 M3. `cli/serve.serve` on loopback with M2's scorer: /health, /score?path=
     for 3 videos equal to `score_video`, a 400 and a 404 (`serve_phase`);
 R1. K9 (KAN's B-spline bases) against its plain version, bit-equal (NaN
     where both are NaN) in fp32 and bf16 at the family's call shapes
     (K9_SHAPES: resvitkan's head at capacity 96 and 8 x 32 rows, reskan's at
     batch 96) on the default grid, a sorted perturbation of it, one with a
     repeated knot, a knot at +-0, swapped knots, non-finite knots and knots
     1e-30 apart (K9_GRIDS), x planted on every knot, below the first, at and
     past the last, at +-0, and on each grid at +-1e38, +-inf and NaN; one
     resvitkan forward's 2 launches timed cold and warm beside the plain
     version, copy_ of the outputs' bytes and the bound (`k9_phase`); a
     grad-tracked input raises (K9 has no backward);
 R2. the resvitkan video path (`resvitkan_path`): `VideoScorer` with the
     full-width resvitkan (vendored ResNet-50 with the 512 squeeze, patch 7,
     dim 1024, depth 6, heads 8, mlp 2048, KAN (2048, 64, 2); seeded) and the
     packaged BlazeFace over the same videos as phase 5; K2 launches equal
     the base path's, K9 twice that; one forward from the crops runs 1 K2
     and 2 K9 launches; logits card vs CPU at batch 4; `score_crops` equal
     to `score_crop_stacks` per video; a bf16 run with finite scores; the
     `Trainer` refuses the model (K9 has no backward);
 R3. the full-width reskan at batch 96 and resvit at batch 4, logits card vs
     CPU, K9 launched 2 and 0 times a forward (`family_forwards`);
 S1. K10 (the S3D transform's JPEG step, in place on the taken frames)
     against its plain version (`k10_phase`), bit for bit: its division
     against IEEE's over every float and divisor 1..255; seeded noise and
     smooth frames, a flat and an every-byte frame, qualities 1, 50, 60, 99,
     100 and the trainer's floor(U[60, 100)), takes none, all and a seeded
     ~20%; the grid's geometries (only the last frame taken, one frame, all
     360 frames of plan1_2's step, frames wider than a chunk and narrower
     than one, a ragged last chunk); untaken frames bit-unchanged; timed cold
     and warm at plan1_2's (360, 224, 224, 3) with 72 taken beside copy_ of
     those frames' bytes, the plain version and the bound;
 S2. the S3D transform, `augment_batch` under plan1_2's augment config on
     (12, 30, 224, 224, 3) uint8 clips: one K10 launch a call, finite output
     in [0, 1], a digest, timed on the card and by the host (`s3d_augment_phase`);
 S3. S3D training from the plans at their published batches and frames,
     clips cached on the card (`s3d_train_phase`): s3d from plan1_2 (bs 12,
     30 frames, the transform on: K10 once a step), ca_s3d from caplan9 (bs
     9, black masking of 6 regions on synth_face frames, the landmarks from
     the port's BlazeFace), msca_s3d from mplan1 (bs 6): train clips/s, ms a
     step, busy share, peak memory, K10 launches a step, `fit` for one
     epoch, 10 fixed-batch steps whose loss falls, one eval batch;
 S4. one train step of ca_s3d and msca_s3d card vs CPU at full width,
     batch 2, 16 frames: the loss, the gradient and the running stats held
     to a float64 step (`s3d_train_vs_cpu`);
 S5. `S3DEvaluator` with the full-width msca_s3d and msca_s3d_srm in fp32
     and int8 (`msca_scoring`, `msca_int8`): clips/s at batch 32 beside
     ca_s3d's fp32; the int8 path's launches (22 K5 convs a forward, 20 with
     ReLU6 in the epilogue, 2 K6 pools, 4 quantize passes and K2's raw entry,
     or 5 passes behind the residual SRM) against `S3DInt8.walk_counts`;
     every K5/K6 call of one int8 forward bit-equal to its plain version;
     int8 vs fp32 logits (information); fp32 and int8 logits and head input
     card vs CPU at batch 1 (phase 14's rule);
 15. the training line and the kernels line; 16. the result line.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# kernel checks: stated tolerances against the plain PyTorch version
K2_TOL = {"float32": 1e-6, "bfloat16": 1.6e-2}   # bf16: one ulp in [2, 4)
K1_RTOL, K1_ATOL = 1e-5, 1e-3                      # pixels; mask must be equal
LOGIT_TOL = 1e-3                                   # PARITY.md logit bar
# K3, K4: bit-equal (exact int32 sums; quantize and epilogue are the same
# IEEE fp32 operations in both, built with -fmad=false), fp32 and bf16 out
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM
FP32_FLOPS = 67e12                                 # H100 SXM, outside tensor cores
INT8_TC_OPS = 1979e12                              # H100 SXM, dense int8 tensor cores
SLEEP_CYCLES = 100_000_000                         # ~50 ms at the H100's 1.98 GHz boost

QBATCH = 96                                        # crops a batch (batch_crops)
# (H, Cin, Cout) of the folded base stem's 17 convs -> how many there are
STEM_CONVS = {(224, 3, 32): 1, (224, 32, 32): 2, (112, 32, 64): 1, (112, 64, 64): 2,
              (56, 64, 128): 1, (56, 128, 128): 2, (28, 128, 256): 1, (28, 256, 256): 3,
              (14, 256, 512): 1, (14, 512, 512): 3}
# (rows, out, in, bias) of the 26 int8_full denses at batch 96 -> how many:
# patch embedding, to_qkv, to_out, FFN fc1, fc2 (two tokens a crop), head fc1
INT8_DENSES = {(96, 1024, 25088, True): 1, (192, 3072, 1024, False): 6,
               (192, 1024, 1024, True): 6, (192, 2048, 1024, True): 6,
               (192, 1024, 2048, True): 6, (96, 2048, 1024, True): 1}
# one forward from uint8 crops through the quantized base stem's int8 walk:
# K2's int8 entry (no K2 fp launch), 17 K3 launches (16 quantizing for the
# next conv), 0 quantize passes, no fp ReLU, 4 int8 pools and 1 fp max-pool
CVIT_INT8_WALK = {"convs": 17, "fused": 16, "no_relu_fused": 0, "quantize": 0, "k2_int8": 1,
                  "k2_fp": 0, "int8_pools": 4, "fp_pools": 1, "fp_relus": 0}
# the same for the flagship cvit_repbn8's two quantized stems: 18 K3 launches
# (14 + 4), 16 quantizing for the next conv, one of them with no ReLU between
# (the 56^2 conv -> deconv), 1 quantize pass (stem 2's fp input), 3 int8
# pools, 2 fp pools
FLAGSHIP_INT8_WALK = {"convs": 18, "fused": 16, "no_relu_fused": 1, "quantize": 1,
                      "k2_int8": 1, "k2_fp": 0, "int8_pools": 3, "fp_pools": 2, "fp_relus": 0}
# what forward_counts and check_k3_calls read of a walk
FORWARD_KEYS = ("convs", "quantize", "k2_int8", "k2_fp", "int8_pools", "fp_pools", "fp_relus")
CHECKED_KEYS = ("convs", "fused", "no_relu_fused", "quantize", "k2_int8")
S3D_BATCH = 32                                     # clips a predict_batch
S3D_CHECK_BATCH = 2                                # clips a K5/K6 bit-equality check
S3D_T, S3D_HW = 20, 224                            # frames, pixels (ca_s3d's input)
# K5, K6 and K2 calls of one ca_s3d int8 forward from uint8 clips: 77 convs,
# 39 of which quantize their output for the next conv, 10 quantize passes, 1
# K2 raw entry (the stem conv's input), 9 int8 pools
S3D_INT8_CALLS = {"conv": 77, "fused": 39, "quantize": 10, "raw": 1, "pool": 9}
L2_BYTES = 50e6                                    # H100 L2: K2, K6 timed cold beyond it
K2_CROP_BATCHES = (96, 256)                        # K2's CViT modes: batch_crops, and 256
# ca_s3d's head input (the pooled last mix), card vs CPU, by error norm: fp32
# over the features' norm; int8 over the CPU's int8-vs-fp32 difference, since
# the int8 walk turns a rounding difference in its fp layers (the ctx blocks)
# into quantization steps that flip, and those spread as int8 noise does
S3D_FP32_FEATURE_RTOL = 1e-5
S3D_INT8_FEATURE_RATIO = 1.0
# S5's int8 walk card vs CPU in lock-step (`int8_lockstep`): each fp step's
# output (an iFormer, MSCAN-half or context block, the residual SRM) card vs
# CPU over its largest value, the fp32 layers' rounding (TF32 off)
S3D_FP_BLOCK_RTOL = 1e-4
# training (T1-T4)
K7_BATCHES = (8, 32)          # K7: the trainer's CLAHE subset at batch 32, and a whole batch
# K7's in-place subset entry: name -> ((N, H, W, 3), seeded takers, budget)
K7_SUBSETS = {"trainer": ((32, 224, 224, 3), 8, 8), "over budget": ((32, 224, 224, 3), 12, 8),
              "budget n": ((32, 224, 224, 3), 13, 32), "grid 1": ((16, 120, 120, 3), 5, 8),
              "flat": ((16, 224, 224, 3), 6, 8),
              "streamed": ((4, 448, 448, 3), 3, 4)}  # bands beyond shared memory: read twice
K7_TRAIN_TAKERS = 8           # timed: the trainer's step with its budget of 8 full
AUGMENT_DIGEST_SEEDS = 4      # augment_phase: generator seeds whose outputs are digested
AUGMENT_TIMED_CALLS = 4       # augment_phase: calls timed
K7_OPS_PER_PIXEL = 57         # the plain version's fp32 operations a pixel (luma, blend, RGB)
TRAIN_BATCH = 32              # data.batch_size, JAX's default
TRAIN_HW = 224                # the crops' side (data.image_size)
TRAIN_CROPS = 256             # seeded crops cached on the card: 224 train (7 steps), 32 val
TRAIN_TIMED_STEPS = 10        # timed train steps after a warm-up step
TRAIN_FIXED_STEPS = 10        # steps on one fixed batch, augmentation off: the loss falls
TRAIN_CHECK_BATCH = 2         # T3/T4: one train step card vs CPU
# one train step at full width, card (TF32 off) vs CPU, from the same weights,
# the CPU's max-pools routed as the card's (`train_vs_cpu`). The fp32
# gradient of these nets at full width is far from exact on either device:
# measured on an H100 (seeded and trained weights, batch 2; PERF.md §6),
# each device's is 0.07-1.4% (relative L2) off the float64 gradient, and the
# card's and the CPU's 0.18-1.2% apart, worst tensor 1.8%. So the gradient
# is held to the float64 one: the card's within three times the CPU fp32's
# distance to it, plus 1e-3; card vs CPU directly within the sanity bounds
# below. Also: the loss; the BatchNorm running stats and LinearNorm's
# counters; the parameters after the Adam step where |g| > 1e-5 and the two
# gradients agree within 10% (Adam's first step is about ±lr there, whatever
# the gradient's rounding); a tensor whose float64 gradient is zero but for
# rounding (a conv bias before a BatchNorm) is under 1e-4 of the whole norm
# on both devices
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_F64_RATIO, TRAIN_GRAD_F64_SLACK = 3.0, 1e-3
TRAIN_GRAD_RTOL = 5e-2
TRAIN_GRAD_TENSOR_RTOL = 2e-1
TRAIN_STATS_RTOL, TRAIN_STATS_ATOL = 1e-3, 1e-5
TRAIN_PARAM_ATOL = 1e-6
# MTCNN (M1-M3)
MTCNN_HW = (1080, 1920)                            # the reader's frames: 12 pyramid scales
MTCNN_THRESHOLDS = ((0.6, 0.7, 0.7), (0.0, 0.0, 0.0))   # the predict preset; every slot live
K8_OPS_PER_IOU = 16           # fp32 operations an IoU test and its suppression
K8_COLD_SLEEP_CYCLES = 8 * SLEEP_CYCLES   # ahead of the cold run's 800 launches
# K8's cold run times 200 frames (800 launches) of a turn over ~1250 copies:
# a whole turn enqueues ~5000 launches, more than the host keeps ahead of the
# card once a frame takes less card time than its four Python calls
K8_COLD_FRAMES = 200
# card vs CPU on one frame, the same inputs: each net's outputs (fp32 convs,
# TF32 off; a different summation order), the stage patches on the 0-255
# scale (the same gathers and IEEE products on both)
MTCNN_NET_TOL = 1e-4
MTCNN_PATCH_TOL = 1e-3
SERVE_PROB_TOL = 1e-6         # /score against score_video: the same computation twice
MTCNN_ALONE_CALLS = 5         # M2: one frame's detect timed alone, after each run's counts
# the ResNet/KAN family (R1-R3)
KAN_MODELS = ("resvitkan",)   # scored models with a KAN head: K9 twice a forward
K9_ORDER, K9_GRID_SIZE = 3, 5     # every KAN head's spline order and grid size
# (B, in) of K9's calls on the paths: resvitkan's head at capacity 96 and at
# 8 x 32 rows (2048 -> 64 -> 2), reskan's at batch 96 (512 -> 64 -> 2)
K9_SHAPES = ((96, 2048), (96, 64), (256, 2048), (256, 64), (96, 512))
K9_GRIDS = ("default", "nonuniform", "repeated", "zero_knot", "swapped", "nonfinite", "tiny")
K9_NAN_GRIDS = ("repeated", "nonfinite")   # the full recursion's 0/0 and inf - inf
# fp32 operations of K9's function a (row, feature): order 0, two compares
# and an and on each of the 11 intervals; a level, x - g, g' - x, two
# divisions, two products and a sum on each of its 10, 9, 8 bases
K9_OPS_PER_FEATURE = 3 * 11 + 7 * (10 + 9 + 8)
RESVIT_HW = 224               # the family's crops (data.image_size)
RESKAN_BATCH, RESVIT_BATCH = 96, 4    # R3: forwards card vs CPU
STACK_TOL = 1e-6              # R2: score_crops against score_crop_stacks, per video
# S3D training (S1-S5)
K10_QUALITIES = (1, 50, 60, 99, 100)
K10_FRAMES, K10_TAKEN = 360, 72   # plan1_2's 12 x 30 frames; ImageCompression's p .2
# S1's geometries of K10's grid: (shape, take) on seeded noise at seeded qualities
K10_GEOMETRIES = (((6, 224, 224, 3), "last"), ((1, 224, 224, 3), "all"),
                  ((K10_FRAMES, 224, 224, 3), "all"), ((3, 64, 1920, 3), "all"),
                  ((5, 48, 80, 3), "seeded"), ((2, 32, 272, 3), "all"))
S3D_PLANS = (("s3d", "configs/plan1_2.yaml"), ("ca_s3d", "configs/caplan9.yaml"),
             ("msca_s3d", "configs/mplan1.yaml"))
S3D_TIMED_STEPS = 3           # S3: timed train steps after a warm-up step
S3D_FIT_STEPS = 2             # S3: fit's epoch, in steps (and one eval batch)
S3D_FIXED_STEPS = 10          # S3: steps on one fixed batch, augmentation off: the loss falls
S3D_CHECK_BATCH, S3D_CHECK_T = 2, 16   # S4: 16 frames, the fewest the S3D head takes
S3D_LOSS_RTOL = 1e-4          # S4: loss card vs CPU
# S4: each running-stat tensor card vs CPU, elementwise |card - cpu| <= rtol |cpu| + atol
# (atol for running means that are zero but for rounding: at rtol 3e-4 the means
# needed 1.4e-8 to 1.6e-7 over three seeds on an H100, the variances none); and
# the slack of its float64 rule
S3D_STATS_RTOL, S3D_STATS_ATOL = 3e-4, 5e-7
S3D_STATS_F64_SLACK = 1e-5
S3D_MSCA_T = 30               # S5: the plans' frames
MSCA_INT8 = ("msca_s3d", "msca_s3d_srm")   # S5: scored in int8 too
S3D_TRAIN_HW = 224            # S3-S5: the plans' image-size


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, sleep_cycles: int = SLEEP_CYCLES,
            device_bound: bool = False) -> float:
    """Device ms a call of ``fn``: CUDA events around ``iters`` calls that
    are queued behind a ~50 ms sleep kernel, so that the host has enqueued
    them all before the first runs and the events time the card, not the
    host's launch overhead (which exceeds the device time of a small
    kernel). A call that synchronizes falls back to timing both. With
    ``device_bound``, fails if the host took longer to enqueue the calls
    than the sleep lasted: the card then waited on the host (or on the
    driver's launch queue, full), and the events would time the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    asleep = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    asleep.record()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    slept = asleep.elapsed_time(start)
    if device_bound and host_ms >= slept:
        raise AssertionError(f"timing paced by the host: {iters} calls took {host_ms:.1f} ms "
                             f"to enqueue, the sleep ahead of them {slept:.1f} ms")
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, rate: float = FP32_FLOPS) -> tuple:
    """The larger of bytes over the memory rate and operations over
    ``rate``, in ms, and which of the two it is."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def quant_inputs(rng, dev, x_shape, n_out, k_in, x_scale=0.0625):
    """fp32 activations (an eighth of them exact .5 quantization ties),
    int8 weights (n_out, k_in), per-channel scales, bias, 0-d x_scale."""
    import torch
    x = rng.standard_normal(x_shape, dtype=np.float32) * 3.0
    ties = rng.random(x_shape, dtype=np.float32) < 0.125
    x[ties] = (rng.integers(-200, 200, int(ties.sum())) + 0.5) * x_scale
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(x), t(rng.integers(-127, 128, (n_out, k_in), dtype=np.int8)),
            t(rng.uniform(0.001, 0.05, n_out).astype(np.float32)),
            torch.tensor(x_scale, device=dev), t(rng.standard_normal(n_out, dtype=np.float32)))


def int8_image(rng, dev, shape, c):
    """int8 values of a quantized activation, zero in the padded channels."""
    import torch
    xq = rng.integers(-127, 128, shape, dtype=np.int8)
    xq[..., c:] = 0
    return torch.from_numpy(xq).to(dev)


def digest(t) -> float:
    """A tensor's bytes as a number (48 bits of their SHA-256, exact in a
    float): equal outputs give equal digests across processes and trees."""
    import hashlib

    import torch
    data = t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return float(int.from_bytes(hashlib.sha256(data).digest()[:6], "little"))


def rotated_ms(fn, xs, sleep_cycles: int = SLEEP_CYCLES, iters: int = 0, **kw) -> float:
    """Device ms a call of ``fn`` on inputs that rotate over ``xs``, each
    call's output kept until its input comes round again: with ``xs`` and
    their outputs beyond twice the L2, every call reads its input from
    device memory (cold). ``iters`` timed calls (default: a whole turn, at
    least 20), after a whole turn of warm-up."""
    import itertools
    turn = itertools.count()
    keep = [None] * len(xs)

    def cold():
        i = next(turn) % len(xs)
        keep[i] = fn(xs[i])

    return cuda_ms(cold, iters=iters or max(20, len(xs)), warmup=len(xs) + 2,
                   sleep_cycles=sleep_cycles, **kw)


def k2_phase(rng, dev) -> dict:
    """K2 in its five modes against their plain versions: the normalize to
    fp32 and bf16 (within K2_TOL), the CViT walk's int8 entry of each
    (``int8_fp32``, ``int8_bf16``: bit-equal to the normalize and then the
    quantize pass, `quantize_pad_plain`) at (B, 224, 224, 3) for B in
    K2_CROP_BATCHES, and S3D's raw int8 entry (``raw``: bit-equal to the
    cast and the quantize pass) at (S3D_BATCH, S3D_T, S3D_HW, S3D_HW, 3);
    each also on an image of every byte value in every channel, at scales
    that clip and tie. The int8 scales are the calibrated ones (the input's
    max / 127).

    Timed cold (``ms``: launches rotating over inputs and outputs beyond
    twice the L2, as `k6_phase` times K6) and warm (one input again and
    again), beside a yardstick of the same bytes, cold: the fp modes beside
    the cast of the uint8 input (``copy_`` into a tensor of the output
    dtype, the kernel ``u8.to(dtype)`` runs), the int8 modes beside
    ``copy_`` of their output's bytes. The bound counts each value at its
    real channels, read once and written once (3 bytes a pixel in; 12, 6 or
    3 out: the int8 modes' zero fourth channel is padding, not work the
    function needs, as K5 and K6 count it; the scale), and 3 fp32
    operations a value for the normalize, 7 with the quantize, 4 for the raw
    quantize.

    Returns the totals of the fp32 mode at batch 96 (``ms``: what the fp32
    main path runs) and, for each mode and batch, its numbers (``modes``,
    and flat ``{mode}_{batch}_{what}`` keys for `utils/kernel_pairs.py`),
    with the digest of its output on the seeded input."""
    import torch
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3
    dts = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8_fp32": torch.float32,
           "int8_bf16": torch.bfloat16}

    def fns(mode, s):
        """(kernel, plain) of a mode: x (uint8) -> the output"""
        dt = dts.get(mode)
        if mode in ("fp32", "bf16"):
            return (lambda x: pp.normalize_imagenet(x, dt),
                    lambda x: pp.normalize_imagenet_plain(x, dt))
        if mode == "raw":
            return (lambda x: pp.quantize_clips(x, s),
                    lambda x: q3.quantize_pad_plain(x.float(), s))
        return (lambda x: pp.quantize_crops(x, s, dt),
                lambda x: q3.quantize_pad_plain(
                    pp.normalize_imagenet_plain(x, dt).permute(0, 2, 3, 1), s))

    def check(mode, got, ref, what):
        if mode in ("fp32", "bf16"):
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"K2 {mode} {what}: output is not channels_last")
            err = float((got.float() - ref.float()).abs().max())
            if err > K2_TOL[str(got.dtype).split(".")[1]]:
                raise AssertionError(f"K2 {mode} {what}: max abs err {err} > {K2_TOL}")
            return err
        if got.dtype != torch.int8 or not torch.equal(got, ref):
            raise AssertionError(f"K2 {mode} {what}: differs from plain, max abs "
                                 f"{float((got.float() - ref.float()).abs().max())}")
        return 0.0

    b = np.arange(256)
    every = torch.from_numpy(np.stack([b, (b + 85) % 256, (b + 170) % 256], -1)
                             .astype(np.uint8).reshape(1, 16, 16, 3)).to(dev)
    res = {"err": 0.0, "bit_equal": True, "modes": {}}
    cases = [(m, bb) for bb in K2_CROP_BATCHES for m in ("fp32", "bf16", "int8_fp32",
                                                         "int8_bf16")]
    cases.append(("raw", S3D_BATCH))
    for mode, batch in cases:
        shape = ((batch, S3D_T, S3D_HW, S3D_HW, 3) if mode == "raw" else (batch, 224, 224, 3))
        u8 = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        if mode == "raw":
            s = (u8.amax().float() / 127.0).reshape(())
        else:
            s = (pp.normalize_imagenet_plain(u8).abs().amax() / 127.0).reshape(())
        kern, plain = fns(mode, s)
        for scale in (0.011131090112030506, 2.0 ** -6, 2.0):   # clips, ties (fp32, bf16, raw)
            k_e, p_e = fns(mode, torch.tensor(scale, device=dev))
            x = every if mode != "raw" else every[None]
            check(mode, k_e(x), p_e(x), f"every byte, scale {scale}")
        got, ref = kern(u8), plain(u8)
        torch.cuda.synchronize()
        err = check(mode, got, ref, f"{tuple(shape)}")
        res["err"] = max(res["err"], err)
        res["bit_equal"] &= bool(torch.equal(got, ref))
        out_bytes = got.numel() * got.element_size()
        dig = digest(got)
        del got, ref
        n_rot = int(2 * L2_BYTES // (u8.numel() + out_bytes)) + 2
        xs = [u8] + [u8.clone() for _ in range(n_rot - 1)]
        k_ms = rotated_ms(kern, xs)
        w_ms = cuda_ms(lambda: kern(u8))
        if mode in ("fp32", "bf16"):
            sinks = [torch.empty(shape, dtype=dts[mode], device=dev) for _ in xs]
            pairs = list(zip(sinks, xs))
        else:
            srcs = [kern(x) for x in xs]
            pairs = list(zip([torch.empty_like(y) for y in srcs], srcs))
        y_ms = rotated_ms(lambda pair: pair[0].copy_(pair[1]), pairs)
        del pairs
        p_ms = cuda_ms(lambda: plain(u8), iters=3, warmup=1)
        per_value = {"fp32": 3, "bf16": 3, "raw": 4}.get(mode, 7)
        nbytes = u8.numel() + (out_bytes if mode in ("fp32", "bf16") else u8.numel()) + 4
        bms, by = bound_ms(nbytes, per_value * u8.numel())
        row = dict(ms=k_ms, warm_ms=w_ms, yardstick_ms=y_ms, plain_ms=p_ms, bound_ms=bms,
                   bound_by=by, bytes=float(nbytes), digest=dig, shape=list(shape),
                   rotation=n_rot)
        res["modes"][f"{mode}_{batch}"] = row
        for k in ("ms", "warm_ms", "yardstick_ms", "plain_ms", "bound_ms", "digest"):
            res[f"{mode}_{batch}_{k}"] = row[k]
        yard = "the u8 cast" if mode in ("fp32", "bf16") else "copy_ of the output"
        log(f"K2 {mode} {tuple(shape)}: {'max_abs_err %.3g' % err if err else 'equal'}; "
            f"kernel {k_ms:.4f} ms cold ({bms / k_ms:.1%} of the bound, {n_rot} buffers), "
            f"{w_ms:.4f} ms warm; {yard} {y_ms:.4f} ms cold; plain {p_ms:.4f} ms; bound "
            f"{bms:.4f} ms ({by}, {row['bytes'] / 1e6:.2f} MB); digest {dig:.0f}")
        del xs, u8
        torch.cuda.empty_cache()
    main = res["modes"][f"fp32_{K2_CROP_BATCHES[0]}"]
    res.update(ms=main["ms"], warm_ms=main["warm_ms"], yardstick_ms=main["yardstick_ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"])
    log(f"K2 fp32 at batch {K2_CROP_BATCHES[0]} (the fp32 main path's): {res['ms']:.4f} ms cold, "
        f"{res['warm_ms']:.4f} ms warm, bound {res['bound_ms']:.4f} ms; every mode "
        f"bit-equal to its plain version: {res['bit_equal']}")
    return res


def stem_walk(name: str = "cvit") -> list:
    """(H, Cin, Cout, fused, relu, source) of each K3 launch of one forward
    of the quantized CViT ``name`` from the crops, in order, from the
    stems' own planner (value-free: DEConvs fold to convs, BNs drop out);
    ``fused``: the conv quantizes its output for the next conv; ``source``
    of its int8 input: "k2" (K2's int8 entry), "quantize" (a later stem's
    quantize pass of its fp input), "conv" or "pool"."""
    from fac_fake_torch.models.stems import plan_walk, repbn8_stem1, repbn8_stem2, vgg_stem
    specs = {"cvit": [vgg_stem()], "cvit_repbn8": [repbn8_stem1(), repbn8_stem2()]}[name]
    hw, cin, out = 224, 3, []
    for k, spec in enumerate(specs):
        spec = tuple(("qconv", op[1]) if op[0] in ("conv", "deconv") else op for op in spec
                     if op[0] != "bn")
        steps, _ = plan_walk(spec)
        source = "k2" if k == 0 else "quantize"
        for st in steps:
            cout = spec[st.conv][1]
            out.append((hw, cin, cout, st.to is not None, st.relu, source))
            source = "pool" if st.pool else "conv"
            hw, cin = hw // (2 if st.pool else 1), cout
        hw //= 2 ** sum(op[0] == "pool" for op in spec[steps[-1].conv:])   # the fp tail
    return out


def k3_phase(rng, dev, name: str = "cvit") -> dict:
    """K3 against its plain versions at every distinct conv of the quantized
    CViT ``name``'s stem walk (`stem_walk`) at batch 96, fp32 and bf16,
    bit-equal: as JAX's layer (`quant_conv3x3`: quantize pass, conv, fp
    out) and as the int8 walk's step (`int8_conv3x3` on an int8 input, the
    ReLU where the walk has one, and where the walk fuses it the next
    conv's quantize in the epilogue, against
    quantize_pad_plain(int8_conv3x3_plain(...))). Timed as the walk runs
    them from the crops: the convs of one forward (fp32; 17 for cvit, 18
    for cvit_repbn8), the first conv's int8 input made by K2's int8 entry
    (timed in `k2_phase`), a later stem's first by its quantize pass (timed
    here, as K3's).

    The bound counts each tensor at its real channels: the int8 inputs the
    convs read (the first from K2's entry, the others from the convs, or
    int8 pools, before them), a later stem's fp32 input read by its
    quantize pass (the int8 tensor between that pass and its conv not
    counted, as K5 counts it), weights, scales, biases, the int8 outputs
    quantized for the next conv and the fp32 outputs.
    ``bytes_old`` is the count without the fused edges, each conv reading
    fp32 and writing fp32 (the count of PRs 2-4). Beside the deep convs
    (28² and 14²) torch._int_mm times their GEMMs alone on the im2col'd
    int8 operands."""
    import torch
    import torch.nn.functional as F
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    tot = dict(ms=0.0, conv_ms=0.0, quantize_ms=0.0, plain_ms=0.0, ms_deep=0.0, library_ms=0.0,
               bytes=0.0, bytes_old=0.0, ops=0.0, err=0.0, convs=0, fused=0, no_relu_fused=0)
    walk = stem_walk(name)
    groups = {}
    for key in walk:
        groups[key] = groups.get(key, 0) + 1
    for (hw, cin, cout, fused, relu, source), mult in groups.items():
        m = QBATCH * hw * hw
        x, wq, sw, sx, b = quant_inputs(rng, dev, (QBATCH, hw, hw, cin), cout, 9 * cin)
        kq = wq.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)       # OIHW, O-HW-I memory
        s, w_k = sx * sw, q.conv3x3_rows(kq)
        from_fp = source in ("k2", "quantize")
        xq = q3.quantize_pad(x, sx) if from_fp else int8_image(rng, dev, (QBATCH, hw, hw,
                                                                          q.pad16(cin)), cin)
        qs = None
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt).permute(0, 3, 1, 2)
            checks = [("layer", q.quant_conv3x3(xd, kq, sw, sx, b),
                       q.quant_conv3x3_plain(xd, kq, sw, sx, b))]
            if source == "quantize":
                checks.append(("quantize pass", q3.quantize_pad(x.to(dt), sx),
                               q3.quantize_pad_plain(x.to(dt), sx)))
            del xd
            ref = q.int8_conv3x3_plain(xq, kq, s, b, relu, dt)
            checks.append(("walk, fp out", q.int8_conv3x3(xq, kq, s, b, relu, dt, w_k=w_k), ref))
            qs = (ref.float().abs().amax().clamp_min(1e-8) / 127.0).reshape(())
            checks.append(("walk, quantized for the next conv",
                           q.int8_conv3x3(xq, kq, s, b, relu, dt, qs, w_k),
                           q3.quantize_pad_plain(ref, qs)))
            torch.cuda.synchronize()
            for what, got, want in checks:
                err = float((got.float() - want.float()).abs().max())
                tot["err"] = max(tot["err"], err)
                if not torch.equal(got, want):
                    raise AssertionError(f"K3 {hw}x{hw} {cin}->{cout} relu={relu} {dt} {what}: "
                                         f"differs from plain, max abs {err}")
            del checks, ref
        qs = qs if fused else None
        k_ms = cuda_ms(lambda: q.int8_conv3x3(xq, kq, s, b, relu, torch.float32, qs, w_k),
                       iters=10)
        p_ms = cuda_ms(lambda: q.int8_conv3x3_plain(xq, kq, s, b, relu, torch.float32, qs),
                       iters=2, warmup=1)
        ops = 2.0 * m * cout * 9 * cin
        params = kq.numel() + 8 * cout
        x_new = m * cin
        if source == "quantize":
            qp_ms = cuda_ms(lambda: q3.quantize_pad(x, sx))
            tot["quantize_ms"] += mult * qp_ms
            tot["plain_ms"] += mult * cuda_ms(lambda: q3.quantize_pad_plain(x, sx), iters=3)
            x_new = 4 * m * cin + 4
        tot["bytes"] += mult * (x_new + params + (m * cout if fused else 4 * m * cout))
        tot["bytes_old"] += mult * (4 * m * cin + params + 4 + 4 * m * cout)
        tot["conv_ms"] += mult * k_ms
        tot["plain_ms"] += mult * p_ms
        tot["ops"] += mult * ops
        tot["convs"] += mult
        tot["fused"] += mult if fused else 0
        tot["no_relu_fused"] += mult if fused and not relu else 0
        lib = ""
        if hw <= 28:   # the deep convs: torch._int_mm on the im2col'd operands
            xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
            cols = torch.stack([xp[:, dy:dy + hw, dx:dx + hw] for dy in range(3)
                                for dx in range(3)], 3).reshape(m, -1)
            if not torch.equal(torch._int_mm(cols, w_k.t()).reshape(QBATCH, hw, hw, cout),
                               q.int_conv3x3_plain(xq[..., :cin], kq)):
                raise AssertionError("torch._int_mm differs from the exact int32 conv")
            l_ms = cuda_ms(lambda: torch._int_mm(cols, w_k.t()))
            tot["library_ms"] += mult * l_ms
            tot["ms_deep"] += mult * k_ms
            lib = f"; torch._int_mm on the im2col'd operands {l_ms:.4f} ms"
            del xp, cols
        if source == "quantize":
            lib += f"; its input's quantize pass {qp_ms:.4f} ms (equal fp32+bf16)"
        log(f"K3 int8_conv3x3 ({QBATCH},{hw},{hw},{cin})->{cout} "
            f"{'-> int8' if fused else '-> fp'}{'' if relu else ' (no ReLU)'} x{mult}: equal "
            f"fp32+bf16 (layer, walk fp out, walk quantized); kernel {k_ms:.4f} ms plain "
            f"{p_ms:.4f} ms {ops / k_ms / 1e9:.1f} int8 TOP/s{lib}")
        del x, xq, wq, kq, w_k
        torch.cuda.empty_cache()
    tot["ms"] = tot["conv_ms"] + tot["quantize_ms"]
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"], INT8_TC_OPS)
    tot["bound_ms_old_count"] = bound_ms(tot["bytes_old"], tot["ops"], INT8_TC_OPS)[0]
    pools = [(a[0], a[2]) for a, b in zip(walk, walk[1:]) if b[5] == "pool"]   # (H, C) pooled
    pool_ms = 0.0
    for hw, c in pools:
        xq = int8_image(rng, dev, (QBATCH, hw, hw, q.pad16(c)), c)
        pool_ms += cuda_ms(lambda: q.max_pool2x2_i8(xq))
    quantize = f" + its quantize pass {tot['quantize_ms']:.4f} ms" if tot["quantize_ms"] else ""
    log(f"K3 over one {name} forward at batch {QBATCH}: {tot['convs']} convs ({tot['fused']} "
        f"quantizing for the next, {tot['no_relu_fused']} of them with no ReLU) "
        f"{tot['conv_ms']:.4f} ms{quantize}; plain {tot['plain_ms']:.4f} ms; bound "
        f"{tot['bound_ms']:.4f} ms "
        f"({tot['bound_by']}; {tot['ops'] / 1e12:.3f} T int8 ops, {tot['bytes'] / 1e9:.3f} GB; "
        f"without the fused edges {tot['bytes_old'] / 1e9:.3f} GB, "
        f"{tot['bound_ms_old_count']:.4f} ms); {tot['ops'] / tot['conv_ms'] / 1e9:.1f} int8 "
        f"TOP/s; the deep convs {tot['ms_deep']:.4f} ms against torch._int_mm's GEMMs alone "
        f"{tot['library_ms']:.4f} ms; the walk's {len(pools)} int8 pools (PyTorch amax) "
        f"{pool_ms:.4f} ms")
    return tot


def k4_phase(rng, dev) -> dict:
    """K4 against its plain version at the 26 int8_full denses, batch 96,
    beside torch._int_mm (the GEMM alone, on pre-quantized operands)."""
    import torch
    from fac_fake_torch.ops import quant as q
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, bound_sum=0.0,
               err=0.0)
    for (m, n, k, has_bias), mult in INT8_DENSES.items():
        x, wq, sw, sx, b = quant_inputs(rng, dev, (m, k), n, k)
        b = b if has_bias else None
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            ref = q.quant_dense_plain(xd, wq, sw, sx, b)
            got = q.quant_dense(xd, wq, sw, sx, b)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tot["err"] = max(tot["err"], err)
            if not torch.equal(got, ref):
                raise AssertionError(f"K4 ({m},{k})x({k},{n}) {dt}: differs from plain, "
                                     f"max abs {err}")
        xq = q.quantize_plain(x, sx)
        wt = wq.t()
        if not torch.equal(torch._int_mm(xq, wt), q.int_matmul_plain(xq, wq)):
            raise AssertionError("torch._int_mm differs from the exact int32 product")
        k_ms = cuda_ms(lambda: q.quant_dense(x, wq, sw, sx, b))
        p_ms = cuda_ms(lambda: q.quant_dense_plain(x, wq, sw, sx, b), iters=5)
        l_ms = cuda_ms(lambda: torch._int_mm(xq, wt))
        nbytes = m * k * 4 + n * k + 4 * n * (2 if has_bias else 1) + 4 + m * n * 4
        ops = 2.0 * m * n * k
        bms, by = bound_ms(nbytes, ops, INT8_TC_OPS)
        log(f"K4 quant_dense ({m},{k})x({k},{n}) bias={has_bias} x{mult} "
            f"(rows tile {q.dense_rows_tile(m)}, cluster split {q.dense_splits(m, n, k)}): "
            f"equal fp32+bf16; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms torch._int_mm "
            f"{l_ms:.4f} ms bound {bms:.4f} ms ({by})")
        tot["ms"] += mult * k_ms
        tot["plain_ms"] += mult * p_ms
        tot["library_ms"] += mult * l_ms
        tot["bytes"] += mult * nbytes
        tot["ops"] += mult * ops
        tot["bound_sum"] += mult * bms
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"], INT8_TC_OPS)
    log(f"K4 over one int8_full forward's 26 denses: kernel {tot['ms']:.4f} ms plain "
        f"{tot['plain_ms']:.4f} ms torch._int_mm {tot['library_ms']:.4f} ms bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}; sum of per-dense bounds "
        f"{tot['bound_sum']:.4f} ms)")
    return tot


def profile_forward(fn, label: str, top: int = 12, expect: tuple = (),
                    absent: tuple = (), inference: bool = True) -> tuple:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    busy share of its wall time, and the ``top`` kernels; each name in
    ``expect`` must be among the kernels' names, and no name in ``absent``
    may be part of one. A first call is traced and
    dropped (the profiler's warm-up step): without it the trace loses the
    kernels at the start of the window. ``inference=False`` (a train step)
    runs ``fn`` outside inference mode. Returns (wall ms, busy ms)."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    rows = []

    def ready(prof):
        # the kernels' and copies' own rows: an aten op's row repeats its
        # kernels' device time, and the step annotation spans the window
        rows.extend((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                    and not e.key.startswith("ProfilerStep"))

    with torch.inference_mode() if inference else contextlib.nullcontext():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    log(f"profile {label}: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
        f"({busy / (wall * 1e3):.1%}; kernels and copies summed, so overlap would count "
        f"twice)")
    if not rows:
        raise AssertionError(f"profile {label}: the profiler saw no kernel on the card")
    for key, us, n in rows[:top]:
        log(f"  {us / 1e3:9.3f} ms  {n:4d}x  {key[:100]}")
    for name in expect:
        hits = [(us, n) for key, us, n in rows if name in key]
        if not hits:
            raise AssertionError(f"profile {label}: no kernel named {name}")
        log(f"  {name}: {sum(us for us, _ in hits) / 1e3:.3f} ms in {sum(n for _, n in hits)} "
            f"launches")
    for name in absent:
        if any(name in key for key, _, _ in rows):
            raise AssertionError(f"profile {label}: a kernel named {name} ran")
    return wall * 1e3, busy


def forward_counts(model, u8, pos) -> dict:
    """One fp32 forward of the CViT ``model`` from the uint8 crops ``u8``
    (`forward_crops`, as `VideoScorer` runs it): the launches of K3
    (``convs``), its quantize pass, K2's int8 entry and its fp launches, K4,
    the walks' int8 pools and the stems' fp ReLU and max-pool modules that
    ran, over every stem."""
    import torch
    from torch import nn
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    ran = {"int8_pools": 0, "fp_relus": 0, "fp_pools": 0}
    hooks = []
    for _, _, stem in model.stems():
        for mod in stem:
            kind = {nn.ReLU: "fp_relus", nn.MaxPool2d: "fp_pools"}.get(type(mod))
            if kind:
                hooks.append(mod.register_forward_hook(
                    lambda *_, kind=kind: ran.__setitem__(kind, ran[kind] + 1)))
    pool = q.max_pool2x2_i8

    def int8_pool(xq):
        ran["int8_pools"] += 1
        return pool(xq)

    q.int8_conv3x3.launches = q3.quantize_pad.launches = q.quant_dense.launches = 0
    pp.normalize_imagenet.launches = pp.quantize_crops.launches = 0
    q.max_pool2x2_i8 = int8_pool
    try:
        with torch.inference_mode():
            model.forward_crops(u8, torch.float32, pos)
        torch.cuda.synchronize()
    finally:
        q.max_pool2x2_i8 = pool
        for h in hooks:
            h.remove()
    return {"convs": q.int8_conv3x3.launches, "quantize": q3.quantize_pad.launches,
            "k2_int8": pp.quantize_crops.launches,
            "k2_fp": pp.normalize_imagenet.launches - pp.quantize_crops.launches, **ran,
            "K4": q.quant_dense.launches}


def check_k3_calls(model, u8, pos) -> tuple:
    """One fp32 forward of the quantized CViT ``model`` from the uint8 crops
    ``u8`` in which K2's int8 entry, every K3 call and any quantize pass also
    run through their plain versions on the same (real, calibrated) inputs
    and must be bit-equal: ({kind: calls checked}, "fused" among the convs
    those that quantize for the next conv, "no_relu_fused" those of them
    with no ReLU; the shapes of the latter)."""
    import torch
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    n = {"convs": 0, "fused": 0, "no_relu_fused": 0, "quantize": 0, "k2_int8": 0}
    no_relu = []
    orig = (q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops)

    def same(got, ref, what):
        if not torch.equal(got, ref):
            err = float((got.float() - ref.float()).abs().max())
            raise AssertionError(f"{what} on real activations: differs from plain, max abs "
                                 f"{err}")

    def conv(xq, kernel_q, s, bias, relu, dtype, q_scale=None, w_k=None):
        y = orig[0](xq, kernel_q, s, bias, relu, dtype, q_scale, w_k)
        what = f"K3 conv {tuple(xq.shape)} -> {kernel_q.shape[0]}, relu={relu}"
        same(y, q.int8_conv3x3_plain(xq, kernel_q, s, bias, relu, dtype, q_scale), what)
        n["convs"] += 1
        n["fused"] += q_scale is not None
        if q_scale is not None and not relu:
            n["no_relu_fused"] += 1
            no_relu.append(f"{tuple(xq.shape)} -> {kernel_q.shape[0]}, quantized for the next "
                           f"conv")
        return y

    def quantize(x, s_x):
        y = orig[1](x, s_x)
        same(y, q3.quantize_pad_plain(x, s_x), f"K3 quantize {tuple(x.shape)}")
        n["quantize"] += 1
        return y

    def entry(crops_u8, x_scale, dtype=torch.float32):
        y = orig[2](crops_u8, x_scale, dtype)
        same(y, pp.quantize_crops_plain(crops_u8, x_scale, dtype),
             f"K2 int8 entry {tuple(crops_u8.shape)}")
        n["k2_int8"] += 1
        return y

    # launches made here count on the checker's functions, not the wrappers'
    conv.launches = quantize.launches = entry.launches = 0
    q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops = conv, quantize, entry
    try:
        with torch.inference_mode():
            model.forward_crops(u8, torch.float32, pos)
    finally:
        q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops = orig
    return n, no_relu


def crops_per_s(scorer, crops, stacks, n_it: int = 10) -> tuple:
    """crops/s through `score_crops` and `score_crop_stacks`, and the last
    scores of each."""
    import torch
    t0 = time.perf_counter()
    for _ in range(n_it):
        p_crops = scorer.score_crops(crops)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_it):
        p_stacks = scorer.score_crop_stacks(stacks)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = crops.shape[0]
    return (n * n_it / (t1 - t0), len(stacks) * n * n_it / (t2 - t1), p_crops, p_stacks)


class SeededReader:
    """In-memory stand-in for the cv2 reader: ``n_frames`` per video, each a
    seeded uint8 1920x1080 RGB noise frame made on demand. Videos named in
    ``faces`` get ``face`` (an RGB patch) pasted 8x enlarged at a place that
    moves with the video and the frame."""

    def __init__(self, seed: int, n_frames: int = 300, hw=(1080, 1920),
                 face: np.ndarray = None, faces=()):
        self.seed, self.n_frames, self.hw = seed, n_frames, hw
        self.face = None if face is None else np.repeat(np.repeat(face, 8, 0), 8, 1)
        self.faces = set(faces)

    def frame(self, video: str, idx: int) -> np.ndarray:
        vid = int(video.rsplit("_", 1)[1])
        rng = np.random.default_rng([self.seed, vid, idx])
        img = rng.integers(0, 256, (*self.hw, 3), dtype=np.uint8)
        if self.face is not None and video in self.faces:
            fh, fw = self.face.shape[:2]
            y = (60 * vid + 3 * idx) % (self.hw[0] - fh)
            x = (170 * vid + 5 * idx) % (self.hw[1] - fw)
            img[y:y + fh, x:x + fw] = self.face
        return img

    def frame_count(self, path: str) -> int:
        return self.n_frames

    def stream_frames_at_indices(self, path, frame_idxs, chunk=16, stop=None):
        for s in range(0, len(frame_idxs), chunk):
            frames = []
            for i in frame_idxs[s:s + chunk]:
                if stop is not None and stop():
                    return
                frames.append(self.frame(path, i))
            yield np.stack(frames), list(frame_idxs[s:s + chunk])


def synth_face(det, seed: int, steps: int = 300) -> np.ndarray:
    """A 64x64 uint8 RGB patch that the packaged BlazeFace scores as a face
    on a noise background: gradient ascent on the detector's top anchor
    logit over random placements and sizes (56-72 px in a 128-px tile),
    from a seeded start. Random noise frames hold no face, so the main path
    needs this to exercise crops, their resize and their scoring."""
    import torch
    import torch.nn.functional as F
    dev = det.device
    g = torch.Generator(device=dev).manual_seed(seed)
    logit = torch.zeros((1, 3, 64, 64), device=dev).normal_(0.0, 0.5, generator=g)
    logit.requires_grad_(True)
    opt = torch.optim.Adam([logit], lr=0.05)
    for _ in range(steps):
        bg = 0.5 + 0.04 * torch.randn((8, 3, 128, 128), generator=g, device=dev)
        sizes = torch.randint(56, 73, (8,), generator=g, device=dev).tolist()
        corner = torch.rand((8, 2), generator=g, device=dev).tolist()
        tiles = []
        for b, sz in enumerate(sizes):
            y, x = int(corner[b][0] * (128 - sz)), int(corner[b][1] * (128 - sz))
            patch = F.interpolate(torch.sigmoid(logit), size=(sz, sz), mode="bilinear",
                                  align_corners=False)
            tiles.append(F.pad(patch, (x, 128 - sz - x, y, 128 - sz - y)))
            inside = torch.zeros((1, 1, 128, 128), device=dev)
            inside[..., y:y + sz, x:x + sz] = 1.0
            tiles[-1] = tiles[-1] + bg[b:b + 1] * (1.0 - inside)
        _, c = det.net(torch.cat(tiles).contiguous(memory_format=torch.channels_last) * 2 - 1)
        loss = -c[..., 0].amax(dim=1).clamp(max=12.0).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    face = torch.sigmoid(logit.detach())[0].permute(1, 2, 0) * 255.0
    return face.round().to(torch.uint8).cpu().numpy()


def planted_dets(rng, f: int = 16, t: int = 3):
    """Tile detections (F·T, 896, 17) in [0, 1] tile units with overlapping
    clusters (scores ≥ 0.75), exact score ties and one zero-area box per
    frame; background anchors invalid."""
    dets = rng.uniform(0.0, 0.8, (f * t, 896, 17)).astype(np.float32)
    dets[..., 2:4] = dets[..., 0:2] + 0.15
    dets[..., 16] = rng.uniform(0.0, 0.7, (f * t, 896))
    for k in range(f * t):
        for c in range(3):
            y, x = rng.uniform(0.05, 0.6, 2)
            for j in range(5):
                a = 40 * c + 7 * j
                jit = rng.normal(0, 0.01, 2)
                dets[k, a, :4] = [y + jit[0], x + jit[1], y + 0.3 + jit[0], x + 0.3 + jit[1]]
                dets[k, a, 16] = 0.9 if j < 2 else rng.uniform(0.75, 0.95)  # ties at 0.9
        dets[k, 500, :4] = [0.5, 0.5, 0.5, 0.5]                            # zero area
        dets[k, 500, 16] = 0.97
    valid = dets[..., 16] >= 0.75
    return dets, valid


def compare_k1(dets, valid, split, offsets, hw, t):
    import torch
    from fac_fake_torch.detect import extractor as ex
    f = dets.shape[0] // t
    d = dets.reshape(f, t * 896, 17).contiguous()
    v = valid.reshape(f, t * 896).contiguous()
    args = (split, offsets, hw, ex.MAX_FACES, ex.IOU_THRESH, ex.MARGIN)
    kf, km = ex.frame_detections(d, v, *args)
    pf, pm = ex.frame_detections_plain(d, v, *args)
    torch.cuda.synchronize()
    if not torch.equal(km, pm):
        raise AssertionError(f"K1 mask differs from plain: {km.sum()} vs {pm.sum()} set")
    m = km
    err = float((kf - pf).abs()[m].max()) if bool(m.any()) else 0.0
    if bool(m.any()) and not torch.allclose(kf[m], pf[m], rtol=K1_RTOL, atol=K1_ATOL):
        raise AssertionError(f"K1 faces differ from plain: max abs {err}")
    k_ms = cuda_ms(lambda: ex.frame_detections(d, v, *args))
    p_ms = cuda_ms(lambda: ex.frame_detections_plain(d, v, *args), iters=5)
    nbytes = d.numel() * 4 + v.numel() + offsets.numel() * 4 + kf.numel() * 4 + km.numel()
    return err, int(m.sum()), k_ms, p_ms, nbytes


def k1_phase(rng, dev, real=None) -> dict:
    """K1 against its plain version on planted dets (`planted_dets`: 16
    1080p frames, T = 3) and, with ``real`` = (dets, valid, split, offsets),
    on real BlazeFace dets of 16 such frames: masks equal, faces within
    K1_RTOL/K1_ATOL. Timed on the planted 16-frame chunk, and with no step
    (``load_ms``: the launch and the load pass alone); the bound counts its
    bytes (dets, valid, offsets, faces, mask) and 8 steps of 20 operations
    an anchor."""
    import torch
    from fac_fake_torch.detect import extractor as ex
    hw = (1080.0, 1920.0)
    split, t, offs = ex.tile_geometry(1080, 1920)
    err_a = 0.0
    if real is not None:
        dets, valid, split_r, offsets = real
        err_a, n_a, ms_a, pms_a, _ = compare_k1(dets, valid, float(split_r), offsets, hw, t)
        log(f"K1 real dets (16 frames, 8 with the synthetic face, T={t}): faces {n_a} "
            f"max_abs_err {err_a:.3g} kernel {ms_a:.4f} ms plain {pms_a:.4f} ms")
    offsets = torch.tensor(offs, dtype=torch.float32, device=dev)
    pd_, pv_ = planted_dets(rng, t=t)
    pd = torch.from_numpy(pd_).to(dev)
    pv = torch.from_numpy(pv_).to(dev)
    err_b, n_b, ms_b, pms_b, nbytes_b = compare_k1(pd, pv, float(split), offsets, hw, t)
    if n_b == 0:
        raise AssertionError("K1 planted dets produced no faces")
    bms, by = bound_ms(nbytes_b, 8 * pd.shape[0] * 896 * 20)   # (F·T, 896) anchors
    d = pd.reshape(-1, t * 896, 17).contiguous()
    v = pv.reshape(-1, t * 896).contiguous()
    load_ms = cuda_ms(lambda: ex.frame_detections(d, v, float(split), offsets, hw, 0))
    log(f"K1 planted dets (16 frames, T={t}): faces {n_b} max_abs_err {err_b:.3g} "
        f"kernel {ms_b:.4f} ms (with no step {load_ms:.4f} ms) plain {pms_b:.4f} ms bound "
        f"{bms:.5f} ms ({by})")
    return dict(ms=ms_b, load_ms=load_ms, plain_ms=pms_b, bound_ms=bms, bound_by=by,
                err=max(err_a, err_b))


class InMemoryClips:
    """In-memory stand-in for `ClipDataset`: ``n`` seeded uint8 (T, H, W, 3)
    clips, labels alternating; ``load_clip`` draws the masking region order
    from the generator first, as `ClipDataset.load_clip` does."""

    def __init__(self, seed: int, n: int = 4):
        self.seed = seed
        self.samples = [(f"clip_{i}", i % 2, f"clip_{i}") for i in range(n)]

    def load_clip(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        rng.permutation(8)
        return np.random.default_rng([self.seed, idx]).integers(
            0, 256, (S3D_T, S3D_HW, S3D_HW, 3), dtype=np.uint8)


def clips_per_s(ev, clips, n_it: int = 5) -> tuple:
    """clips/s through `predict_batch`, and the last scores."""
    import torch
    t0 = time.perf_counter()
    for _ in range(n_it):
        probs = ev.predict_batch(clips)
    torch.cuda.synchronize()
    return clips.shape[0] * n_it / (time.perf_counter() - t0), probs


def record_s3d_calls(engine, x) -> dict:
    """One int8 forward of ``engine`` on ``x`` with the K5/K6 wrappers
    wrapped: {kind: {call key: count}}, where a conv's key is (xq shape,
    w_q shape, stride, padding, relu, real input channels, what made its
    input: "quantize", "raw" (K2's raw entry), "pool" (K6) or "conv" (the
    previous conv's fused epilogue), whether it quantizes its own output for
    the next conv), a quantize's or a raw entry's (x shape) and a pool's (xq
    shape, real channels). The real channel count of an int8 tensor is that
    of the fp tensor it stands for."""
    import torch
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3
    calls = {"conv": {}, "quantize": {}, "raw": {}, "pool": {}}
    orig = (q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, pp.quantize_clips)
    made = {}                                   # data_ptr of an int8 tensor -> (C, source)

    def bump(kind, key):
        calls[kind][key] = calls[kind].get(key, 0) + 1

    def conv(xq, w_q, s, b, stride, padding, relu, dtype, out=None, c0=0, q_scale=None,
             w_rows=None):
        c, source = made[xq.data_ptr()]
        bump("conv", (tuple(xq.shape), tuple(w_q.shape), tuple(stride), tuple(padding), relu,
                      c, source, q_scale is not None))
        y = orig[0](xq, w_q, s, b, stride, padding, relu, dtype, out, c0, q_scale, w_rows)
        if q_scale is not None:
            made[y.data_ptr()] = (w_q.shape[0], "conv")
        return y

    def quantize(x, s_x):
        bump("quantize", tuple(x.shape))
        xq = orig[1](x, s_x)
        made[xq.data_ptr()] = (x.shape[-1], "quantize")
        return xq

    def pool(xq):
        c = made[xq.data_ptr()][0]
        bump("pool", (tuple(xq.shape), c))
        y = orig[2](xq)
        made[y.data_ptr()] = (c, "pool")
        return y

    def raw(x, s_x):
        bump("raw", tuple(x.shape))
        xq = orig[3](x, s_x)
        made[xq.data_ptr()] = (x.shape[-1], "raw")
        return xq

    # each wrapper counts its launches on the function its module's name is
    # bound to: here the recorder's, so that recording launches do not count
    conv.launches = conv.relu6_launches = quantize.launches = pool.launches = raw.launches = 0
    q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, pp.quantize_clips = conv, quantize, pool, raw
    try:
        with torch.no_grad():
            engine(x)
    finally:
        q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, pp.quantize_clips = orig
    return calls


def check_s3d_calls(engine, x) -> dict:
    """One int8 forward of ``engine`` on ``x`` in which every K5 and K6
    call, and K2's raw entry, is also run through its plain version on the
    same (real, calibrated) inputs and must be bit-equal; a conv that
    quantizes its output for the next conv against
    ``quantize_pad_plain(int8_conv3d_plain(...))``: {kind: calls checked},
    "fused" among the convs."""
    import torch
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3
    n = {"conv": 0, "fused": 0, "quantize": 0, "raw": 0, "pool": 0}
    orig = (q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, pp.quantize_clips)

    def same(kind, got, ref, what):
        if not torch.equal(got, ref):
            err = float((got.float() - ref.float()).abs().max())
            raise AssertionError(f"K2/K5/K6 {kind} {what} on real activations: differs from "
                                 f"plain, max abs {err}")
        n[kind] += 1

    def conv(xq, w_q, s, b, stride, padding, relu, dtype, out=None, c0=0, q_scale=None,
             w_rows=None):
        ref = q3.int8_conv3d_plain(xq, w_q, s, b, stride, padding, relu, dtype)
        y = orig[0](xq, w_q, s, b, stride, padding, relu, dtype, out, c0, q_scale, w_rows)
        what = f"{tuple(xq.shape)} * {tuple(w_q.shape)}"
        if q_scale is not None:
            same("conv", y, q3.quantize_pad_plain(ref, q_scale), what + " quantized")
            n["fused"] += 1
        else:
            same("conv", y[..., c0:c0 + ref.shape[-1]], ref, what)
        return y

    def quantize(x, s_x):
        y = orig[1](x, s_x)
        same("quantize", y, q3.quantize_pad_plain(x, s_x), tuple(x.shape))
        return y

    def pool(xq):
        y = orig[2](xq)
        same("pool", y, q3.max_pool3d_i8_plain(xq), tuple(xq.shape))
        return y

    def raw(x, s_x):
        y = orig[3](x, s_x)
        same("raw", y, pp.quantize_clips_plain(x, s_x), tuple(x.shape))
        return y

    # launches made here count on the checker's functions, not the wrappers'
    conv.launches = conv.relu6_launches = quantize.launches = pool.launches = raw.launches = 0
    q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, pp.quantize_clips = conv, quantize, pool, raw
    try:
        with torch.no_grad():
            engine(x)
    finally:
        q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8, pp.quantize_clips = orig
    return n


def head_input(mod, x) -> tuple:
    """Logits of ``mod`` (an `S3DNet` or its int8 engine) on ``x``, and the
    features its head's 1x1x1 conv reads (the last mix's output, pooled)."""
    import torch
    seen = []
    hook = mod.fc.register_forward_pre_hook(lambda _, args: seen.append(args[0].detach()))
    try:
        with torch.no_grad():
            logits = mod(x)
    finally:
        hook.remove()
    return logits, seen[0]


def _at_batch(shape, b):
    return (b,) + tuple(shape[1:])


def s3d_pool_shapes(batch: int) -> dict:
    """{(B, T, H, W, Cp): count} of the int8 pools of one ca_s3d forward on
    S3D_T x S3D_HW² clips. Each Inception mix pools its int8 input (its
    fourth branch), so these are the mixes' input shapes, the channels
    padded as the int8 tensors are; from the spec, by a forward on the meta
    device (no memory, no compute)."""
    import torch
    from fac_fake_torch.models.s3d.blocks import InceptionMix
    from fac_fake_torch.models.s3d.model import S3DNet, ca_s3d_spec
    from fac_fake_torch.ops.quant3d import quant_channels
    with torch.device("meta"):
        net = S3DNet(ca_s3d_spec(), 1)
    shapes = {}

    def record(mod, args):
        b, c, t, h, w = args[0].shape
        key = (b, t, h, w, quant_channels(c))
        shapes[key] = shapes.get(key, 0) + 1

    for mod in net.modules():
        if isinstance(mod, InceptionMix):
            mod.register_forward_pre_hook(record)
    with torch.no_grad():
        net(torch.empty((batch, 3, S3D_T, S3D_HW, S3D_HW), device="meta"))
    return shapes


def k6_phase(rng, dev) -> dict:
    """K6 against its plain version at the int8 pools of one ca_s3d forward
    (`s3d_pool_shapes`; batches S3D_CHECK_BATCH and S3D_BATCH, bit-equal),
    timed at batch S3D_BATCH, each shape times its count in one forward.
    Cold (``ms``): the timed launches rotate over input/output pairs that
    together exceed twice the L2, so that each reads its input from device
    memory, as a forward's pools do; warm (``warm_ms``): one input again and
    again (the pools of 16 MB then read L2). The bound counts one read and
    one write an element at real channels; its share is taken on the cold
    time. ``copy_ms``: torch's ``copy_`` of the same tensors over the same
    rotation, the rate a plain copy of these bytes reaches (a yardstick,
    not the same function)."""
    import torch
    from fac_fake_torch.ops import quant3d as q3
    k6 = dict(ms=0.0, warm_ms=0.0, copy_ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, err=0.0,
              pools=0)
    for xs, mult in s3d_pool_shapes(S3D_BATCH).items():
        c = xs[-1]
        for batch in (S3D_CHECK_BATCH, S3D_BATCH):
            xq = int8_image(rng, dev, _at_batch(xs, batch), c)
            got, ref = q3.max_pool3d_i8(xq), q3.max_pool3d_i8_plain(xq)
            torch.cuda.synchronize()
            k6["err"] = max(k6["err"], float((got.int() - ref.int()).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(f"K6 {tuple(xq.shape)}: differs from plain")
            del got, ref
        n_rot = int(L2_BYTES // xq.numel()) + 2      # pairs of 2·numel bytes > 2·L2
        rot_x = [xq] + [xq.clone() for _ in range(n_rot - 1)]
        k_ms = rotated_ms(q3.max_pool3d_i8, rot_x)
        w_ms = cuda_ms(lambda: q3.max_pool3d_i8(xq))
        pairs = [(torch.empty_like(x), x) for x in rot_x]
        c_ms = rotated_ms(lambda pair: pair[0].copy_(pair[1]), pairs)
        p_ms = cuda_ms(lambda: q3.max_pool3d_i8_plain(xq), iters=3)
        del rot_x, pairs
        real = xq.numel() // xs[-1] * c
        b_ms = bound_ms(2.0 * real, 26.0 * real)[0]
        k6["ms"] += mult * k_ms
        k6["warm_ms"] += mult * w_ms
        k6["copy_ms"] += mult * c_ms
        k6["plain_ms"] += mult * p_ms
        k6["bytes"] += mult * 2.0 * real
        k6["ops"] += mult * 26.0 * real          # byte maxima, outside the tensor cores
        k6["pools"] += mult
        log(f"K6 max_pool3d_i8 {tuple(xq.shape)} x{mult}: equal; kernel {k_ms:.4f} ms cold "
            f"({b_ms / k_ms:.1%} of the bound, {n_rot} buffer pairs), {w_ms:.4f} ms warm; "
            f"copy_ {c_ms:.4f} ms; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms")
        del xq
        torch.cuda.empty_cache()
    k6["bound_ms"], k6["bound_by"] = bound_ms(k6["bytes"], k6["ops"])
    log(f"K6 over one forward's {k6['pools']} pools at batch {S3D_BATCH}: kernel "
        f"{k6['ms']:.4f} ms cold ({k6['bound_ms'] / k6['ms']:.1%} of the bound), "
        f"{k6['warm_ms']:.4f} ms warm; copy_ of the same bytes {k6['copy_ms']:.4f} ms cold; "
        f"plain {k6['plain_ms']:.4f} ms; bound {k6['bound_ms']:.4f} ms ({k6['bound_by']}, "
        f"{k6['bytes'] / 1e6:.1f} MB)")
    return k6


def k5_phase(rng, dev, calls=None) -> dict:
    """K5 against its plain versions at every recorded conv and quantize
    shape (``calls``, `record_s3d_calls`; if not given, recorded here from
    one int8 forward of the seeded full-width ca_s3d, calibrated on seeded
    uint8 clips at batch S3D_CHECK_BATCH, so that the phase stands alone for
    `utils/kernel_pairs.py`) (batches S3D_CHECK_BATCH and S3D_BATCH, fp32
    and bf16, bit-equal;
    a conv that quantizes its output for the next conv against
    ``quantize_pad_plain(int8_conv3d_plain(...))`` at a scale of its
    output's range), then timed at batch S3D_BATCH, each shape times its
    count in one forward. Returns the K5 totals.

    The bound counts each tensor at its real channel count (the zero
    channels K5 pads to 16 are not work the function needs). K5's bytes
    are those of its quantize passes and convs as one function: the fp32
    inputs of the quantize passes, the int8 inputs the convs read from K2's
    raw entry (the stem conv's), K6 pools and the convs before them, the
    weights, scales,
    biases, the fp32 outputs and the int8 outputs quantized for the next
    conv; the int8 tensor between a quantize pass and its convs is not
    counted. ``bytes_old`` is the count for the same work without the fused
    epilogue: each fused conv's output as an fp32 write and, in the
    next conv's quantize pass, an fp32 read."""
    import torch
    from fac_fake_torch.ops import quant3d as q3
    if calls is None:
        from fac_fake_torch.compat.quantize_s3d import quantize_s3d
        from fac_fake_torch.core.config import ModelConfig
        from fac_fake_torch.models import build_model
        s3d = build_model(ModelConfig(name="ca_s3d", num_class=1), device=dev, seed=0)
        x = torch.from_numpy(side_rng(rng).integers(
            0, 256, (S3D_CHECK_BATCH, S3D_T, S3D_HW, S3D_HW, 3), dtype=np.uint8)).to(dev)
        x = x.permute(0, 4, 1, 2, 3)
        calls = record_s3d_calls(quantize_s3d(s3d, x.float()), x)
        del s3d, x
        torch.cuda.empty_cache()
    k5 = dict(ms=0.0, conv_ms=0.0, quantize_ms=0.0, plain_ms=0.0, ms_1x1x1=0.0,
              library_ms=0.0, bytes=0.0, bytes_old=0.0, ops=0.0, err=0.0, convs=0, fused=0,
              quantizes=0)
    t = lambda a: torch.from_numpy(a).to(dev)

    for (xs, ws, stride, padding, relu, cin, source, fused), mult in calls["conv"].items():
        n, kt, kh, kw, cp = ws
        w_q = rng.integers(-127, 128, ws, dtype=np.int8)
        w_q[..., cin:] = 0
        w_q = t(w_q)
        s = t(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
        b = t(rng.standard_normal(n, dtype=np.float32))
        qs = None
        for batch in (S3D_CHECK_BATCH, S3D_BATCH):
            xq = int8_image(rng, dev, _at_batch(xs, batch), cin)
            for dt in (torch.float32, torch.bfloat16):
                ref = q3.int8_conv3d_plain(xq, w_q, s, b, stride, padding, relu, dt)
                if fused:
                    qs = (ref.float().abs().amax().clamp_min(1e-8) / 127.0).reshape(())
                    got = q3.int8_conv3d(xq, w_q, s, b, stride, padding, relu, dt, q_scale=qs)
                    ref = q3.quantize_pad_plain(ref, qs)
                else:
                    got = q3.int8_conv3d(xq, w_q, s, b, stride, padding, relu, dt)
                torch.cuda.synchronize()
                k5["err"] = max(k5["err"], float((got.float() - ref.float()).abs().max()))
                if not torch.equal(got, ref):
                    raise AssertionError(f"K5 conv {_at_batch(xs, batch)} * {ws} s{stride} "
                                         f"p{padding} {dt} fused={fused}: differs from plain, "
                                         f"max abs {k5['err']}")
                del got, ref
        k_ms = cuda_ms(lambda: q3.int8_conv3d(xq, w_q, s, b, stride, padding, relu,
                                              torch.float32, q_scale=qs), iters=10)
        p_ms = cuda_ms(lambda: q3.int8_conv3d_plain(xq, w_q, s, b, stride, padding, relu,
                                                    torch.float32, q_scale=qs), iters=1, warmup=1)
        out = q3.conv3d_out_shape(xq.shape[:4], (kt, kh, kw), stride, padding)
        m = float(np.prod(out))
        taps = kt * kh * kw
        k5["ops"] += mult * 2.0 * m * n * taps * cin
        x_real = xq.numel() // xs[-1] * cin
        params = n * taps * cin + 8 * n
        x_new = x_real if source in ("pool", "conv", "raw") else 0
        x_old = x_real if source in ("pool", "raw") else 4 * x_real if source == "conv" else 0
        k5["bytes"] += mult * (x_new + params + (m * n if fused else 4 * m * n))
        k5["bytes_old"] += mult * (x_old + params + 4 * m * n)
        k5["conv_ms"] += mult * k_ms
        k5["plain_ms"] += mult * p_ms
        k5["convs"] += mult
        k5["fused"] += mult if fused else 0
        log(f"K5 conv {tuple(xq.shape)} * {ws} s{stride} p{padding} from {source} "
            f"{'-> int8' if fused else '-> fp'} x{mult}: equal; kernel {k_ms:.4f} ms "
            f"{2.0 * m * n * taps * cin / k_ms / 1e9:.1f} int8 TOP/s")
        if (kt, kh, kw) == (1, 1, 1):
            xm, wm = xq.reshape(-1, cp), w_q.reshape(n, cp)
            if not torch.equal(torch._int_mm(xm, wm.t()),
                               q3.int_conv3d_plain(xq, w_q, stride, padding).reshape(-1, n)):
                raise AssertionError("torch._int_mm differs from the exact int32 conv")
            k5["library_ms"] += mult * cuda_ms(lambda: torch._int_mm(xm, wm.t()))
            k5["ms_1x1x1"] += mult * k_ms
        del xq, w_q
        torch.cuda.empty_cache()
    for xs, mult in calls["quantize"].items():
        for batch in (S3D_CHECK_BATCH, S3D_BATCH):
            x, _, _, sx, _ = quant_inputs(rng, dev, _at_batch(xs, batch), 1, 1)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                if not torch.equal(q3.quantize_pad(xd, sx), q3.quantize_pad_plain(xd, sx)):
                    raise AssertionError(f"K5 quantize {tuple(x.shape)} {dt}: differs from plain")
                del xd
        k_ms = cuda_ms(lambda: q3.quantize_pad(x, sx))
        k5["quantize_ms"] += mult * k_ms
        k5["plain_ms"] += mult * cuda_ms(lambda: q3.quantize_pad_plain(x, sx), iters=3)
        k5["bytes"] += mult * (4.0 * x.numel() + 4)
        k5["bytes_old"] += mult * (4.0 * x.numel() + 4)
        k5["quantizes"] += mult
        del x
    k5["ms"] = k5["conv_ms"] + k5["quantize_ms"]
    k5["bound_ms"], k5["bound_by"] = bound_ms(k5["bytes"], k5["ops"], INT8_TC_OPS)
    k5["bound_ms_old_count"] = bound_ms(k5["bytes_old"], k5["ops"], INT8_TC_OPS)[0]
    log(f"K5 over one forward at batch {S3D_BATCH}: {k5['convs']} convs ({k5['fused']} "
        f"quantizing for the next) {k5['conv_ms']:.4f} ms + {k5['quantizes']} quantize passes "
        f"{k5['quantize_ms']:.4f} ms = {k5['ms']:.4f} ms; plain {k5['plain_ms']:.4f} ms; "
        f"bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}; {k5['ops'] / 1e12:.3f} T int8 ops, "
        f"{k5['bytes'] / 1e9:.3f} GB; without the fused epilogue {k5['bytes_old'] / 1e9:.3f} GB, "
        f"{k5['bound_ms_old_count']:.4f} ms); "
        f"{k5['ops'] / k5['conv_ms'] / 1e9:.1f} int8 TOP/s; the 1x1x1 convs {k5['ms_1x1x1']:.4f} "
        f"ms against torch._int_mm's GEMMs alone {k5['library_ms']:.4f} ms")
    return k5


def s3d_phases(seed: int, rng, dev, profile: bool = False) -> dict:
    """Phases 11-14: the S3D fp32 path, K5 and K6 against their plain
    versions, the S3D int8 path (with ``profile``, a torch.profiler
    breakdown of one `predict_batch` in fp32 and in int8), and ca_s3d
    logits card against CPU. Returns what the kernels line needs."""
    import torch
    from fac_fake_torch.compat.quantize_s3d import quantize_s3d
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.detect import extractor as ex
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3

    # ---- 11. S3D fp32 main path --------------------------------------------------
    s3d_cfg = Config().model
    s3d_cfg.name, s3d_cfg.num_class = "ca_s3d", 1
    s3d = build_model(s3d_cfg, device=dev, seed=seed)
    clips = rng.integers(0, 256, (S3D_BATCH, S3D_T, S3D_HW, S3D_HW, 3), dtype=np.uint8)
    mem = InMemoryClips(seed)
    ev = S3DEvaluator(s3d, degrade=False, seed=seed, device=dev)
    ev.predict_batch(clips)                     # warm cuDNN before timing
    torch.cuda.synchronize()

    def zero_counts():
        ex.frame_detections.launches = pp.normalize_imagenet.launches = 0
        pp.quantize_clips.launches = 0
        q.int8_conv3x3.launches = q.quant_dense.launches = 0
        q3.int8_conv3d.launches = q3.quantize_pad.launches = q3.max_pool3d_i8.launches = 0

    def read_counts():
        return {"K1": ex.frame_detections.launches, "K2": pp.normalize_imagenet.launches,
                "K2_raw": pp.quantize_clips.launches, "K3": q.int8_conv3x3.launches,
                "K4": q.quant_dense.launches,
                "K5": q3.int8_conv3d.launches, "K5_quantize": q3.quantize_pad.launches,
                "K6": q3.max_pool3d_i8.launches}

    zero_counts()
    s3d_rate, s3d_probs = clips_per_s(ev, clips)
    s3d_video = ev.predict_video(clips[0])
    s3d_eval = ev.evaluate(mem)
    s3d_launches = read_counts()
    log(f"S3D fp32 (ca_s3d, {S3D_T}x{S3D_HW}^2): predict_batch {S3D_BATCH} clips "
        f"{s3d_rate:.1f} clips/s; predict_video {s3d_video:.6f}; evaluate {s3d_eval}; "
        f"launches {s3d_launches} (no hand-written kernel on the fp32 S3D path)")
    s3d_scores = list(s3d_probs) + [s3d_video]
    if not (all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in s3d_scores)
            and s3d_eval["count"] == len(mem.samples) and s3d_probs.shape == (S3D_BATCH,)):
        raise AssertionError(f"S3D fp32 scores {s3d_scores} / evaluate {s3d_eval}")

    # ---- 12. K5 and K6 against their plain versions ------------------------------
    # uint8 clips, as `S3DEvaluator` hands them to the engine
    x_check = torch.from_numpy(clips[:S3D_CHECK_BATCH]).to(dev).permute(0, 4, 1, 2, 3)
    calls = record_s3d_calls(quantize_s3d(s3d, x_check.float()), x_check)
    per_forward = {"conv": sum(calls["conv"].values()),
                   "fused": sum(c for key, c in calls["conv"].items() if key[-1]),
                   "quantize": sum(calls["quantize"].values()), "raw": sum(calls["raw"].values()),
                   "pool": sum(calls["pool"].values())}
    log(f"S3D int8 forward: {per_forward['conv']} convs ({len(calls['conv'])} shapes, "
        f"{per_forward['fused']} quantizing their output for the next conv), "
        f"{per_forward['quantize']} quantize passes, {per_forward['raw']} K2 raw entry, "
        f"{per_forward['pool']} int8 pools")
    if per_forward != S3D_INT8_CALLS:
        raise AssertionError(f"a ca_s3d int8 forward makes {S3D_INT8_CALLS}, recorded "
                             f"{per_forward}")
    pools = {}
    for (xs, _), mult in calls["pool"].items():
        pools[xs] = pools.get(xs, 0) + mult
    if pools != s3d_pool_shapes(S3D_CHECK_BATCH):
        raise AssertionError(f"the int8 forward pooled {pools}, the spec gives "
                             f"{s3d_pool_shapes(S3D_CHECK_BATCH)}")
    k5 = k5_phase(rng, dev, calls)
    k6 = k6_phase(rng, dev)
    torch.cuda.empty_cache()

    # ---- 13. S3D int8 main path ------------------------------------------------------
    ev8 = S3DEvaluator(s3d, degrade=False, seed=seed, quantize="int8", device=dev)
    t_cal = time.perf_counter()
    ev8.predict_batch(clips)                    # calibrates on clips[:2], then scores
    torch.cuda.synchronize()
    log(f"S3D int8: first predict_batch calibrated and scored in "
        f"{time.perf_counter() - t_cal:.2f} s: {len(ev8.engine.qparams)} convs quantized")
    zero_counts()
    s3d8_rate, s3d8_probs = clips_per_s(ev8, clips)
    s3d8_video = ev8.predict_video(clips[0])
    s3d8_eval = ev8.evaluate(mem)
    s3d8_launches = read_counts()
    log(f"S3D int8: predict_batch {S3D_BATCH} clips {s3d8_rate:.1f} clips/s (fp32 "
        f"{s3d_rate:.1f}); predict_video {s3d8_video:.6f}; evaluate {s3d8_eval}; "
        f"launches {s3d8_launches}")
    s3d8_scores = list(s3d8_probs) + [s3d8_video]
    if not (all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in s3d8_scores)
            and s3d8_eval["count"] == len(mem.samples)):
        raise AssertionError(f"S3D int8 scores {s3d8_scores} / evaluate {s3d8_eval}")
    if min(s3d8_launches[k] for k in ("K2", "K5", "K5_quantize", "K6")) <= 0:
        raise AssertionError(f"S3D int8: a kernel of the path never launched: {s3d8_launches}")
    forwards = s3d8_launches["K5"] / S3D_INT8_CALLS["conv"]
    if (s3d8_launches["K5_quantize"], s3d8_launches["K6"], s3d8_launches["K2_raw"],
            s3d8_launches["K2"]) != (
            forwards * S3D_INT8_CALLS["quantize"], forwards * S3D_INT8_CALLS["pool"],
            forwards * S3D_INT8_CALLS["raw"], forwards * S3D_INT8_CALLS["raw"]):
        raise AssertionError(f"S3D int8: launches {s3d8_launches} are not {forwards} forwards "
                             f"of {S3D_INT8_CALLS}")
    if profile:
        profile_forward(lambda: ev.predict_batch(clips), f"S3D fp32 predict_batch {S3D_BATCH}")
        profile_forward(lambda: ev8.predict_batch(clips), f"S3D int8 predict_batch {S3D_BATCH}",
                        expect=("conv_wgmma", "qwg::quantize_rows", "max_pool3d_i8_sep",
                                "normalize_table"))
    with torch.no_grad():
        x32 = torch.from_numpy(clips).to(dev).permute(0, 4, 1, 2, 3)      # uint8
        a, b = s3d(x32.float()).double(), ev8.engine(x32).double()
    checked = check_s3d_calls(ev8.engine, x32)
    log(f"S3D int8 forward at batch {S3D_BATCH} on the seeded clips: K2's raw entry and "
        f"every K5/K6 call bit-equal to their plain versions on the same clips and "
        f"activations: {checked}")
    if checked != S3D_INT8_CALLS:
        raise AssertionError(f"S3D int8: checked {checked}, not every call of a forward")
    del x32
    ac, bc = a - a.mean(), b - b.mean()
    log(f"S3D int8 vs fp32 logits on {S3D_BATCH} clips (information): max abs "
        f"{float((a - b).abs().max()):.4g} cosine {float((a * b).sum() / (a.norm() * b.norm())):.6f} "
        f"centred cosine {float((ac * bc).sum() / (ac.norm() * bc.norm())):.6f} "
        f"(|logit| max {float(a.abs().max()):.3g}, spread {float(a.max() - a.min()):.3g})")

    # ---- 14. full-width ca_s3d logits and features, card against CPU -------------
    u1 = torch.from_numpy(clips[:1]).permute(0, 4, 1, 2, 3)
    feats = {}
    for label, mod in (("fp32", s3d), ("int8", ev8.engine)):
        # as `S3DEvaluator` runs them: fp32 on the cast clip, int8 on the uint8 one
        one = u1.float() if label == "fp32" else u1
        cpu_mod = copy.deepcopy(mod).cpu()
        gpu_l, gpu_f = head_input(mod, one.to(dev))
        t_cpu = time.perf_counter()
        cpu_l, cpu_f = head_input(cpu_mod, one)
        t_cpu = time.perf_counter() - t_cpu
        gpu_l, gpu_f, cpu_f = gpu_l.cpu(), gpu_f.cpu().double(), cpu_f.double()
        feats[label] = gpu_f, cpu_f
        err = float((gpu_l - cpu_l).abs().max())
        log(f"full-width ca_s3d {label} logits card vs CPU ({t_cpu:.1f} s on the CPU): max abs "
            f"{err:.3g} (logit {float(cpu_l[0, 0]):.6g}); head input {tuple(cpu_f.shape)} error "
            f"norm / its norm {float((gpu_f - cpu_f).norm() / cpu_f.norm()):.3g}")
        if not (torch.isfinite(gpu_l).all() and err <= LOGIT_TOL):
            raise AssertionError(f"ca_s3d {label} logits differ: {err} > {LOGIT_TOL}")
    (g32, c32), (g8, c8) = feats["fp32"], feats["int8"]
    f32_err = float((g32 - c32).norm() / c32.norm())
    f8_err = float((g8 - c8).norm() / (c8 - c32).norm())
    log(f"ca_s3d head input card vs CPU: fp32 error {f32_err:.3g} of its norm (limit "
        f"{S3D_FP32_FEATURE_RTOL}); int8 error {f8_err:.3g} of the CPU's int8-vs-fp32 "
        f"difference (limit {S3D_INT8_FEATURE_RATIO}; that difference is "
        f"{float((c8 - c32).norm() / c32.norm()):.3g} of the fp32 norm)")
    if not (f32_err <= S3D_FP32_FEATURE_RTOL and f8_err <= S3D_INT8_FEATURE_RATIO):
        raise AssertionError(f"ca_s3d head input differs card vs CPU: fp32 {f32_err}, "
                             f"int8 {f8_err}")

    return dict(k5=k5, k6=k6, launches=s3d8_launches)


def crops_96(crops, dev) -> tuple:
    """A batch of QBATCH uint8 crops on the card (the 29 seeded crops
    repeated) and its legacy pos rows."""
    import torch
    u96 = torch.from_numpy(np.concatenate([crops] * 4)[:QBATCH]).to(dev)
    return u96, torch.arange(QBATCH, device=dev) % 32


def fp32_path(scorer, paths, crops, stacks, with_faces, name: str = "cvit",
              rates: dict = None) -> dict:
    """Phase 5 (base cvit), F1 (the flagship) and R2 (resvitkan):
    ``score_videos_batched`` over ``paths``, ``score_video`` over video_8,
    then the crops through ``score_crops`` and the stacks through
    ``score_crop_stacks``; scores in [0, 1], faces found where the synthetic
    face is and nowhere else, K1 and K2 launched (and K9, for a model with a
    KAN head). Returns the launches of K1 and K2 (and K9); ``rates``, if
    given, receives videos/min and the crops/s of both entries."""
    import torch
    from fac_fake_torch.detect import extractor as ex
    from fac_fake_torch.ops import kan
    from fac_fake_torch.ops import preprocess as pp
    tag = "" if name == "cvit" else f"{name} "
    scorer.enable_stage_stats()
    scorer.score_crops(crops)                    # warm cuDNN/cuBLAS before timing
    scorer.score_crop_stacks(stacks)
    torch.cuda.synchronize()

    ex.frame_detections.launches = 0
    pp.normalize_imagenet.launches = 0
    kan.kan_bases.launches = 0
    t0 = time.perf_counter()
    batched = scorer.score_videos_batched(paths)
    t_batched = time.perf_counter() - t0
    single = scorer.score_video("video_8")
    t1 = time.perf_counter()
    n_it = 10
    for _ in range(n_it):
        p_crops = scorer.score_crops(crops)
    torch.cuda.synchronize()
    t_crops = time.perf_counter() - t1
    t2 = time.perf_counter()
    for _ in range(n_it):
        p_stacks = scorer.score_crop_stacks(stacks)
    torch.cuda.synchronize()
    t_stacks = time.perf_counter() - t2
    launches = {"K1": ex.frame_detections.launches, "K2": pp.normalize_imagenet.launches}
    if name in KAN_MODELS:
        launches["K9"] = kan.kan_bases.launches

    log(f"{tag}videos (batched): scores {batched} faces "
        f"{[scorer.crop_counts[p] for p in paths]} "
        f"{len(paths) / t_batched * 60:.1f} videos/min ({t_batched:.2f} s)")
    log(f"{tag}video_8 (score_video): score {single} faces {scorer.crop_counts['video_8']}")
    log(f"{tag}stage stats: {json.dumps(scorer.stage_stats)}")
    log(f"{tag}score_crops {len(crops)} crops (capacity {scorer.capacity}): score {p_crops} "
        f"{len(crops) * n_it / t_crops:.1f} crops/s")
    log(f"{tag}score_crop_stacks {len(stacks)}x{len(crops)} crops: scores {p_stacks} "
        f"{len(stacks) * len(crops) * n_it / t_stacks:.1f} crops/s")
    log(f"{tag}main-path launches: {launches}")
    if rates is not None:
        rates.update(videos_per_min=len(paths) / t_batched * 60,
                     score_crops_per_s=len(crops) * n_it / t_crops,
                     score_crop_stacks_per_s=len(stacks) * len(crops) * n_it / t_stacks)
    probs = batched + [single, p_crops] + p_stacks
    if not all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in probs):
        raise AssertionError(f"{tag}scores out of [0, 1]: {probs}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{tag}a kernel of the path never launched: {launches}")
    found = {p: scorer.crop_counts[p] for p in paths + ["video_8"]}
    faces = [p for p in with_faces if p in found]
    if not (all(found[p] > 0 for p in faces)
            and all(found[p] == 0 for p in found if p not in with_faces)):
        raise AssertionError(f"faces found per video {found}; the synthetic face is "
                             f"in {with_faces} only")
    return launches


def logits_vs_cpu(model, four, what: str, plain: bool = False) -> float:
    """Phases 6 and 10 (and F2, F4): ``model``'s fp32 logits from the uint8
    crops ``four`` (on the CPU) on the card and on a copy of it on the CPU
    (``plain``: the kernels' plain versions run there), within LOGIT_TOL and
    finite."""
    import torch
    pos = torch.arange(four.shape[0])
    dev = model.cls_token.device
    with torch.inference_mode():
        gpu = model.forward_crops(four.to(dev), torch.float32, pos.to(dev)).cpu()
        t_cpu = time.perf_counter()
        cpu = copy.deepcopy(model).cpu().forward_crops(four, torch.float32, pos)
        t_cpu = time.perf_counter() - t_cpu
    err = float((gpu - cpu).abs().max())
    log(f"{what} card vs CPU ({'plain versions, ' if plain else ''}{t_cpu:.1f} s on the CPU): "
        f"max abs {err:.3g} (|logit| max {float(cpu.abs().max()):.3g})")
    if not (torch.isfinite(gpu).all() and err <= LOGIT_TOL):
        raise AssertionError(f"{what} differ: {err} > {LOGIT_TOL}")
    return err


def int8_modes(model, scorer, det, reader, crops, stacks, paths, fp32_rates, want,
               name: str = "cvit") -> tuple:
    """Phase 9 (base cvit) and F3 (the flagship): `VideoScorer` of ``model``
    with infer.quantize="int8_full" (it calibrates on its first batch) runs
    ``score_videos_batched`` over ``paths``, ``score_video``, ``score_crops``
    and ``score_crop_stacks``; then infer.quantize="int8" the last two. In
    each mode every stem's convs quantize, the launches are whole forwards
    of the planned walk, and one forward from the uint8 crops at batch
    QBATCH runs ``want`` (`forward_counts`; 26 K4 launches under
    int8_full); under int8_full every K3 call of one such forward, the
    quantize pass and K2's int8 entry are held bit-equal to their plain
    versions on the real crops and activations. int8 vs fp32 logits for
    information. Returns the int8_full launches and scorer."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.detect import extractor as ex
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    tag = "" if name == "cvit" else f"{name} "
    dev = scorer.device
    n_convs = sum(op[0] == "conv" for op in scorer.model.stem_ops())
    u96, pos96 = crops_96(crops, dev)
    for mode in ("int8_full", "int8"):
        qcfg = Config()
        qcfg.infer.quantize = mode
        qscorer = VideoScorer(model, qcfg, detector=det, reader=reader)
        t_cal = time.perf_counter()
        qscorer.score_crops(crops)           # the first batch of >= 8 crops calibrates
        torch.cuda.synchronize()
        n_q = sum(op[0] == "qconv" for op in qscorer.model.stem_ops())
        log(f"{tag}{mode}: first score_crops calibrated and scored in "
            f"{time.perf_counter() - t_cal:.2f} s: {n_q} convs quantized, "
            f"quant_dense={qscorer.model.quant_dense}")
        if qscorer._quant_pending or n_q != n_convs:
            raise AssertionError(f"{tag}{mode}: the first batch did not quantize the stems")
        qscorer.score_crop_stacks(stacks)    # warm up
        torch.cuda.synchronize()
        ex.frame_detections.launches = pp.normalize_imagenet.launches = 0
        q.int8_conv3x3.launches = q3.quantize_pad.launches = q.quant_dense.launches = 0
        pp.quantize_crops.launches = 0
        qprobs = []
        if mode == "int8_full":
            qscorer.enable_stage_stats()
            t0 = time.perf_counter()
            qprobs += qscorer.score_videos_batched(paths)
            t_q = time.perf_counter() - t0
            qprobs.append(qscorer.score_video("video_8"))
            log(f"{tag}{mode} videos (batched): scores {qprobs[:len(paths)]} "
                f"{len(paths) / t_q * 60:.1f} videos/min ({t_q:.2f} s); video_8 "
                f"{qprobs[-1]}; stage stats {json.dumps(qscorer.stage_stats)}")
        rates = crops_per_s(qscorer, crops, stacks)
        qprobs += [rates[2]] + rates[3]
        qlaunch = {"K1": ex.frame_detections.launches, "K2": pp.normalize_imagenet.launches,
                   "K2_int8": pp.quantize_crops.launches, "K3": q.int8_conv3x3.launches,
                   "K3_quantize": q3.quantize_pad.launches, "K4": q.quant_dense.launches}
        log(f"{tag}{mode}: score_crops {rates[0]:.1f} crops/s (fp32 {fp32_rates[0]:.1f}), "
            f"score_crop_stacks {rates[1]:.1f} crops/s (fp32 {fp32_rates[1]:.1f}); "
            f"launches {qlaunch}")
        if not all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in qprobs):
            raise AssertionError(f"{tag}{mode} scores out of [0, 1]: {qprobs}")
        need = ("K1", "K2", "K3", "K4") if mode == "int8_full" else ("K2", "K3")
        if min(qlaunch[k] for k in need) <= 0:
            raise AssertionError(f"{tag}{mode}: a kernel of the path never launched: {qlaunch}")
        walk = qscorer.model.walk_counts()
        fwd = qlaunch["K3"] // walk["convs"]
        if (qlaunch["K3"] % walk["convs"] or qlaunch["K3_quantize"] != fwd * walk["quantize"]
                or qlaunch["K2_int8"] != fwd * walk["k2_int8"]
                or qlaunch["K2"] != qlaunch["K2_int8"]):
            raise AssertionError(f"{tag}{mode}: launches {qlaunch} are not whole forwards of "
                                 f"the stems' walk from the crops {walk}")
        one = forward_counts(qscorer.model, u96, pos96)
        log(f"{tag}{mode}: one forward at batch {QBATCH} runs {one} (the stems' planned walk: "
            f"{walk})")
        want_one = dict({k: want[k] for k in FORWARD_KEYS},
                        K4=sum(INT8_DENSES.values()) if mode == "int8_full" else 0)
        if one != want_one or walk != want:
            raise AssertionError(f"{tag}{mode}: one forward ran {one}, the walk plans {walk}; "
                                 f"want {want_one}, {want}")
        if mode == "int8_full":
            full_launches, full = qlaunch, qscorer
            checked, no_relu = check_k3_calls(qscorer.model, u96, pos96)
            log(f"{tag}{mode} forward at batch {QBATCH} on the seeded crops: K2's int8 entry and "
                f"every K3 call bit-equal to the plain versions on the same crops and "
                f"activations: {checked}; the no-ReLU fused edges among them: {no_relu}")
            if checked != {k: want[k] for k in CHECKED_KEYS}:
                raise AssertionError(f"{tag}{mode}: checked {checked}, not every call of a "
                                     f"forward")
        with torch.inference_mode():
            u29 = torch.from_numpy(crops).to(dev)
            pos29 = torch.arange(29, device=dev)
            a = scorer.model.forward_crops(u29, torch.float32, pos29).double()
            b = qscorer.model.forward_crops(u29, torch.float32, pos29).double()
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        log(f"{tag}{mode} vs fp32 logits on 29 crops (information): max abs "
            f"{float((a - b).abs().max()):.4g} cosine {cos:.6f} "
            f"(|logit| max {float(a.abs().max()):.3g})")
    return full_launches, full


def flagship_phases(seed, rng, dev, det, reader, crops, stacks, paths, with_faces, four,
                    profile: bool = False) -> dict:
    """F1-F4: the flagship cvit_repbn8 at its published widths (seeded
    weights): F1 its fp32 path as phase 5 runs the base's (`fp32_path`);
    F2 its fp32 logits card vs CPU; F3 `int8_modes` with the flagship's walk
    (FLAGSHIP_INT8_WALK), and K3 at every distinct conv of that walk
    (`k3_phase`), with ``profile`` a breakdown of one fp32 and one int8_full
    forward; F4 its int8_full logits card vs CPU. Returns the launches of
    the fp32 and int8_full paths and K3's numbers on the walk."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model
    name = "cvit_repbn8"
    cfg = Config()
    cfg.model.name = name
    model = build_model(cfg.model, device=dev, seed=seed)
    scorer = VideoScorer(model, cfg, detector=det, reader=reader)
    launches = fp32_path(scorer, paths, crops, stacks, with_faces, name)
    logits_vs_cpu(scorer.model, four, f"{name} fp32 logits")
    fp32_rates = crops_per_s(scorer, crops, stacks)
    log(f"{name} fp32 beside the int8 runs: score_crops {fp32_rates[0]:.1f} crops/s, "
        f"score_crop_stacks {fp32_rates[1]:.1f} crops/s")
    int8_launches, full = int8_modes(model, scorer, det, reader, crops, stacks, paths,
                                     fp32_rates, FLAGSHIP_INT8_WALK, name)
    k3 = k3_phase(rng, dev, name)
    if profile:
        u96, pos96 = crops_96(crops, dev)
        profile_forward(lambda: scorer.model.forward_crops(u96, torch.float32, pos96),
                        f"{name} fp32 forward, batch {QBATCH}", expect=("normalize_table",))
        profile_forward(lambda: full.model.forward_crops(u96, torch.float32, pos96),
                        f"{name} int8_full forward, batch {QBATCH}",
                        expect=("dense_wgmma", "conv_wgmma", "qwg::quantize_rows",
                                "normalize_table"), absent=("qmma::",))
    logits_vs_cpu(full.model, four, f"{name} int8_full logits", plain=True)
    return dict(launches=launches, int8_launches=int8_launches, k3=k3)


def side_rng(rng):
    """A generator seeded from ``rng`` without advancing it: what a phase
    draws from it leaves the seeded inputs of the phases after it as they
    were."""
    return np.random.default_rng(int(copy.deepcopy(rng).integers(1 << 62)))


def k7_phase(rng, dev) -> dict:
    """T1: K7 (the strong_aug chain's CLAHE step) against its plain versions,
    bit-equal. The whole-batch entry `clahe_luma` at (8|32, 224, 224, 3) on
    seeded uint8-derived images, on a flat image (every bin clipped, the
    residual spread), on an image of every byte value, and at grid 1 (8x8
    and 120x120 images: tiles of 1 and 15 pixels); the chain's in-place
    entry `clahe_subset_` against `clahe_subset_plain_` at K7_SUBSETS: the
    trainer's (32 images, 8 takers, a budget of 8), over budget, a budget of
    n (JAX's where branch), grid 1 and a flat image, each also leaving its
    untaken images' bits. Timed at (8, 224, 224, 3) all taken, and at the
    trainer's step (`clahe_subset_` on 32 images, K7_TRAIN_TAKERS seeded
    takers, a budget of 8): cold (launches rotating over buffers beyond
    twice the L2; the subset entry works in place, so each buffer is
    equalized again each time it comes round), warm, the plain version, and
    torch ``copy_`` of the same bytes, cold (a yardstick, not the same
    function). The bound: bytes, each taken image read once and written
    once (and ``take``). The subset cases and the trainer's inputs draw
    from `side_rng`."""
    import torch
    from fac_fake_torch.ops import augment as aug
    d255 = torch.full((1,), 255.0, device=dev)
    to01 = lambda u8: (torch.from_numpy(u8).to(dev).float() / d255).contiguous()
    every = (np.arange(8 * 224 * 224 * 3) % 256).reshape(8, 224, 224, 3).astype(np.uint8)
    cases = [(f"seeded, batch {k}", rng.integers(0, 256, (k, 224, 224, 3), dtype=np.uint8))
             for k in K7_BATCHES]
    cases += [("flat", np.full((8, 224, 224, 3), 128, np.uint8)), ("every byte", every),
              ("grid 1, 1-px tiles", rng.integers(0, 256, (8, 8, 8, 3), dtype=np.uint8)),
              ("grid 1, 15-px tiles", rng.integers(0, 256, (8, 120, 120, 3), dtype=np.uint8))]
    err = 0.0
    for name, u8 in cases:
        x = to01(u8)
        got, ref = aug.clahe_luma(x), aug.clahe_luma_plain(x)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        err = max(err, e)
        if not torch.equal(got, ref):
            raise AssertionError(f"K7 {name} {tuple(x.shape)}: differs from plain by {e}")
        log(f"K7 clahe_luma {name} {tuple(x.shape)} grid {aug.clahe_grid(*x.shape[1:3])}: "
            f"bit-equal to plain")

    side = side_rng(rng)

    def seeded_take(n, takers):
        take = np.zeros(n, bool)
        take[side.choice(n, takers, replace=False)] = True
        return torch.from_numpy(take).to(dev)

    for name, (shape, takers, kb) in K7_SUBSETS.items():
        u8 = (np.full(shape, 128, np.uint8) if name == "flat"
              else side.integers(0, 256, shape, dtype=np.uint8))
        x, take = to01(u8), seeded_take(shape[0], takers)
        got = aug.clahe_subset_(x.clone(), take, kb)
        ref = aug.clahe_subset_plain_(x.clone(), take, kb)
        done = torch.zeros(shape[0], dtype=torch.bool, device=dev)
        done[torch.nonzero(take).flatten()[:kb]] = True
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        err = max(err, e)
        if not (torch.equal(got, ref) and torch.equal(got[~done], x[~done])):
            raise AssertionError(f"K7 clahe_subset_ {name} {shape}, {takers} takers, budget "
                                 f"{kb}: differs from plain by {e}, or an untaken image moved")
        log(f"K7 clahe_subset_ {name} {shape}, {takers} takers, budget {kb}: bit-equal to "
            f"plain, {int((~done).sum())} untaken images unchanged")

    x8 = to01(cases[0][1])
    nbytes = 2.0 * x8.numel() * 4
    n_rot = int(2 * L2_BYTES // nbytes) + 2
    rot = [x8] + [x8.clone() for _ in range(n_rot - 1)]
    k_ms = rotated_ms(aug.clahe_luma, rot)
    w_ms = cuda_ms(lambda: aug.clahe_luma(x8))
    pairs = [(torch.empty_like(x), x) for x in rot]
    c_ms = rotated_ms(lambda pair: pair[0].copy_(pair[1]), pairs)
    p_ms = cuda_ms(lambda: aug.clahe_luma_plain(x8), iters=3)
    del rot, pairs
    b_ms, b_by = bound_ms(nbytes, K7_OPS_PER_PIXEL * x8.numel() / 3)
    log(f"K7 at {tuple(x8.shape)}, all taken: kernel {k_ms:.4f} ms cold ({b_ms / k_ms:.1%} of "
        f"the bound, {n_rot} buffer pairs), {w_ms:.4f} ms warm; copy_ of the same bytes "
        f"{c_ms:.4f} ms cold; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.2f} MB)")

    # the trainer's step: 8 of 32 images taken, in place
    kb = 8
    x32 = to01(side.integers(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=np.uint8))
    take = seeded_take(TRAIN_BATCH, K7_TRAIN_TAKERS)
    taken = min(K7_TRAIN_TAKERS, kb)
    s_bytes = 2.0 * taken * x32[0].numel() * 4 + take.numel()
    n_rot = int(2 * L2_BYTES // (x32.numel() * 4)) + 2
    rot = [x32] + [x32.clone() for _ in range(n_rot - 1)]
    s_ms = rotated_ms(lambda x: aug.clahe_subset_(x, take, kb), rot)
    s_warm = cuda_ms(lambda: aug.clahe_subset_(x32, take, kb))
    s_plain = cuda_ms(lambda: aug.clahe_subset_plain_(x32, take, kb), iters=3)
    del rot
    sb_ms, sb_by = bound_ms(s_bytes, K7_OPS_PER_PIXEL * taken * x32[0].numel() / 3)
    log(f"K7 at the trainer's step, clahe_subset_ on {tuple(x32.shape)}, {K7_TRAIN_TAKERS} "
        f"takers, budget {kb}: kernel {s_ms:.4f} ms cold ({sb_ms / s_ms:.1%} of the bound, "
        f"{n_rot} buffers), {s_warm:.4f} ms warm; copy_ of the same bytes {c_ms:.4f} ms cold; "
        f"plain {s_plain:.4f} ms; bound {sb_ms:.4f} ms ({sb_by}, {s_bytes / 1e6:.2f} MB)")
    return dict(ms=k_ms, warm_ms=w_ms, copy_ms=c_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, err=err, subset_ms=s_ms, subset_warm_ms=s_warm,
                subset_plain_ms=s_plain, subset_bound_ms=sb_ms, subset_bound_by=sb_by)


def augment_phase(rng, dev) -> dict:
    """The strong_aug chain as the trainer runs it: `augment_batch` on
    (TRAIN_BATCH, 224, 224, 3) seeded uint8 crops with the default
    `AugmentConfig`, device ms a call (each call draws anew from one
    generator), and by the host's clock (``wall_ms``, the launches from
    Python included); ``augment_digest``: a digest of the outputs of generators
    seeded 0..AUGMENT_DIGEST_SEEDS-1 (a batch has a CLAHE taker with
    probability 0.77), equal across trees whose chains compute the same
    bits; the crops from `side_rng`. Calls nothing but `augment_batch` and
    `AugmentConfig`, so that `kernel_pairs --phase augment --phases-from .`
    runs it on a parent's tree too."""
    import torch
    from fac_fake_torch.core.config import AugmentConfig
    from fac_fake_torch.data.augment import augment_batch
    cfg = AugmentConfig()
    u8 = torch.from_numpy(side_rng(rng).integers(0, 256, (TRAIN_BATCH, 224, 224, 3),
                                                 dtype=np.uint8)).to(dev)
    outs = [augment_batch(u8, cfg, torch.Generator(device=dev).manual_seed(s))
            for s in range(AUGMENT_DIGEST_SEEDS)]
    dig = digest(torch.stack(outs))
    del outs
    gen = torch.Generator(device=dev).manual_seed(0)
    # device time: few enough calls that the host has queued them all before
    # the sleep ends (a call is some 200 launches from Python)
    ms = cuda_ms(lambda: augment_batch(u8, cfg, gen), iters=AUGMENT_TIMED_CALLS, warmup=2)
    t0 = time.perf_counter()
    for _ in range(AUGMENT_TIMED_CALLS):
        augment_batch(u8, cfg, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / AUGMENT_TIMED_CALLS * 1e3
    log(f"augment_batch {tuple(u8.shape)}, the trainer's AugmentConfig: {ms:.4f} ms a call on "
        f"the card (queued behind a sleep), {wall:.4f} ms a call by the host's clock; digest "
        f"of {AUGMENT_DIGEST_SEEDS} seeded outputs {dig:.0f}")
    return dict(ms=ms, wall_ms=wall, augment_digest=dig)


def train_data(rng, face) -> tuple:
    """TRAIN_CROPS seeded uint8 crops (TRAIN_HW², 224) and seeded labels; the
    crops of label 1 carry the synthetic face (`synth_face`, upscaled to 128
    px) at a seeded place."""
    imgs = rng.integers(0, 256, (TRAIN_CROPS, TRAIN_HW, TRAIN_HW, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, TRAIN_CROPS).astype(np.int64)
    big = np.repeat(np.repeat(face, 2, axis=0), 2, axis=1)[:TRAIN_HW // 2, :TRAIN_HW // 2]
    side = big.shape[0]
    for i in np.flatnonzero(labels):
        y, x = rng.integers(0, TRAIN_HW - side + 1, 2)
        imgs[i, y:y + side, x:x + side] = big
    return imgs, labels


def _linear_norms(model) -> list:
    return [m for m in model.modules() if type(m).__name__ == "LinearNorm"]


def train_phase(name, seed, dev, data, profile: bool = False, ckpt_dir: str = "") -> tuple:
    """T2 (base cvit) and T4's first half (the flagship): `Trainer` at full
    width, batch TRAIN_BATCH, the default strong_aug chain and plateau
    schedule, seeded weights. The dataset cached on the card
    (`Trainer.cache_data`); one warm-up step, TRAIN_TIMED_STEPS timed steps
    (crops/s, ms a step, peak memory), one step traced (the device's busy
    share; K7's `clahe_subset` must be in it; with ``profile``, the top
    kernels, and an eval step that must run K2's normalize_table); then the
    main path, `fit` for one epoch with an eval pass, with the launch
    counts set to 0 before it: one K7 call a train step, one K2 fp32 launch
    an eval batch, finite losses; then TRAIN_FIXED_STEPS steps on one fixed
    batch with the augmentation off, whose last loss must be below its
    first. The flagship's LinearNorm ``iter`` must have fallen by the
    number of training forwards, and no ``warm`` below 0. Returns the
    numbers and the trained model."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import augment as aug
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.train.trainer import Trainer
    imgs, labels = data
    cfg = Config()
    cfg.model.name = name
    cfg.train.epochs = 1
    cfg.train.log_every = 0
    cfg.train.checkpoint_dir = ckpt_dir
    cfg.train.checkpoint_every = 1 if ckpt_dir else 0
    model = build_model(cfg.model, device=dev, seed=seed)
    tr = Trainer(model, cfg)
    n_train = TRAIN_CROPS - TRAIN_BATCH
    train = tr.cache_data(imgs[:n_train], labels[:n_train], TRAIN_BATCH)
    val = tr.cache_data(imgs[n_train:], labels[n_train:], TRAIN_BATCH)
    ones = torch.ones((TRAIN_BATCH,), device=dev)
    batch = lambda i: {"image": train.images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                       "label": train.labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], "mask": ones}
    gen = torch.Generator(device=dev).manual_seed(seed)
    lin = _linear_norms(model)
    iter0 = [int(m.iter) for m in lin]

    tr.train_step(batch(0), gen)                        # warm-up: cuDNN, cuBLAS, K7
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED_STEPS):
        tr.train_step(batch(i % train.steps), gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall, busy = profile_forward(lambda: tr.train_step(batch(0), gen),
                                 f"{name} train step, batch {TRAIN_BATCH}",
                                 top=12 if profile else 0, expect=("clahe_subset",),
                                 inference=False)
    if profile:
        vb = {"image": val.images, "label": val.labels, "mask": ones}
        profile_forward(lambda: tr.eval_step(vb), f"{name} eval step, batch {TRAIN_BATCH}",
                        expect=("normalize_table",))
    step_ms = dt / TRAIN_TIMED_STEPS * 1e3
    timing = dict(step_ms=step_ms, crops_per_s=TRAIN_BATCH * TRAIN_TIMED_STEPS / dt,
                  peak_gb=peak_gb, traced_wall_ms=wall, traced_busy_ms=busy,
                  traced_busy_share=busy / wall, busy_share=busy / step_ms)
    log(f"{name} training at batch {TRAIN_BATCH}: {timing['crops_per_s']:.1f} train crops/s, "
        f"{step_ms:.2f} ms a step ({TRAIN_TIMED_STEPS} steps after a warm-up step); one traced "
        f"step {wall:.2f} ms wall (the profiler's overhead in it), device busy {busy:.2f} ms: "
        f"{busy / wall:.1%} of the traced step, {busy / step_ms:.1%} of an untraced step; peak "
        f"memory {peak_gb:.2f} GB")

    aug.clahe_luma.launches = 0
    pp.normalize_imagenet.launches = 0
    steps0 = tr.step
    t0 = time.perf_counter()
    out = tr.fit(train, val)
    t_fit = time.perf_counter() - t0
    launches = {"K7": aug.clahe_luma.launches, "K2": pp.normalize_imagenet.launches}
    h = out["history"]
    fit_steps = tr.step - steps0
    log(f"{name} fit, 1 epoch of {fit_steps} steps and {val.steps} eval batch(es): "
        f"{t_fit:.2f} s; train loss {h['train_loss'][0]:.4f} acc {h['train_acc'][0]:.4f}, "
        f"val loss {h['val_loss'][0]:.4f} acc {h['val_acc'][0]:.4f}; launches {launches}")
    if not all(np.isfinite(h[k][0]) for k in ("train_loss", "val_loss")):
        raise AssertionError(f"{name}: losses not finite: {h}")
    if launches != {"K7": fit_steps, "K2": val.steps}:
        raise AssertionError(f"{name}: want 1 K7 call a train step ({fit_steps}) and 1 K2 "
                             f"launch an eval batch ({val.steps}), got {launches}")

    tr.cfg.data.augment.enabled = False
    fixed = batch(train.steps - 1)
    losses = [float(tr.train_step(fixed, gen)["loss"]) for _ in range(TRAIN_FIXED_STEPS)]
    tr.cfg.data.augment.enabled = True
    log(f"{name} {TRAIN_FIXED_STEPS} steps on one fixed batch, augmentation off: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the fixed-batch loss did not fall: {losses}")
    if lin:
        fell = [a - int(m.iter) for a, m in zip(iter0, lin)]
        warm = [int(m.warm) for m in lin]
        log(f"{name} LinearNorm: iter fell by {fell} over {tr.step} training forwards; "
            f"warm {warm}")
        if fell != [tr.step] * len(lin) or min(warm) < 0:
            raise AssertionError(f"{name}: LinearNorm counters {fell}, warm {warm}, "
                                 f"{tr.step} forwards")
    return dict(timing, launches=launches, fit_steps=fit_steps, eval_batches=val.steps,
                fixed_losses=losses, history={k: h[k] for k in ("train_loss", "val_loss")}), model


def _record_routes(model) -> tuple:
    """Hooks on ``model``'s 2x2 max-pools that record each forward's argmax
    indices; returns (the list they fill, the hooks)."""
    import torch.nn.functional as F
    routes = []
    hooks = [m.register_forward_hook(lambda m, i, o: routes.append(
        F.max_pool2d(i[0].detach(), 2, 2, return_indices=True)[1].cpu()))
        for m in model.modules() if type(m).__name__ == "MaxPool2d"]
    return routes, hooks


def _route_pools(model, routes) -> None:
    """``model``'s 2x2 max-pools take their values (and so their gradients)
    from ``routes``, in order: another device's choice at each window."""
    pools = [m for m in model.modules() if type(m).__name__ == "MaxPool2d"]
    if len(pools) != len(routes):
        raise AssertionError(f"{len(routes)} recorded pools for {len(pools)} max-pools")
    for m, idx in zip(pools, routes):
        m.forward = lambda x, idx=idx: x.flatten(2).gather(2, idx.to(x.device).flatten(2)) \
            .view(idx.shape)


def _f64_grads(model, b, routes) -> dict:
    """The float64 gradient of a training forward (augmentation off) of a
    CPU copy of ``model`` on ``b``, its max-pools routed by ``routes``."""
    import copy

    import torch
    from fac_fake_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from fac_fake_torch.train.losses import cross_entropy
    m = copy.deepcopy(model).cpu().double().train()
    _route_pools(m, routes)
    x = (b["image"].double() / 255.0 - torch.from_numpy(IMAGENET_MEAN).double()) \
        / torch.from_numpy(IMAGENET_STD).double()
    cross_entropy(m(x.permute(0, 3, 1, 2)), b["label"], b["mask"].double()).backward()
    return {k: p.grad.clone() for k, p in m.named_parameters()}


def train_vs_cpu(model, name, rng) -> dict:
    """T3 (base cvit) and T4's second half (the flagship): one train step at
    full width, batch TRAIN_CHECK_BATCH, augmentation off, TF32 off, from
    the same weights on the card and on the CPU, each with a fresh Adam:
    the loss, each parameter's gradient (relative L2), the BatchNorm
    running stats and LinearNorm's counters, and the parameters after the
    step, within the TRAIN_* tolerances; the card's gradient against the
    float64 one (`_f64_grads`). The CPU's max-pools take the card's argmax
    at every window (`_route_pools`): at full width a few windows hold a
    near-tie that the two devices' roundings break apart, and a gradient
    entry then goes elsewhere. The CPU's step with its own pools is printed
    beside it."""
    import copy

    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.train.trainer import Trainer
    cfg = Config()
    cfg.model.name = name
    cfg.data.augment.enabled = False
    cfg.train.checkpoint_dir = ""
    u8 = torch.from_numpy(rng.integers(0, 256, (TRAIN_CHECK_BATCH, TRAIN_HW, TRAIN_HW, 3),
                                       dtype=np.uint8))
    b = {"image": u8, "label": torch.arange(TRAIN_CHECK_BATCH) % 2,
         "mask": torch.ones(TRAIN_CHECK_BATCH)}
    dev = next(model.parameters()).device
    side, routes = {}, None
    for where in ("card", "cpu", "cpu_own_pools"):
        m = copy.deepcopy(model) if where == "card" else copy.deepcopy(model).cpu()
        if where == "cpu":
            _route_pools(m, routes)
        else:
            recorded, hooks = _record_routes(m)
        tr = Trainer(m, cfg, device=None if where == "card" else "cpu")
        d = dev if where == "card" else torch.device("cpu")
        t0 = time.perf_counter()
        met = tr.train_step({k: v.to(d) for k, v in b.items()},
                            torch.Generator(device=d).manual_seed(0))
        side[where] = dict(t=time.perf_counter() - t0, loss=float(met["loss"]),
                           grads={k: p.grad.double().cpu() for k, p in m.named_parameters()},
                           params={k: p.detach().double().cpu() for k, p in m.named_parameters()},
                           bufs={k: v.double().cpu() for k, v in m.named_buffers()})
        if where == "card":
            routes = recorded
        if where != "cpu":
            for h in hooks:
                h.remove()
        del m, tr
    c, g, own = side["cpu"], side["card"], side["cpu_own_pools"]
    g64 = _f64_grads(model, b, routes)
    norm = lambda d: float(sum((t ** 2).sum() for t in d.values())) ** 0.5
    total = norm(c["grads"])
    rel = lambda a, b: norm({k: a[k] - b[k] for k in b}) / norm(b)
    card_f64, cpu_f64 = rel(g["grads"], g64), rel(c["grads"], g64)
    loss_err = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    whole = rel(g["grads"], c["grads"])
    per, noise, left_out, p_err = {}, [], 0, 0.0
    for k, gc in c["grads"].items():
        gg = g["grads"][k]
        if float(g64[k].norm()) < 1e-8 * total:      # zero but for rounding
            noise.append(k)
            if max(float(gg.norm()), float(gc.norm())) >= 1e-4 * total:
                raise AssertionError(f"{name}: {k}'s gradient is zero in float64, "
                                     f"{float(gg.norm()) / total:.3g} of the norm on the card")
            left_out += gc.numel()
            continue
        per[k] = float((gg - gc).norm() / gc.norm())
        clear = (gc.abs() > 1e-5) & ((gg - gc).abs() < 0.1 * gc.abs())
        left_out += int((~clear).sum())
        if clear.any():
            p_err = max(p_err, float((g["params"][k] - c["params"][k])[clear].abs().max()))
    worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    stats = [k for k in c["bufs"] if k.endswith(("running_mean", "running_var", "warm", "iter"))]
    s_err = max(float(((g["bufs"][k] - c["bufs"][k]).abs()
                       / (TRAIN_STATS_ATOL + TRAIN_STATS_RTOL * c["bufs"][k].abs())).max())
                for k in stats)
    n = sum(t.numel() for t in c["params"].values())
    res = dict(loss_rel=loss_err, grad_rel=whole, grad_tensor_max=worst[0][1],
               card_vs_f64=card_f64, cpu_vs_f64=cpu_f64,
               stats_over_tol=s_err, param_max_abs=p_err, left_out=left_out, params=n,
               cpu_s=c["t"], own_pools_loss_rel=abs(g["loss"] - own["loss"]) / abs(own["loss"]),
               own_pools_grad_rel=rel(g["grads"], own["grads"]),
               pool_windows_routed_apart=sum(int((a != r).sum())
                                             for a, r in zip(routes, recorded)))
    log(f"{name} one train step card vs CPU, batch {TRAIN_CHECK_BATCH} (CPU {c['t']:.1f} s; "
        f"its max-pools routed as the card's): loss {g['loss']:.6f} / {c['loss']:.6f} (rel "
        f"{loss_err:.3g}, bound {TRAIN_LOSS_RTOL}); gradient rel L2 to the float64 one: card "
        f"{card_f64:.3g}, CPU {cpu_f64:.3g} (bound: card <= {TRAIN_GRAD_F64_RATIO} x CPU + "
        f"{TRAIN_GRAD_F64_SLACK}); card vs CPU gradient rel L2 {whole:.3g} (bound "
        f"{TRAIN_GRAD_RTOL}), worst tensors {[(k, round(v, 6)) for k, v in worst]} (bound "
        f"{TRAIN_GRAD_TENSOR_RTOL}), {len(noise)} rounding-noise tensors; running stats and "
        f"counters at {s_err:.3g} of their tolerance (rtol {TRAIN_STATS_RTOL}, atol "
        f"{TRAIN_STATS_ATOL}); parameters after the step max abs {p_err:.3g} (bound "
        f"{TRAIN_PARAM_ATOL}), {left_out} of {n} entries left out. With the CPU's own pools "
        f"({res['pool_windows_routed_apart']} windows routed apart): loss rel "
        f"{res['own_pools_loss_rel']:.3g}, gradient rel L2 {res['own_pools_grad_rel']:.3g} "
        f"(information)")
    if not (loss_err <= TRAIN_LOSS_RTOL and whole <= TRAIN_GRAD_RTOL
            and card_f64 <= TRAIN_GRAD_F64_RATIO * cpu_f64 + TRAIN_GRAD_F64_SLACK
            and worst[0][1] <= TRAIN_GRAD_TENSOR_RTOL and s_err <= 1.0
            and p_err <= TRAIN_PARAM_ATOL and left_out < 0.1 * n):
        raise AssertionError(f"{name}: one train step card vs CPU out of bounds: {res}")
    return res


# ---- M1-M3: MTCNN with K8, the MTCNN video path, the serving entry point -------------

def k8_planted(side) -> dict:
    """K8's planted cases, name -> (boxes, scores, valid, iou_thresh, mode,
    max_out) as numpy: exact score ties; a valid NaN score and a NaN box;
    zero-area and inverted boxes (+1 areas of 0 and below); none valid;
    max_out above the live count; the min denominator; max_out 0; and at the
    edges of K8's 32-candidate tiles (`k8_tile_planted`)."""
    def cells(n):
        x, y = side.integers(0, 40, n) * 2.0, side.integers(0, 30, n) * 2.0
        s = side.integers(10, 24, n).astype(np.float64)
        return np.stack([x, y, x + s, y + s], 1).astype(np.float32)

    b = cells(128)
    ties = (np.round(side.uniform(0, 1, 128) * 4) / 4).astype(np.float32)
    on = np.ones(128, bool)
    nan_b, nan_s = cells(64), side.uniform(0, 1, 64).astype(np.float32)
    nan_s[[3, 17, 40]] = np.nan
    nan_b[9] = [np.nan, 2.0, 20.0, 30.0]
    nan_s[9] = 0.99
    z_b, z_s = cells(64), side.uniform(0, 1, 64).astype(np.float32)
    z_b[5], z_b[6], z_b[7] = [10, 10, 9, 9], [30, 30, 20, 35], [4, 4, 4, 4]
    z_s[[5, 6, 7]] = [0.999, 0.998, 0.997]
    few = np.zeros(64, bool)
    few[[4, 30, 31, 60]] = True
    return {"exact ties, union": (b, ties, on, 0.3, "union", 128),
            "exact ties, min": (b, ties, on, 0.5, "min", 64),
            "NaN scores and box": (nan_b, nan_s, np.ones(64, bool), 0.5, "union", 64),
            "zero-area and inverted": (z_b, z_s, np.ones(64, bool), 0.5, "union", 64),
            "zero-area, min": (z_b, z_s, np.ones(64, bool), 0.5, "min", 64),
            "none valid": (z_b, z_s, np.zeros(64, bool), 0.7, "union", 32),
            "max_out above live": (z_b, z_s, few, 0.7, "union", 64),
            "max_out 0": (z_b, z_s, np.ones(64, bool), 0.7, "union", 0),
            **k8_tile_planted(side, cells)}


def k8_tile_planted(side, cells) -> dict:
    """K8's cases at the edges of its 32-candidate tiles: 31, 32 and 33 live
    (disjoint boxes: all survive); 1024 live with max_out 4; 28 NaN scores
    then 10 tied ones across the first tile boundary; one box that holds
    every other (min IoU 1); exactly max_out survivors (each box twice, +1
    px: the better of each pair); G = 3 calls, none / all / a few live."""
    def disjoint(n):
        c = np.arange(n)
        x, y = (c % 16) * 20.0, (c // 16) * 20.0
        return np.stack([x, y, x + 10, y + 10], 1).astype(np.float32)

    out = {}
    for n_live in (31, 32, 33):
        v = np.zeros(64, bool)
        v[side.permutation(64)[:n_live]] = True
        out[f"{n_live} live"] = (disjoint(64)[side.permutation(64)],
                                 side.uniform(0, 1, 64).astype(np.float32), v, 0.7, "union", 40)
    out["1024 live, max_out 4"] = (cells(1024), side.uniform(0, 1, 1024).astype(np.float32),
                                   np.ones(1024, bool), 0.7, "union", 4)
    s = (np.round(side.uniform(0, 1, 128) * 4) / 4).astype(np.float32)
    order = side.permutation(128)
    s[order[:28]], s[order[28:38]] = np.nan, 2.0
    out["NaN and ties across a tile"] = (cells(128), s, np.ones(128, bool), 0.5, "union", 128)
    b, s = cells(256), side.uniform(0, 1, 256).astype(np.float32)
    b[37], s[37] = [0, 0, 200, 200], 2.0
    out["one box suppresses all"] = (b, s, np.ones(256, bool), 0.7, "min", 64)
    d = disjoint(48)
    out["exactly max_out survivors"] = (np.concatenate([d, d + np.float32(1)]),
                                        side.uniform(0, 1, 96).astype(np.float32),
                                        np.ones(96, bool), 0.5, "union", 48)
    v = np.ones((3, 128), bool)
    v[0], v[2] = False, side.random(128) < 0.3
    out["G-batched, none and all live"] = (np.stack([cells(128) for _ in range(3)]),
                                           side.uniform(0, 1, (3, 128)).astype(np.float32), v,
                                           0.7, "union", 64)
    return out


def record_nms(fn) -> list:
    """Run ``fn`` with `ops.nms.hard_nms` rebound to a recorder: the calls
    (inputs cloned) and their results, in order."""
    from fac_fake_torch.ops import nms
    calls, wrapped = [], nms.hard_nms

    def rec(boxes, scores, valid, iou_thresh=0.7, mode="union", max_out=32):
        out = wrapped(boxes, scores, valid, iou_thresh, mode, max_out)
        calls.append(((boxes.clone(), scores.clone(), valid.clone(), iou_thresh, mode, max_out),
                      out))
        return out

    rec.launches = wrapped.launches
    nms.hard_nms = rec
    try:
        fn()
    finally:
        nms.hard_nms = wrapped
        wrapped.launches = rec.launches
    return calls


def k8_iou_tests(call) -> int:
    """The IoU tests one call's scan needs on its data: at each step with a
    live candidate left, one a live candidate (what the kernel tests)."""
    import torch
    from fac_fake_torch.ops import nms
    boxes, scores, valid, thr, mode, max_out = (x.cpu() if torch.is_tensor(x) else x
                                                for x in call)
    b = boxes.reshape(-1, boxes.shape[-2], 4)
    sc, va = scores.reshape(b.shape[:2]), valid.reshape(b.shape[:2])
    idx, _ = nms.hard_nms_plain(b, sc, va, thr, mode, max_out)
    tests = 0
    for g in range(b.shape[0]):
        s = torch.where(va[g], sc[g], float("-inf"))
        live = (s > float("-inf")) | torch.isnan(s)
        x1, y1, x2, y2 = b[g].unbind(-1)
        area = (x2 - x1 + 1) * (y2 - y1 + 1)
        for i in idx[g].tolist():
            if not bool(live.any()):
                break
            tests += int(live.sum())
            sb = b[g, i]
            inter = (torch.clamp(torch.minimum(sb[2], x2) - torch.maximum(sb[0], x1) + 1, min=0)
                     * torch.clamp(torch.minimum(sb[3], y2) - torch.maximum(sb[1], y1) + 1, min=0))
            den = torch.minimum(area[i], area) if mode == "min" else area[i] + area - inter
            live &= ~(inter / torch.clamp(den, min=1e-12) > thr)
            live[i] = False
    return tests


def k8_phase(rng, dev, det=None) -> dict:
    """M1: K8 against its plain version, bit-equal (idx and keep in every
    slot), on the real candidate sets of one `MTCNN.run` on a seeded
    1920x1080 frame at each of MTCNN_THRESHOLDS (its four calls a frame,
    recorded at the wrapper: 12 x 128 -> 128 union 0.5, 1536 -> 64 and
    64 -> 64 union 0.7, 64 -> 32 min 0.7) and on `k8_planted`. Timed as the
    (0, 0, 0) frame's four launches: cold (launches rotating over copies of
    the candidate sets beyond twice the L2), warm, and the plain version.
    The bound: the sets' bytes read once and idx/keep written once, and 16
    fp32 operations an IoU test that the scan needs on this data
    (`k8_iou_tests`). Beside it, the launch floor: 4 launches of a kernel
    that returns at once (``torch.cuda._sleep(0)``) on the same stream, which
    a latency-bound K8 approaches. The cold run and the floor time
    K8_COLD_FRAMES frames, and every K8 timing fails if the host paced it.
    ``det``: the MTCNN whose calls are recorded, a seeded one built on
    ``dev`` when not given. Inputs from `side_rng`."""
    import torch
    from fac_fake_torch.ops import nms
    if det is None:
        from fac_fake_torch.detect.mtcnn import MTCNN
        det = MTCNN(device=dev)
    side = side_rng(rng)
    frame = torch.from_numpy(side.integers(0, 256, (*MTCNN_HW, 3), dtype=np.uint8)).to(dev)
    before = det.thresholds
    real = {}
    for th in MTCNN_THRESHOLDS:
        det.thresholds = th
        real[th] = record_nms(lambda: det.run(frame))
    det.thresholds = before

    def check(name, args, out=None):
        idx, keep = nms.hard_nms(*args) if out is None else out
        pidx, pkeep = nms.hard_nms_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(idx, pidx) and torch.equal(keep, pkeep)):
            raise AssertionError(f"K8 {name}: idx/keep differ from the plain version in "
                                 f"{int((idx != pidx).sum())} / {int((keep != pkeep).sum())} "
                                 "slots")

    for th, calls in real.items():
        if len(calls) != 4:
            raise AssertionError(f"MTCNN.run made {len(calls)} K8 calls, expected 4")
        for k, (args, out) in enumerate(calls):
            check(f"real call {k} at thresholds {th}", args, out)
        desc = [f"{tuple(a[0].shape[:-1])}->{a[5]} {a[4]} {a[3]}: "
                f"{int(a[2].sum())} valid, {int(o[1].sum())} kept" for a, o in calls]
        log(f"M1 K8 real candidate sets of one 1080p frame, thresholds {th}: bit-equal to "
            f"plain; {'; '.join(desc)}")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for name, (b, s, v, thr, mode, mo) in k8_planted(side).items():
        check(name, (t(b), t(s), t(v), thr, mode, mo))
    log(f"M1 K8 planted cases bit-equal to plain: {', '.join(k8_planted(side_rng(rng)))}")

    run = lambda cs: [nms.hard_nms(*c) for c in cs]
    timed = {}
    for th, calls in real.items():
        args = [a for a, _ in calls]
        timed[th] = (cuda_ms(lambda: run(args), device_bound=True), args)
    calls = timed[(0.0, 0.0, 0.0)][1]
    # boxes, scores and valid read once; idx (int64) and keep written once
    nbytes = sum(a[0].numel() * 4 + a[1].numel() * 4 + a[2].numel()
                 + a[1].numel() // a[1].shape[-1] * a[5] * 9 for a in calls)
    n_rot = int(2 * L2_BYTES // nbytes) + 2
    rot = [calls] + [[(a[0].clone(), a[1].clone(), a[2].clone(), *a[3:]) for a in calls]
                     for _ in range(n_rot - 1)]
    cold = rotated_ms(run, rot, sleep_cycles=K8_COLD_SLEEP_CYCLES, iters=K8_COLD_FRAMES,
                      device_bound=True)
    del rot
    warm = timed[(0.0, 0.0, 0.0)][0]
    plain = cuda_ms(lambda: [nms.hard_nms_plain(*c) for c in calls], iters=2, warmup=1)
    floor = cuda_ms(lambda: [torch.cuda._sleep(0) for _ in calls], iters=K8_COLD_FRAMES,
                    sleep_cycles=K8_COLD_SLEEP_CYCLES, device_bound=True)
    tests = sum(k8_iou_tests(c) for c in calls)
    b_ms, b_by = bound_ms(nbytes, K8_OPS_PER_IOU * tests)
    log(f"M1 K8, one 1080p frame's 4 launches at thresholds (0, 0, 0): kernel {cold:.4f} ms "
        f"cold ({K8_COLD_FRAMES} frames of a turn over {n_rot} copies), {warm:.4f} ms warm "
        f"(at {MTCNN_THRESHOLDS[0]}: "
        f"{timed[MTCNN_THRESHOLDS[0]][0]:.4f} ms warm); plain {plain:.4f} ms; bound "
        f"{b_ms:.6f} ms ({b_by}: {nbytes / 1e3:.1f} KB, {tests} IoU tests); launch floor "
        f"{floor:.4f} ms (4 empty kernels)")
    return dict(ms=cold, warm_ms=warm, default_warm_ms=timed[MTCNN_THRESHOLDS[0]][0],
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, iou_tests=tests, nbytes=nbytes,
                launch_floor_ms=floor)


def mtcnn_vs_cpu(det, frame: np.ndarray) -> dict:
    """M2's card-vs-CPU check on one frame, the same weights: every P/R/O-net
    call of the card's cascade run again on the CPU on the same input (within
    MTCNN_NET_TOL), every stage patch (`_extract_patches`) made again on the
    CPU from the card's boxes (within MTCNN_PATCH_TOL on the 0-255 scale),
    every K8 call bit-equal to the plain version on the CPU on the same
    candidate set; and, for information, how many of the card's valid boxes
    have a CPU box with IoU >= 0.99 (a near-tie in the nets may flip a
    candidate, so this is no bar)."""
    import torch
    from fac_fake_torch.detect import mtcnn as M
    from fac_fake_torch.ops import nms
    cpu = M.MTCNN({k: v.cpu() for k, v in det.state_dict().items()}, thresholds=det.thresholds,
                  caps=det.caps, device="cpu")
    nets = {"pnet": [], "rnet": [], "onet": []}
    hooks = [getattr(det, n).register_forward_hook(
        lambda m, i, o, n=n: nets[n].append((i[0].clone(), o))) for n in nets]
    patches, extract = [], M._extract_patches

    def rec_patches(img, boxes, size):
        out = extract(img, boxes, size)
        patches.append((img, boxes.clone(), size, out))
        return out

    M._extract_patches = rec_patches
    x = torch.from_numpy(frame).to(det.device)
    try:
        calls = record_nms(lambda: det.run(x))
    finally:
        M._extract_patches = extract
        for h in hooks:
            h.remove()
    net_err = 0.0
    with torch.inference_mode():
        for n, recs in nets.items():
            for inp, out in recs:
                for a, b in zip(getattr(cpu, n)(inp.cpu()), out):
                    net_err = max(net_err, float((a - b.cpu()).abs().max()))
        patch_err = max(float((extract(img.cpu(), boxes.cpu(), size) - out.cpu()).abs().max())
                        * 128.0 for img, boxes, size, out in patches)
    for k, (args, (idx, keep)) in enumerate(calls):
        pidx, pkeep = nms.hard_nms_plain(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        if not (torch.equal(idx.cpu(), pidx) and torch.equal(keep.cpu(), pkeep)):
            raise AssertionError(f"M2 K8 call {k}: the card's idx/keep differ from the plain "
                                 "version on the CPU")
    if net_err > MTCNN_NET_TOL or patch_err > MTCNN_PATCH_TOL:
        raise AssertionError(f"M2 card vs CPU: nets {net_err:.3g} (bar {MTCNN_NET_TOL}), "
                             f"patches {patch_err:.3g} (bar {MTCNN_PATCH_TOL})")
    g, c = det.detect(frame), cpu.detect(frame)
    agree = 0
    cb = c[0][c[3]]
    for b in g[0][g[3]]:
        if len(cb):
            ix = np.clip(np.minimum(b[2], cb[:, 2]) - np.maximum(b[0], cb[:, 0]) + 1, 0, None)
            iy = np.clip(np.minimum(b[3], cb[:, 3]) - np.maximum(b[1], cb[:, 1]) + 1, 0, None)
            area = lambda q: (q[..., 2] - q[..., 0] + 1) * (q[..., 3] - q[..., 1] + 1)
            iou = ix * iy / (area(b) + area(cb) - ix * iy)
            agree += int(iou.max() >= 0.99)
    n_nets = sum(len(r) for r in nets.values())
    log(f"M2 card vs CPU, one 1080p frame, thresholds {det.thresholds}: {n_nets} net calls "
        f"max abs {net_err:.3g} (bar {MTCNN_NET_TOL}); {len(patches)} patch stacks max abs "
        f"{patch_err:.3g} on 0-255 (bar {MTCNN_PATCH_TOL}); {len(calls)} K8 calls bit-equal "
        f"to plain on the CPU; valid boxes card {int(g[3].sum())}, CPU {int(c[3].sum())}, "
        f"{agree} of the card's with a CPU box at IoU >= 0.99 (reported, no bar)")
    return dict(net_err=net_err, patch_err=patch_err, agree=agree,
                valid_card=int(g[3].sum()), valid_cpu=int(c[3].sum()))


def mtcnn_path(seed, dev, reader) -> tuple:
    """M2: `VideoScorer` with the full-width base `cvit` (seeded) and
    infer.detector="mtcnn" (the seeded MTCNN it builds on the card) over the
    in-memory reader's 9 videos: `score_videos_batched` over 8 and
    `score_video` over 1, at each of MTCNN_THRESHOLDS (seeded nets may pass
    nothing at the real preset; at (0, 0, 0) every capacity slot is live and
    crops come out). Each run: K8 launched 4 times a detected frame, scores
    in [0, 1]; the (0, 0, 0) run must find faces and launch K2. Then the
    card-vs-CPU check on one frame (`mtcnn_vs_cpu`). Returns the scorer (at
    (0, 0, 0)) and the runs' numbers."""
    import threading

    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.detect.mtcnn import MTCNN
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import nms
    from fac_fake_torch.ops import preprocess as pp
    cfg = Config()
    cfg.infer.detector = "mtcnn"
    scorer = VideoScorer(build_model(cfg.model, device=dev, seed=seed), cfg, reader=reader)
    det = scorer.detector
    if not (isinstance(det, MTCNN) and det.device.type == dev.type):
        raise AssertionError(f"infer.detector=mtcnn built {type(det).__name__} on "
                             f"{getattr(det, 'device', None)}")
    seen = {"frames": 0, "faces": 0}
    lock = threading.Lock()
    detect = det.detect

    def counted(img):
        out = detect(img)
        with lock:
            seen["frames"] += 1
            seen["faces"] += int(out[3].sum())
        return out

    det.detect = counted
    scorer.score_crops(np.zeros((29, 224, 224, 3), np.uint8))     # warm cuDNN / cuBLAS
    det.detect(reader.frame("video_0", 0))
    torch.cuda.synchronize()
    paths = [f"video_{i}" for i in range(8)]
    runs = {}
    for th in MTCNN_THRESHOLDS:
        det.thresholds = th
        seen.update(frames=0, faces=0)
        nms.hard_nms.launches = 0
        pp.normalize_imagenet.launches = 0
        stats = scorer.enable_stage_stats()
        t0 = time.perf_counter()
        batched = scorer.score_videos_batched(paths)
        t_b = time.perf_counter() - t0
        single = scorer.score_video("video_8")
        t_s = time.perf_counter() - t0 - t_b
        launches = {"K8": nms.hard_nms.launches, "K2": pp.normalize_imagenet.launches}
        n = seen["frames"]
        crops = {p: scorer.crop_counts[p] for p in paths + ["video_8"]}
        run = dict(launches=launches, frames=n, faces_per_frame=seen["faces"] / max(n, 1),
                   crops=crops, videos_per_min=len(paths) / t_b * 60,
                   video_8_s=t_s, detect_s_per_frame=stats["detect_s"] / max(n, 1),
                   scores=batched + [single])
        log(f"M2 MTCNN path, thresholds {th}: videos (batched) {len(paths) / t_b * 60:.1f} "
            f"videos/min ({t_b:.2f} s), video_8 {t_s:.2f} s; {n} frames detected, "
            f"{run['faces_per_frame']:.2f} faces a frame, crops {list(crops.values())}; "
            f"detect {run['detect_s_per_frame'] * 1e3:.2f} ms a frame (summed over the "
            f"scorer's threads); launches {launches}; "
            f"scores {run['scores']}")
        one = reader.frame("video_0", 3)
        t1 = time.perf_counter()
        for _ in range(MTCNN_ALONE_CALLS):
            detect(one)
        run["detect_alone_ms"] = (time.perf_counter() - t1) / MTCNN_ALONE_CALLS * 1e3
        log(f"M2 one frame's detect alone (no other thread), thresholds {th}: "
            f"{run['detect_alone_ms']:.2f} ms a frame over {MTCNN_ALONE_CALLS} calls")
        if n == 0 or launches["K8"] != 4 * n:
            raise AssertionError(f"M2 thresholds {th}: {launches['K8']} K8 launches for {n} "
                                 "detected frames, expected 4 a frame")
        if not all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in run["scores"]):
            raise AssertionError(f"M2 scores out of [0, 1]: {run['scores']}")
        runs[th] = run
    full = runs[(0.0, 0.0, 0.0)]
    if full["launches"]["K2"] <= 0 or sum(full["crops"].values()) == 0:
        raise AssertionError(f"M2 at (0, 0, 0): no crops or no K2 launch: {full}")
    del det.detect
    vs_cpu = mtcnn_vs_cpu(det, reader.frame("video_0", 0))
    return scorer, dict(runs=runs, vs_cpu=vs_cpu)


def serve_phase(scorer) -> dict:
    """M3: `cli/serve.serve` on loopback with M2's scorer (MTCNN at (0, 0, 0)):
    GET /health; GET /score?path= for 3 placeholder files whose names the
    in-memory reader knows, each prob equal to `score_video` on the same
    path (within SERVE_PROB_TOL; the JSON float round-trips exactly); a 400
    (no path) and a 404. POST needs cv2 to decode and is left to the CPU
    tests."""
    import threading
    import urllib.error
    import urllib.request

    from fac_fake_torch.cli import serve as srv

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=300) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in (1, 4, 7):
            paths.append(os.path.join(tmp, f"video_{i}"))
            with open(paths[-1], "wb") as fh:
                fh.write(b"placeholder: the in-memory reader makes this video's frames")
        ready, box = threading.Event(), []
        t = threading.Thread(target=srv.serve, args=(
            ["--port", "0", "--no-warmup", "--set", "infer.detector=mtcnn"],),
            kwargs=dict(scorer=scorer, ready_event=ready, server_box=box), daemon=True)
        t.start()
        if not ready.wait(60):
            raise AssertionError("M3: the server did not start")
        base = f"http://127.0.0.1:{box[0].server_address[1]}"
        try:
            code, health = get(f"{base}/health")
            if code != 200 or health.get("status") != "ok":
                raise AssertionError(f"M3 /health: {code} {health}")
            lat = []
            for p in paths:
                code, r = get(f"{base}/score?path={p}")
                want = scorer.score_video(p)
                log(f"M3 GET /score {os.path.basename(p)}: {code} prob {r.get('prob')} "
                    f"label {r.get('label')} crops {r.get('num_crops')} latency_s "
                    f"{r.get('latency_s')}; score_video {want}")
                if code != 200 or abs(r["prob"] - want) > SERVE_PROB_TOL:
                    raise AssertionError(f"M3 /score {p}: {code} {r}, score_video {want}")
                lat.append(r["latency_s"])
            c400, _ = get(f"{base}/score")
            c404, _ = get(f"{base}/nothing")
            log(f"M3 GET /score with no path: {c400}; GET /nothing: {c404}")
            if (c400, c404) != (400, 404):
                raise AssertionError(f"M3 error codes {c400}, {c404}: expected 400, 404")
            out = dict(latency_s=lat, health=health)
        finally:
            box[0].shutdown()
            t.join(30)
    return out


def k9_grid(rng, case: str, n_in: int) -> np.ndarray:
    """(in, 12) fp32 knots: the default grid; a sorted per-feature
    perturbation of it (non-uniform, as a refit leaves it; drawn here, since
    the card's machine has no JAX for `update_grid`); the default with
    feature 1's knots 4 and 5 equal (a repeated knot: 0/0 = NaN); knots 0.25
    apart with knot 5 at +0 on even features and -0 on odd ones; the default
    with feature 1's knots 4 and 5 swapped (unsorted); the default with
    feature 1's knot 6 +inf, feature 2's knot 0 -inf and feature 3's knot 3
    NaN; knots 1e-30 apart around 0. A feature whose knots are repeated,
    swapped or non-finite takes K9's full recursion; on the others a finite
    in-range x takes its fast path."""
    from fac_fake_torch.models.blocks.kan import default_grid
    g = default_grid(n_in, K9_GRID_SIZE, K9_ORDER)
    n_knots = g.shape[1]
    if case == "nonuniform":
        h = 2.0 / K9_GRID_SIZE
        g = np.sort(g + rng.uniform(-0.45 * h, 0.45 * h, g.shape).astype(np.float32), axis=1)
    elif case == "repeated":
        g = g.copy()
        g[1, 5] = g[1, 4]
    elif case == "zero_knot":
        g = np.tile((np.arange(n_knots, dtype=np.float32) - 5) * np.float32(0.25), (n_in, 1))
        g[1::2, 5] = -0.0
    elif case == "swapped":
        g = g.copy()
        g[1, [4, 5]] = g[1, [5, 4]]
    elif case == "nonfinite":
        g = g.copy()
        g[1, 6], g[2, 0], g[3, 3] = np.inf, -np.inf, np.nan
    elif case == "tiny":
        g = np.tile(((np.arange(n_knots) - 5.5) * 1e-30).astype(np.float32), (n_in, 1))
    return g


def k9_x(rng, grid: np.ndarray, rows: int, extreme: bool = False) -> np.ndarray:
    """(rows, in) fp32 over the grid's span and 0.3 beyond it, with planted
    rows: each knot exactly, below the first, at the last, one ulp past it,
    +0.0, -0.0; with ``extreme``, then +-1e38, +-inf and NaN."""
    n_in = grid.shape[0]
    with np.errstate(invalid="ignore", over="ignore"):
        lo, hi = grid[:, 0] - 0.3, grid[:, -1] + 0.3
        x = (lo + (hi - lo) * rng.random((rows, n_in))).astype(np.float32)
    x[~np.isfinite(x)] = 0.5                # a non-finite knot's feature
    planted = [grid[:, j] for j in range(grid.shape[1])] + [
        grid[:, 0] - 0.5, grid[:, -1], np.nextafter(grid[:, -1], np.float32(np.inf)),
        np.zeros(n_in), np.full(n_in, -0.0)]
    if extreme:
        planted += [np.full(n_in, v) for v in (1e38, -1e38, np.inf, -np.inf, np.nan)]
    for r, p in enumerate(planted[:rows]):
        x[r] = p
    return x


def same_bits(a, b) -> bool:
    """Bit-equal, with NaN equal only where both are NaN."""
    import torch
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a[~nan].view(ints), b[~nan].view(ints))


def k9_phase(rng, dev) -> dict:
    """R1: K9 (KAN's B-spline bases) against its plain version, bit-equal (NaN
    where both are NaN) in fp32 and bf16, at every K9_SHAPES on each of
    K9_GRIDS, x planted on every knot, below the first, at and past the
    last, at +-0; at (96, 64) on each grid with x also at +-1e38, +-inf and
    NaN. Timed at one resvitkan forward's 2 launches at capacity 96 ((96,
    2048), (96, 64), fp32): cold (launches rotating over buffers beyond twice
    the L2), warm, bf16 warm, the plain version, and torch ``copy_`` of the
    outputs' bytes, cold (a yardstick, not the same function). The bound:
    bytes, x and the grid read once and the bases written once. Inputs from
    `side_rng`."""
    import torch
    from fac_fake_torch.ops import kan
    side = side_rng(rng)
    cases = [(shape, case, False) for shape in K9_SHAPES for case in K9_GRIDS]
    cases += [(K9_SHAPES[1], case, True) for case in K9_GRIDS]
    calls = 0
    for shape, case, extreme in cases:
        g = k9_grid(side, case, shape[1])
        x = k9_x(side, g, shape[0], extreme)
        for dt in (torch.float32, torch.bfloat16):
            xt, gt = torch.from_numpy(x).to(dev, dt), torch.from_numpy(g).to(dev, dt)
            got = kan.kan_bases(xt, gt, K9_ORDER)
            ref = kan.kan_bases_plain(xt, gt, K9_ORDER)
            torch.cuda.synchronize()
            nan = bool(torch.isnan(ref).any())
            if not same_bits(got, ref) or nan != (extreme or case in K9_NAN_GRIDS):
                raise AssertionError(f"K9 {shape} {case} {dt} (extreme x: {extreme}): differs "
                                     f"from plain (NaN in plain: {nan})")
            calls += 1
    log(f"K9 kan_bases: bit-equal to plain in fp32 and bf16 at {list(K9_SHAPES)} on the "
        f"{', '.join(K9_GRIDS)} grids, x planted on every knot, below the first, at and "
        f"past the last, at +-0; at {K9_SHAPES[1]} with x at +-1e38, +-inf and NaN on each "
        f"grid ({calls} calls)")
    # K9 has no backward: a grad-tracked input raises, and launches nothing
    xg = torch.rand((4, 6), device=dev, requires_grad=True)
    gg = torch.from_numpy(k9_grid(side, "default", 6)).to(dev)
    before = kan.kan_bases.launches
    try:
        kan.kan_bases(xg, gg, K9_ORDER)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    if "no backward" not in raised or kan.kan_bases.launches != before:
        raise AssertionError(f"K9 on a grad-tracked input: raised {raised!r}, launches "
                             f"{kan.kan_bases.launches - before}")
    log(f"K9 on a grad-tracked CUDA input with grad mode on: raises ({raised})")

    dims = K9_SHAPES[:2]

    def forward_inputs(dt):
        pairs = []
        for b, n in dims:
            g = k9_grid(side, "nonuniform", n)
            pairs.append((torch.from_numpy(k9_x(side, g, b)).to(dev, dt),
                          torch.from_numpy(g).to(dev, dt)))
        return pairs

    launch = lambda pairs: [kan.kan_bases(x, g, K9_ORDER) for x, g in pairs]
    fwd = forward_inputs(torch.float32)
    n_out = K9_GRID_SIZE + K9_ORDER
    out_bytes = sum(b * n * n_out * 4 for b, n in dims)
    nbytes = out_bytes + sum((x.numel() + g.numel()) * 4 for x, g in fwd)
    n_rot = int(2 * L2_BYTES // nbytes) + 2
    rot = [fwd] + [[(x.clone(), g.clone()) for x, g in fwd] for _ in range(n_rot - 1)]
    k_ms = rotated_ms(launch, rot)
    w_ms = cuda_ms(lambda: launch(fwd))
    bf = forward_inputs(torch.bfloat16)
    bf_ms = cuda_ms(lambda: launch(bf))
    p_ms = cuda_ms(lambda: [kan.kan_bases_plain(x, g, K9_ORDER) for x, g in fwd], iters=5)
    pairs = [[(torch.empty(b, n, n_out, device=dev), torch.rand(b, n, n_out, device=dev))
              for b, n in dims] for _ in range(n_rot)]
    c_ms = rotated_ms(lambda ps: [o.copy_(i) for o, i in ps], pairs)
    del rot, pairs
    b_ms, b_by = bound_ms(nbytes, K9_OPS_PER_FEATURE * sum(b * n for b, n in dims))
    log(f"K9 at one resvitkan forward's 2 launches {list(dims)}: kernel {k_ms:.4f} ms cold "
        f"({b_ms / k_ms:.1%} of the bound, {n_rot} buffer sets), {w_ms:.4f} ms warm, bf16 "
        f"{bf_ms:.4f} ms warm; copy_ of the outputs' bytes {c_ms:.4f} ms cold; plain "
        f"{p_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
    return dict(ms=k_ms, warm_ms=w_ms, bf16_warm_ms=bf_ms, plain_ms=p_ms, copy_ms=c_ms,
                bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, calls=calls)


def resvitkan_path(seed, rng, dev, det, reader, paths, with_faces, base_k2: int) -> dict:
    """R2: `VideoScorer` with the full-width resvitkan (vendored ResNet-50,
    patch 7, dim 1024, depth 6, heads 8, mlp 2048, KAN (2048, 64, 2); seeded
    weights) and the packaged BlazeFace over the in-memory videos, as phase
    5 (`fp32_path`: videos/min, crops/s of both entries); K2 launched as
    often as on the base path and K9 twice as often; one forward from the
    crops at capacity 96 runs 1 K2 and 2 K9 launches; logits card vs CPU;
    `score_crops` equal to `score_crop_stacks` per video (STACK_TOL); a bf16
    run (`model.dtype=bfloat16`) with finite scores. Crops from
    `side_rng`."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import kan
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.train.trainer import Trainer
    name, hw = "resvitkan", RESVIT_HW
    side = side_rng(rng)
    crops = side.integers(0, 256, (29, hw, hw, 3), dtype=np.uint8)
    stacks = [side.integers(0, 256, (29, hw, hw, 3), dtype=np.uint8) for _ in range(8)]
    four = torch.from_numpy(side.integers(0, 256, (4, hw, hw, 3), dtype=np.uint8))

    def config(dtype="float32"):
        cfg = Config()
        cfg.model.name, cfg.model.dtype, cfg.data.image_size = name, dtype, hw
        return cfg

    cfg = config()
    scorer = VideoScorer(build_model(cfg.model, device=dev, seed=seed), cfg, detector=det,
                         reader=reader)
    rates = {}
    launches = fp32_path(scorer, paths, crops, stacks, with_faces, name, rates)
    if launches["K2"] != base_k2 or launches["K9"] != 2 * launches["K2"]:
        raise AssertionError(f"{name} path launches {launches}: want K2 {base_k2} (the base "
                             "path's) and K9 twice K2")
    u96, pos96 = crops_96(crops, dev)
    pp.normalize_imagenet.launches = kan.kan_bases.launches = 0
    with torch.inference_mode():
        scorer.model.forward_crops(u96, torch.float32, pos96)
    torch.cuda.synchronize()
    per_forward = {"K2": pp.normalize_imagenet.launches, "K9": kan.kan_bases.launches}
    log(f"{name} one forward from the crops, batch {QBATCH}: launches {per_forward}")
    if per_forward != {"K2": 1, "K9": 2}:
        raise AssertionError(f"{name} forward launches {per_forward}: want K2 1, K9 2")
    logit_err = logits_vs_cpu(scorer.model, four, f"{name} fp32 logits")
    per_video = [scorer.score_crops(s) for s in stacks]
    packed = scorer.score_crop_stacks(stacks)
    stack_diff = max(abs(a - b) for a, b in zip(per_video, packed))
    log(f"{name} score_crops vs score_crop_stacks, 8 videos: max abs {stack_diff:.3g}")
    if stack_diff > STACK_TOL:
        raise AssertionError(f"{name} score_crops differs from score_crop_stacks by "
                             f"{stack_diff} > {STACK_TOL}")
    try:                                           # K9 has no backward
        Trainer(scorer.model, cfg, device=dev)
        refused = ""
    except ValueError as e:
        refused = str(e)
    log(f"{name}: Trainer refuses it: {refused}")
    if "KANLinear" not in refused:
        raise AssertionError(f"Trainer took {name}, whose KAN head K9 cannot train")
    bf = VideoScorer(scorer.model, config("bfloat16"), detector=det, reader=reader)
    kan.kan_bases.launches = 0
    bf_probs = [bf.score_crops(crops)] + bf.score_crop_stacks(stacks)
    torch.cuda.synchronize()
    bf_k9 = kan.kan_bases.launches
    fp_probs = [scorer.score_crops(crops)] + packed
    bf_diff = max(abs(a - b) for a, b in zip(bf_probs, fp_probs))
    log(f"{name} bf16 score_crops and score_crop_stacks: {bf_probs}; max abs against fp32 "
        f"{bf_diff:.3g}; K9 launches {bf_k9}")
    if not all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in bf_probs) or bf_k9 != 4:
        raise AssertionError(f"{name} bf16 scores {bf_probs}, K9 launches {bf_k9} (want 4)")
    return dict(launches=launches, per_forward=per_forward, logit_err=logit_err,
                stack_diff=stack_diff, bf16_diff=bf_diff, **rates)


def family_forwards(seed, rng, dev) -> dict:
    """R3: the full-width reskan (ResNet-34, KAN (512, 64, 2)) at batch 96
    and resvit (ResNet-18, MLP head) at batch 4, 224², seeded: logits card
    vs CPU within LOGIT_TOL, K9 launched twice by reskan's forward and never
    by resvit's. Inputs from `side_rng`."""
    import torch
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import kan
    from fac_fake_torch.ops import preprocess as pp
    side = side_rng(rng)
    u8 = torch.from_numpy(side.integers(0, 256, (RESKAN_BATCH, RESVIT_HW, RESVIT_HW, 3),
                                        dtype=np.uint8))
    model = build_model(ModelConfig(name="reskan"), device=dev, seed=seed)
    x = pp.normalize_imagenet(u8.to(dev))
    kan.kan_bases.launches = 0
    with torch.inference_mode():
        gpu = model(x).cpu()
        torch.cuda.synchronize()
        k9_reskan = kan.kan_bases.launches
        t_cpu = time.perf_counter()
        cpu = copy.deepcopy(model).cpu()(x.cpu())
        t_cpu = time.perf_counter() - t_cpu
    err_reskan = float((gpu - cpu).abs().max())
    log(f"reskan logits, batch {RESKAN_BATCH}, card vs CPU ({t_cpu:.1f} s on the CPU): max abs "
        f"{err_reskan:.3g} (|logit| max {float(cpu.abs().max()):.3g}); K9 launches {k9_reskan}")
    if not (torch.isfinite(gpu).all() and err_reskan <= LOGIT_TOL and k9_reskan == 2):
        raise AssertionError(f"reskan: logits differ by {err_reskan} > {LOGIT_TOL}, or K9 "
                             f"launched {k9_reskan} times (want 2)")
    del model
    model = build_model(ModelConfig(name="resvit", image_size=RESVIT_HW), device=dev, seed=seed)
    four = torch.from_numpy(side.integers(0, 256, (RESVIT_BATCH, RESVIT_HW, RESVIT_HW, 3),
                                          dtype=np.uint8))
    kan.kan_bases.launches = 0
    err_resvit = logits_vs_cpu(model, four, f"resvit logits, batch {RESVIT_BATCH},")
    if kan.kan_bases.launches != 0:
        raise AssertionError(f"resvit launched K9 {kan.kan_bases.launches} times")
    return dict(reskan_err=err_reskan, reskan_k9=k9_reskan, resvit_err=err_resvit)



# ---- S1-S5: S3D training with K10 ---------------------------------------------------

def k10_frames(side, dev, n: int, kind: str, hw=(224, 224)):
    """(n, *hw, 3) float32 frames in [0, 1]: ``noise`` (uniform bytes),
    ``smooth`` (seeded 8x8 colour fields, bilinearly upsampled, with a little
    noise: what natural frames look like to the DCT), ``flat`` (one grey) or
    ``every byte`` (each channel runs through the 256 byte values)."""
    import torch
    import torch.nn.functional as F
    d255 = torch.full((1,), 255.0, device=dev)
    if kind == "noise":
        u8 = side.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
    elif kind == "smooth":
        low = torch.from_numpy(side.uniform(0.0, 255.0, (n, 3, 8, 8)).astype(np.float32))
        up = F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
        up = up + torch.from_numpy(side.normal(0.0, 4.0, up.shape).astype(np.float32))
        u8 = up.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()
    elif kind == "flat":
        u8 = np.full((n, *hw, 3), 128, np.uint8)
    else:
        i = np.arange(n * hw[0] * hw[1])
        u8 = np.stack([i % 256, (i * 7 + 3) % 256, (i * 31 + 11) % 256], -1)
        u8 = u8.reshape(n, *hw, 3).astype(np.uint8)
    return (torch.from_numpy(np.ascontiguousarray(u8)).to(dev).float() / d255).contiguous()


def k10_check(x, take, q, what: str) -> float:
    """K10 (`jpeg_subset_`) against `jpeg_subset_plain_` on a copy of ``x``
    each: every frame equal bit for bit (the untaken ones also to ``x``).
    Returns the largest difference (0)."""
    import torch
    from fac_fake_torch.ops import jpeg as oj
    got = oj.jpeg_subset_(x.clone(), take, q)
    ref = oj.jpeg_subset_plain_(x.clone(), take, q)
    torch.cuda.synchronize()
    if not torch.equal(got[~take], x[~take]):
        raise AssertionError(f"K10 {what}: an untaken frame moved")
    if not torch.equal(got[take], ref[take]):
        diff = (got != ref).any(-1)
        raise AssertionError(f"K10 {what}: {int(diff.sum())} pixels differ from the plain "
                             f"version, max {float((got - ref).abs().max()):.3g}")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def k10_phase(rng, dev) -> dict:
    """S1: K10 (the S3D transform's JPEG step, in place on the taken frames)
    against its plain version `jpeg_subset_plain_` on the card, bit for bit:
    first its division (`division_check`: no float x and divisor whose
    quotient differs from IEEE's), then seeded noise and smooth frames, a
    flat frame and an every-byte frame, at qualities K10_QUALITIES and at
    seeded floor(U[60, 100)); takes none, all, and a seeded ~20%; then
    K10_GEOMETRIES, the cases of the grid's
    work items (one frame, only the last frame, all of plan1_2's step,
    several chunks a band, one narrow chunk, a ragged last chunk). Untaken
    frames bit-unchanged. Timed at the trainer's step, (K10_FRAMES, 224,
    224, 3) with K10_TAKEN taken: cold (launches rotating over buffers
    beyond twice the L2), warm, the plain version, and copy_ of the taken
    frames' bytes (a yardstick; no PyTorch call computes this function);
    ``k10_digest``: a digest of K10's output on that input. The bound: bytes,
    each taken frame read once and written once. Inputs from `side_rng`."""
    import torch
    from fac_fake_torch.ops import jpeg as oj
    side = side_rng(rng)
    t0 = time.perf_counter()
    div_bad = oj.division_check(dev)
    log(f"K10's division (quantize, unit) against IEEE over all 2^32 floats and divisors "
        f"1..255: {div_bad} results differ ({time.perf_counter() - t0:.2f} s)")
    if div_bad:
        raise AssertionError(f"K10's division differs from IEEE's in {div_bad} results")
    n = 16
    takes = {"none": torch.zeros(n, dtype=torch.bool, device=dev),
             "all": torch.ones(n, dtype=torch.bool, device=dev),
             "seeded 20%": torch.from_numpy(side.random(n) < 0.2).to(dev)}
    takes["seeded 20%"][side.integers(0, n)] = True          # at least one
    err = 0.0
    for kind in ("noise", "smooth", "flat", "every byte"):
        x = k10_frames(side, dev, n, kind)
        quals = [(f"quality {q}", torch.full((n,), float(q), device=dev)) for q in K10_QUALITIES]
        quals.append(("trainer", torch.from_numpy(np.floor(
            side.uniform(60.0, 100.0, n)).astype(np.float32)).to(dev)))
        for qname, q in quals:
            for tname, take in takes.items():
                err = max(err, k10_check(x, take, q, f"{kind}, {qname}, take {tname}"))
        log(f"K10 {kind} frames, qualities {K10_QUALITIES} and the trainer's floor(U[60, 100)) "
            f"x {len(takes)} take patterns: bit-equal to plain, untaken frames bit-unchanged")
    for shape, how in K10_GEOMETRIES:
        n = shape[0]
        x = k10_frames(side, dev, n, "noise", shape[1:3])
        take = np.ones(n, bool) if how == "all" else np.arange(n) == n - 1
        if how == "seeded":
            take = side.random(n) < 0.5
            take[side.integers(0, n)] = True
        q = torch.from_numpy(np.floor(side.uniform(1.0, 100.0, n)).astype(np.float32)).to(dev)
        err = max(err, k10_check(x, torch.from_numpy(take).to(dev), q, f"{shape} take {how}"))
        bands, chunks, mcus = oj.band_chunks(*shape[1:3])
        log(f"K10 {shape}, {int(take.sum())} taken ({how}), {bands} bands of {chunks} chunk(s) "
            f"of <= {mcus} MCUs: bit-equal to plain")
        del x

    # timing at the trainer's step: plan1_2's 12 x 30 frames, K10_TAKEN taken
    xs = k10_frames(side, dev, K10_FRAMES, "smooth")
    take = torch.zeros(K10_FRAMES, dtype=torch.bool, device=dev)
    take[torch.from_numpy(side.choice(K10_FRAMES, K10_TAKEN, replace=False)).to(dev)] = True
    q = torch.from_numpy(np.floor(side.uniform(60.0, 100.0, K10_FRAMES)).astype(np.float32)
                         ).to(dev)
    dig = digest(oj.jpeg_subset_(xs.clone(), take, q))
    frame_bytes = xs[0].numel() * 4
    nbytes = 2.0 * K10_TAKEN * frame_bytes
    n_rot = int(2 * L2_BYTES // (K10_TAKEN * frame_bytes)) + 2
    rot = [xs] + [xs.clone() for _ in range(n_rot - 1)]
    k_ms = rotated_ms(lambda x: oj.jpeg_subset_(x, take, q), rot)
    w_ms = cuda_ms(lambda: oj.jpeg_subset_(xs, take, q))
    idx = torch.nonzero(take).flatten()
    pairs = [(torch.empty((K10_TAKEN, 224, 224, 3), device=dev), x.index_select(0, idx))
             for x in rot]
    c_ms = rotated_ms(lambda pair: pair[0].copy_(pair[1]), pairs)
    p_ms = cuda_ms(lambda: oj.jpeg_subset_plain_(xs, take, q), iters=3)
    del rot, pairs
    # operations: per pixel the colour transforms (~30) and 4 DCT passes of 16
    # flops a coefficient over 1.5 planes' worth of coefficients
    b_ms, b_by = bound_ms(nbytes, K10_TAKEN * 224 * 224 * (30 + 4 * 16 * 1.5))
    log(f"K10 at ({K10_FRAMES}, 224, 224, 3), {K10_TAKEN} taken: kernel {k_ms:.4f} ms cold "
        f"({b_ms / k_ms:.1%} of the bound, {n_rot} buffers), {w_ms:.4f} ms warm; copy_ of "
        f"the taken frames' bytes {c_ms:.4f} ms cold; plain {p_ms:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); digest {dig:.0f}")
    return dict(ms=k_ms, warm_ms=w_ms, copy_ms=c_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, err=err, k10_digest=dig, div_bad=div_bad)


def s3d_augment_phase(rng, dev) -> dict:
    """S2: the S3D train transform as the trainer runs it: `augment_batch`
    under ``load_plan("configs/plan1_2.yaml")``'s augment config on
    (12, 30, 224, 224, 3) seeded uint8 clips: one K10 launch a call, a
    finite output in [0, 1], a digest of the outputs of generators seeded
    0..AUGMENT_DIGEST_SEEDS-1; device ms a call and ms by the host's
    clock. Inputs from `side_rng`."""
    import torch
    from fac_fake_torch.core.plans import load_plan
    from fac_fake_torch.data.augment import augment_batch
    from fac_fake_torch.ops import jpeg as oj
    plan = load_plan("configs/plan1_2.yaml")
    cfg, bs, t = plan.data.augment, plan.data.batch_size, plan.data.frames_per_video
    u8 = torch.from_numpy(side_rng(rng).integers(0, 256, (bs, t, 224, 224, 3),
                                                 dtype=np.uint8)).to(dev)
    oj.jpeg_subset_.launches = 0
    outs = [augment_batch(u8, cfg, torch.Generator(device=dev).manual_seed(s))
            for s in range(AUGMENT_DIGEST_SEEDS)]
    launches = oj.jpeg_subset_.launches
    dig = digest(torch.stack(outs))
    lo, hi = min(float(o.min()) for o in outs), max(float(o.max()) for o in outs)
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    del outs
    if launches != AUGMENT_DIGEST_SEEDS or not finite or lo < 0.0 or hi > 1.0:
        raise AssertionError(f"S3D augment_batch: {launches} K10 launches for "
                             f"{AUGMENT_DIGEST_SEEDS} calls, finite {finite}, range [{lo}, {hi}]")
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = cuda_ms(lambda: augment_batch(u8, cfg, gen), iters=AUGMENT_TIMED_CALLS, warmup=2)
    t0 = time.perf_counter()
    for _ in range(AUGMENT_TIMED_CALLS):
        augment_batch(u8, cfg, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / AUGMENT_TIMED_CALLS * 1e3
    log(f"S3D augment_batch {tuple(u8.shape)}, plan1_2's transform: 1 K10 launch a call, "
        f"output finite in [{lo:.3g}, {hi:.3g}]; {ms:.4f} ms a call on the card (queued behind "
        f"a sleep), {wall:.4f} ms a call by the host's clock; digest of "
        f"{AUGMENT_DIGEST_SEEDS} seeded outputs {dig:.0f}")
    return dict(ms=ms, wall_ms=wall, augment_digest=dig)


def masked_face_clips(side, det, face, n: int, t: int, hw: int) -> tuple:
    """``n`` seeded uint8 clips (t, hw, hw, 3) of `synth_face` frames (the
    face enlarged to 4/7 of the frame, 128 px at 224, at a seeded place on a
    grey, lightly noisy background,
    one place a clip), each frame masked black on the host as
    ``ClipDataset.mask_frame`` does, the landmarks from the port's BlazeFace
    on the card (`landmarks_from_blazeface`, one detection a clip), the
    region order a clip from the generator. Returns (clips, frames whose
    landmarks were found)."""
    from fac_fake_torch.data import masking
    from fac_fake_torch.ops.resize import resize_area
    fh = hw * 4 // 7
    face = resize_area(face, (fh, fh))
    clips = np.empty((n, t, hw, hw, 3), np.uint8)
    found = 0
    for i in range(n):
        y, x = side.integers(0, hw - fh + 1, 2)
        base = np.clip(128 + side.normal(0.0, 10.0, (hw, hw, 3)), 0, 255).astype(np.uint8)
        base[y:y + fh, x:x + fh] = face
        lm = masking.landmarks_from_blazeface(det, base)
        found += lm is not None
        order = side.permutation(8).tolist()
        for j in range(t):
            noisy = np.clip(base.astype(np.int16) + side.integers(-3, 4, base.shape), 0, 255)
            clips[i, j] = masking.apply_face_mask(noisy.astype(np.uint8), lm, order, "black",
                                                  6, side)
    return clips, found


def s3d_train_phase(seed, rng, dev, det, face, profile: bool = False) -> dict:
    """S3: `Trainer` on clip batches cached on the card, at each plan of
    S3D_PLANS at its published batch and frames (``s3d`` from plan1_2, the
    S3D transform on, so K10 once a step; ``ca_s3d`` from caplan9, black
    masking of 6 regions on `synth_face` frames, on the host; ``msca_s3d``
    from mplan1), seeded weights, raw 0-255 inputs, bce_weighted with the
    plans' rebalancing: one warm-up step, S3D_TIMED_STEPS timed steps (train
    clips/s, ms a step, peak memory), one traced step (the device's busy
    share; K10's ``jpeg_bands`` in it where the transform is on), K10
    launches a step; `fit` for one epoch of S3D_FIT_STEPS steps and one
    eval batch with the counts set to 0 before it (K10 launched once a train
    step with aug on, never with it off); S3D_FIXED_STEPS steps on one fixed
    batch, augmentation off, whose last loss must be below its first; one
    eval batch. Inputs from `side_rng`."""
    import torch
    from fac_fake_torch.core.plans import load_plan
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import jpeg as oj
    from fac_fake_torch.train.trainer import Trainer
    side = side_rng(rng)
    out = {}
    for name, plan in S3D_PLANS:
        cfg = load_plan(plan)
        cfg.data.normalize = "raw255"
        cfg.model.image_size = S3D_TRAIN_HW
        cfg.train.epochs = 1
        cfg.train.log_every = 0
        cfg.train.checkpoint_dir = ""
        cfg.train.checkpoint_every = 0
        bs, t = cfg.data.batch_size, cfg.data.frames_per_video
        n = bs * (S3D_FIT_STEPS + 1)
        if cfg.data.mask_method == "black":
            clips, found = masked_face_clips(side, det, face, n, t, S3D_TRAIN_HW)
            if found < n:
                raise AssertionError(f"{name}: BlazeFace found the face in {found} of {n} clips")
        else:
            clips = side.integers(0, 256, (n, t, S3D_TRAIN_HW, S3D_TRAIN_HW, 3), dtype=np.uint8)
            found = 0
        labels = np.arange(n) % 2
        pw = cfg.train.rebalance_real / cfg.train.rebalance_fake      # balanced labels
        torch.cuda.empty_cache()
        model = build_model(cfg.model, device=dev, seed=seed)
        tr = Trainer(model, cfg, loss_kwargs={"pos_weight": pw})
        train = tr.cache_data(clips[:bs * S3D_FIT_STEPS], labels[:bs * S3D_FIT_STEPS], bs)
        val = tr.cache_data(clips[bs * S3D_FIT_STEPS:], labels[bs * S3D_FIT_STEPS:], bs)
        del clips
        ones = torch.ones((bs,), device=dev)
        batch = lambda i: {"image": train.images[i * bs:(i + 1) * bs],
                           "label": train.labels[i * bs:(i + 1) * bs], "mask": ones}
        gen = torch.Generator(device=dev).manual_seed(seed)
        aug_on = cfg.data.augment.enabled
        tr.train_step(batch(0), gen)                     # warm-up: cuDNN, cuBLAS, K10
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        oj.jpeg_subset_.launches = 0
        t0 = time.perf_counter()
        for i in range(S3D_TIMED_STEPS):
            tr.train_step(batch(i % train.steps), gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_step = oj.jpeg_subset_.launches / S3D_TIMED_STEPS
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wall, busy = profile_forward(lambda: tr.train_step(batch(0), gen),
                                     f"{name} train step, batch {bs}", top=12 if profile else 0,
                                     expect=("jpeg_bands",) if aug_on else (), inference=False)
        step_ms = dt / S3D_TIMED_STEPS * 1e3
        res = dict(plan=plan, batch=bs, frames=t, step_ms=step_ms,
                   clips_per_s=bs * S3D_TIMED_STEPS / dt, peak_gb=peak_gb,
                   traced_wall_ms=wall, traced_busy_ms=busy, busy_share=busy / step_ms,
                   k10_per_step=per_step, augment=aug_on, mask=cfg.data.mask_method,
                   faces_found=found)
        log(f"{name} training ({plan}, batch {bs} x {t} x {S3D_TRAIN_HW}^2, aug {aug_on}, mask "
            f"{cfg.data.mask_method}): {res['clips_per_s']:.2f} train clips/s, {step_ms:.1f} ms "
            f"a step ({S3D_TIMED_STEPS} steps after a warm-up step); one traced step "
            f"{wall:.1f} ms wall, device busy {busy:.1f} ms ({busy / step_ms:.1%} of an "
            f"untraced step); peak memory {peak_gb:.2f} GB; K10 {per_step:g} a step")
        if per_step != (1 if aug_on else 0):
            raise AssertionError(f"{name}: K10 {per_step} a step, aug {aug_on}")

        oj.jpeg_subset_.launches = 0
        steps0 = tr.step
        t0 = time.perf_counter()
        fit = tr.fit(train, val)
        t_fit = time.perf_counter() - t0
        fit_steps = tr.step - steps0
        h = fit["history"]
        res["fit_launches"] = {"K10": oj.jpeg_subset_.launches}
        res["fit_steps"] = fit_steps
        log(f"{name} fit, 1 epoch of {fit_steps} steps and {val.steps} eval batch: "
            f"{t_fit:.1f} s; train loss {h['train_loss'][0]:.4f}, val loss "
            f"{h['val_loss'][0]:.4f} acc {h['val_acc'][0]:.4f}; K10 launches "
            f"{oj.jpeg_subset_.launches}")
        if not all(np.isfinite(h[k][0]) for k in ("train_loss", "val_loss")):
            raise AssertionError(f"{name}: losses not finite: {h}")
        if oj.jpeg_subset_.launches != (fit_steps if aug_on else 0):
            raise AssertionError(f"{name}: {oj.jpeg_subset_.launches} K10 launches in "
                                 f"{fit_steps} steps, aug {aug_on}")

        tr.cfg.data.augment.enabled = False
        fixed = batch(0)
        losses = [float(tr.train_step(fixed, gen)["loss"]) for _ in range(S3D_FIXED_STEPS)]
        tr.cfg.data.augment.enabled = aug_on
        ev = tr.eval_step({"image": val.images, "label": val.labels, "mask": ones})
        ev = {k: float(v) for k, v in ev.items()}
        res.update(fixed_losses=losses, eval_batch=ev)
        log(f"{name} {S3D_FIXED_STEPS} steps on one fixed batch, augmentation off: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; one eval batch {ev}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and np.isfinite(ev["loss"]) and ev["count"] == bs):
            raise AssertionError(f"{name}: fixed-batch losses {losses}, eval {ev}")
        out[name] = res
        del tr, model, train, val
    torch.cuda.empty_cache()
    return out


def s3d_train_vs_cpu(seed, rng, dev) -> dict:
    """S4: one train step of ``ca_s3d`` and ``msca_s3d`` at full width, batch
    S3D_CHECK_BATCH, S3D_CHECK_T frames (the fewest the head takes) at 224^2,
    augmentation off, TF32 off, from the same seeded weights and clips on
    the card and on the CPU: the loss within S3D_LOSS_RTOL; the gradient
    held to the float64 one of a CPU copy (the card's distance within
    TRAIN_GRAD_F64_RATIO x the CPU fp32's + TRAIN_GRAD_F64_SLACK, relative
    L2); each running-stat tensor card vs CPU elementwise within
    S3D_STATS_RTOL of the CPU's value + S3D_STATS_ATOL (the two fp32
    forwards are some 1e-5 apart, and a deep layer's batch mean carries that
    into its running mean; a mean that is zero but for rounding needs the
    atol), and held to the float64 step's as the gradient is (within
    TRAIN_GRAD_F64_RATIO x the CPU's distance + S3D_STATS_F64_SLACK). The
    atol each tensor would need at S3D_STATS_RTOL is printed. Inputs from
    `side_rng`."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.models import build_model
    from fac_fake_torch.train.trainer import Trainer
    side = side_rng(rng)
    out = {}
    for name in ("ca_s3d", "msca_s3d"):
        cfg = Config()
        cfg.model.name, cfg.model.num_class = name, 1
        cfg.data.normalize = "raw255"
        cfg.data.augment.enabled = False
        cfg.train.loss = "bce_weighted"
        cfg.train.checkpoint_dir = ""
        model = build_model(cfg.model, device="cpu", seed=seed)
        u8 = torch.from_numpy(side.integers(
            0, 256, (S3D_CHECK_BATCH, S3D_CHECK_T, S3D_TRAIN_HW, S3D_TRAIN_HW, 3), dtype=np.uint8))
        b = {"image": u8, "label": torch.arange(S3D_CHECK_BATCH) % 2,
             "mask": torch.ones(S3D_CHECK_BATCH)}
        side_res = {}
        for where, d, dt in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                             ("f64", "cpu", torch.float64)):
            m = copy.deepcopy(model).to(d if where != "f64" else "cpu")
            tr = Trainer(m, cfg, device=d, loss_kwargs={"pos_weight": 0.3})
            t0 = time.perf_counter()
            if where == "f64":
                m = m.double().train()
                x = tr.normalize(b["image"].double() / torch.full((1,), 255.0,
                                                                  dtype=torch.float64))
                loss = tr.loss_fn(m(x), b["label"], b["mask"].double())
                loss.backward()
                loss = float(loss.detach())
            else:
                met = tr.train_step({k: v.to(d) for k, v in b.items()},
                                    torch.Generator(device=d).manual_seed(0))
                loss = float(met["loss"])
            side_res[where] = dict(
                t=time.perf_counter() - t0, loss=loss,
                grads={k: p.grad.double().cpu() for k, p in m.named_parameters()},
                bufs={k: v.double().cpu() for k, v in m.named_buffers()
                      if k.endswith(("running_mean", "running_var"))})
            del m, tr
        g, c, f = side_res["card"], side_res["cpu"], side_res["f64"]
        norm = lambda dd: float(sum((t ** 2).sum() for t in dd.values())) ** 0.5
        rel = lambda a, bb: norm({k: a[k] - bb[k] for k in bb}) / norm(bb)
        rt = lambda a, bb: float((a - bb).norm() / bb.norm())
        # elementwise: the share of the tolerance used, and the atol needed at the rtol
        over = lambda a, bb: float(((a - bb).abs() / (S3D_STATS_RTOL * bb.abs()
                                                      + S3D_STATS_ATOL)).max())
        need = lambda a, bb: max(0.0, float(((a - bb).abs() - S3D_STATS_RTOL * bb.abs()).max()))
        gb, cb = g["bufs"], c["bufs"]
        res = dict(loss_rel=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
                   card_vs_f64=rel(g["grads"], f["grads"]), cpu_vs_f64=rel(c["grads"], f["grads"]),
                   card_vs_cpu=rel(g["grads"], c["grads"]),
                   stats_rel=max(rt(gb[k], cb[k]) for k in cb),
                   stats_worst=max(cb, key=lambda k: rt(gb[k], cb[k])),
                   stats_tol_share=max(over(gb[k], cb[k]) for k in cb),
                   stats_atol_needed={kind: max((need(gb[k], cb[k]) for k in cb
                                                 if k.endswith(kind)), default=0.0)
                                      for kind in ("running_mean", "running_var")},
                   stats_rel_by_kind={kind: max((rt(gb[k], cb[k]) for k in cb
                                                 if k.endswith(kind) and float(cb[k].norm())
                                                 > S3D_STATS_ATOL * cb[k].numel() ** 0.5),
                                                default=0.0)
                                      for kind in ("running_mean", "running_var")},
                   stats_f64_over=max((rt(gb[k], f["bufs"][k])
                                       - TRAIN_GRAD_F64_RATIO * rt(cb[k], f["bufs"][k]))
                                      / S3D_STATS_F64_SLACK for k in cb),
                   losses={k: v["loss"] for k, v in side_res.items()},
                   cpu_s=c["t"], f64_s=f["t"])
        log(f"{name} one train step card vs CPU, batch {S3D_CHECK_BATCH} x {S3D_CHECK_T} x "
            f"{S3D_TRAIN_HW}^2 (CPU {c['t']:.1f} s, float64 {f['t']:.1f} s): loss {g['loss']:.6f} / "
            f"{c['loss']:.6f} / float64 {f['loss']:.6f} (card vs CPU rel {res['loss_rel']:.3g}, "
            f"bound {S3D_LOSS_RTOL}); gradient rel L2 to the float64 one: card "
            f"{res['card_vs_f64']:.3g}, CPU {res['cpu_vs_f64']:.3g} (bound: card <= "
            f"{TRAIN_GRAD_F64_RATIO} x CPU + {TRAIN_GRAD_F64_SLACK}); card vs CPU "
            f"{res['card_vs_cpu']:.3g}; running stats card vs CPU at "
            f"{res['stats_tol_share']:.3g} of their tolerance (rtol {S3D_STATS_RTOL}, atol "
            f"{S3D_STATS_ATOL}; the atol needed at that rtol: {res['stats_atol_needed']}), worst "
            f"tensor rel L2 {res['stats_rel']:.3g} ({res['stats_worst']}), by kind above the "
            f"atol's floor {res['stats_rel_by_kind']}; each tensor's distance to the float64 "
            f"one within {TRAIN_GRAD_F64_RATIO} x the CPU's + {S3D_STATS_F64_SLACK} (at "
            f"{res['stats_f64_over']:.3g} of that slack)")
        if not (res["loss_rel"] <= S3D_LOSS_RTOL and res["stats_tol_share"] <= 1.0
                and res["stats_f64_over"] <= 1.0
                and res["card_vs_f64"] <= TRAIN_GRAD_F64_RATIO * res["cpu_vs_f64"]
                + TRAIN_GRAD_F64_SLACK):
            raise AssertionError(f"{name}: one train step card vs CPU out of bounds: {res}")
        out[name] = res
    return out


def msca_int8(name, model, clips, dev) -> dict:
    """S5's int8 half for one full-width msca model: `S3DEvaluator(quantize=
    "int8")` calibrated on two of ``clips``; the counts set to 0, then
    `predict_batch` of the S3D_BATCH clips twice (clips/s), the counts read:
    every launch a forward makes (`S3DInt8.walk_counts`: K5 convs, those with
    ReLU6, quantize passes, K6 pools, K2's raw entry without an SRM bank)
    times the forwards; one forward's calls recorded against those counts;
    every K5, K6 and K2 raw call of one forward from the uint8 clips
    bit-equal to its plain version on the same activations (ReLU6 and the
    fused quantize included) at batch S3D_CHECK_BATCH, and for msca_s3d at
    S3D_BATCH too; int8 vs fp32 logits at S3D_BATCH (information); logits
    card vs CPU at batch 1: fp32 within LOGIT_TOL (its head input's error
    printed); int8 free-running with the head input's error at most
    S3D_INT8_FEATURE_RATIO of the CPU's own int8-vs-fp32 difference (phase
    14's rule: a flipped step is legitimate there), and in lock-step
    (`int8_lockstep`) within LOGIT_TOL."""
    import torch
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3
    ev8 = S3DEvaluator(model, degrade=False, quantize="int8", device=dev)
    ev8.predict_batch(clips[:2])                   # calibrates on these two clips
    torch.cuda.synchronize()
    want = ev8.engine.walk_counts()
    q3.int8_conv3d.launches = q3.int8_conv3d.relu6_launches = 0
    q3.quantize_pad.launches = q3.max_pool3d_i8.launches = 0
    pp.quantize_clips.launches = pp.normalize_imagenet.launches = 0
    rate, probs = clips_per_s(ev8, clips, n_it=2)
    launches = {"K5": q3.int8_conv3d.launches, "K5_relu6": q3.int8_conv3d.relu6_launches,
                "K5_quantize": q3.quantize_pad.launches, "K6": q3.max_pool3d_i8.launches,
                "K2_raw": pp.quantize_clips.launches, "K2": pp.normalize_imagenet.launches}
    per = {"K5": want["conv"], "K5_relu6": want["relu6"], "K5_quantize": want["quantize"],
           "K6": want["pool"], "K2_raw": want["raw"], "K2": want["raw"]}
    forwards = launches["K5"] // want["conv"]
    log(f"S5 {name} int8 (SRM {model.srm}): predict_batch {S3D_BATCH} clips {rate:.2f} "
        f"clips/s; launches {launches} over {forwards} forwards; a forward: {want}")
    if forwards < 1 or any(launches[k] != forwards * v for k, v in per.items()) \
            or min(launches[k] for k in ("K5", "K5_relu6", "K5_quantize", "K6")) < 1 \
            or not (np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()):
        raise AssertionError(f"{name} int8: launches {launches}, want {per} a forward; "
                             f"scores {probs}")

    x2 = torch.from_numpy(clips[:S3D_CHECK_BATCH]).to(dev).permute(0, 4, 1, 2, 3)
    calls = record_s3d_calls(ev8.engine, x2)
    recorded = {"conv": sum(calls["conv"].values()),
                "fused": sum(c for key, c in calls["conv"].items() if key[-1]),
                "relu6": sum(c for key, c in calls["conv"].items() if key[4] == q3.ACT_RELU6),
                "quantize": sum(calls["quantize"].values()),
                "raw": sum(calls["raw"].values()), "pool": sum(calls["pool"].values())}
    if recorded != {k: want[k] for k in recorded}:
        raise AssertionError(f"{name} int8 forward recorded {recorded}, want {want}")
    checked = {}
    for batch in (S3D_CHECK_BATCH, S3D_BATCH) if name == "msca_s3d" else (S3D_CHECK_BATCH,):
        xb = torch.from_numpy(clips[:batch]).to(dev).permute(0, 4, 1, 2, 3)
        checked[batch] = check_s3d_calls(ev8.engine, xb)
        if checked[batch] != {k: want[k] for k in checked[batch]}:
            raise AssertionError(f"{name} int8: checked {checked[batch]} at batch {batch}, "
                                 f"not every call of a forward ({want})")
    log(f"S5 {name} int8 forward: {len(calls['conv'])} conv shapes; K2's raw entry and every "
        f"K5/K6 call bit-equal to their plain versions on the same clips and activations "
        f"(ReLU6 and fused epilogues included): {checked}")
    with torch.no_grad():
        x32 = torch.from_numpy(clips).to(dev).permute(0, 4, 1, 2, 3)
        a, b = model(x32.float()).double(), ev8.engine(x32).double()
    del x32
    ac, bc = a - a.mean(), b - b.mean()
    int8_vs_fp32 = float((a - b).abs().max())
    log(f"S5 {name} int8 vs fp32 logits on {S3D_BATCH} clips (information): max abs "
        f"{int8_vs_fp32:.4g} centred cosine "
        f"{float((ac * bc).sum() / (ac.norm() * bc.norm())):.6f} (|logit| max "
        f"{float(a.abs().max()):.3g}, spread {float(a.max() - a.min()):.3g})")

    u1 = torch.from_numpy(clips[:1]).permute(0, 4, 1, 2, 3)
    feats, errs = {}, {}
    for label, mod in (("fp32", model), ("int8", ev8.engine)):
        one = u1.float() if label == "fp32" else u1
        gpu_l, gpu_f = head_input(mod, one.to(dev))
        t_cpu = time.perf_counter()
        cpu_l, cpu_f = head_input(copy.deepcopy(mod).cpu(), one)
        t_cpu = time.perf_counter() - t_cpu
        gpu_l, gpu_f, cpu_f = gpu_l.cpu(), gpu_f.cpu().double(), cpu_f.double()
        feats[label] = gpu_f, cpu_f
        errs[label] = float((gpu_l - cpu_l).abs().max())
        log(f"S5 {name} {label} logits card vs CPU, batch 1 ({t_cpu:.1f} s on the CPU): max "
            f"abs {errs[label]:.3g} (logit {float(cpu_l[0, 0]):.6g})")
        if not torch.isfinite(gpu_l).all() or (label == "fp32" and errs[label] > LOGIT_TOL):
            raise AssertionError(f"{name} {label} logits differ: {errs[label]} > {LOGIT_TOL}")
    (g32, c32), (g8, c8) = feats["fp32"], feats["int8"]
    f32_err = float((g32 - c32).norm() / c32.norm())
    f8_err = float((g8 - c8).norm() / (c8 - c32).norm())
    # fp32: information (the iFormer blocks round further apart than
    # ca_s3d's layers: 1.8-2.7e-5 of the norm on an H100, ca_s3d's 7.7e-7);
    # fp32 is held by its logits above
    log(f"S5 {name} head input card vs CPU: fp32 error {f32_err:.3g} of its norm "
        f"(information); int8 error {f8_err:.3g} of the CPU's int8-vs-fp32 difference "
        f"(limit {S3D_INT8_FEATURE_RATIO}; that difference is "
        f"{float((c8 - c32).norm() / c32.norm()):.3g} of the fp32 norm)")
    if not f8_err <= S3D_INT8_FEATURE_RATIO:
        raise AssertionError(f"{name} int8 head input differs card vs CPU: {f8_err} of the "
                             f"int8-vs-fp32 difference")
    lock = int8_lockstep(ev8.engine, u1, dev)
    log(f"S5 {name} int8 card vs CPU in lock-step (the CPU's walk fed the card's fp-block "
        f"and SRM outputs, each within {lock['block_err']:.3g} of the CPU's own, bound "
        f"{S3D_FP_BLOCK_RTOL}, of its largest value): logits max abs {lock['logit_err']:.3g} "
        f"(bound {LOGIT_TOL}); free-running, above: {errs['int8']:.3g}")
    if not (lock["block_err"] <= S3D_FP_BLOCK_RTOL and lock["logit_err"] <= LOGIT_TOL):
        raise AssertionError(f"{name} int8 card vs CPU in lock-step: {lock}")
    del ev8
    return dict(int8_clips_per_s=rate, int8_launches=launches, int8_walk=want,
                int8_forwards=forwards, int8_checked={str(k): v for k, v in checked.items()},
                logit_err=errs["fp32"], int8_logit_err=errs["int8"],
                int8_lockstep_logit_err=lock["logit_err"], fp_block_err=lock["block_err"],
                int8_vs_fp32_max_abs=int8_vs_fp32, head_fp32_err=f32_err,
                head_int8_ratio=f8_err)


def int8_lockstep(engine, u1, dev) -> dict:
    """The int8 walk of ``engine`` on the uint8 clip ``u1``, card against CPU
    in lock-step. The two walks' K2/K5/K6 steps are exact either way (each
    kernel equals its plain version, and those equal the CPU's); only their
    fp steps round differently: the fp blocks (iFormer, MSCAN-half, GCNet
    context) and the residual SRM. Free-running, such a difference flips
    a code wherever a value sits on a .5 tie of a quantize point. Here the
    card's walk records each fp step's output; the CPU's runs its own, holds
    it to the card's (``block_err``: the largest difference over the card's
    largest value, any step) and goes on with the card's. Returns that and
    the logits' max abs difference."""
    import torch
    from fac_fake_torch.compat import quantize_s3d as qs3
    real_srm, seen = qs3.srm_filter, []

    def recording(key):
        return lambda mod, args, out: seen.append((key, out.detach().cpu()))

    def srm_recorded(x, w):
        y = real_srm(x, w)
        seen.append(("srm", y.detach().cpu()))
        return y

    hooks = [m.register_forward_hook(recording(k)) for k, m in engine.fp.items()]
    qs3.srm_filter = srm_recorded
    try:
        gpu_l = head_input(engine, u1.to(dev))[0].cpu()
    finally:
        qs3.srm_filter = real_srm
        for h in hooks:
            h.remove()
    steps, worst = iter(seen), [0.0]

    def carried(key, own):
        k, ref = next(steps)
        if k != key:
            raise AssertionError(f"fp steps out of order: the card's {k}, the CPU's {key}")
        worst[0] = max(worst[0], float((own - ref).abs().max() / ref.abs().max()))
        return ref

    cpu = copy.deepcopy(engine).cpu()
    hooks = [m.register_forward_hook(lambda mod, args, out, k=k: carried(k, out))
             for k, m in cpu.fp.items()]
    qs3.srm_filter = lambda x, w: carried("srm", real_srm(x, w))
    try:
        cpu_l = head_input(cpu, u1)[0]
    finally:
        qs3.srm_filter = real_srm
        for h in hooks:
            h.remove()
    if next(steps, None) is not None:
        raise AssertionError("the CPU's walk ran fewer fp steps than the card's")
    return dict(logit_err=float((gpu_l - cpu_l).abs().max()), block_err=worst[0])


def msca_scoring(seed, rng, dev) -> dict:
    """S5: `S3DEvaluator` with the full-width ``msca_s3d`` and ``msca_s3d_srm``
    (the residual 3-filter SRM input), seeded weights: `predict_batch`
    clips/s at batch S3D_BATCH in fp32 beside ``ca_s3d``'s at the same
    frames, and in int8 with what `msca_int8` checks (the launches, every
    K5/K6 call bit-equal to its plain version, logits and head input card
    vs CPU at batch 1, S3D_MSCA_T frames). Inputs from `side_rng`."""
    import torch
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.models import build_model
    side = side_rng(rng)
    clips = side.integers(0, 256, (S3D_BATCH, S3D_MSCA_T, S3D_TRAIN_HW, S3D_TRAIN_HW, 3),
                          dtype=np.uint8)
    out = {}
    for name, srm in (("ca_s3d", False), ("msca_s3d", False), ("msca_s3d_srm", True)):
        mc = ModelConfig(name=name, num_class=1, srm_net=srm)
        model = build_model(mc, device=dev, seed=seed)
        ev = S3DEvaluator(model, degrade=False, device=dev)
        ev.predict_batch(clips[:2])                           # warm cuDNN
        rate, probs = clips_per_s(ev, clips, n_it=2)
        if not np.isfinite(probs).all():
            raise AssertionError(f"{name}: fp32 scores {probs}")
        res = dict(clips_per_s=rate, srm=model.srm)
        log(f"S5 {name} fp32 (SRM {model.srm}), {S3D_MSCA_T} x {S3D_TRAIN_HW}^2: predict_batch "
            f"{S3D_BATCH} clips {rate:.2f} clips/s")
        del ev
        if name != "ca_s3d":
            res.update(msca_int8(name, model, clips, dev))
        out[name] = res
        del model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="break CViT and S3D forwards down by kernel")
    args = ap.parse_args()

    import torch
    # ---- 1. environment -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from fac_fake_torch import kernels
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.detect import extractor as ex
    from fac_fake_torch.detect.blazeface import BlazeFace
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # ---- 2. build ---------------------------------------------------------
    kernels.build(verbose=True)
    log(f"build: {kernels.last_build_s:.1f} s for {', '.join(kernels.SOURCES)}")

    # ---- 3. K2 in its five modes against their plain versions -------------
    k2 = k2_phase(rng, dev)

    # ---- 4. K1 against its plain version ---------------------------------
    det = BlazeFace.from_packaged_assets(dev)
    t_face = time.perf_counter()
    face = synth_face(det, args.seed)
    with_faces = [f"video_{i}" for i in (0, 1, 2, 3, 4, 5, 8)]
    reader = SeededReader(args.seed, face=face, faces=with_faces)
    log(f"synthetic face: {time.perf_counter() - t_face:.1f} s")
    frames = np.stack([reader.frame(v, i) for v in ("video_0", "video_6")
                       for i in range(0, 40, 5)])
    tiles, split, offs = ex.make_tiles(frames)
    dets, valid = det.predict_on_batch(tiles, apply_nms=False)
    k1 = k1_phase(rng, dev, (dets, valid, split, torch.as_tensor(offs, device=dev)))

    # ---- 5. main path ------------------------------------------------------
    cfg = Config()
    model = build_model(cfg.model, device=dev, seed=args.seed)
    scorer = VideoScorer(model, cfg, detector=det, reader=reader)
    crops = rng.integers(0, 256, (29, 224, 224, 3), dtype=np.uint8)
    stacks = [rng.integers(0, 256, (29, 224, 224, 3), dtype=np.uint8) for _ in range(8)]
    paths = [f"video_{i}" for i in range(8)]
    launches = fp32_path(scorer, paths, crops, stacks, with_faces)

    # ---- 6. full-width logits, card against CPU ---------------------------
    four = torch.from_numpy(rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8))
    logits_vs_cpu(scorer.model, four, "full-width logits")

    # ---- 7-8. K3 and K4 against their plain versions -----------------------
    fp32_rates = crops_per_s(scorer, crops, stacks)
    log(f"fp32 beside the int8 runs: score_crops {fp32_rates[0]:.1f} crops/s, "
        f"score_crop_stacks {fp32_rates[1]:.1f} crops/s")
    k3 = k3_phase(rng, dev)
    k4 = k4_phase(rng, dev)

    # ---- 9. int8 main path -----------------------------------------------------
    int8_launches, full = int8_modes(model, scorer, det, reader, crops, stacks, paths,
                                     fp32_rates, CVIT_INT8_WALK)
    if args.profile:
        u96, pos96 = crops_96(crops, dev)
        profile_forward(lambda: scorer.model.forward_crops(u96, torch.float32, pos96),
                        f"fp32 forward, batch {QBATCH}", expect=("normalize_table",))
        profile_forward(lambda: full.model.forward_crops(u96, torch.float32, pos96),
                        f"int8_full forward, batch {QBATCH}",
                        expect=("dense_wgmma", "conv_wgmma", "qwg::quantize_rows",
                                "normalize_table"), absent=("qmma::",))

    # ---- 10. full-width int8_full logits, card against CPU ------------------
    logits_vs_cpu(full.model, four, "full-width int8_full logits", plain=True)
    del scorer, full, model
    torch.cuda.empty_cache()

    # ---- M1-M3. MTCNN with K8, its video path, the serving entry point ----------
    k8 = k8_phase(rng, dev)
    m_scorer, m2 = mtcnn_path(args.seed, dev, reader)
    m3 = serve_phase(m_scorer)
    del m_scorer
    torch.cuda.empty_cache()

    # ---- F1-F4. the flagship cvit_repbn8 -----------------------------------------
    flag = flagship_phases(args.seed, rng, dev, det, reader, crops, stacks, paths, with_faces,
                           four, args.profile)
    torch.cuda.empty_cache()
    s3d = s3d_phases(args.seed, rng, dev, args.profile)
    torch.cuda.empty_cache()

    # ---- T1-T4. training ----------------------------------------------------------
    k7 = k7_phase(rng, dev)
    augment = augment_phase(rng, dev)
    data = train_data(rng, face)
    with tempfile.TemporaryDirectory() as ck:
        t2, model = train_phase("cvit", args.seed, dev, data, args.profile, ck)
        saved = sorted(os.listdir(ck))
        log(f"cvit checkpoints written by fit: {saved}")
        if saved != ["best.pth", "epoch_000000.pt"]:
            raise AssertionError(f"fit's checkpoints: {saved}")
    t3 = train_vs_cpu(model, "cvit", rng)
    del model
    torch.cuda.empty_cache()
    t4, model = train_phase("cvit_repbn8", args.seed, dev, data, args.profile)
    t4_cpu = train_vs_cpu(model, "cvit_repbn8", rng)
    del model
    torch.cuda.empty_cache()

    # ---- R1-R3. the ResNet/KAN family with K9 -------------------------------------
    k9 = k9_phase(rng, dev)
    r2 = resvitkan_path(args.seed, rng, dev, det, reader, paths, with_faces, launches["K2"])
    torch.cuda.empty_cache()
    r3 = family_forwards(args.seed, rng, dev)
    torch.cuda.empty_cache()

    # ---- S1-S5. S3D training with K10 ---------------------------------------------
    k10 = k10_phase(rng, dev)
    s3d_aug = s3d_augment_phase(rng, dev)
    s3 = s3d_train_phase(args.seed, rng, dev, det, face, args.profile)
    s4 = s3d_train_vs_cpu(args.seed, rng, dev)
    s5 = msca_scoring(args.seed, rng, dev)

    # ---- 15. kernels line -----------------------------------------------------
    k5, k6 = s3d["k5"], s3d["k6"]
    # launches: the base cvit's paths; flagship_*: cvit_repbn8's, each path
    # counted in its own run
    fl, fq = flag["launches"], flag["int8_launches"]
    fk3 = flag["k3"]
    rows = [
        {"name": "K1_frame_detections", "route": "cuda",
         "source": "fac_fake_torch/csrc/frame_detections.cu",
         "replaces": "fac_fake_tpu/detect/extractor.py:73",
         "launches": launches["K1"], "flagship_launches": fl["K1"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
         "load_ms": k1["load_ms"],
         "shapes": "the planted 16-frame T=3 chunk, (16, 2688, 17); load_ms: with no step; "
                   "launches: the cvit fp32 path; flagship_launches: the cvit_repbn8 fp32 "
                   "path"},
        {"name": "K2_normalize_imagenet", "route": "cuda",
         "source": "fac_fake_torch/csrc/normalize.cu",
         "replaces": "fac_fake_tpu/ops/preprocess.py:25",
         "launches": launches["K2"], "int8_launches": int8_launches["K2_int8"],
         "flagship_launches": fl["K2"], "flagship_int8_launches": fq["K2_int8"],
         "raw_launches": s3d["launches"]["K2_raw"],
         "train_eval_launches": t2["launches"]["K2"],
         "flagship_train_eval_launches": t4["launches"]["K2"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "kernel_ms": k2["ms"], "warm_ms": k2["warm_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "yardstick_ms": k2["yardstick_ms"],
         "bound_counts": "real channels: 3 bytes a pixel in; 12 (fp32), 6 (bf16) or 3 (int8 "
                         "modes, their zero fourth channel not counted) out; the scale",
         "modes": {k: {f: v[f] for f in ("ms", "warm_ms", "yardstick_ms", "plain_ms",
                                         "bound_ms")} for k, v in k2["modes"].items()},
         "timing": "ms: cold, the launches rotating over buffers beyond twice the L2; warm_ms: "
                   "one input again and again; yardstick_ms: cold, the u8 cast to the output "
                   "dtype (fp modes) or copy_ of the output's bytes (int8 modes), the same "
                   "bytes, not the same function",
         "shapes": "ms: fp32 (96, 224, 224, 3), the fp32 main path's; modes: fp32, bf16 and "
                   "the int8 CViT entry of each at batches 96 and 256, the raw int8 entry at "
                   f"({S3D_BATCH}, {S3D_T}, {S3D_HW}, {S3D_HW}, 3); launches: the cvit fp32 "
                   "path; int8_launches: int8 entries on the cvit int8_full path; "
                   "flagship_launches, flagship_int8_launches: the same on cvit_repbn8's; "
                   "raw_launches: the S3D int8 path; train_eval_launches, "
                   "flagship_train_eval_launches: the eval batches of one training epoch (fp32)"},
        {"name": "K3_quant_conv3x3", "route": "cuda",
         "source": "fac_fake_torch/csrc/quant_conv3d.cu",
         "replaces": "fac_fake_tpu/models/layers.py:106",
         "launches": int8_launches["K3"], "quantize_launches": int8_launches["K3_quantize"],
         "max_abs_err": k3["err"], "ms": k3["ms"], "kernel_ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "bound_counts": "real channels; the first conv's int8 input (K2's int8 entry makes it) "
                         "read once; the 16 tensors a conv quantizes for the next conv as int8",
         "bound_ms_old_count": k3["bound_ms_old_count"],
         "old_count": "each conv reading fp32 and writing fp32 (the count without the fused "
                      "edges)",
         "library_ms": None, "int_mm_deep_ms": k3["library_ms"], "ms_deep": k3["ms_deep"],
         "int_mm": "torch._int_mm, the GEMMs alone of the 8 deep convs (28x28 and 14x14) on "
                   "im2col'd int8 operands",
         "shapes": "the 17 convs (16 fused with the next quantize) of one cvit int8 "
                   "forward's stem walk from the crops, batch 96, fp32; launches, "
                   "quantize_launches: the cvit int8_full path (no quantize pass there); "
                   "flagship_launches, flagship_quantize_launches: the cvit_repbn8 int8_full "
                   "path (stem 2's quantize pass)",
         "flagship_ms": fk3["ms"], "flagship_conv_ms": fk3["conv_ms"],
         "flagship_quantize_ms": fk3["quantize_ms"], "flagship_plain_ms": fk3["plain_ms"],
         "flagship_bound_ms": fk3["bound_ms"], "flagship_bound_by": fk3["bound_by"],
         "flagship_launches": fq["K3"], "flagship_quantize_launches": fq["K3_quantize"],
         "flagship_shapes": "the 18 convs (16 fused with the next quantize, 1 of them with no "
                            "ReLU) and 1 quantize pass of one cvit_repbn8 int8 forward from "
                            "the crops, batch 96, fp32"},
        {"name": "K4_quant_dense", "route": "cuda",
         "source": "fac_fake_torch/csrc/quant_dense.cu",
         "replaces": "fac_fake_tpu/models/layers.py:142",
         "launches": int8_launches["K4"], "flagship_launches": fq["K4"],
         "max_abs_err": k4["err"],
         "ms": k4["ms"], "kernel_ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"], "library": "torch._int_mm, the GEMM alone",
         "shapes": "the 26 denses of one int8_full forward, batch 96, fp32 (the same on cvit "
                   "and cvit_repbn8); launches: the cvit int8_full path; flagship_launches: "
                   "the cvit_repbn8 int8_full path"},
        {"name": "K5_quant_conv3d", "route": "cuda",
         "source": "fac_fake_torch/csrc/quant_conv3d.cu",
         "replaces": "fac_fake_tpu/compat/quantize_s3d.py:59",
         "launches": s3d["launches"]["K5"], "quantize_launches": s3d["launches"]["K5_quantize"],
         "max_abs_err": k5["err"], "ms": k5["ms"], "kernel_ms": k5["ms"],
         "conv_ms": k5["conv_ms"], "quantize_ms": k5["quantize_ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "bound_counts": "real channels; the quantize passes and convs as one function "
                         "(fp32 in, fp32 out), the int8 tensor between a quantize pass and its "
                         "convs not counted; the stem conv's int8 input (K2's raw entry makes "
                         "it) read once; the 39 tensors a conv quantizes for the next conv as "
                         "int8, written once and read once",
         "bound_ms_old_count": k5["bound_ms_old_count"],
         "old_count": "the same, with those 39 tensors as an fp32 write and an fp32 read "
                      "(the count without the fused epilogue)",
         "library_ms": k5["library_ms"], "ms_1x1x1": k5["ms_1x1x1"],
         "library": "torch._int_mm, the GEMMs of the 1x1x1 convs alone (pre-quantized)",
         "relu6_launches": sum(s5[n]["int8_launches"]["K5_relu6"] for n in MSCA_INT8),
         "msca_launches": {n: s5[n]["int8_launches"] for n in MSCA_INT8},
         "msca_relu6_launches_per_forward": {n: s5[n]["int8_walk"]["relu6"] for n in MSCA_INT8},
         "msca_int8_clips_per_s": {n: s5[n]["int8_clips_per_s"] for n in MSCA_INT8},
         "shapes": f"the 77 convs (39 fused with the next quantize) and 10 quantize passes "
                   f"of one ca_s3d int8 forward from uint8 clips, batch {S3D_BATCH}, fp32; "
                   f"launches: the ca_s3d int8 path (ReLU); relu6_launches, msca_launches: "
                   f"the msca_s3d and msca_s3d_srm int8 paths of S5 ({S3D_BATCH} clips of "
                   f"{S3D_MSCA_T} x {S3D_TRAIN_HW}^2, 22 convs a forward, 20 with ReLU6)"},
        {"name": "K6_max_pool3d_i8", "route": "cuda",
         "source": "fac_fake_torch/csrc/max_pool3d_i8.cu",
         "replaces": "fac_fake_tpu/compat/quantize_s3d.py:85",
         "launches": s3d["launches"]["K6"], "max_abs_err": k6["err"],
         "msca_launches": {n: s5[n]["int8_launches"]["K6"] for n in MSCA_INT8},
         "ms": k6["ms"], "kernel_ms": k6["ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"], "library_ms": None,
         "warm_ms": k6["warm_ms"], "copy_ms": k6["copy_ms"],
         "timing": "ms: cold, the launches rotating over buffers of more than twice the L2; "
                   "warm_ms: one input again and again; copy_ms: torch copy_ of the same "
                   "tensors, cold (a yardstick, not the same function)",
         "shapes": f"the 9 int8 pools of one ca_s3d int8 forward, batch {S3D_BATCH}"},
        {"name": "K7_clahe_luma", "route": "cuda", "source": "fac_fake_torch/csrc/clahe.cu",
         "replaces": "fac_fake_tpu/data/augment.py:274",
         "launches": t2["launches"]["K7"], "train_steps": t2["fit_steps"],
         "launches_per_train_step": t2["launches"]["K7"] / t2["fit_steps"],
         "flagship_launches": t4["launches"]["K7"], "flagship_train_steps": t4["fit_steps"],
         "max_abs_err": k7["err"], "ms": k7["ms"], "kernel_ms": k7["ms"],
         "warm_ms": k7["warm_ms"], "plain_ms": k7["plain_ms"], "bound_ms": k7["bound_ms"],
         "bound_by": k7["bound_by"], "copy_ms": k7["copy_ms"], "library_ms": None,
         "trainer_ms": k7["subset_ms"], "trainer_warm_ms": k7["subset_warm_ms"],
         "trainer_plain_ms": k7["subset_plain_ms"], "trainer_bound_ms": k7["subset_bound_ms"],
         "trainer_bound_by": k7["subset_bound_by"], "augment_chain_ms": augment["ms"],
         "augment_chain_wall_ms": augment["wall_ms"],
         "timing": "ms: cold, the launches rotating over buffers beyond twice the L2; warm_ms: "
                   "one input again and again; copy_ms: torch copy_ of the same bytes, cold (a "
                   "yardstick, not the same function); one call is one kernel",
         "shapes": "ms: clahe_luma on (8, 224, 224, 3) fp32, all taken; trainer_*: "
                   f"clahe_subset_ in place on ({TRAIN_BATCH}, 224, 224, 3), "
                   f"{K7_TRAIN_TAKERS} seeded takers, a budget of 8, the CLAHE step of a "
                   f"batch-{TRAIN_BATCH} train step (fac_fake_tpu/data/augment.py:802-811); "
                   "augment_chain_ms, augment_chain_wall_ms: augment_batch at the same batch, "
                   "device time and host wall time; "
                   "launches: one training epoch of cvit (one call a step); "
                   "flagship_launches: the same of cvit_repbn8"},
        {"name": "K8_hard_nms", "route": "cuda", "source": "fac_fake_torch/csrc/hard_nms.cu",
         "replaces": "fac_fake_tpu/detect/mtcnn.py:183",
         "launches": sum(r["launches"]["K8"] for r in m2["runs"].values()),
         "launches_per_frame": 4, "frames": {str(th): r["frames"] for th, r in m2["runs"].items()},
         "max_abs_err": 0.0, "ms": k8["ms"], "kernel_ms": k8["ms"], "warm_ms": k8["warm_ms"],
         "default_thresholds_warm_ms": k8["default_warm_ms"], "plain_ms": k8["plain_ms"],
         "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"], "library_ms": None,
         "launch_floor_ms": k8["launch_floor_ms"],
         "iou_tests": k8["iou_tests"], "bytes": k8["nbytes"],
         "timing": "ms: cold, one frame's 4 launches rotating over copies of its candidate sets "
                   f"beyond twice the L2, {K8_COLD_FRAMES} frames timed; warm_ms: the same sets "
                   "again and again; each timing fails if the host paced it; "
                   "launch_floor_ms: 4 launches of a kernel that returns at once "
                   "(torch.cuda._sleep(0)) on the same stream, information beside the bound; "
                   "idx and keep bit-equal to the plain version (max_abs_err 0)",
         "shapes": "one 1920x1080 frame's calls at thresholds (0, 0, 0): (12, 128) -> 128 union "
                   "0.5, 1536 -> 64 union 0.7, 64 -> 64 union 0.7, 64 -> 32 min 0.7; launches: "
                   "the M2 path's two runs (4 a detected frame); frames: frames detected a run; "
                   "library_ms: no PyTorch call computes this NMS (no min mode, +1 areas or "
                   "fixed capacity in any)",
         "mtcnn_path": {str(th): {k: r[k] for k in ("videos_per_min", "detect_s_per_frame",
                                                    "detect_alone_ms", "faces_per_frame",
                                                    "frames")}
                        for th, r in m2["runs"].items()},
         "serve_latency_s": m3["latency_s"]},
        {"name": "K9_kan_bases", "route": "cuda", "source": "fac_fake_torch/csrc/kan_bases.cu",
         "replaces": "fac_fake_tpu/models/blocks/kan.py:35",
         "launches": r2["launches"]["K9"], "launches_per_forward": r2["per_forward"]["K9"],
         "reskan_launches_per_forward": r3["reskan_k9"], "max_abs_err": 0.0,
         "ms": k9["ms"], "kernel_ms": k9["ms"], "warm_ms": k9["warm_ms"],
         "bf16_warm_ms": k9["bf16_warm_ms"], "plain_ms": k9["plain_ms"],
         "bound_ms": k9["bound_ms"], "bound_by": k9["bound_by"], "bytes": k9["nbytes"],
         "library_ms": None, "copy_ms": k9["copy_ms"], "checked_calls": k9["calls"],
         "timing": "ms: cold, one forward's 2 launches rotating over buffers beyond twice the "
                   "L2; warm_ms: the same inputs again and again; copy_ms: torch copy_ of the "
                   "outputs' bytes, cold (a yardstick, not the same function); bit-equal to "
                   "the plain version in fp32 and bf16 (NaN where both are NaN; max_abs_err 0)",
         "shapes": "ms: one resvitkan forward at capacity 96, (96, 2048) and (96, 64), grid "
                   "(in, 12), order 3, fp32; launches: the resvitkan fp32 path (R2), 2 a "
                   "forward; library_ms: no PyTorch call computes B-spline bases",
         "resvitkan_path": {k: r2[k] for k in ("videos_per_min", "score_crops_per_s",
                                               "score_crop_stacks_per_s", "logit_err",
                                               "stack_diff", "bf16_diff")},
         "family_logit_err": {"reskan": r3["reskan_err"], "resvit": r3["resvit_err"]}},
        {"name": "K10_jpeg_subset", "route": "cuda", "source": "fac_fake_torch/csrc/jpeg.cu",
         "replaces": "fac_fake_tpu/data/augment.py:415",
         "launches": s3["s3d"]["fit_launches"]["K10"], "train_steps": s3["s3d"]["fit_steps"],
         "launches_per_train_step": s3["s3d"]["k10_per_step"],
         "max_abs_err": k10["err"], "bit_equal": True, "ms": k10["ms"], "kernel_ms": k10["ms"],
         "warm_ms": k10["warm_ms"], "plain_ms": k10["plain_ms"], "bound_ms": k10["bound_ms"],
         "bound_by": k10["bound_by"], "copy_ms": k10["copy_ms"], "library_ms": None,
         "k10_digest": k10["k10_digest"], "division_check_differ": k10["div_bad"],
         "augment_chain_ms": s3d_aug["ms"],
         "augment_chain_wall_ms": s3d_aug["wall_ms"],
         "timing": "ms: cold, the launches rotating over buffers beyond twice the L2; warm_ms: "
                   "one input again and again; copy_ms: torch copy_ of the taken frames' "
                   "bytes, cold (a yardstick, not the same function); bit-equal to the "
                   "plain version in every case of S1 (max_abs_err 0)",
         "shapes": f"ms: jpeg_subset_ in place on ({K10_FRAMES}, 224, 224, 3) fp32, "
                   f"{K10_TAKEN} taken, the step of a plan1_2 train step; launches: one "
                   "training epoch of s3d under plan1_2 (one a step); augment_chain_*: "
                   "augment_batch on plan1_2's (12, 30, 224, 224, 3), device and host time; "
                   "library_ms: no PyTorch call computes this JPEG"},
    ]
    log(json.dumps({"training": {"cvit": dict(t2, vs_cpu=t3),
                                 "cvit_repbn8": dict(t4, vs_cpu=t4_cpu),
                                 "s3d_family": s3, "s3d_vs_cpu": s4, "s3d_scoring": s5}}))
    log(json.dumps({"kernels": rows}))
    # ---- 16. result -----------------------------------------------------------
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
