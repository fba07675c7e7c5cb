#!/usr/bin/env python3
"""Drive fac_fake_torch on one NVIDIA H100: build the hand-written kernels,
hold each against its plain PyTorch version, score videos end to end with the
full-width base CViT and the flagship cvit_repbn8 in fp32 and under int8
post-training quantization, score S3D clips, train both CViTs at full width,
detect with MTCNN and serve, build face-crop datasets and compare the two
detectors, evaluate the scores' CSV, explain scores with Grad-CAM, profile a
scoring call, export CViTs (ONNX, torch.export, .pth), score videos with the
ResNet/KAN resvitkan and refit its KAN head's grids, train the S3D family
from its plans and score the msca family, score every entry of the CViT
variant zoo in fp32 and bf16 and three of them in int8_full, train one entry
of each of its block kinds in fp32 and four in bf16, and print what it
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
 E1. evaluation (`evaluation_phase`): phase 5's 9 scores through the
     prediction-CSV writer, a seeded metadata.json (the 7 face videos FAKE
     or REAL, the 2 without a face, 2 names no row has):
     `evaluate_prediction_csv`, `legacy_int_accuracy` and `cli/evaluate.py
     csv` equal to a plain computation over the scores in memory, exactly;
     the no-face rows' 0.5 dropped; K1's and K2's launches for the scores;
  6. full-width logits on the card against the same module on the CPU;
 G1. Grad-CAM (`gradcam_phase`): `gradcam` and `gradcam_tokens` of cvit,
     cvit_repbn8, cvit_ggca_sla, cvit_ggca_add_glu and cvit_bfm_ggca_mdfa
     at full width on phase 6's four uint8 crops, card (K2 once a call, its
     plain version never) against the CPU at a fixed class (`cam_rule`):
     the raw CAM within CAM_RAW_TOL of the CPU's largest value + 3 x the
     CPU's distance from a float64 CAM (the crops normalized in float64 on
     the CPU), the min-maxed one within CAM_NORM_TOL + 3 x its own; the
     argmax's agreement and ms a call printed;
 U1. profiling (`profiling_phase`): `flops_estimate` of cvit's forward at
     batch 1 equal to 2 x its convs', linears' and attention products'
     multiply-adds from their shapes; `trace` of one fp32 `score_crops` call
     names K2's `normalize_table`; `time_fn` at least WAIT_SHARE x
     `cuda_ms` of the same call;
 X1. export (`export_phase`): the full-width seeded cvit on phase 6's crops,
     each normalized by K2 (its plain version never on the card): the ONNX
     graph (`export_onnx_cvit`) parsed back and run by `run_onnx` on the
     card and on the CPU within ONNX_TOL of the eager card forward; the
     `torch.export` program of cvit and cvit_repbn8 at batch 4 loaded on the
     card within PROGRAM_TOL of the eager forward; the reference-layout
     `.pth` reloaded strict=True with bit-equal logits; `cli/export.py` once
     a format;
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
     fp32 logits, the int8 logits in lock-step (`int8_lockstep`: the CPU's
     walk fed the card's outputs of the 7 fp GCNet context blocks, each
     within S3D_FP_BLOCK_RTOL of the CPU's own; free-running, a value on a
     .5 tie takes another code: printed), and the head's input features
     (int8: against the int8-vs-fp32 difference);
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
     the TRAIN_* bounds it prints (`train_vs_cpu`; the entries left out,
     under 10%: those not bit-equal that are under min(TRAIN_GRAD_FLOOR,
     TRAIN_GRAD_FLOOR_RMS x their tensor's RMS) or 10% apart, printed
     beside the share the absolute floor alone leaves out);
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
 P1. the face-crop dataset build (`dataset_phase`): the per-video work of
     `extract_faces_from_video` (10 random frames a video, drawn with
     replacement) and of `extract_video_crop_folders` (30 evenly spaced)
     over the 9 in-memory videos with the packaged BlazeFace on the card
     (`data/preprocess.py video_face_crops`, `video_crop_folder_crops`: each
     frame's best face resized to 224^2; the card's machine has no cv2, so
     the phase stops before the file write), then the same frames on the
     CPU: the same (frame, face) pairs, every box edge within 1 px (the
     boxes that moved printed), crops of equal boxes bit-equal, crops from
     every face video, K1 once a video and its plain version never on the
     card; frames/s, crops/s and the time split (tile resizes, detection,
     crop resizes) beside the card's name and power limit;
 P2. the detector agreement (`agreement_phase`): `agreement_report` over
     the 9 videos at 8 frames, BlazeFace (K1 once a video) against the
     seeded MTCNN at (0, 0, 0) (K8 4 times a frame), each detector's
     frames/s; BlazeFace against itself (recall 1.0 both ways, every
     matched IoU 1.0); the same report with BlazeFace on the CPU (its boxes
     by P1's rule) and the card's MTCNN boxes replayed; --score's scorers
     (`cli/detector_agreement.build_scorers`, seeded bf16 cvit, MTCNN at
     (0, 0, 0)) on 2 videos, each score within 1e-6 of `score_video`'s;
     `mask_geometry_report` over the face videos (hit rate above 0, K1 once
     a frame);
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
 R4. KAN's grid refit (`kan_grid_phase`): `update_grid` of each layer of
     resvitkan's KAN head on its real input from R2's capacity-96 forward,
     on the card (K9 once a layer, its plain version never) and on the CPU
     from the same input: the grid bit-equal, the weight within
     KAN_GRID_WEIGHT_TOL of its largest value, `regularization_loss` within
     KAN_LOSS_RTOL; the refit head's forward finite;
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
     epoch and one eval batch, then 10 steps on a fixed batch from the
     weights and optimizer state the phase started with (the first loss at
     least S3D_FIXED_FIRST_LOSS: a model that has not fit the batch), whose
     loss falls;
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
 B1. K7 and K10 in their bf16 modes against their plain versions, bit for
     bit, on T1's and S1's cases in bf16 (`k7_phase`, `k10_phase` with
     dtype bfloat16; K7 also on a band beyond shared memory and on rows of
     44 x 6 B), timed cold and warm at the trainer's step and at plan1_2's,
     beside the fp32 mode's time of this run, copy_ of the same bf16 bytes
     and the bound from those bytes;
 B2. bf16 training (`model.dtype=bfloat16`: fp32 master weights, bf16
     compute, the chain in bf16) of cvit and cvit_repbn8 as T2 and T4
     (`train_phase(..., dtype="bfloat16")`: K7's bf16 mode once a train
     step, K2's bf16 normalize once an eval batch), and one bf16 step card vs
     CPU vs float64 (`train_vs_cpu(..., "bfloat16")`): held layer by layer
     (`replay_layers`: each module's output and gradients on the card
     within BF16_LAYER_RATIO x the CPU bf16's distance from float64 +
     BF16_LAYER_SLACK, the left-out share under BF16_LAYER_LEFT_OUT), the
     whole step's gradient within TRAIN_GRAD_F64_RATIO x the CPU bf16
     step's distance from float64 + TRAIN_BF16_GRAD_F64_SLACK and its logits
     within that ratio of the CPU's + BF16_LAYER_SLACK (`logit_rule`; the
     loss rule it replaced printed beside it);
 B3. bf16 S3D training from the three plans as S3 (K10's bf16 mode once a
     plan1_2 step), and one bf16 ca_s3d step held as B2's and by the loss
     rule as well (ca_s3d's bf16 logits sit 0.3-0.5 from float64 on either
     device, so its logit bound passes all-zero logits);
 B4. bf16 `S3DEvaluator` with ca_s3d, msca_s3d and msca_s3d_srm, fp and
     int8 (`msca_scoring(..., "bfloat16")`): clips/s at batch 32; the int8
     engine's walk in bf16 (K5's bf16 out), every K5/K6 call of a forward
     bit-equal to its plain version; head input card vs CPU at batch 1 (fp:
     within S3D_BF16_FEATURE_RATIO x the CPU's own bf16-vs-fp32 difference;
     int8 by phase 14's rule),
     lock-step within S3D_FP_BLOCK_RTOL_BF16 and LOGIT_TOL_BF16; each B
     phase's numbers printed beside the fp32 ones of this run;
 Z1. the variant zoo (`zoo_phases`), each of its 29 registry entries at its
     published widths, seeded, carried through a reference checkpoint
     (`load_reference_pth`) into a second build, folded by `VideoScorer`:
     fp32 logits card vs CPU at batch 2 within the JAX package's zoo bar
     (ZOO_LOGIT_RTOL, ZOO_LOGIT_ATOL), crops/s through `score_crops` (29
     crops, capacity 96) beside base cvit's, one line an entry;
 Z2. cvit_bfm_ggca_mdfa (BFM, GGCA, the MDFA token block) end to end as
     phase 5 (`fp32_path`: videos/min, K1 and K2 launches); then K3 and K4
     (`k3_phase`, `k4_phase`) at the int8_full walks of cvit_ggca_sla (28^2
     256- and 512-channel convs, 96 x 16/17 dense rows) and
     cvit_ggca_add_glu (56^2 convs, 96 x 64/65 rows), bit-equal and timed;
 Z3. int8_full on cvit_ggca_sla, cvit_ggca_add_glu and cvit_ggca_add_wtconv
     (`zoo_int8`): crops/s beside fp32's, launches whole forwards of the
     planned walk (ZOO_INT8_WALKS, `int8_denses`), one forward at batch 96
     running it, every K3 and K4 call of one more bit-equal to its plain
     version, logits card vs CPU in lock-step (`cvit_int8_lockstep`: the
     CPU's forward fed the card's input at each fp quantize point, each fp
     step within ZOO_FP_STEP_RTOL) within LOGIT_TOL, the free-running
     difference and int8 vs fp32 for information;
 Z4. the zoo trained (`zoo_train_phases`): one entry of each block kind
     (ZOO_TRAIN: the ScConv, WTConv, InceptionDW and ODConv stems, the
     ODConv, MOGA, SMFA and UFFC slots, SLA and GLU on the embedding, BFM
     and MDFA in a slot and on the tokens both ways, the DEConv stems) as
     T2 at its published widths, batch 32 (a batch that does not fit
     fails the run), strong_aug on, the crops cached on the card: crops/s, ms a
     step, peak memory and the busy share over ZOO_TRAIN_TIMED_STEPS steps,
     one K7 call a step; ZOO_FIT_ENTRY also `fit` for one epoch (one K2
     launch an eval batch, finite losses) and 10 fixed-batch steps whose
     loss falls;
 Z5. one train step of each card vs CPU vs float64 at batch 2
     (`train_vs_cpu(..., zoo=True)`, T3's float64 rule: the loss card vs
     CPU within TRAIN_LOSS_RTOL + 3 x the CPU's distance to float64
     (`z5_loss_rule`), the gradient and each running-stat tensor against
     float64; the CPU's and
     float64's max-pools, ScConv gates, ReLUs, maxima and UFFC's clip and
     its bounds routed as the card's);
 Z6. bf16: every zoo entry through `VideoScorer` at model.dtype=bfloat16
     (`zoo_bf16_scoring`: crops/s beside Z1's fp32 of this run, one K2
     launch a call, the head's input on the card within
     ZOO_BF16_FEATURE_RATIO x the CPU bf16's distance from the CPU's fp32
     one, at weight seed --seed), and ZOO_BF16_TRAIN (SLA, GLU, the ODConv
     block, BFM/GGCA/MDFA) trained in bf16 as B2 (K7's bf16 mode once a step) with
     one bf16 step card vs CPU vs float64 held layer by layer
     (`replay_layers`);
 15. the training line (and T3/T4's per-tensor distances), the zoo lines,
     the datasets line (P1, P2, E1, G1, U1) and the kernels line, with
     K7's and K10's bf16 modes, the zoo's K1-K4 launches and K3/K4 times,
     K7's and K2's launches in the zoo's training and bf16 scoring, K1's
     and K8's on P1 and P2, K1's and K2's on E1, K2's on G1, U1 and X1,
     K9's on R4; 16. the
     result line.
     Each phase group prints the seconds since the start.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

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
# B4, bf16 S3D scoring: card vs CPU the two devices' bf16 layers round apart
# by bf16 ulps, so the fp head input is held by the CPU's own bf16-vs-fp32
# difference (S3D_BF16_FEATURE_RATIO, below); in lock-step each fp step
# within a few bf16 ulps of its largest value, and the logits within two
# bf16 ulps at |logit| < 2
S3D_FP_BLOCK_RTOL_BF16 = 3e-2
LOGIT_TOL_BF16 = 1.6e-2
# B4's bf16 fp head input card vs CPU, over the CPU's own bf16-vs-fp32
# difference (`b4_bf16_rule`): two independent bf16 roundings, each about d
# from fp32, part by about sqrt(2)·d, so the rule reads about 1 on a right
# card and 1.0 failed by chance (msca_s3d_srm at --seed 2: 1.02; seeds 0-1
# 0.81, 0.98; Z6's zoo entries 1.02-1.12 by the same measure). The int8 head
# input keeps phase 14's S3D_INT8_FEATURE_RATIO
S3D_BF16_FEATURE_RATIO = 1.5
# training (T1-T4)
K7_BATCHES = (8, 32)          # K7: the trainer's CLAHE subset at batch 32, and a whole batch
# K7's in-place subset entry: name -> ((N, H, W, 3), seeded takers, budget)
K7_SUBSETS = {"trainer": ((32, 224, 224, 3), 8, 8), "over budget": ((32, 224, 224, 3), 12, 8),
              "budget n": ((32, 224, 224, 3), 13, 32), "grid 1": ((16, 120, 120, 3), 5, 8),
              "flat": ((16, 224, 224, 3), 6, 8),
              "streamed": ((4, 448, 448, 3), 3, 4)}  # bands beyond shared memory: read twice
# B1 adds, in bf16 (whose bands are half the bytes): a band beyond shared
# memory, and rows that are no multiple of 16 bytes (44 x 3 x 2 B): read twice
K7_BF16_SUBSETS = {"streamed": ((2, 640, 640, 3), 2, 2), "unaligned rows": ((4, 44, 44, 3), 3, 4)}
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
# the left-out share's floor, below which a gradient entry that is not
# bit-equal on the two devices is left out as too small to compare:
# TRAIN_GRAD_FLOOR_RMS of its tensor's RMS on the CPU, and never above the
# absolute TRAIN_GRAD_FLOOR (the whole floor before: a step whose loss is
# 0.0068 has most entries under 1e-5 while the card is 7.6e-6 from float64,
# PERF.md §6). The parameters after the step are compared where
# |g| > TRAIN_GRAD_FLOOR, as before: Adam's first step is about ±lr only
# where |g| is well above its eps
TRAIN_GRAD_FLOOR, TRAIN_GRAD_FLOOR_RMS = 1e-5, 1e-2
# B2/B3: one bf16 train step card vs CPU (both bf16) vs float64, the same
# weights and batch. A bf16 step is far from float64 on either device, so
# the card is held to float64 as the fp32 step is, with a bf16 slack: its
# gradient (relative L2) and its loss within TRAIN_GRAD_F64_RATIO x the CPU
# bf16 step's distance + these; the card-vs-CPU quantities of the fp32
# check are printed, not held. Measured on an H100 (three runs, PERF.md §6):
# gradients 0.18-1.45 of their norm from float64 on either device; losses
# 0.04-5.3% on the card and 0.09-2.7% on the CPU, apart by draw, not by
# device (the flagship's CPU loss 0.09% off where the card's was 2.5%), so
# the loss's slack is 5% of it, a bf16 forward's own scale
TRAIN_BF16_GRAD_F64_SLACK = 1e-2
# The whole step's forward is held by its logits (relative L2 over the
# batch): the card's within TRAIN_GRAD_F64_RATIO x the CPU bf16's distance
# to float64 + BF16_LAYER_SLACK. The loss's rule before it (within the ratio
# x the CPU's + TRAIN_BF16_LOSS_F64_SLACK, relative to the loss) is
# printed beside it in B2, not held: a loss far below its untrained ln 2 is
# the small difference of large logits, and at a float64 loss of 0.20 the
# flagship's card step read 14.2% against a bound of 13.99% while its layers
# were at 0.287 of theirs (`--seed 2`, PERF.md §6). B3 holds both: ca_s3d's
# two bf16 logits sit 0.1-0.5 from float64 on the CPU too, so its logit
# bound passes all-zero logits
TRAIN_BF16_LOSS_F64_SLACK = 5e-2
# That whole-step rule is a sanity check, not one a wrong gradient fails: a
# zero gradient is 1.0 from float64, under 3 x 0.9 + 1e-2. So B2/B3 hold
# the card's bf16 step layer by layer (`replay_layers`): each module that owns a parameter (and
# each attention core) is run again on the inputs and the output gradient it
# had in the card's step, on the card and on the CPU in bf16 and on the CPU
# in float64. Its output, its input's gradient and its parameters'
# gradients (relative L2 each) on the card within BF16_LAYER_RATIO x the
# CPU's distance to float64 + BF16_LAYER_SLACK (2^-6: two bf16 ulps, where
# a zero or a wrong gradient reads 1 or more, and a bf16 sum that did not
# accumulate in fp32 some sqrt(n) ulps); the entries of tensors whose bound
# is 1 or more, and so could not fail a zero gradient, are the left-out
# share, under BF16_LAYER_LEFT_OUT
BF16_LAYER_RATIO, BF16_LAYER_SLACK = 3.0, 2.0 ** -6
BF16_LAYER_LEFT_OUT = 0.1
# a tensor whose float64 gradient is zero but for rounding (a conv bias before
# a BatchNorm): its share of the whole gradient's norm on either device, in
# fp32 and (bf16 rounding is 2^16 times coarser) in bf16
TRAIN_NOISE_SHARE = {"float32": 1e-4, "bfloat16": 1e-2}
# the routed step's decisions (`_route_pools`: 2x2 max-pool windows, ReLU
# values, `MaxOver` maxima, ScConv's SRU gates) that the CPU or the float64
# step would have taken otherwise, as a share of all routed. In fp32 these
# are near-ties that the two devices' roundings break apart: on an H100,
# T3 and T4 over three seeds, 2.4e-7 to 1.2e-6 (PERF.md §6), so 1e-4. A
# bf16 step routes its max-pools alone; a deep bf16 activation is some 1%
# off float64 (2^-9 an op, over some 20 layers), and each window whose two
# largest values lie within that can flip: B2 and Z6 read 1.3-2.9% of the
# windows (PERF.md §6), so 1e-1, the share at which `train_vs_cpu`'s
# left-out check fails. More is not rounding, and fails
ROUTED_APART_SHARE = {"float32": 1e-4, "bfloat16": 1e-1}
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
# S3, B3: steps on one fixed batch, augmentation off, from the plan's
# starting weights and optimizer (first loss at least S3D_FIXED_FIRST_LOSS),
# whose last loss must be below the first. From that state Adam's first
# steps can overshoot: ca_s3d at --seed 2 read 1.41, 0.75, 4.68, 2.58, 2.26
# over 5 steps (PERF.md §6), so 10, as the CViTs' fixed batch takes
S3D_FIXED_STEPS = 10
S3D_FIXED_FIRST_LOSS = 0.1
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
# Z1-Z3: the variant zoo, the JAX registry's other 29 CViT entries in its order
ZOO = ("cvit_ggca", "cvit_ggca_add", "cvit_ggca_add_repbn", "cvit_ggca4", "cvit_ggca_add3",
       "cvit_deconv", "cvit_ggca_add_deconv", "cvit_repbn", "cvit_repbn3", "cvit_repbn4",
       "cvit_repbn5", "cvit_ggca_add_dconv", "cvit_ggca_add_scconv", "cvit_ggca_add_wtconv",
       "cvit_ggca_add_odconv", "cvit_ggca_odconv", "cvit_ggca_add_moga", "cvit_ggca_smfa",
       "cvit_ggca_uffc", "cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_ggca4_bfm5",
       "cvit_ggca4_mdfa5", "cvit_bfm_ggca_mdfa", "cvit_bfm_mdfa", "cvit_ggca_bfm_mdfa",
       "cvit_ggca_mdfa_bfm", "cvit_mdfa_bfm", "cvit_mdfa_ggca_bfm")
ZOO_CHECK_BATCH = 2           # Z1, Z3: logits card vs CPU
# Z1: fp32 logits card vs CPU, the JAX package's zoo bar (rtol, atol of
# tests/test_variant_zoo_parity.py): with seeded weights the MDFA token
# block's x * excite(x) products drive cvit_ggca_bfm_mdfa's logits to ~10^3
ZOO_LOGIT_RTOL, ZOO_LOGIT_ATOL = 1e-3, 5e-4
# Z3: each fp step between int8 layers, card vs CPU on the same input, over
# its largest value (the S3D lock-step's bound, S3D_FP_BLOCK_RTOL)
ZOO_FP_STEP_RTOL = 1e-4
ZOO_TIMED_CALLS = 3           # Z1, Z3, Z6: score_crops calls timed after a warm-up call
ZOO_VIDEO_ENTRY = "cvit_bfm_ggca_mdfa"    # Z2: BFM, GGCA and the MDFA token block
# Z3: int8_full on the entries whose walks are new, one forward from uint8
# crops: sla two all-int8 stems (28^2 convs with no pool before them, stem 2
# from a quantize pass), glu one of 17 convs (56^2), wtconv one conv from
# K2's int8 entry that writes fp32 for WTConv and the fp rest of its stem
ZOO_INT8_WALKS = {
    "cvit_ggca_sla": dict(convs=17, fused=15, no_relu_fused=0, quantize=1, k2_int8=1, k2_fp=0,
                          int8_pools=3, fp_pools=0, fp_relus=0),
    "cvit_ggca_add_glu": dict(convs=17, fused=16, no_relu_fused=0, quantize=0, k2_int8=1,
                              k2_fp=0, int8_pools=2, fp_pools=0, fp_relus=0),
    "cvit_ggca_add_wtconv": dict(convs=1, fused=0, no_relu_fused=0, quantize=0, k2_int8=1,
                                 k2_fp=0, int8_pools=0, fp_pools=5, fp_relus=16),
}
# Z4-Z6: the zoo trained, one entry of each block kind (the stem mixers
# ScConv, WTConv, InceptionDW, ODConv; the slot blocks ODConv, MOGA, SMFA,
# UFFC; the embedding blocks SLA, GLU; BFM and MDFA in a slot and on the
# tokens; the DEConv family without the flagship's stems)
ZOO_TRAIN = ("cvit_ggca_add_scconv", "cvit_ggca_add_wtconv", "cvit_ggca_add_dconv",
             "cvit_ggca_add_odconv", "cvit_ggca_odconv", "cvit_ggca_add_moga", "cvit_ggca_smfa",
             "cvit_ggca_uffc", "cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_bfm_ggca_mdfa",
             "cvit_ggca_mdfa_bfm", "cvit_deconv")
ZOO_TRAIN_TIMED_STEPS = 3     # Z4: timed train steps an entry after a warm-up step
ZOO_FIT_ENTRY = "cvit_ggca_add_odconv"    # Z4: also fit for one epoch, and the fixed batch
ZOO_BF16_TRAIN = ("cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_ggca_odconv",
                  "cvit_bfm_ggca_mdfa")  # Z6: one bf16 step each, held layer by layer
# Z6: bf16 card vs CPU at batch ZOO_CHECK_BATCH on the head's input (the
# class token after the transformer, dim values a crop), held to the CPU's
# fp32 one: the card's bf16 error norm within ZOO_BF16_FEATURE_RATIO x the
# CPU bf16's. Phase 14's card-vs-CPU form would fail by chance here: the
# two devices' bf16 roundings part as far as either parts from fp32 after
# the transformer (on an H100 over the 29 entries: card vs CPU 0.51-1.13 of
# the CPU's bf16-vs-fp32 difference, the card's own distance 0.70-1.07 of
# the CPU's), where a wrong or zero output reads ~1/bf16-error, some 100
ZOO_BF16_FEATURE_RATIO = 2.0
DATASET_RANDOM_FRAMES = 10    # P1: `extract_faces_from_video`'s random frames a video
DATASET_FOLDER_FRAMES = 30    # P1: `extract_video_crop_folders`' evenly spaced frames a video
DATASET_CROP = 224            # P1: the crops' side
DATASET_BOX_PX = 1.0          # P1, P2: a BlazeFace box edge card vs CPU, pixels
AGREEMENT_FRAMES = 8          # P2: frames a video (the tool's default)
AGREEMENT_SCORED = 2          # P2: videos scored through --score's scorers
AGREEMENT_SCORE_TOL = 1e-6    # P2: --score against score_video, the same computation twice
# E1, G1, U1: evaluation, Grad-CAM, profiling
EVAL_UNJOINED = ("video_9.mp4", "video_10.mp4")   # E1: metadata entries no CSV row names
CAM_MODELS = ("cvit", "cvit_repbn8", "cvit_ggca_sla", "cvit_ggca_add_glu", "cvit_bfm_ggca_mdfa")
CAM_TARGET = 1                # G1: the class explained on both devices (near-tie logits can
                              # take another argmax on the card; its agreement is printed)
# G1: each CAM card vs CPU: raw (before the min-max) within CAM_RAW_TOL of the
# CPU's largest value, min-maxed to [0, 1] within CAM_NORM_TOL, max abs
CAM_RAW_TOL = 1e-4
CAM_NORM_TOL = 1e-3
# ... each widened by TRAIN_GRAD_F64_RATIO x the CPU fp32 CAM's own distance
# from a float64 CAM of the same crops (`cam_rule`): a CAM that sums channel
# terms cancelling to ~1e-3 of themselves (cvit_ggca_sla's feature CAM) is
# ill-conditioned in fp32, on either device 4.5-5.0e-6 from float64 against
# a card-vs-CPU bound of 1.78e-7 at --seed 2
CAM_TIMED_CALLS = 3           # G1: calls timed a model and mode, after a warm-up call
WAIT_SHARE = 0.9              # U1: time_fn's wall time at least this share of the device time
# X1: export (`export_phase`)
ONNX_TOL = 1e-4               # the ONNX graph's logits against the eager forward's (JAX's bar,
                              # tests/test_onnx_export.py)
PROGRAM_TOL = 1e-5            # the exported program's logits against the eager forward's
PROGRAM_MODELS = ("cvit", "cvit_repbn8")
EXPORT_BATCH = 4              # the program's fixed batch: phase 6's four crops
ONNX_TIMED_RUNS = 3           # run_onnx on the card, timed after a first run
# R4: KAN's grid refit on resvitkan's head (`kan_grid_phase`)
KAN_GRID_WEIGHT_TOL = 1e-5    # the refit weight card vs CPU, of its largest value (the solve is
                              # the CPU's on both; the right side's bmm rounds apart)
KAN_LOSS_RTOL = 1e-6          # regularization_loss card vs CPU, relative


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


def quantized_specs(name: str) -> list:
    """The stems' specs of the registry entry ``name`` as int8 serving runs
    them, value-free: `compat/fold.py`'s spec (each conv or deconv, with the
    BN after it folded in, one conv; BNs after the zoo's mixers stay), then
    `compat/quantize.py`'s plan of its conv prefix."""
    import torch
    import fac_fake_torch.models  # noqa: F401  (registers the entries)
    from fac_fake_torch.compat.quantize import _plan_stem
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.core.registry import get
    with torch.device("meta"):
        model = get("model", name)(ModelConfig(name=name))
    out = []
    for field, _, _ in model.stems():
        spec, folded, i = model.config[field], [], 0
        while i < len(spec):
            op = spec[i]
            if op[0] in ("conv", "deconv"):
                folded.append(("conv", op[1]))
                i += 2 if i + 1 < len(spec) and spec[i + 1][0] == "bn" else 1
            else:
                folded.append(op)
                i += 1
        out.append(_plan_stem(tuple(folded))[0])
    return out


def stem_walk(name: str = "cvit") -> list:
    """(H, Cin, Cout, fused, relu, source) of each K3 launch of one forward
    of the quantized CViT ``name`` from the crops, in order, from the
    stems' own planner (`quantized_specs`); ``fused``: the conv quantizes
    its output for the next conv; ``source`` of its int8 input: "k2" (K2's
    int8 entry), "quantize" (a later stem's quantize pass of its fp input),
    "conv" or "pool"."""
    from fac_fake_torch.models.stems import plan_walk
    hw, cin, out = 224, 3, []
    for k, spec in enumerate(quantized_specs(name)):
        steps, _ = plan_walk(spec)
        source = "k2" if k == 0 else "quantize"
        for st in steps:
            cout = spec[st.conv][1]
            out.append((hw, cin, cout, st.to is not None, st.relu, source))
            source = "pool" if st.pool else "conv"
            hw, cin = hw // (2 if st.pool else 1), cout
        hw //= 2 ** sum(op[0] == "pool" for op in spec[steps[-1].conv:])   # the fp tail
    return out


def int8_denses(name: str, batch: int = QBATCH) -> dict:
    """(rows, out, in, bias) of each int8_full dense of one forward of the
    registry entry ``name`` at ``batch`` crops -> how many: the patch
    embedding (one row a patch), to_qkv, to_out, FFN fc1 and fc2 (one row a
    token: the patches and the cls token), head fc1 (one a crop)."""
    import torch
    import fac_fake_torch.models  # noqa: F401  (registers the entries)
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.core.registry import get
    with torch.device("meta"):
        model = get("model", name)(ModelConfig(name=name))
    dim, k_pe = model.patch_to_embedding.weight.shape
    mlp, depth = model.mlp_head[0].weight.shape[0], len(model.transformer.layers)
    side = model.config["image_size"] // 2 ** sum(st.pools for _, _, st in model.stems())
    patches = (side // model.patch_size) ** 2
    rows, tokens = batch * patches, batch * (patches + 1)
    out = {}
    for key, n in (((rows, dim, k_pe, True), 1), ((tokens, 3 * dim, dim, False), depth),
                   ((tokens, dim, dim, True), depth), ((tokens, mlp, dim, True), depth),
                   ((tokens, dim, mlp, True), depth), ((batch, mlp, dim, True), 1)):
        out[key] = out.get(key, 0) + n
    return out


def k3_phase(rng, dev, name: str = "cvit", done: Optional[dict] = None) -> dict:
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
    int8 operands. ``done`` ({conv: its times}, filled here) holds each conv
    already checked and timed at another walk of this run (the zoo's two
    walks share their first six convs): its times are reused (`k3_conv`)."""
    from fac_fake_torch.ops import quant as q
    tot = dict(ms=0.0, conv_ms=0.0, quantize_ms=0.0, plain_ms=0.0, ms_deep=0.0, library_ms=0.0,
               bytes=0.0, bytes_old=0.0, ops=0.0, err=0.0, convs=0, fused=0, no_relu_fused=0)
    walk = stem_walk(name)
    groups = {}
    for key in walk:
        groups[key] = groups.get(key, 0) + 1
    done = {} if done is None else done
    for key, mult in groups.items():
        hw, cin, cout, fused, relu, source = key
        m = QBATCH * hw * hw
        ops = 2.0 * m * cout * 9 * cin
        params = 9 * cin * cout + 8 * cout
        x_new = 4 * m * cin + 4 if source == "quantize" else m * cin
        tot["bytes"] += mult * (x_new + params + (m * cout if fused else 4 * m * cout))
        tot["bytes_old"] += mult * (4 * m * cin + params + 4 + 4 * m * cout)
        tot["ops"] += mult * ops
        tot["convs"] += mult
        tot["fused"] += mult if fused else 0
        tot["no_relu_fused"] += mult if fused and not relu else 0
        if key not in done:
            done[key] = dict(k3_conv(rng, dev, key), walk=name)
        r = done[key]
        tot["conv_ms"] += mult * r["k_ms"]
        tot["plain_ms"] += mult * (r["p_ms"] + r.get("qp_plain_ms", 0.0))
        tot["quantize_ms"] += mult * r.get("qp_ms", 0.0)
        tot["err"] = max(tot["err"], r["err"])
        lib = "" if r["walk"] == name else f"; as checked and timed at {r['walk']}'s walk"
        if "l_ms" in r:
            tot["library_ms"] += mult * r["l_ms"]
            tot["ms_deep"] += mult * r["k_ms"]
            lib += f"; torch._int_mm on the im2col'd operands {r['l_ms']:.4f} ms"
        if "qp_ms" in r:
            lib += f"; its input's quantize pass {r['qp_ms']:.4f} ms (equal fp32+bf16)"
        log(f"K3 int8_conv3x3 ({QBATCH},{hw},{hw},{cin})->{cout} "
            f"{'-> int8' if fused else '-> fp'}{'' if relu else ' (no ReLU)'} x{mult}: equal "
            f"fp32+bf16 (layer, walk fp out, walk quantized); kernel {r['k_ms']:.4f} ms plain "
            f"{r['p_ms']:.4f} ms {ops / r['k_ms'] / 1e9:.1f} int8 TOP/s{lib}")
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


def k3_conv(rng, dev, key) -> dict:
    """`k3_phase`'s work at one distinct conv ``key`` (H, Cin, Cout, fused,
    relu, source) of a walk at batch QBATCH: K3 bit-equal to its plain
    versions in fp32 and bf16 (as JAX's layer, as the walk's step with fp
    out and quantized for the next conv; the quantize pass of a later
    stem's input), timed with its plain version (and torch._int_mm on the
    deep convs' im2col'd operands); returns the times and the error."""
    import torch
    import torch.nn.functional as F
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    hw, cin, cout, fused, relu, source = key
    m = QBATCH * hw * hw
    x, wq, sw, sx, b = quant_inputs(rng, dev, (QBATCH, hw, hw, cin), cout, 9 * cin)
    kq = wq.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)       # OIHW, O-HW-I memory
    s, w_k = sx * sw, q.conv3x3_rows(kq)
    from_fp = source in ("k2", "quantize")
    xq = q3.quantize_pad(x, sx) if from_fp else int8_image(rng, dev, (QBATCH, hw, hw,
                                                                      q.pad16(cin)), cin)
    out = {"err": 0.0}
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
            out["err"] = max(out["err"], err)
            if not torch.equal(got, want):
                raise AssertionError(f"K3 {hw}x{hw} {cin}->{cout} relu={relu} {dt} {what}: "
                                     f"differs from plain, max abs {err}")
        del checks, ref
    qs = qs if fused else None
    out["k_ms"] = cuda_ms(lambda: q.int8_conv3x3(xq, kq, s, b, relu, torch.float32, qs, w_k),
                          iters=10)
    out["p_ms"] = cuda_ms(lambda: q.int8_conv3x3_plain(xq, kq, s, b, relu, torch.float32, qs),
                          iters=2, warmup=1)
    if source == "quantize":
        out["qp_ms"] = cuda_ms(lambda: q3.quantize_pad(x, sx))
        out["qp_plain_ms"] = cuda_ms(lambda: q3.quantize_pad_plain(x, sx), iters=3)
    if hw <= 28:   # the deep convs: torch._int_mm on the im2col'd operands
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        cols = torch.stack([xp[:, dy:dy + hw, dx:dx + hw] for dy in range(3)
                            for dx in range(3)], 3).reshape(m, -1)
        if not torch.equal(torch._int_mm(cols, w_k.t()).reshape(QBATCH, hw, hw, cout),
                           q.int_conv3x3_plain(xq[..., :cin], kq)):
            raise AssertionError("torch._int_mm differs from the exact int32 conv")
        out["l_ms"] = cuda_ms(lambda: torch._int_mm(cols, w_k.t()))
        del xp, cols
    del x, xq, wq, kq, w_k
    torch.cuda.empty_cache()
    return out


def k4_phase(rng, dev, name: str = "cvit") -> dict:
    """K4 against its plain version at the 26 int8_full denses of the CViT
    ``name`` at batch 96 (`int8_denses`), beside torch._int_mm (the GEMM
    alone, on pre-quantized operands)."""
    import torch
    from fac_fake_torch.ops import quant as q
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0, bound_sum=0.0,
               err=0.0)
    denses = int8_denses(name)
    for (m, n, k, has_bias), mult in denses.items():
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
    log(f"K4 over one {name} int8_full forward's {sum(denses.values())} denses: kernel "
        f"{tot['ms']:.4f} ms plain "
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


def check_k3_calls(model, u8, pos, denses: bool = False) -> tuple:
    """One fp32 forward of the quantized CViT ``model`` from the uint8 crops
    ``u8`` in which K2's int8 entry, every K3 call and any quantize pass
    (and with ``denses`` every K4 call) also run through their plain
    versions on the same (real, calibrated) inputs and must be bit-equal:
    ({kind: calls checked}, "fused" among the convs those that quantize for
    the next conv, "no_relu_fused" those of them with no ReLU, "K4" the
    denses; the shapes of the no-ReLU ones)."""
    import torch
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    n = {"convs": 0, "fused": 0, "no_relu_fused": 0, "quantize": 0, "k2_int8": 0}
    no_relu = []
    orig = (q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops, q.quant_dense)

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

    def dense(x, kernel_q, w_scale, x_scale, bias=None):
        y = orig[3](x, kernel_q, w_scale, x_scale, bias)
        same(y, q.quant_dense_plain(x, kernel_q, w_scale, x_scale, bias),
             f"K4 dense {tuple(x.shape)} -> {kernel_q.shape[0]}")
        n["K4"] += 1
        return y

    # launches made here count on the checker's functions, not the wrappers'
    conv.launches = quantize.launches = entry.launches = dense.launches = 0
    q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops = conv, quantize, entry
    if denses:
        n["K4"], q.quant_dense = 0, dense
    try:
        with torch.inference_mode():
            model.forward_crops(u8, torch.float32, pos)
    finally:
        q.int8_conv3x3, q3.quantize_pad, pp.quantize_crops, q.quant_dense = orig
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
        self.cache: Optional[dict] = None      # (video, idx) -> frame, where a phase keeps them

    def frame(self, video: str, idx: int) -> np.ndarray:
        if self.cache is not None:
            key = (video, int(idx))
            if key not in self.cache:
                self.cache[key] = self._frame(video, idx)
            return self.cache[key]
        return self._frame(video, idx)

    def _frame(self, video: str, idx: int) -> np.ndarray:
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
    feats, errs = {}, {}
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
        errs[label] = err = float((gpu_l - cpu_l).abs().max())
        note = "" if label == "fp32" else "; free-running, information"
        log(f"full-width ca_s3d {label} logits card vs CPU ({t_cpu:.1f} s on the CPU): max abs "
            f"{err:.3g} (logit {float(cpu_l[0, 0]):.6g}{note}); head input "
            f"{tuple(cpu_f.shape)} error norm / its norm "
            f"{float((gpu_f - cpu_f).norm() / cpu_f.norm()):.3g}")
        if not (torch.isfinite(gpu_l).all() and (label == "int8" or err <= LOGIT_TOL)):
            raise AssertionError(f"ca_s3d {label} logits differ: {err} > {LOGIT_TOL}")
    # int8: its walk's fp steps (the 7 GCNet context blocks) round apart on the
    # two devices, and free-running, a value on a .5 tie of the next quantize
    # takes another code and carries it on (--seed 1: 0.00209, PERF.md §6).
    # So the int8 logits are held in lock-step, as S5 holds msca's
    lock = int8_lockstep(ev8.engine, u1, dev)
    log(f"full-width ca_s3d int8 card vs CPU in lock-step (the CPU's walk fed the card's "
        f"fp-block outputs, each within {lock['block_err']:.3g} of the CPU's own, bound "
        f"{S3D_FP_BLOCK_RTOL}, of its largest value): logits max abs {lock['logit_err']:.3g} "
        f"(bound {LOGIT_TOL}); free-running, above: {errs['int8']:.3g}")
    if not (lock["block_err"] <= S3D_FP_BLOCK_RTOL and lock["logit_err"] <= LOGIT_TOL):
        raise AssertionError(f"ca_s3d int8 card vs CPU in lock-step: {lock}")
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

    return dict(k5=k5, k6=k6, launches=s3d8_launches, ca_s3d_int8_free_err=errs["int8"],
                ca_s3d_int8_lockstep_err=lock["logit_err"], ca_s3d_fp_block_err=lock["block_err"],
                ca_s3d_head_int8_ratio=f8_err)


def crops_96(crops, dev) -> tuple:
    """A batch of QBATCH uint8 crops on the card (the 29 seeded crops
    repeated) and its legacy pos rows."""
    import torch
    u96 = torch.from_numpy(np.concatenate([crops] * 4)[:QBATCH]).to(dev)
    return u96, torch.arange(QBATCH, device=dev) % 32


def fp32_path(scorer, paths, crops, stacks, with_faces, name: str = "cvit",
              rates: dict = None, scores: dict = None) -> dict:
    """Phase 5 (base cvit), F1 (the flagship) and R2 (resvitkan):
    ``score_videos_batched`` over ``paths``, ``score_video`` over video_8,
    then the crops through ``score_crops`` and the stacks through
    ``score_crop_stacks``; scores in [0, 1], faces found where the synthetic
    face is and nowhere else, K1 and K2 launched (and K9, for a model with a
    KAN head). Returns the launches of K1 and K2 (and K9); ``rates``, if
    given, receives videos/min and the crops/s of both entries, ``scores``
    each video's score."""
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
    if scores is not None:
        scores.update(zip(paths, batched), video_8=single)
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


def logits_vs_cpu(model, four, what: str, plain: bool = False, rtol: float = 0.0,
                  atol: float = LOGIT_TOL) -> float:
    """Phases 6 and 10 (and F2, F4, Z1, Z3): ``model``'s fp32 logits from
    the uint8 crops ``four`` (on the CPU) on the card and on a copy of it on
    the CPU (``plain``: the kernels' plain versions run there), each within
    ``atol + rtol·|CPU's|`` (LOGIT_TOL unless given) and finite."""
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
    if not (torch.isfinite(gpu).all() and ((gpu - cpu).abs() <= atol + rtol * cpu.abs()).all()):
        raise AssertionError(f"{what} differ: {err} > {atol} + {rtol} x |logit|")
    return err


def evaluation_phase(seed, scores: dict, with_faces, launches: dict) -> dict:
    """E1: phase 5's scores (video -> fake-probability, 0.5 where no face was
    found) through `write_predictions_csv` (the writer of
    `VideoScorer.predict_to_csv`; the card's machine decodes no mp4) to a
    temporary CSV, each video as ``<name>.mp4`` and ``video_8`` bare (the
    metadata's ``name + ".mp4"`` lookup); a seeded metadata.json labels the
    7 face videos FAKE or REAL (both classes), the 2 without a face, and
    EVAL_UNJOINED, which no row names. `evaluate_prediction_csv`,
    `legacy_int_accuracy` (on integer labels) and ``cli/evaluate.py csv``
    (both modes) must equal a plain computation over the probabilities in
    memory exactly: accuracy, count, AUC (the Mann-Whitney U, pair by
    pair), the no-face rows' 0.5 dropped, the legacy accuracy over all 9
    rows."""
    import io
    from fac_fake_torch.cli import evaluate as cli_eval
    from fac_fake_torch.evaluate.metrics import evaluate_prediction_csv, legacy_int_accuracy
    from fac_fake_torch.infer.predictor import write_predictions_csv
    rng = np.random.default_rng([seed, 22])
    videos = sorted(scores, key=lambda v: int(v.rsplit("_", 1)[1]))
    faces = [v for v in videos if v in with_faces]
    fake = dict(zip(faces, rng.permutation([i % 2 for i in range(len(faces))]).tolist()))
    fake.update({v: int(rng.integers(2)) for v in videos if v not in fake})
    row = lambda v: v if v == "video_8" else f"{v}.mp4"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        csv_path, meta_path, int_path = (os.path.join(d, f) for f in
                                         ("pred.csv", "metadata.json", "int_labels.json"))
        write_predictions_csv(csv_path, [(row(v), scores[v]) for v in videos])
        meta = {f"{v}.mp4": {"label": "FAKE" if fake[v] else "REAL"} for v in videos}
        meta.update({n: {"label": "FAKE"} for n in EVAL_UNJOINED})
        with open(meta_path, "w") as fh:
            json.dump(meta, fh)
        with open(int_path, "w") as fh:
            json.dump({row(v): fake[v] for v in videos}, fh)
        got = evaluate_prediction_csv(csv_path, meta_path)
        legacy = legacy_int_accuracy(csv_path, int_path)
        printed = []
        for args in (["csv", "--csv", csv_path, "--metadata", meta_path],
                     ["csv", "--csv", csv_path, "--metadata", int_path, "--legacy-int-labels"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli_eval.main(args)
            printed.append(out.getvalue().strip())
    t = time.perf_counter() - t0
    # the plain computation, over the probabilities in memory
    kept = [(fake[v], scores[v]) for v in videos if scores[v] != 0.5]
    pos = [p for y, p in kept if y]
    neg = [p for y, p in kept if not y]
    u = sum(1.0 if a > b else 0.5 if a == b else 0.0 for a in pos for b in neg)
    want = {"accuracy": sum((p >= 0.5) == bool(y) for y, p in kept) / len(kept),
            "count": len(kept), "auc": u / (len(pos) * len(neg))}
    want_legacy = sum((scores[v] < 0.5) == bool(fake[v]) for v in videos) / len(videos)
    lines = [f"accuracy: {want['accuracy'] * 100:.2f}%  AUC: {want['auc']:.4f}  "
             f"({want['count']} scored)", f"prediction Acc: {want_legacy * 100:.2f}%"]
    no_face = [v for v in videos if v not in with_faces]
    log(f"E1 evaluation of phase 5's {len(videos)} scores ({t:.2f} s; K1 {launches['K1']} and "
        f"K2 {launches['K2']} launches made them): {got}; legacy int-label accuracy {legacy}; "
        f"plain {want}, legacy {want_legacy}; the no-face rows {no_face} at "
        f"{[scores[v] for v in no_face]} dropped; CLI {printed}")
    if not (got == want and legacy == want_legacy and printed == lines
            and all(scores[v] == 0.5 for v in no_face) and len(kept) == len(faces)
            and pos and neg):
        raise AssertionError(f"E1: the CSV evaluation {got}, {legacy}, {printed} against the "
                             f"plain computation {want}, {want_legacy}, {lines}")
    return dict(want, legacy_accuracy=legacy, seconds=t, launches=dict(launches))


def gradcam_phase(seed, dev, four) -> dict:
    """G1: `gradcam` and `gradcam_tokens` of each of CAM_MODELS at full
    width (seeded, unfolded, eval) on phase 6's four uint8 crops, on the
    card (the crops normalized by K2: one launch a call, and K2's plain
    version never run on the card) and on a CPU copy, explaining CAM_TARGET
    on both, held by `cam_rule`: the raw CAM (`gradcam_raw`, before the
    min-max) within CAM_RAW_TOL x the CPU's largest value +
    TRAIN_GRAD_F64_RATIO x the CPU's distance from a float64 CAM, the
    min-maxed one within CAM_NORM_TOL + the same factor x its own, max abs.
    The float64 CAM is a float64 copy of the CPU model on the crops
    normalized in float64 (``(x/255 - mean)/std``, as `_f64_grads`). The
    argmax's agreement card vs CPU is printed, not held (near-tie logits),
    and the ms of a call at batch 4."""
    import torch
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.evaluate import gradcam as gc
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import preprocess as pp
    plain = pp.normalize_imagenet_plain
    x64 = ((four.double() / 255.0 - torch.from_numpy(pp.IMAGENET_MEAN).double())
           / torch.from_numpy(pp.IMAGENET_STD).double()).permute(0, 3, 1, 2)
    on_card = []

    def watched(x, *a, **k):
        if x.is_cuda:
            on_card.append(tuple(x.shape))
        return plain(x, *a, **k)

    out, f64_s = {}, 0.0
    u8 = four.to(dev)
    pp.normalize_imagenet_plain = watched
    try:
        for name in CAM_MODELS:
            model = build_model(ModelConfig(name=name), device=dev, seed=seed)
            cpu = copy.deepcopy(model).cpu()
            cpu64 = copy.deepcopy(cpu).double()
            with torch.no_grad():
                agree = int((model.forward_crops(u8).argmax(-1).cpu()
                             == cpu.forward_crops(four).argmax(-1)).sum())
            res = {"argmax_agree": agree}
            for mode, fn in (("cnn", gc.gradcam_raw), ("tokens", gc.gradcam_tokens_raw)):
                pp.normalize_imagenet.launches = 0
                card = fn(model, u8, CAM_TARGET)
                k2 = pp.normalize_imagenet.launches
                ref = fn(cpu, four, CAM_TARGET)
                t64 = time.perf_counter()
                ref64 = fn(cpu64, x64, CAM_TARGET)
                f64_s += time.perf_counter() - t64
                largest = float(ref.abs().max())
                raw_err = float((card.cpu() - ref).abs().max())
                norm_err = float(np.abs(gc.minmax(card) - gc.minmax(ref)).max())
                raw64 = float((ref.double() - ref64).abs().max())
                norm64 = float(np.abs(gc.minmax(ref) - gc.minmax(ref64)).max())
                card64 = float((card.cpu().double() - ref64).abs().max())
                fn(model, u8, CAM_TARGET)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CAM_TIMED_CALLS):
                    fn(model, u8, CAM_TARGET)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / CAM_TIMED_CALLS * 1e3
                rule = cam_rule(raw_err, largest, raw64, norm_err, norm64)
                res[mode] = dict(shape=list(card.shape), largest=largest, raw_err=raw_err,
                                 norm_err=norm_err, cpu_vs_f64=raw64, norm_cpu_vs_f64=norm64,
                                 card_vs_f64=card64, k2_launches=k2, ms=ms, **rule)
                if not (rule["raw_holds"] and rule["norm_holds"]
                        and k2 == 1 and torch.isfinite(card).all()):
                    raise AssertionError(f"G1 {name} {mode}: CAM card vs CPU {res[mode]} (K2 "
                                         f"launches want 1)")
            log(f"G1 {name} Grad-CAM at batch {four.shape[0]}, class {CAM_TARGET}: argmax card vs "
                f"CPU agrees on {agree} of {four.shape[0]}; "
                + "; ".join(f"{mode} {r['shape']}: raw CAM card vs CPU {r['raw_err']:.3g} <= "
                            f"{CAM_RAW_TOL} x {r['largest']:.3g} + {TRAIN_GRAD_F64_RATIO} x the "
                            f"CPU's {r['cpu_vs_f64']:.3g} from float64 = {r['raw_bound']:.3g} "
                            f"(the card's {r['card_vs_f64']:.3g}), min-maxed {r['norm_err']:.3g} "
                            f"<= {CAM_NORM_TOL} + {TRAIN_GRAD_F64_RATIO} x "
                            f"{r['norm_cpu_vs_f64']:.3g} = {r['norm_bound']:.3g}; "
                            f"{r['k2_launches']} K2 launch, {r['ms']:.2f} ms a call"
                            for mode, r in res.items() if mode != "argmax_agree"))
            out[name] = res
            del model, cpu, cpu64
            torch.cuda.empty_cache()
    finally:
        pp.normalize_imagenet_plain = plain
    log(f"G1 float64 CAMs on the CPU: {f64_s:.1f} s")
    if on_card:
        raise AssertionError(f"G1: K2's plain version ran on the card: {on_card}")
    out["f64_s"] = f64_s
    return out


def profiling_phase(scorer, crops, dev, smi: str) -> dict:
    """U1: `utils/profiling.py` on the card. `flops_estimate` of the base
    cvit's forward at batch 1 equals 2 x the multiply-adds of its convs,
    linears and attention products counted from their shapes (forward hooks);
    `trace` around one fp32 `score_crops` call writes a Chrome trace that
    names K2's `normalize_table`; `time_fn` of that call and of a batch-96
    `forward_crops` (whose output is not waited for by the call) at least
    WAIT_SHARE x their device time (`cuda_ms`): less would be a time_fn that
    did not wait."""
    import torch
    from fac_fake_torch.models.layers import MultiHeadSelfAttention
    from fac_fake_torch.utils import profiling
    model = scorer.model
    x = torch.from_numpy(crops[:1]).to(dev)
    macs = []

    def count(m, args, y):
        if isinstance(m, torch.nn.Conv2d):
            macs.append(y.numel() * m.weight[0].numel())
        elif isinstance(m, torch.nn.Linear):
            macs.append(y.numel() * m.in_features)
        else:                           # q k^T and attn v: b·n·n·dim each
            b, n, d = args[0].shape
            macs.append(2 * b * n * n * d)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, MultiHeadSelfAttention))]
    with torch.no_grad():
        flops = profiling.flops_estimate(lambda: model.forward_crops(x))
    for h in hooks:
        h.remove()
    want = 2 * sum(macs)
    from fac_fake_torch.ops import preprocess as pp
    pp.normalize_imagenet.launches = 0
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            scorer.score_crops(crops)
        k2 = pp.normalize_imagenet.launches
        with open(os.path.join(d, profiling.TRACE_FILE)) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    k2_named = sorted(n for n in names if "normalize_table" in n)
    u96, pos96 = crops_96(crops, dev)
    timed = {}
    for what, fn in (("score_crops", lambda: scorer.score_crops(crops)),
                     (f"forward_crops batch {QBATCH}",
                      lambda: model.forward_crops(u96, torch.float32, pos96))):
        with torch.no_grad():
            wall = profiling.time_fn(fn)[0] * 1e3
            device = cuda_ms(fn, iters=10)
        timed[what] = {"time_fn_ms": wall, "cuda_ms": device}
    log(f"U1 profiling ({smi}): flops_estimate of cvit's forward at batch 1 {flops:.6g}, from "
        f"the shapes {want:.6g}; the trace of one score_crops call ({k2} K2 launch) names "
        f"{k2_named}; time_fn "
        f"against cuda_ms: {timed}")
    if not (flops == want and k2_named and k2 == 1
            and all(t["time_fn_ms"] >= WAIT_SHARE * t["cuda_ms"] for t in timed.values())):
        raise AssertionError(f"U1: flops {flops} against {want}, K2 in the trace {k2_named}, "
                             f"time_fn against cuda_ms {timed}")
    return dict(flops=flops, k2_in_trace=k2_named, k2_launches=k2, timed=timed)


def export_phase(seed, model, four, dev) -> dict:
    """X1: the three export formats of the full-width base ``model`` (phase
    5's, seeded, unfolded) on the card, on phase 6's four uint8 crops, each
    normalized by K2 (one launch a normalize; its plain version never on
    the card). ONNX: `export_onnx_cvit`, parsed back and run by `run_onnx`
    on the card and on the CPU on the first crop, each within ONNX_TOL of
    the eager card forward's logits; the file's size and ms a card run.
    Program: `export_program` of each of PROGRAM_MODELS at batch
    EXPORT_BATCH, `load_program` on the card within PROGRAM_TOL of the eager
    forward on the same K2 output (bit-equality printed); the seconds to
    export. ``.pth``: `export_state_dict`, `torch.save`, a ``strict=True``
    load into a model built at another seed, its logits bit-equal. CLI:
    ``cli/export.py`` once a format, from that ``.pth``, its line checked
    and its output held as above (its ONNX file byte-equal to the one
    exported here, its program within PROGRAM_TOL, its ``.pth`` equal)."""
    import re

    import torch
    from fac_fake_torch.cli import export as cli_export
    from fac_fake_torch.compat.export import export_program, load_program
    from fac_fake_torch.compat.onnx_export import export_onnx_cvit, run_onnx
    from fac_fake_torch.compat.onnx_proto import parse_model
    from fac_fake_torch.compat.weights import export_state_dict, load_reference_pth
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import preprocess as pp
    plain = pp.normalize_imagenet_plain
    on_card = []

    def watched(x, *a, **k):
        if x.is_cuda:
            on_card.append(tuple(x.shape))
        return plain(x, *a, **k)

    def logits(m, x):
        with torch.no_grad():
            return m(x).float()

    out = {}
    u8 = four.to(dev)
    pp.normalize_imagenet_plain = watched
    try:
        pp.normalize_imagenet.launches = 0
        x1, x4 = pp.normalize_imagenet(u8[:1]), pp.normalize_imagenet(u8)
        k2 = pp.normalize_imagenet.launches
        eager1, eager4 = logits(model, x1), logits(model, x4)
        with tempfile.TemporaryDirectory() as d:
            # ONNX
            path = os.path.join(d, "cvit.onnx")
            t0 = time.perf_counter()
            blob = export_onnx_cvit(model, path)
            onnx_s = time.perf_counter() - t0
            parsed = parse_model(path)
            card = run_onnx(parsed, {"input": x1}, dev)["logits"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ONNX_TIMED_RUNS):
                run_onnx(parsed, {"input": x1}, dev)
            torch.cuda.synchronize()
            onnx_ms = (time.perf_counter() - t0) / ONNX_TIMED_RUNS * 1e3
            cpu = run_onnx(parsed, {"input": x1.cpu()}, "cpu")["logits"]
            del parsed
            onnx_err = {"card": float((card - eager1).abs().max()),
                        "cpu": float((cpu - eager1.cpu()).abs().max())}
            out["onnx"] = dict(bytes=len(blob), export_s=onnx_s, ms=onnx_ms, err=onnx_err,
                               opset=12)
            log(f"X1 ONNX of cvit: {len(blob)} bytes in {onnx_s:.2f} s, opset 12; run_onnx on "
                f"the card {onnx_ms:.2f} ms a run; logits against the eager card forward on "
                f"K2's normalize of one crop: card {onnx_err['card']:.3g}, CPU "
                f"{onnx_err['cpu']:.3g} (bound {ONNX_TOL}; |logit| max "
                f"{float(eager1.abs().max()):.3g})")
            if not (max(onnx_err.values()) <= ONNX_TOL and torch.isfinite(card).all()):
                raise AssertionError(f"X1 ONNX logits off the eager forward's: {onnx_err}")
            # the exported program, at batch EXPORT_BATCH
            out["program"] = {}
            for name in PROGRAM_MODELS:
                m = model if name == "cvit" else build_model(ModelConfig(name=name),
                                                             device=dev, seed=seed)
                ppath = os.path.join(d, f"{name}.pt2")
                t0 = time.perf_counter()
                export_program(m, tuple(x4.shape), ppath)
                export_s = time.perf_counter() - t0
                got = logits(load_program(ppath), x4)
                want = eager4 if name == "cvit" else logits(m, x4)
                err = float((got - want).abs().max())
                out["program"][name] = dict(export_s=export_s, err=err,
                                            bit_equal=bool(torch.equal(got, want)),
                                            bytes=os.path.getsize(ppath))
                log(f"X1 program of {name} at batch {EXPORT_BATCH}: exported in {export_s:.2f} s "
                    f"({out['program'][name]['bytes']} bytes); loaded on the card, logits against "
                    f"the eager forward max abs {err:.3g} (bound {PROGRAM_TOL}), bit-equal "
                    f"{out['program'][name]['bit_equal']}")
                if not (err <= PROGRAM_TOL and torch.isfinite(got).all()):
                    raise AssertionError(f"X1 program of {name}: logits off by {err}")
                del m
                os.remove(ppath)
            # the reference-layout .pth, reloaded strictly into another build
            pth = os.path.join(d, "cvit.pth")
            sd = export_state_dict(model)
            torch.save(sd, pth)
            fresh = build_model(ModelConfig(name="cvit"), device=dev, seed=seed + 1)
            fresh.load_state_dict(load_reference_pth(pth), strict=True)
            reloaded = logits(fresh, x4)
            out["pth"] = dict(tensors=len(sd), bit_equal=bool(torch.equal(reloaded, eager4)))
            log(f"X1 .pth of cvit: {len(sd)} tensors, reference layout, loaded strict=True into "
                f"a build at seed {seed + 1}: logits bit-equal {out['pth']['bit_equal']}")
            if not out["pth"]["bit_equal"]:
                raise AssertionError("X1: the reloaded .pth's logits differ from the model's")
            del fresh
            # the CLI, once a format, from that .pth
            lines = {}
            for fmt, ext, tail in (("onnx", "onnx", r"\((\d+) bytes, opset 12\)"),
                                   ("program", "pt2", r"\((\d+) bytes, torch\.export\)"),
                                   ("torch", "pth", r"\((\d+) tensors, reference layout\)")):
                target = os.path.join(d, f"cli.{ext}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    cli_export.main([fmt, target, "--weights", pth, "--batch", str(EXPORT_BATCH),
                                     "--device", "cuda"])
                lines[fmt] = buf.getvalue().strip()
                hit = re.fullmatch("wrote " + re.escape(target) + " " + tail, lines[fmt])
                if fmt == "onnx":
                    with open(target, "rb") as fh:
                        same = fh.read() == blob
                elif fmt == "program":
                    same = float((logits(load_program(target), x4) - eager4).abs().max()) \
                        <= PROGRAM_TOL
                else:
                    again = load_reference_pth(target)
                    same = sorted(again) == sorted(sd) and all(torch.equal(again[k], sd[k])
                                                               for k in sd)
                size = os.path.getsize(target) if fmt != "torch" else len(sd)
                if not (hit and int(hit.group(1)) == size and same):
                    raise AssertionError(f"X1 cli/export.py {fmt}: {lines[fmt]!r}, its output "
                                         f"{'matches' if same else 'differs'}")
                os.remove(target)
            out["cli"] = lines
            log(f"X1 cli/export.py from the .pth: {lines}; each output as above (the ONNX file "
                f"byte-equal, the program's logits within {PROGRAM_TOL}, the .pth's tensors "
                f"equal)")
    finally:
        pp.normalize_imagenet_plain = plain
    if on_card or k2 != 2:
        raise AssertionError(f"X1: K2 launches {k2} (want 2), its plain version on the card "
                             f"{on_card}")
    out["k2_launches"] = k2
    return out


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
                        K4=sum(int8_denses(name).values()) if mode == "int8_full" else 0)
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


def k7_phase(rng, dev, dtype: str = "float32") -> dict:
    """T1 (``dtype`` bfloat16: B1's half of it, on bf16 images, with
    K7_BF16_SUBSETS too): K7 (the strong_aug chain's CLAHE step) against
    its plain versions, bit-equal. The whole-batch entry `clahe_luma` at (8|32, 224, 224, 3) on
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
    dt = getattr(torch, dtype)
    esize = torch.finfo(dt).bits // 8
    d255 = torch.full((1,), 255.0, device=dev, dtype=dt)
    to01 = lambda u8: (torch.from_numpy(u8).to(dev).to(dt) / d255).contiguous()
    tag = "" if dtype == "float32" else f" {dtype}"
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
        if not torch.equal(got, ref) or got.dtype != dt:
            raise AssertionError(f"K7{tag} {name} {tuple(x.shape)}: differs from plain by {e}")
        log(f"K7{tag} clahe_luma {name} {tuple(x.shape)} grid "
            f"{aug.clahe_grid(*x.shape[1:3])}: bit-equal to plain")

    side = side_rng(rng)

    def seeded_take(n, takers):
        take = np.zeros(n, bool)
        take[side.choice(n, takers, replace=False)] = True
        return torch.from_numpy(take).to(dev)

    subsets = dict(K7_SUBSETS)
    if dtype != "float32":
        subsets.update({f"bf16 {k}": v for k, v in K7_BF16_SUBSETS.items()})
    for name, (shape, takers, kb) in subsets.items():
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
            raise AssertionError(f"K7{tag} clahe_subset_ {name} {shape}, {takers} takers, "
                                 f"budget {kb}: differs from plain by {e}, or an untaken image "
                                 f"moved")
        log(f"K7{tag} clahe_subset_ {name} {shape}, {takers} takers, budget {kb}: bit-equal "
            f"to plain, {int((~done).sum())} untaken images unchanged")

    x8 = to01(cases[0][1])
    nbytes = 2.0 * x8.numel() * esize
    n_rot = int(2 * L2_BYTES // nbytes) + 2
    rot = [x8] + [x8.clone() for _ in range(n_rot - 1)]
    k_ms = rotated_ms(aug.clahe_luma, rot)
    w_ms = cuda_ms(lambda: aug.clahe_luma(x8))
    pairs = [(torch.empty_like(x), x) for x in rot]
    c_ms = rotated_ms(lambda pair: pair[0].copy_(pair[1]), pairs)
    p_ms = cuda_ms(lambda: aug.clahe_luma_plain(x8), iters=3)
    del rot, pairs
    b_ms, b_by = bound_ms(nbytes, K7_OPS_PER_PIXEL * x8.numel() / 3)
    log(f"K7{tag} at {tuple(x8.shape)}, all taken: kernel {k_ms:.4f} ms cold ({b_ms / k_ms:.1%} "
        f"of the bound, {n_rot} buffer pairs), {w_ms:.4f} ms warm; copy_ of the same bytes "
        f"{c_ms:.4f} ms cold; plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.2f} MB)")

    # the trainer's step: 8 of 32 images taken, in place
    kb = 8
    x32 = to01(side.integers(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=np.uint8))
    take = seeded_take(TRAIN_BATCH, K7_TRAIN_TAKERS)
    taken = min(K7_TRAIN_TAKERS, kb)
    s_bytes = 2.0 * taken * x32[0].numel() * esize + take.numel()
    n_rot = int(2 * L2_BYTES // (x32.numel() * esize)) + 2
    rot = [x32] + [x32.clone() for _ in range(n_rot - 1)]
    s_ms = rotated_ms(lambda x: aug.clahe_subset_(x, take, kb), rot)
    s_warm = cuda_ms(lambda: aug.clahe_subset_(x32, take, kb))
    s_plain = cuda_ms(lambda: aug.clahe_subset_plain_(x32, take, kb), iters=3)
    # copy_ of the same bytes at the trainer's step: the taken images' read and write
    idx = torch.nonzero(take).flatten()[:kb]
    s_pairs = [(torch.empty((taken, *x32.shape[1:]), device=dev, dtype=dt),
                x.index_select(0, idx)) for x in rot]
    s_copy = rotated_ms(lambda pair: pair[0].copy_(pair[1]), s_pairs)
    del rot, s_pairs
    sb_ms, sb_by = bound_ms(s_bytes, K7_OPS_PER_PIXEL * taken * x32[0].numel() / 3)
    log(f"K7{tag} at the trainer's step, clahe_subset_ on {tuple(x32.shape)}, "
        f"{K7_TRAIN_TAKERS} takers, budget {kb}: kernel {s_ms:.4f} ms cold ({sb_ms / s_ms:.1%} "
        f"of the bound, {n_rot} buffers), {s_warm:.4f} ms warm; copy_ of the taken images' "
        f"bytes {s_copy:.4f} ms cold (of the 8 images above {c_ms:.4f}); plain {s_plain:.4f} "
        f"ms; bound {sb_ms:.4f} ms ({sb_by}, {s_bytes / 1e6:.2f} MB)")
    return dict(ms=k_ms, warm_ms=w_ms, copy_ms=c_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, err=err, subset_ms=s_ms, subset_warm_ms=s_warm,
                subset_plain_ms=s_plain, subset_bound_ms=sb_ms, subset_bound_by=sb_by,
                subset_copy_ms=s_copy)


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


def train_phase(name, seed, dev, data, profile: bool = False, ckpt_dir: str = "",
                dtype: str = "float32", timed_steps: int = TRAIN_TIMED_STEPS,
                fit: bool = True) -> tuple:
    """T2 (base cvit) and T4's first half (the flagship), and with ``dtype``
    bfloat16 B2's (``model.dtype``: bf16 compute over fp32 master weights,
    the chain in bf16, K7's and K2's bf16 modes): `Trainer` at full
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
    number of training forwards, and no ``warm`` below 0. Z4 (the zoo) at
    ``timed_steps`` and without ``fit``: the timed steps are the main path,
    with the counts set to 0 before them: one K7 call a step, no K2 launch.
    Returns the numbers and the trained model."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import augment as aug
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.train.trainer import Trainer
    imgs, labels = data
    cfg = Config()
    cfg.model.name = name
    cfg.model.dtype = dtype
    cfg.train.epochs = 1
    cfg.train.log_every = 0
    cfg.train.checkpoint_dir = ckpt_dir
    cfg.train.checkpoint_every = 1 if ckpt_dir else 0
    model = build_model(cfg.model, device=dev, seed=seed)
    tr = Trainer(model, cfg)
    name = name if dtype == "float32" else f"{name} {dtype}"
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
    aug.clahe_luma.launches = aug.clahe_luma.bf16_launches = 0
    pp.normalize_imagenet.launches = 0
    t0 = time.perf_counter()
    for i in range(timed_steps):
        tr.train_step(batch(i % train.steps), gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_launches = {"K7": aug.clahe_luma.launches, "K7_bf16": aug.clahe_luma.bf16_launches,
                     "K2": pp.normalize_imagenet.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall, busy = profile_forward(lambda: tr.train_step(batch(0), gen),
                                 f"{name} train step, batch {TRAIN_BATCH}",
                                 top=12 if profile else 0, expect=("clahe_subset",),
                                 inference=False)
    if profile:
        vb = {"image": val.images, "label": val.labels, "mask": ones}
        profile_forward(lambda: tr.eval_step(vb), f"{name} eval step, batch {TRAIN_BATCH}",
                        expect=("normalize_table",))
    step_ms = dt / timed_steps * 1e3
    timing = dict(step_ms=step_ms, crops_per_s=TRAIN_BATCH * timed_steps / dt, batch=TRAIN_BATCH,
                  peak_gb=peak_gb, traced_wall_ms=wall, traced_busy_ms=busy,
                  traced_busy_share=busy / wall, busy_share=busy / step_ms,
                  step_launches=step_launches)
    log(f"{name} training at batch {TRAIN_BATCH}: {timing['crops_per_s']:.1f} train crops/s, "
        f"{step_ms:.2f} ms a step ({timed_steps} steps after a warm-up step); one traced "
        f"step {wall:.2f} ms wall (the profiler's overhead in it), device busy {busy:.2f} ms: "
        f"{busy / wall:.1%} of the traced step, {busy / step_ms:.1%} of an untraced step; peak "
        f"memory {peak_gb:.2f} GB; launches over the timed steps {step_launches}")
    want = {"K7": timed_steps, "K7_bf16": timed_steps if dtype == "bfloat16" else 0, "K2": 0}
    if step_launches != want:
        raise AssertionError(f"{name}: want one K7 call a train step, in its {dtype} mode, and "
                             f"no K2 launch over {timed_steps} steps: {step_launches}")
    if not fit:
        return dict(timing, dtype=dtype), model

    aug.clahe_luma.launches = aug.clahe_luma.bf16_launches = 0
    pp.normalize_imagenet.launches = 0
    steps0 = tr.step
    t0 = time.perf_counter()
    out = tr.fit(train, val)
    t_fit = time.perf_counter() - t0
    launches = {"K7": aug.clahe_luma.launches, "K2": pp.normalize_imagenet.launches}
    bf16_k7 = aug.clahe_luma.bf16_launches
    h = out["history"]
    fit_steps = tr.step - steps0
    log(f"{name} fit, 1 epoch of {fit_steps} steps and {val.steps} eval batch(es): "
        f"{t_fit:.2f} s; train loss {h['train_loss'][0]:.4f} acc {h['train_acc'][0]:.4f}, "
        f"val loss {h['val_loss'][0]:.4f} acc {h['val_acc'][0]:.4f}; launches {launches}")
    if not all(np.isfinite(h[k][0]) for k in ("train_loss", "val_loss")):
        raise AssertionError(f"{name}: losses not finite: {h}")
    if launches != {"K7": fit_steps, "K2": val.steps} \
            or bf16_k7 != (fit_steps if dtype == "bfloat16" else 0):
        raise AssertionError(f"{name}: want 1 K7 call a train step ({fit_steps}), in its "
                             f"{dtype} mode, and 1 K2 launch an eval batch ({val.steps}), got "
                             f"{launches}, {bf16_k7} in bf16")

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
                fixed_losses=losses, history={k: h[k] for k in ("train_loss", "val_loss")},
                dtype=dtype), model


def _replayed(model) -> list:
    """(name, module) of each module of ``model`` that owns a parameter (the
    root aside) or is an attention core: what `replay_layers` runs again."""
    return [(n, m) for n, m in model.named_modules()
            if n and (any(True for _ in m.parameters(recurse=False))
                      or type(m).__name__ == "MultiHeadSelfAttention")]


def record_layers(model) -> tuple:
    """Hooks on `_replayed` modules that keep, from the first call of each
    in the next training step, its inputs and its output's gradient;
    returns (the dict they fill, the hooks)."""
    import torch
    rec = {}

    def hook(name):
        def fn(m, args, kwargs, out):
            if name in rec or not torch.is_tensor(out) or not out.requires_grad:
                return
            e = rec[name] = {"args": [a.detach().clone() if torch.is_tensor(a) else a
                                      for a in args], "kwargs": kwargs}
            out.register_hook(lambda g: e.__setitem__("gy", g.detach().clone()))
        return fn
    return rec, [m.register_forward_hook(hook(n), with_kwargs=True)
                 for n, m in _replayed(model)]


def _replay(mod, e, device, f64: bool) -> dict:
    """One module's forward and backward, in training mode, on its recorded
    inputs and output gradient: its output and every gradient, float64 on
    the CPU."""
    import torch
    m = copy.deepcopy(mod).to(device).train()
    if f64:
        m = m.double()
    args = [a.to(device, torch.float64 if f64 else a.dtype, copy=True).requires_grad_(True)
            if torch.is_tensor(a) and a.is_floating_point() else a for a in e["args"]]
    y = m(*args, **e["kwargs"])
    y.backward(e["gy"].to(device, y.dtype))
    out = {"out": y.detach()}
    out.update({f"input{i}.grad": a.grad for i, a in enumerate(args)
                if torch.is_tensor(a) and a.grad is not None})
    out.update({f"{k}.grad": p.grad for k, p in m.named_parameters() if p.grad is not None})
    return {k: v.double().cpu() for k, v in out.items()}


def replay_layers(before, rec, what: str) -> dict:
    """B2/B3: the card's bf16 training step held layer by layer. ``before``
    is the model as the step found it, ``rec`` what `record_layers` kept
    of the step. Each recorded module is run again on the card and on the
    CPU (bf16) and in float64 on the CPU (`_replay`); each tensor's
    distance to float64 on the card within BF16_LAYER_RATIO x the CPU's +
    BF16_LAYER_SLACK, and the left-out share (see BF16_LAYER_SLACK) under
    BF16_LAYER_LEFT_OUT. A zero gradient (the control) reads 1.0."""
    mods = dict(before.named_modules())
    dev = next(before.parameters()).device
    worst, over, n_all, n_left, tensors = [], [], 0, 0, 0
    for name, e in rec.items():
        if "gy" not in e:                    # an output no loss depends on
            continue
        card, cpu, f64 = (_replay(mods[name], e, d, f) for d, f in
                          ((dev, False), ("cpu", False), ("cpu", True)))
        for k, ref in f64.items():
            r = float(ref.norm())
            if r == 0.0:
                continue
            d_card, d_cpu = (float((t[k] - ref).norm()) / r for t in (card, cpu))
            bound = BF16_LAYER_RATIO * d_cpu + BF16_LAYER_SLACK
            tensors += 1
            n_all += ref.numel()
            if bound >= 1.0:
                n_left += ref.numel()
            worst.append((d_card / bound, f"{name}.{k}", d_card, d_cpu))
            if not d_card <= bound:              # NaN too
                over.append((f"{name}.{k}", d_card, d_cpu))
    worst.sort(reverse=True)
    res = dict(modules=len(rec), tensors=tensors, left_out_share=n_left / max(n_all, 1),
               worst=[(k, round(c, 6), round(p, 6)) for _, k, c, p in worst[:5]],
               worst_of_bound=worst[0][0] if worst else 0.0,
               card_vs_f64_max=max((c for _, _, c, _ in worst), default=0.0),
               cpu_vs_f64_max=max((p for _, _, _, p in worst), default=0.0))
    log(f"{what} bf16 step layer by layer ({res['modules']} modules, {tensors} tensors: "
        f"output, input and parameter gradients), card vs float64 within "
        f"{BF16_LAYER_RATIO} x CPU + {BF16_LAYER_SLACK:.4g}: at {res['worst_of_bound']:.3g} of "
        f"the bound at worst, largest distance card {res['card_vs_f64_max']:.3g}, CPU "
        f"{res['cpu_vs_f64_max']:.3g} (a zero gradient: 1.0); left out {res['left_out_share']:.2%}"
        f" (bound {BF16_LAYER_LEFT_OUT:.0%}); worst tensors (card, CPU) {res['worst']}")
    if over or res["left_out_share"] >= BF16_LAYER_LEFT_OUT or not tensors:
        raise AssertionError(f"{what}: bf16 layers card vs float64 out of bounds: {over[:10]}, "
                             f"{res}")
    return res


def _flat_max(m, x):
    """``x`` with a `MaxOver` module's dims moved last and flattened: its
    max is the last axis's."""
    k = len(m.dims)
    return x.movedim(m.dims, tuple(range(x.dim() - k, x.dim()))).flatten(-k)


def _record_routes(model) -> tuple:
    """Record the choices of ``model``'s next forward: each 2x2 max-pool's
    argmax indices (by hooks, in call order), each `MaxOver` call's argmax
    (GGCA's, TFAM's and SMFA's maxima), each ScConv SRU's gate
    (`SRU.gate`, which values pass whole: a step at ``rew = 0.5``, so a
    value within rounding of it changes the forward on one device and not
    on another) and each `nn.ReLU` call's positives (a BatchNorm output
    within rounding of 0 takes the other side on another device, and that
    entry's gradient moves every layer before it) and each `Clip` call's
    values below and above its bounds; returns ({"pools": [...], "gates":
    {SRU name: [...]}, "relus": {ReLU name: [...]}, "maxes": {MaxOver
    name: [...]}, "clips": {Clip name: [...]}}, the hooks)."""
    import torch.nn.functional as F
    routes = {"pools": [], "gates": {}, "relus": {}, "maxes": {}, "clips": {}}
    hooks = [m.register_forward_hook(lambda m, i, o: routes["pools"].append(
        F.max_pool2d(i[0].detach(), 2, 2, return_indices=True)[1].cpu()))
        for m in model.modules() if type(m).__name__ == "MaxPool2d"]
    for name, m in model.named_modules():
        if type(m).__name__ == "ReLU":
            kept = routes["relus"][name] = []
            hooks.append(m.register_forward_hook(
                lambda m, i, o, kept=kept: kept.append((i[0] > 0).detach().cpu())))
        elif type(m).__name__ == "MaxOver":
            kept = routes["maxes"][name] = []
            hooks.append(m.register_forward_hook(lambda m, i, o, kept=kept: kept.append(
                _flat_max(m, i[0].detach()).argmax(-1, keepdim=True).cpu())))
        elif type(m).__name__ == "Clip":
            kept = routes["clips"][name] = []
            hooks.append(m.register_forward_hook(lambda m, i, o, kept=kept: kept.append(
                ((i[0] < i[1]).detach().cpu(), (i[0] > i[2]).detach().cpu()))))
    for name, m in model.named_modules():
        if type(m).__name__ == "SRU":
            kept = routes["gates"][name] = []
            m.gate = lambda rew, m=m, kept=kept: kept.append(
                type(m).gate(m, rew).cpu()) or kept[-1].to(rew.device)
    return routes, hooks


def _route_pools(model, routes, apart: dict) -> None:
    """``model``'s 2x2 max-pools take their values (and so their gradients)
    from ``routes["pools"]``, in order, its SRU gates from
    ``routes["gates"]``, its ReLUs' positives from ``routes["relus"]`` and
    its `MaxOver` maxima from ``routes["maxes"]`` and its `Clip` sides
    (UFFC's) from ``routes["clips"]`` (those named there): another device's
    choice at each window and value. ``apart[kind]`` counts, over the
    forward, [decisions this model would have taken otherwise, decisions
    routed]: a routed pool window or maximum whose value is below the
    model's own max there, a ReLU value, SRU gate or clipped value on the
    other side of its step."""
    import torch
    import torch.nn.functional as F

    def tally(kind, other, n):
        count = apart.setdefault(kind, [0, 0])
        count[0] += int(other)
        count[1] += n

    def pool(x, idx):
        y = x.flatten(2).gather(2, idx.to(x.device).flatten(2)).view(idx.shape)
        tally("pools", (y.detach() < F.max_pool2d(x.detach(), 2, 2)).sum(), y.numel())
        return y

    def relu(x, keep):
        keep = keep.to(x.device)
        tally("relus", ((x.detach() > 0) != keep).sum(), keep.numel())
        return x * keep

    def most(m, x, idx):
        flat = _flat_max(m, x)
        y = flat.gather(-1, idx.to(x.device))
        tally("maxes", (y.detach() < flat.detach().amax(-1, keepdim=True)).sum(), y.numel())
        return y.reshape(x.amax(m.dims, keepdim=True).shape)

    def clip(x, lo, hi, sides):
        below, above = (t.to(x.device) for t in sides)
        tally("clips", ((x.detach() < lo) != below).sum() + ((x.detach() > hi) != above).sum(),
              below.numel())
        return torch.where(below, lo, torch.where(above, hi, x))

    def gate(m, rew, routed):
        routed = routed.to(rew.device)
        tally("gates", (type(m).gate(m, rew) != routed).sum(), routed.numel())
        return routed

    pools = [m for m in model.modules() if type(m).__name__ == "MaxPool2d"]
    if len(pools) != len(routes["pools"]):
        raise AssertionError(f"{len(routes['pools'])} recorded pools for {len(pools)} "
                             "max-pools")
    for m, idx in zip(pools, routes["pools"]):
        m.forward = lambda x, idx=idx: pool(x, idx)
    for name, m in model.named_modules():
        if name in routes["gates"]:
            m.gate = lambda rew, m=m, it=iter(routes["gates"][name]): gate(m, rew, next(it))
        elif name in routes["relus"]:
            m.forward = lambda x, it=iter(routes["relus"][name]): relu(x, next(it))
        elif name in routes["maxes"]:
            m.forward = lambda x, m=m, it=iter(routes["maxes"][name]): most(m, x, next(it))
        elif name in routes["clips"]:
            m.forward = lambda x, lo, hi, it=iter(routes["clips"][name]): clip(x, lo, hi,
                                                                               next(it))


def _routed_apart(apart: dict, dtype: str, where: str, name: str) -> float:
    """The share of the routed decisions (all kinds) that ``where`` would
    have taken otherwise (`_route_pools`); more than ROUTED_APART_SHARE of
    them is more than near-ties at ``dtype``'s rounding, and fails."""
    other, n = (sum(v[i] for v in apart.values()) for i in (0, 1))
    share = other / max(n, 1)
    if share > ROUTED_APART_SHARE[dtype]:
        raise AssertionError(f"{name} {dtype}: {where} would route {other} of {n} decisions "
                             f"apart from the card ({share:.3g} > "
                             f"{ROUTED_APART_SHARE[dtype]}): {apart}")
    return share


def _f64_grads(model, b, routes, apart: dict) -> tuple:
    """The float64 gradient, loss and buffers of a training forward
    (augmentation off) of a CPU copy of ``model`` on ``b``, its max-pools,
    SRU gates, ReLUs and maxima routed by ``routes`` (the decisions routed
    apart counted into ``apart``)."""
    import copy

    import torch
    from fac_fake_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from fac_fake_torch.train.losses import cross_entropy
    m = copy.deepcopy(model).cpu().double().train()
    _route_pools(m, routes, apart)
    x = (b["image"].double() / 255.0 - torch.from_numpy(IMAGENET_MEAN).double()) \
        / torch.from_numpy(IMAGENET_STD).double()
    logits = m(x.permute(0, 3, 1, 2))
    loss = cross_entropy(logits, b["label"], b["mask"].double())
    loss.backward()
    return ({k: p.grad.clone() for k, p in m.named_parameters()}, float(loss.detach()),
            {k: v.detach().double() for k, v in m.named_buffers()}, logits.detach())


def step_logits(model) -> tuple:
    """A hook on ``model`` that keeps the logits of its next forward (the
    train step's, float64 on the CPU): (the list it fills, the hook)."""
    kept = []
    return kept, model.register_forward_hook(
        lambda m, args, out: kept.append(out.detach().double().cpu()) if not kept else None)


def loss_rule(res: dict) -> bool:
    """The bf16 step's loss rule before `logit_rule`: the card's loss within
    TRAIN_GRAD_F64_RATIO x the CPU bf16's distance to float64 +
    TRAIN_BF16_LOSS_F64_SLACK, relative to the float64 loss."""
    return res["card_loss_vs_f64"] <= (TRAIN_GRAD_F64_RATIO * res["cpu_loss_vs_f64"]
                                       + TRAIN_BF16_LOSS_F64_SLACK)


def bf16_rules(res: dict, loss_held: bool = False) -> str:
    """The logit rule's reading (held) beside the loss rule's (held with
    ``loss_held``, else printed)."""
    old_bound = TRAIN_GRAD_F64_RATIO * res["cpu_loss_vs_f64"] + TRAIN_BF16_LOSS_F64_SLACK
    return (f"logits (held) card {res['logits_card_vs_f64']:.4g} <= {TRAIN_GRAD_F64_RATIO} x CPU "
            f"{res['logits_cpu_vs_f64']:.4g} + {BF16_LAYER_SLACK:.4g} = "
            f"{res['logit_bound']:.4g}: {'holds' if res['logit_rule_holds'] else 'FAILS'}; "
            f"loss ({'held' if loss_held else 'printed, not held'}) card "
            f"{res['card_loss_vs_f64']:.4g} <= {TRAIN_GRAD_F64_RATIO} x CPU "
            f"{res['cpu_loss_vs_f64']:.4g} + {TRAIN_BF16_LOSS_F64_SLACK} = {old_bound:.4g}: "
            f"{'holds' if loss_rule(res) else 'FAILS' if loss_held else 'fails'}; logits card "
            f"{[round(v, 5) for v in res['logits_card']]}, CPU "
            f"{[round(v, 5) for v in res['logits_cpu']]}, float64 "
            f"{[round(v, 5) for v in res['logits_f64']]}")


def logit_rule(card, cpu, f64) -> dict:
    """B2/B3's whole-step forward: the card's bf16 logits within
    TRAIN_GRAD_F64_RATIO x the CPU bf16's distance to the float64 logits +
    BF16_LAYER_SLACK (relative L2 over the batch); the readings and whether
    they hold."""
    rel = lambda a: float((a - f64).norm() / f64.norm())
    res = dict(logits_card_vs_f64=rel(card), logits_cpu_vs_f64=rel(cpu),
               logits_card=card.flatten().tolist(), logits_cpu=cpu.flatten().tolist(),
               logits_f64=f64.flatten().tolist())
    res["logit_bound"] = TRAIN_GRAD_F64_RATIO * res["logits_cpu_vs_f64"] + BF16_LAYER_SLACK
    res["logit_rule_holds"] = res["logits_card_vs_f64"] <= res["logit_bound"]
    return res


def z5_loss_rule(loss_rel: float, cpu_loss_vs_f64: float) -> tuple:
    """Z5's loss rule: the card-vs-CPU relative loss within TRAIN_LOSS_RTOL
    + TRAIN_GRAD_F64_RATIO x the CPU's own relative distance to the float64
    step's loss. A well-conditioned step (the CPU within ~1e-6 of float64)
    keeps T3's bound; an ill-conditioned one widens it by the CPU's own fp32
    error. (bound, holds)."""
    bound = TRAIN_LOSS_RTOL + TRAIN_GRAD_F64_RATIO * cpu_loss_vs_f64
    return bound, loss_rel <= bound


def b4_bf16_rule(head_ratio: float) -> bool:
    """B4's bf16 fp head input: card vs CPU (error norm) within
    S3D_BF16_FEATURE_RATIO x the CPU's own bf16-vs-fp32 difference."""
    return head_ratio <= S3D_BF16_FEATURE_RATIO


def cam_rule(raw_err: float, largest: float, raw_cpu_f64: float, norm_err: float,
             norm_cpu_f64: float) -> dict:
    """G1's CAM rule, card vs CPU (max abs): the raw CAM within CAM_RAW_TOL x
    the CPU's largest value + TRAIN_GRAD_F64_RATIO x the CPU fp32 CAM's
    distance from the float64 CAM; the min-maxed CAM within CAM_NORM_TOL +
    the same factor x the min-maxed CPU-vs-float64 distance. The bounds and
    whether each holds."""
    raw_bound = CAM_RAW_TOL * largest + TRAIN_GRAD_F64_RATIO * raw_cpu_f64
    norm_bound = CAM_NORM_TOL + TRAIN_GRAD_F64_RATIO * norm_cpu_f64
    return dict(raw_bound=raw_bound, norm_bound=norm_bound, raw_holds=raw_err <= raw_bound,
                norm_holds=norm_err <= norm_bound)


def train_vs_cpu(model, name, rng, dtype: str = "float32", zoo: bool = False) -> dict:
    """T3 (base cvit) and T4's second half (the flagship), and with ``dtype``
    bfloat16 B2's (both steps bf16; held layer by layer by `replay_layers`
    and as a whole by its gradient and its logits, `logit_rule`, the rest
    printed): one train step at
    full width, batch TRAIN_CHECK_BATCH, augmentation off, TF32 off, from
    the same weights on the card and on the CPU, each with a fresh Adam:
    the loss, each parameter's gradient (relative L2), the BatchNorm
    running stats and LinearNorm's counters, and the parameters after the
    step, within the TRAIN_* tolerances; the card's gradient against the
    float64 one (`_f64_grads`). The CPU's max-pools take the card's argmax
    at every window (`_route_pools`): at full width a few windows hold a
    near-tie that the two devices' roundings break apart, and a gradient
    entry then goes elsewhere. The ReLUs take the card's positives, the
    `MaxOver` maxima (GGCA's, TFAM's, SMFA's) its argmax, and ScConv's SRU
    gates (`SRU.gate`, a step in the forward: a value passes
    whole above 0.5 and is weighed by its gate below it) the card's
    choices, on the CPU and in float64, for the same reason, in fp32. A
    bf16 step routes its max-pools alone: some 1% of its decisions part from
    the card's, not near-ties, and forcing the card's ReLUs and maxima on
    values that took other sides leaves a reference that agrees with
    neither device (`cvit_ggca_odconv`: its CPU and float64 steps so routed
    25% and 27% from the card's loss, the CPU's own 0.65%). The decisions
    each would have taken otherwise are counted, and more than
    ROUTED_APART_SHARE of those routed fails (`_routed_apart`). The CPU's
    step with its own routes is printed beside it. Z5 (``zoo``, fp32) holds
    T3's float64 rule alone:
    the loss card vs CPU within `z5_loss_rule` (TRAIN_LOSS_RTOL + the ratio
    x the CPU's own distance to the float64 loss), the gradient and each
    running-stat tensor no further from the float64 step's than
    TRAIN_GRAD_F64_RATIO x the CPU's + TRAIN_GRAD_F64_SLACK (stats: +
    S3D_STATS_F64_SLACK), LinearNorm's counters equal, the parameters after
    the step within TRAIN_PARAM_ATOL; the card-vs-CPU tensor and left-out
    numbers are printed (a zoo entry's CPU fp32 gradient can be the further
    from float64: depthwise convs' weight sums over 224² maps). Z6 (``zoo``,
    bf16) holds its step layer by layer (`replay_layers`) and the
    parameters after it; the whole-step numbers and the rounding-noise
    tensors are printed: ODConv's attention BatchNorm normalizes each
    channel by the batch's two values, which bf16 rounds apart, so the whole
    bf16 step of `cvit_ggca_odconv` is a draw on either device (PERF.md §6)."""
    import copy

    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.train.trainer import Trainer
    cfg = Config()
    cfg.model.name = name
    cfg.model.dtype = dtype
    cfg.data.augment.enabled = False
    cfg.train.checkpoint_dir = ""
    u8 = torch.from_numpy(rng.integers(0, 256, (TRAIN_CHECK_BATCH, TRAIN_HW, TRAIN_HW, 3),
                                       dtype=np.uint8))
    b = {"image": u8, "label": torch.arange(TRAIN_CHECK_BATCH) % 2,
         "mask": torch.ones(TRAIN_CHECK_BATCH)}
    dev = next(model.parameters()).device
    side, routes, layers, apart_cpu, apart_f64 = {}, None, None, {}, {}
    # the CPU's step with its own routes is information; Z5 leaves it out
    for where in ("card", "cpu") + (() if zoo else ("cpu_own_pools",)):
        m = copy.deepcopy(model) if where == "card" else copy.deepcopy(model).cpu()
        if where == "card" and dtype == "bfloat16":
            before = copy.deepcopy(m)
            rec, layer_hooks = record_layers(m)
        if where == "cpu":
            _route_pools(m, routes, apart_cpu)
        else:
            recorded, hooks = _record_routes(m)
        if where == "card" and dtype == "bfloat16":
            hooks += layer_hooks
        kept, logit_hook = step_logits(m)
        tr = Trainer(m, cfg, device=None if where == "card" else "cpu")
        d = dev if where == "card" else torch.device("cpu")
        t0 = time.perf_counter()
        met = tr.train_step({k: v.to(d) for k, v in b.items()},
                            torch.Generator(device=d).manual_seed(0))
        logit_hook.remove()
        side[where] = dict(t=time.perf_counter() - t0, loss=float(met["loss"]), logits=kept[0],
                           grads={k: p.grad.double().cpu() for k, p in m.named_parameters()},
                           params={k: p.detach().double().cpu() for k, p in m.named_parameters()},
                           bufs={k: v.double().cpu() for k, v in m.named_buffers()})
        if where == "card":
            # in bf16 the max-pools alone (`_route_pools`)
            routes = recorded if dtype == "float32" else dict(
                recorded, gates={}, relus={}, maxes={}, clips={})
        if where != "cpu":
            for h in hooks:
                h.remove()
        if where == "card" and dtype == "bfloat16":
            layers = replay_layers(before, rec, name)
            del before, rec
        del m, tr
    c, g, own = side["cpu"], side["card"], side.get("cpu_own_pools")
    hold_step = not (zoo and dtype == "bfloat16")   # Z6's bf16 steps: layer by layer alone
    g64, loss64, bufs64, logits64 = _f64_grads(model, b, routes, apart_f64)
    share_cpu = _routed_apart(apart_cpu, dtype, "the CPU", name)
    share_f64 = _routed_apart(apart_f64, dtype, "float64", name)
    norm = lambda d: float(sum((t ** 2).sum() for t in d.values())) ** 0.5
    total = norm(c["grads"])
    rel = lambda a, b: norm({k: a[k] - b[k] for k in b}) / norm(b)
    card_f64, cpu_f64 = rel(g["grads"], g64), rel(c["grads"], g64)
    loss_err = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    whole = rel(g["grads"], c["grads"])
    per, noise, left_out, p_err, per_f64 = {}, [], 0, 0.0, {}
    left_out_abs = 0      # with the absolute floor alone, beside (information)
    equal_small = 0       # bit-equal entries at or under the floor, held
    for k, gc in c["grads"].items():
        gg = g["grads"][k]
        g64n = float(g64[k].norm())
        if float(g64[k].norm()) < 1e-8 * total:      # zero but for rounding
            noise.append(k)
            # Z5 holds the card's alone: the CPU's BatchNorm backward sums a
            # conv bias's gradient over 224^2 maps in fp32, which can leave
            # it over the share on the CPU where the card's is not (as for
            # cvit_ggca_add_odconv's first stage)
            held = float(gg.norm()) if zoo else max(float(gg.norm()), float(gc.norm()))
            if hold_step and held >= TRAIN_NOISE_SHARE[dtype] * total:
                raise AssertionError(f"{name}: {k}'s gradient is zero in float64, "
                                     f"{float(gg.norm()) / total:.3g} of the norm on the card")
            left_out += gc.numel()
            left_out_abs += gc.numel()
            continue
        per[k] = float((gg - gc).norm() / gc.norm())
        agree = (gg - gc).abs() < 0.1 * gc.abs()
        floor = min(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FLOOR_RMS * float(gc.pow(2).mean().sqrt()))
        same = gg == gc
        # bit-equal entries are held, the floor or not: a step at a low loss
        # has whole rows of exact zeros on both devices (a ReLU unit dead for
        # the batch), 56% of mlp_head.0.bias at --seed 2 (PERF.md §6)
        clear = ((gc.abs() > floor) & agree) | same
        above = (gc.abs() > TRAIN_GRAD_FLOOR) & agree
        left_out += int((~clear).sum())
        left_out_abs += int((~above).sum())
        equal_small += int((same & (gc.abs() <= floor)).sum())
        # each tensor's distance to float64 on either
        # device, and its share of entries left out
        per_f64[k] = (float((gg - g64[k]).norm()) / g64n, float((gc - g64[k]).norm()) / g64n,
                      float((~clear).float().mean()))
        if above.any():
            p_err = max(p_err, float((g["params"][k] - c["params"][k])[above].abs().max()))
    worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    stats = [k for k in c["bufs"] if k.endswith(("running_mean", "running_var", "warm", "iter"))]
    s_err = max(float(((g["bufs"][k] - c["bufs"][k]).abs()
                       / (TRAIN_STATS_ATOL + TRAIN_STATS_RTOL * c["bufs"][k].abs())).max())
                for k in stats)
    n = sum(t.numel() for t in c["params"].values())
    # the tensors where the card is furthest beyond the CPU, as distance to float64
    apart = sorted(per_f64.items(), key=lambda kv: -kv[1][0] / max(kv[1][1], 1e-12))[:5]
    res = dict(loss_rel=loss_err, grad_rel=whole, grad_tensor_max=worst[0][1],
               card_vs_f64=card_f64, cpu_vs_f64=cpu_f64, dtype=dtype,
               loss_f64=loss64, card_loss_vs_f64=abs(g["loss"] - loss64) / abs(loss64),
               cpu_loss_vs_f64=abs(c["loss"] - loss64) / abs(loss64),
               left_out_share=left_out / n, left_out_share_abs_floor=left_out_abs / n,
               equal_under_floor_share=equal_small / n,
               card_beyond_cpu_tensors={k: [round(v, 6) for v in t] for k, t in apart},
               stats_over_tol=s_err, param_max_abs=p_err, left_out=left_out, params=n,
               cpu_s=c["t"], layers=layers, routed_apart_cpu=apart_cpu,
               routed_apart_f64=apart_f64)
    if own is not None:
        res.update(own_pools_loss_rel=abs(g["loss"] - own["loss"]) / abs(own["loss"]),
                   own_pools_grad_rel=rel(g["grads"], own["grads"]),
                   pool_windows_routed_apart=sum(int((a != r).sum()) for a, r in
                                                 zip(routes["pools"], recorded["pools"])),
                   **{f"{kind}_routed_apart": sum(int((a != r).sum()) for k in routes[kind]
                                                  for a, r in zip(routes[kind][k],
                                                                  recorded[kind][k]))
                      for kind in ("gates", "relus", "maxes")})
    log(f"{name}{'' if dtype == 'float32' else ' ' + dtype} one train step card vs CPU, batch "
        f"{TRAIN_CHECK_BATCH} (CPU {c['t']:.1f} s; "
        f"routed as the card's: {', '.join(k for k in routes if routes[k])}): loss "
        f"{g['loss']:.6f} / {c['loss']:.6f} (rel "
        f"{loss_err:.3g}, bound {TRAIN_LOSS_RTOL}); gradient rel L2 to the float64 one: card "
        f"{card_f64:.3g}, CPU {cpu_f64:.3g} (bound: card <= {TRAIN_GRAD_F64_RATIO} x CPU + "
        f"{TRAIN_GRAD_F64_SLACK}); card vs CPU gradient rel L2 {whole:.3g} (bound "
        f"{TRAIN_GRAD_RTOL}), worst tensors {[(k, round(v, 6)) for k, v in worst]} (bound "
        f"{TRAIN_GRAD_TENSOR_RTOL}), {len(noise)} rounding-noise tensors; running stats and "
        f"counters at {s_err:.3g} of their tolerance (rtol {TRAIN_STATS_RTOL}, atol "
        f"{TRAIN_STATS_ATOL}); parameters after the step max abs {p_err:.3g} (bound "
        f"{TRAIN_PARAM_ATOL}), {left_out} of {n} entries left out. Decisions [taken "
        f"otherwise, routed] by kind: CPU {apart_cpu}, float64 {apart_f64} (share "
        f"{share_cpu:.3g} and {share_f64:.3g}, bound {ROUTED_APART_SHARE[dtype]}). "
        + (f"With the CPU's own routes ({res['pool_windows_routed_apart']} pool windows, "
           f"{res['relus_routed_apart']} ReLU values, {res['maxes_routed_apart']} maxima and "
           f"{res['gates_routed_apart']} SRU gates routed apart): loss rel "
           f"{res['own_pools_loss_rel']:.3g}, gradient rel L2 {res['own_pools_grad_rel']:.3g} "
           "(information). " if own is not None else "")
        + f"Loss to float64 {loss64:.6f}: card {res['card_loss_vs_f64']:.3g}, CPU "
        f"{res['cpu_loss_vs_f64']:.3g}; left out {left_out / n:.2%} (floor min("
        f"{TRAIN_GRAD_FLOOR}, {TRAIN_GRAD_FLOOR_RMS} x each tensor's RMS; {equal_small / n:.2%} "
        f"bit-equal under it held); with the absolute floor {TRAIN_GRAD_FLOOR} alone, and no "
        f"bit-equal entry held, {left_out_abs / n:.2%}); the tensors where the card "
        f"is furthest beyond the CPU (card, CPU distance to float64, left-out share): "
        f"{res['card_beyond_cpu_tensors']}")
    if zoo and dtype == "float32":
        # Z5: T3's float64 rule alone; each running-stat tensor's distance to
        # the float64 step's within the ratio of the CPU's + the stats' slack
        rt = lambda a, bb: float((a - bb).norm() / max(float(bb.norm()), 1e-30))
        running = [k for k in stats if k.endswith(("running_mean", "running_var"))]
        res["stats_f64_over"] = max((rt(g["bufs"][k], bufs64[k])
                                     - TRAIN_GRAD_F64_RATIO * rt(c["bufs"][k], bufs64[k]))
                                    / S3D_STATS_F64_SLACK for k in running)
        counters = all(torch.equal(g["bufs"][k], c["bufs"][k]) for k in stats
                       if k not in running)
        res["relus_routed"] = sum(len(v) for v in routes["relus"].values())
        res["loss_bound"], loss_holds = z5_loss_rule(loss_err, res["cpu_loss_vs_f64"])
        log(f"{name} Z5: gradient card {card_f64:.3g} <= {TRAIN_GRAD_F64_RATIO} x CPU "
            f"{cpu_f64:.3g} + {TRAIN_GRAD_F64_SLACK}; loss card vs CPU {loss_err:.3g} <= "
            f"{TRAIN_LOSS_RTOL} + {TRAIN_GRAD_F64_RATIO} x the CPU's {res['cpu_loss_vs_f64']:.3g} "
            f"from float64 = {res['loss_bound']:.3g} (the card's own {res['card_loss_vs_f64']:.3g} "
            f"from float64); running stats each at {res['stats_f64_over']:.3g} of the slack "
            f"beyond {TRAIN_GRAD_F64_RATIO} x the CPU's distance to float64; counters equal "
            f"{counters}; {res['relus_routed']} ReLU calls routed as the card's")
        ok = (loss_holds and res["stats_f64_over"] <= 1.0 and counters
              and card_f64 <= TRAIN_GRAD_F64_RATIO * cpu_f64 + TRAIN_GRAD_F64_SLACK
              and p_err <= TRAIN_PARAM_ATOL)
    elif dtype == "float32":
        ok = (loss_err <= TRAIN_LOSS_RTOL and whole <= TRAIN_GRAD_RTOL
              and card_f64 <= TRAIN_GRAD_F64_RATIO * cpu_f64 + TRAIN_GRAD_F64_SLACK
              and worst[0][1] <= TRAIN_GRAD_TENSOR_RTOL and s_err <= 1.0
              and p_err <= TRAIN_PARAM_ATOL and left_out < 0.1 * n)
    else:
        res.update(logit_rule(g["logits"], c["logits"], logits64))
        ok = p_err <= TRAIN_PARAM_ATOL and (not hold_step or (
            card_f64 <= TRAIN_GRAD_F64_RATIO * cpu_f64 + TRAIN_BF16_GRAD_F64_SLACK
            and res["logit_rule_holds"]))
        log(f"{name} {dtype}: {'held' if hold_step else 'printed, not held'} to float64: gradient "
            f"card {card_f64:.3g} <= "
            f"{TRAIN_GRAD_F64_RATIO} x CPU {cpu_f64:.3g} + {TRAIN_BF16_GRAD_F64_SLACK}; "
            + bf16_rules(res) + f"; parameters after the step {p_err:.3g} <= {TRAIN_PARAM_ATOL}")
    if not ok:
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


# ---- P1-P2: face-crop datasets and detector agreement -------------------------------


@contextlib.contextmanager
def reused_host_work(reader):
    """Within: ``reader`` keeps the frames it makes, and `make_tiles` keeps
    the tiles of each stack of frames it resizes, so a CPU run over the
    frames of a card run repeats none of the host's numpy work (the same
    resize of the same pixels either way). The first run over a stack does
    that work, and its stage timers count it."""
    from fac_fake_torch.detect import extractor as ex
    make_tiles, tiles = ex.make_tiles, {}

    def kept(frames, target=128):
        key = (frames.shape, target, hash(frames[:, ::7, ::7].tobytes()))
        if key not in tiles:
            tiles[key] = make_tiles(frames, target)
        return tiles[key]

    ex.make_tiles, reader.cache = kept, {}
    try:
        yield
    finally:
        ex.make_tiles, reader.cache = make_tiles, None


def same_boxes(card: list, cpu: list, what: str) -> int:
    """``card``, ``cpu``: per frame, its (frame_idx, boxes). The same frames
    and the same number of boxes in each, every box edge within
    DATASET_BOX_PX (BlazeFace's convs round apart in the last bits on the two
    devices, and a crop edge is a truncated float). Returns the boxes that
    moved."""
    if [(i, len(b)) for i, b in card] != [(i, len(b)) for i, b in cpu]:
        raise AssertionError(f"{what}: (frame, face) pairs differ card vs CPU: "
                             f"{[(i, len(b)) for i, b in card]} vs {[(i, len(b)) for i, b in cpu]}")
    moved = 0
    for (i, bc), (_, bp) in zip(card, cpu):
        for a, b in zip(bc, bp):
            d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
            if d > DATASET_BOX_PX:
                raise AssertionError(f"{what}: frame {i} box {a} on the card, {b} on the CPU")
            moved += bool(d)
    return moved


def dataset_phase(seed, dev, det, reader, videos, with_faces, smi) -> dict:
    """P1: the dataset build's per-video work over the in-memory videos on the
    card (`data/preprocess.py`: `video_face_crops`, DATASET_RANDOM_FRAMES
    random frames a video, and `video_crop_folder_crops`, DATASET_FOLDER_FRAMES
    evenly spaced; each frame's best face resized to DATASET_CROP^2), then
    the same frames on the CPU (`reused_host_work`). Per build: the same
    (frame, face) pairs, box edges within DATASET_BOX_PX (the boxes that
    moved printed), crops bit-equal where the boxes are, at least one crop
    from each face video; K1 launched once a video's frames on the card
    (`process_frames`' one chunk), its plain version never there and once a
    video on the CPU. frames/s, crops/s and the time split (stage timers)."""
    import torch
    from fac_fake_torch.data import preprocess as pp
    from fac_fake_torch.detect import extractor as ex
    from fac_fake_torch.detect.blazeface import BlazeFace

    cpu_det = BlazeFace.from_packaged_assets("cpu")
    builds = {
        "faces": lambda v, d, st: pp.video_face_crops(v, DATASET_RANDOM_FRAMES, DATASET_CROP, d,
                                                      seed, reader, st),
        "folders": lambda v, d, st: pp.video_crop_folder_crops(v, DATASET_FOLDER_FRAMES,
                                                               DATASET_CROP, d, reader, st),
    }
    seen, plain_calls = [], [0]
    best, plain = ex.FaceExtractor.keep_only_best_face, ex.frame_detections_plain

    def recorded(fds):
        best(fds)
        seen.extend((fd["frame_idx"], list(fd["boxes"])) for fd in fds)

    def counted_plain(*a, **k):
        plain_calls[0] += 1
        return plain(*a, **k)

    out = {}
    ex.FaceExtractor.keep_only_best_face = staticmethod(recorded)
    ex.frame_detections_plain = counted_plain
    try:
        with reused_host_work(reader):
            for build, fn in builds.items():
                runs = {}
                for where, d in (("card", det), ("cpu", cpu_det)):
                    stats = ex.new_stage_stats()
                    ex.frame_detections.launches = plain_calls[0] = 0
                    per = {}
                    t0 = time.perf_counter()
                    for v in videos:
                        del seen[:]
                        crops = fn(v, d, stats)
                        per[v] = list(seen), crops or []
                    torch.cuda.synchronize()
                    runs[where] = dict(per=per, s=time.perf_counter() - t0, stats=stats,
                                       k1=ex.frame_detections.launches, plain=plain_calls[0])
                card, cpu = runs["card"], runs["cpu"]
                moved = boxes = unequal = 0
                for v in videos:
                    (fc, cc), (fp, cp) = card["per"][v], cpu["per"][v]
                    moved += same_boxes(fc, fp, f"P1 {build} {v}")
                    flat_c = [b for _, bs in fc for b in bs]
                    flat_p = [b for _, bs in fp for b in bs]
                    boxes += len(flat_c)
                    if [n for n, _ in cc] != [n for n, _ in cp] or len(cc) != len(flat_c):
                        raise AssertionError(f"P1 {build} {v}: crops {[n for n, _ in cc]} on the "
                                             f"card, {[n for n, _ in cp]} on the CPU")
                    for (name, a), (_, b), bc, bp in zip(cc, cp, flat_c, flat_p):
                        if tuple(bc) == tuple(bp) and not np.array_equal(a, b):
                            unequal += 1
                frames = card["stats"]["frames"]
                crops = sum(len(card["per"][v][1]) for v in videos)
                per_video = {v: len(card["per"][v][1]) for v in videos}
                st = card["stats"]
                res = dict(frames=frames, crops=crops, crops_per_video=per_video,
                           frames_per_s=frames / card["s"], crops_per_s=crops / card["s"],
                           s=card["s"], tiles_s=st["tiles_s"], detect_s=st["detect_s"],
                           crops_s=st["crops_s"],
                           read_s=card["s"] - st["tiles_s"] - st["detect_s"] - st["crops_s"],
                           k1_launches=card["k1"], boxes=boxes, boxes_moved=moved,
                           cpu_s=cpu["s"], cpu_k1_plain=cpu["plain"])
                log(f"P1 {build} build on the card ({smi}): {len(videos)} videos, {frames} "
                    f"frames, {crops} crops {per_video}: {res['frames_per_s']:.1f} frames/s, "
                    f"{res['crops_per_s']:.1f} crops/s ({card['s']:.2f} s: the host's tile "
                    f"resizes {st['tiles_s']:.2f} s, detection on the card with K1 "
                    f"{st['detect_s']:.2f} s, crop resizes {st['crops_s']:.2f} s, reading the "
                    f"frames and the rest {res['read_s']:.2f} s); K1 {card['k1']} launches, "
                    f"its plain version {card['plain']} times; the CPU run {cpu['s']:.2f} s, "
                    f"plain version {cpu['plain']} times; {boxes} boxes, {moved} moved (edges "
                    f"within {DATASET_BOX_PX} px), crops of equal boxes bit-equal: "
                    f"{unequal == 0}")
                if unequal:
                    raise AssertionError(f"P1 {build}: {unequal} crops of equal boxes differ")
                if (card["k1"], card["plain"], cpu["plain"]) != (len(videos), 0, len(videos)):
                    raise AssertionError(f"P1 {build}: K1 {card['k1']} launches and plain "
                                         f"{card['plain']} on the card, plain {cpu['plain']} on "
                                         f"the CPU, for {len(videos)} videos of frames")
                if not all(per_video[v] > 0 for v in with_faces if v in per_video):
                    raise AssertionError(f"P1 {build}: crops per video {per_video}; the "
                                         f"synthetic face is in {with_faces}")
                out[build] = res
    finally:
        ex.FaceExtractor.keep_only_best_face = staticmethod(best)
        ex.frame_detections_plain = plain
    return out


def timed_boxes(fn, acc: dict):
    """A detector adapter that also records its boxes and adds its seconds
    and frames to ``acc``."""
    def run(frames):
        t0 = time.perf_counter()
        out = fn(frames)
        acc["s"] += time.perf_counter() - t0
        acc["frames"] += len(frames)
        acc["boxes"].append([b.copy() for b in out])
        return out
    return run


def agreement_phase(seed, dev, det, reader, videos, with_faces, smi) -> dict:
    """P2: `agreement_report` over the in-memory videos, AGREEMENT_FRAMES
    frames each, BlazeFace (K1 once a video) against the seeded MTCNN at
    (0, 0, 0) (K8 four times a frame) on the card, its launches counted and
    each detector's frames/s; BlazeFace against itself (recall both ways 1.0,
    every matched IoU 1.0); the same report with BlazeFace on the CPU
    (its boxes by P1's rule) against the card's MTCNN boxes replayed;
    `--score`'s scorers
    (`cli/detector_agreement.build_scorers`, seeded bf16 cvit) on
    AGREEMENT_SCORED videos, each score equal to a `VideoScorer`'s
    `score_video` with the same detector within AGREEMENT_SCORE_TOL;
    `mask_geometry_report` over the face videos (a landmark hit rate above 0)."""
    import torch
    from fac_fake_torch.cli.detector_agreement import build_scorers
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.detect import agreement as ag
    from fac_fake_torch.detect import extractor as ex
    from fac_fake_torch.detect.blazeface import BlazeFace
    from fac_fake_torch.detect.mtcnn import MTCNN
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import nms

    cpu_det = BlazeFace.from_packaged_assets("cpu")
    mtcnn = MTCNN(thresholds=(0.0, 0.0, 0.0), seed=seed, device=dev)
    blaze = {"card": ag.blazeface_boxes_fn(ex.FaceExtractor(det)),
             "cpu": ag.blazeface_boxes_fn(ex.FaceExtractor(cpu_det))}
    out = {}
    with reused_host_work(reader):
        reps, accs = {}, {}
        for where in ("card", "cpu"):
            acc = {k: {"s": 0.0, "frames": 0, "boxes": []} for k in ("blazeface", "mtcnn")}
            ex.frame_detections.launches = nms.hard_nms.launches = 0
            # the CPU's pass holds BlazeFace; MTCNN's boxes are the card's again
            # (MTCNN card vs CPU is M2's, on one frame: its counts part on near-ties)
            replay = iter(accs["card"]["mtcnn"]["boxes"]) if where == "cpu" else None
            reps[where] = ag.agreement_report(
                videos, timed_boxes(blaze[where], acc["blazeface"]),
                timed_boxes(ag.mtcnn_boxes_fn(mtcnn), acc["mtcnn"]) if replay is None
                else lambda frames: next(replay), AGREEMENT_FRAMES, reader=reader)
            torch.cuda.synchronize()
            accs[where] = acc
            if where == "card":
                launches = {"K1": ex.frame_detections.launches, "K8": nms.hard_nms.launches}
        card, acc = reps["card"], accs["card"]
        frames = acc["mtcnn"]["frames"]
        rates = {k: a["frames"] / a["s"] for k, a in acc.items()}
        log(f"P2 agreement_report on the card ({smi}), BlazeFace vs the seeded MTCNN at (0, 0, "
            f"0), {len(videos)} videos x {AGREEMENT_FRAMES} frames: totals {card['totals']}; "
            f"BlazeFace {rates['blazeface']:.1f} frames/s, MTCNN {rates['mtcnn']:.1f} frames/s; "
            f"launches {launches} ({frames} frames)")
        if launches != {"K1": len(videos), "K8": 4 * frames} or frames != \
                len(videos) * AGREEMENT_FRAMES:
            raise AssertionError(f"P2: launches {launches}, want K1 {len(videos)} (one a video) "
                                 f"and K8 {4 * frames} (4 a frame)")
        moved = 0
        for v, bc, bp in zip(videos, acc["blazeface"]["boxes"], accs["cpu"]["blazeface"]["boxes"]):
            moved += same_boxes([(i, b.tolist()) for i, b in enumerate(bc)],
                                [(i, b.tolist()) for i, b in enumerate(bp)], f"P2 BlazeFace {v}")
        mt_counts = [sum(len(b) for b in bs) for bs in acc["mtcnn"]["boxes"]]
        cpu_rates = {"blazeface": accs["cpu"]["blazeface"]["frames"]
                     / accs["cpu"]["blazeface"]["s"]}
        log(f"P2 the same report with BlazeFace on the CPU of the card's machine ({smi}) and "
            f"the card's MTCNN boxes: totals {reps['cpu']['totals']}; BlazeFace boxes by P1's "
            f"rule ({moved} moved); MTCNN boxes a video {mt_counts}; CPU BlazeFace "
            f"{cpu_rates['blazeface']:.1f} frames/s")

        ex.frame_detections.launches = 0
        self_rep = ag.agreement_report(videos, blaze["card"], blaze["card"], AGREEMENT_FRAMES,
                                       reader=reader)
        t = self_rep["totals"]
        perfect = all(r["matched"] == r["boxes_a"] == r["boxes_b"]
                      and r["mean_iou"] in (None, 1.0) for r in self_rep["videos"].values())
        log(f"P2 BlazeFace against itself on the card ({smi}): totals {t}; K1 "
            f"{ex.frame_detections.launches} launches; every matched IoU 1.0: {perfect}")
        if not (perfect and t["boxes_a"] > 0 and t["recall_a_by_b"] == t["recall_b_by_a"] == 1.0):
            raise AssertionError(f"P2: BlazeFace does not agree with itself: {self_rep}")

        sa, sb = build_scorers(device=dev, reader=reader, seed=seed)
        sb.detector.thresholds = (0.0, 0.0, 0.0)      # the seeded nets pass no box at the preset
        scored = videos[:AGREEMENT_SCORED]
        t0 = time.perf_counter()
        srep = ag.agreement_report(scored, blaze["card"], ag.mtcnn_boxes_fn(mtcnn),
                                   AGREEMENT_FRAMES, scorers=(sa, sb), reader=reader)
        t_score = time.perf_counter() - t0
        cfg = Config()
        cfg.model.dtype = "bfloat16"
        model = build_model(cfg.model, device=dev, seed=seed)
        ref = {"score_a": VideoScorer(model, cfg, reader=reader, device=dev)}
        cfg_b = copy.deepcopy(cfg)
        cfg_b.infer.detector = "mtcnn"
        cfg_b.infer.mtcnn_thresholds = (0.0, 0.0, 0.0)
        ref["score_b"] = VideoScorer(model, cfg_b, reader=reader, device=dev)
        worst = max(abs(srep["videos"][v][k] - ref[k].score_video(v)) for v in scored
                    for k in ref)
        scores = {v: {k: srep["videos"][v][k] for k in ("score_a", "score_b", "score_delta")}
                  for v in scored}
        log(f"P2 --score on the card ({smi}) on {scored} (seeded bf16 cvit; BlazeFace, MTCNN at "
            f"{sb.detector.thresholds}): {scores} in {t_score:.2f} s; against "
            f"VideoScorer.score_video of each detector: max abs {worst:.3g} (bound "
            f"{AGREEMENT_SCORE_TOL})")
        if not worst <= AGREEMENT_SCORE_TOL:
            raise AssertionError(f"P2: --score's scores {worst} from score_video's")
        del sa, sb, ref, model

        faces = [v for v in videos if v in with_faces]
        ex.frame_detections.launches = 0
        t0 = time.perf_counter()
        mrep = ag.mask_geometry_report(faces, AGREEMENT_FRAMES, reader=reader, device=dev)
        t_mask = time.perf_counter() - t0
        mask_k1 = ex.frame_detections.launches
        log(f"P2 mask_geometry_report on the card ({smi}) over {len(faces)} face videos: totals "
            f"{mrep['totals']}; {t_mask:.2f} s; K1 {mask_k1} launches (one a frame)")
        if not (mrep["totals"]["landmark_hit_rate"] or 0) > 0 or \
                mask_k1 != len(faces) * AGREEMENT_FRAMES:
            raise AssertionError(f"P2 mask geometry: {mrep['totals']}, K1 {mask_k1}")
    torch.cuda.empty_cache()
    out.update(totals=card["totals"], cpu_totals=reps["cpu"]["totals"], launches=launches,
               frames=frames, frames_per_s=rates, cpu_frames_per_s=cpu_rates,
               blazeface_moved=moved, mtcnn_boxes=mt_counts, self_totals=t,
               scores=scores, score_err=worst, mask_totals=mrep["totals"], mask_k1=mask_k1)
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
    `side_rng`. Returns also the KAN head (a copy) and its input in the
    capacity-96 forward (``kan_head``, ``kan_x``: R4's)."""
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
    seen = []
    head = scorer.model.kan_head[-1]
    hook = head.register_forward_pre_hook(lambda _, args: seen.append(args[0].detach().clone()))
    with torch.inference_mode():
        scorer.model.forward_crops(u96, torch.float32, pos96)
    torch.cuda.synchronize()
    hook.remove()
    head = copy.deepcopy(head)
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
                stack_diff=stack_diff, bf16_diff=bf_diff, kan_head=head, kan_x=seen[0].clone(),
                **rates)


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



def kan_grid_phase(head, x, dev) -> dict:
    """R4: KAN's grid refit (`update_grid`) on resvitkan's KAN head (KAN
    (2048, 64, 2), seeded) from its real input, R2's capacity-96 forward's,
    layer by layer as efficient-KAN's ``update_grid=True`` forward does:
    each layer refitted on the card (K9 once, for the old grid's bases; its
    plain version never on the card; the solve `curve2coeff`'s on the CPU)
    and on a CPU copy from the same input, weights and grid: the new grid
    bit-equal (sorted inputs, affine arithmetic, the one division by a
    tensor), the new spline weight within KAN_GRID_WEIGHT_TOL of its largest
    value, `regularization_loss` of the layer's spline weight within
    KAN_LOSS_RTOL (the refit weight's printed); then the refit layer's
    output on the card is the next layer's input. The refit head's forward
    on the card must be finite."""
    import torch
    from fac_fake_torch.models.blocks.kan import regularization_loss, update_grid
    from fac_fake_torch.ops import kan
    plain = kan.kan_bases_plain
    on_card = []

    def watched(xx, *a, **k):
        if xx.is_cuda:
            on_card.append(tuple(xx.shape))
        return plain(xx, *a, **k)

    cpu_head = copy.deepcopy(head).cpu()
    x0, layers = x, []
    kan.kan_bases_plain = watched
    try:
        for i, (layer, cl) in enumerate(zip(head.layers, cpu_head.layers)):
            kan.kan_bases.launches = 0
            t0 = time.perf_counter()
            g, w = update_grid(x, layer.grid, layer.spline_weight, layer.spline_scaler)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            k9 = kan.kan_bases.launches
            t0 = time.perf_counter()
            gc, wc = update_grid(x.cpu(), cl.grid, cl.spline_weight, cl.spline_scaler)
            cpu_s = time.perf_counter() - t0
            w_err = float((w.cpu() - wc).abs().max() / wc.abs().max())
            with torch.no_grad():
                loss = (float(regularization_loss(layer.spline_weight)),
                        float(regularization_loss(cl.spline_weight)))
                refit_loss = float(regularization_loss(w)), float(regularization_loss(wc))
            loss_rel = abs(loss[0] - loss[1]) / abs(loss[1])
            # the refit weight's loss is printed, not kept: a feature whose
            # inputs are all tied refits to a zero edge, and its 0 log 0 is NaN
            res = dict(shape=list(x.shape), k9_launches=k9,
                       grid_equal=bool(torch.equal(g.cpu(), gc)), weight_err=w_err,
                       loss=loss[1], loss_rel=loss_rel, card_s=card_s, cpu_s=cpu_s)
            layers.append(res)
            log(f"R4 layer {i}: update_grid on x {tuple(x.shape)} on the card ({card_s:.2f} s, K9 "
                f"launches {k9}) and the CPU ({cpu_s:.2f} s): grid bit-equal {res['grid_equal']}; "
                f"weight max abs {w_err:.3g} of its largest (bound {KAN_GRID_WEIGHT_TOL}); "
                f"regularization_loss {loss[1]:.8g}, card vs CPU rel {loss_rel:.3g} (bound "
                f"{KAN_LOSS_RTOL}), of the refit weight {refit_loss[0]:.8g} / "
                f"{refit_loss[1]:.8g}")
            if not (k9 == 1 and res["grid_equal"] and w_err <= KAN_GRID_WEIGHT_TOL
                    and loss_rel <= KAN_LOSS_RTOL):
                raise AssertionError(f"R4 layer {i}: {res}")
            with torch.no_grad():
                layer.grid.copy_(g)
                layer.spline_weight.copy_(w)
                x = layer(x)
        kan.kan_bases.launches = 0
        with torch.no_grad():
            y = head(x0)
        torch.cuda.synchronize()
        fwd_k9 = kan.kan_bases.launches
    finally:
        kan.kan_bases_plain = plain
    log(f"R4 the refit head's forward on the card: finite {bool(torch.isfinite(y).all())}, K9 "
        f"launches {fwd_k9}; K9's plain version on the card {on_card}")
    if on_card or not torch.isfinite(y).all() or fwd_k9 != len(head.layers):
        raise AssertionError(f"R4: plain K9 on the card {on_card}, forward K9 {fwd_k9}, "
                             f"finite {bool(torch.isfinite(y).all())}")
    return dict(layers=layers, k9_launches=sum(r["k9_launches"] for r in layers),
                forward_k9=fwd_k9)


# ---- S1-S5: S3D training with K10 ---------------------------------------------------

def k10_frames(side, dev, n: int, kind: str, hw=(224, 224), dtype: str = "float32"):
    """(n, *hw, 3) frames in [0, 1] in ``dtype``: ``noise`` (uniform bytes),
    ``smooth`` (seeded 8x8 colour fields, bilinearly upsampled, with a little
    noise: what natural frames look like to the DCT), ``flat`` (one grey) or
    ``every byte`` (each channel runs through the 256 byte values)."""
    import torch
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    d255 = torch.full((1,), 255.0, device=dev, dtype=dt)
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
    return (torch.from_numpy(np.ascontiguousarray(u8)).to(dev).to(dt) / d255).contiguous()


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


def k10_phase(rng, dev, dtype: str = "float32") -> dict:
    """S1 (``dtype`` bfloat16: B1's half of it, on bf16 frames, the division
    check left to S1): K10 (the S3D transform's JPEG step, in place on the
    taken frames)
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
    dt = getattr(torch, dtype)
    esize = torch.finfo(dt).bits // 8
    tag = "" if dtype == "float32" else f" {dtype}"
    div_bad = 0
    if dtype == "float32":
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
        x = k10_frames(side, dev, n, kind, dtype=dtype)
        quals = [(f"quality {q}", torch.full((n,), float(q), device=dev)) for q in K10_QUALITIES]
        quals.append(("trainer", torch.from_numpy(np.floor(
            side.uniform(60.0, 100.0, n)).astype(np.float32)).to(dev)))
        for qname, q in quals:
            for tname, take in takes.items():
                err = max(err, k10_check(x, take, q, f"{kind}{tag}, {qname}, take {tname}"))
        log(f"K10{tag} {kind} frames, qualities {K10_QUALITIES} and the trainer's floor(U[60, "
            f"100)) x {len(takes)} take patterns: bit-equal to plain, untaken frames "
            f"bit-unchanged")
    for shape, how in K10_GEOMETRIES:
        n = shape[0]
        x = k10_frames(side, dev, n, "noise", shape[1:3], dtype)
        take = np.ones(n, bool) if how == "all" else np.arange(n) == n - 1
        if how == "seeded":
            take = side.random(n) < 0.5
            take[side.integers(0, n)] = True
        q = torch.from_numpy(np.floor(side.uniform(1.0, 100.0, n)).astype(np.float32)).to(dev)
        err = max(err, k10_check(x, torch.from_numpy(take).to(dev), q,
                                 f"{shape}{tag} take {how}"))
        bands, chunks, mcus = oj.band_chunks(*shape[1:3])
        log(f"K10{tag} {shape}, {int(take.sum())} taken ({how}), {bands} bands of {chunks} "
            f"chunk(s) of <= {mcus} MCUs: bit-equal to plain")
        del x

    # timing at the trainer's step: plan1_2's 12 x 30 frames, K10_TAKEN taken
    xs = k10_frames(side, dev, K10_FRAMES, "smooth", dtype=dtype)
    take = torch.zeros(K10_FRAMES, dtype=torch.bool, device=dev)
    take[torch.from_numpy(side.choice(K10_FRAMES, K10_TAKEN, replace=False)).to(dev)] = True
    q = torch.from_numpy(np.floor(side.uniform(60.0, 100.0, K10_FRAMES)).astype(np.float32)
                         ).to(dev)
    dig = digest(oj.jpeg_subset_(xs.clone(), take, q))
    frame_bytes = xs[0].numel() * esize
    nbytes = 2.0 * K10_TAKEN * frame_bytes
    n_rot = int(2 * L2_BYTES // (K10_TAKEN * frame_bytes)) + 2
    rot = [xs] + [xs.clone() for _ in range(n_rot - 1)]
    k_ms = rotated_ms(lambda x: oj.jpeg_subset_(x, take, q), rot)
    w_ms = cuda_ms(lambda: oj.jpeg_subset_(xs, take, q))
    idx = torch.nonzero(take).flatten()
    pairs = [(torch.empty((K10_TAKEN, 224, 224, 3), device=dev, dtype=dt),
              x.index_select(0, idx)) for x in rot]
    c_ms = rotated_ms(lambda pair: pair[0].copy_(pair[1]), pairs)
    p_ms = cuda_ms(lambda: oj.jpeg_subset_plain_(xs, take, q), iters=3)
    del rot, pairs
    # operations: per pixel the colour transforms (~30) and 4 DCT passes of 16
    # flops a coefficient over 1.5 planes' worth of coefficients
    b_ms, b_by = bound_ms(nbytes, K10_TAKEN * 224 * 224 * (30 + 4 * 16 * 1.5))
    log(f"K10{tag} at ({K10_FRAMES}, 224, 224, 3), {K10_TAKEN} taken: kernel {k_ms:.4f} ms cold "
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


def s3d_train_phase(seed, rng, dev, det, face, profile: bool = False,
                    dtype: str = "float32", clips_cache: Optional[dict] = None) -> dict:
    """S3 (with ``dtype`` bfloat16, B3: ``model.dtype`` bf16 and the
    transform's K10 in its bf16 mode): `Trainer` on clip batches cached on
    the card, at each plan of
    S3D_PLANS at its published batch and frames (``s3d`` from plan1_2, the
    S3D transform on, so K10 once a step; ``ca_s3d`` from caplan9, black
    masking of 6 regions on `synth_face` frames, on the host; ``msca_s3d``
    from mplan1), seeded weights, raw 0-255 inputs, bce_weighted with the
    plans' rebalancing: one warm-up step, S3D_TIMED_STEPS timed steps (train
    clips/s, ms a step, peak memory), one traced step (the device's busy
    share; K10's ``jpeg_bands`` in it where the transform is on), K10
    launches a step; `fit` for one epoch of S3D_FIT_STEPS steps and one
    eval batch with the counts set to 0 before it (K10 launched once a train
    step with aug on, never with it off); one eval batch; S3D_FIXED_STEPS
    steps on one fixed batch, augmentation off, from the weights and
    optimizer state copied before the warm-up step, whose first loss must
    be at least S3D_FIXED_FIRST_LOSS and last below it. Inputs from `side_rng`; ``clips_cache`` keeps each plan's
    clips (masked on the host, the slow part) for a later call, which
    trains on the same clips."""
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
        cfg.model.dtype = dtype
        cfg.model.image_size = S3D_TRAIN_HW
        cfg.train.epochs = 1
        cfg.train.log_every = 0
        cfg.train.checkpoint_dir = ""
        cfg.train.checkpoint_every = 0
        bs, t = cfg.data.batch_size, cfg.data.frames_per_video
        n = bs * (S3D_FIT_STEPS + 1)
        if clips_cache is not None and name in clips_cache:
            clips, found = clips_cache[name]
        elif cfg.data.mask_method == "black":
            clips, found = masked_face_clips(side, det, face, n, t, S3D_TRAIN_HW)
            if found < n:
                raise AssertionError(f"{name}: BlazeFace found the face in {found} of {n} clips")
        else:
            clips = side.integers(0, 256, (n, t, S3D_TRAIN_HW, S3D_TRAIN_HW, 3), dtype=np.uint8)
            found = 0
        if clips_cache is not None:
            clips_cache[name] = clips, found
        labels = np.arange(n) % 2
        pw = cfg.train.rebalance_real / cfg.train.rebalance_fake      # balanced labels
        torch.cuda.empty_cache()
        model = build_model(cfg.model, device=dev, seed=seed)
        tr = Trainer(model, cfg, loss_kwargs={"pos_weight": pw})
        # the fixed-batch steps start from here, where the model has not fit
        # their batch (after the timed steps and `fit` it may have: B3 once
        # read 0.0132 -> 0.0139, bf16 rounding deciding, PERF.md §6)
        start = copy.deepcopy(model.state_dict()), copy.deepcopy(tr.optimizer.state_dict())
        train = tr.cache_data(clips[:bs * S3D_FIT_STEPS], labels[:bs * S3D_FIT_STEPS], bs)
        val = tr.cache_data(clips[bs * S3D_FIT_STEPS:], labels[bs * S3D_FIT_STEPS:], bs)
        ones = torch.ones((bs,), device=dev)
        batch = lambda i: {"image": train.images[i * bs:(i + 1) * bs],
                           "label": train.labels[i * bs:(i + 1) * bs], "mask": ones}
        gen = torch.Generator(device=dev).manual_seed(seed)
        aug_on = cfg.data.augment.enabled
        tag = name if dtype == "float32" else f"{name} {dtype}"
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
                                     f"{tag} train step, batch {bs}", top=12 if profile else 0,
                                     expect=("jpeg_bands",) if aug_on else (), inference=False)
        step_ms = dt / S3D_TIMED_STEPS * 1e3
        res = dict(plan=plan, batch=bs, frames=t, step_ms=step_ms,
                   clips_per_s=bs * S3D_TIMED_STEPS / dt, peak_gb=peak_gb,
                   traced_wall_ms=wall, traced_busy_ms=busy, busy_share=busy / step_ms,
                   k10_per_step=per_step, augment=aug_on, mask=cfg.data.mask_method,
                   faces_found=found, dtype=dtype)
        log(f"{tag} training ({plan}, batch {bs} x {t} x {S3D_TRAIN_HW}^2, aug {aug_on}, mask "
            f"{cfg.data.mask_method}): {res['clips_per_s']:.2f} train clips/s, {step_ms:.1f} ms "
            f"a step ({S3D_TIMED_STEPS} steps after a warm-up step); one traced step "
            f"{wall:.1f} ms wall, device busy {busy:.1f} ms ({busy / step_ms:.1%} of an "
            f"untraced step); peak memory {peak_gb:.2f} GB; K10 {per_step:g} a step")
        if per_step != (1 if aug_on else 0):
            raise AssertionError(f"{name}: K10 {per_step} a step, aug {aug_on}")

        oj.jpeg_subset_.launches = oj.jpeg_subset_.bf16_launches = 0
        steps0 = tr.step
        t0 = time.perf_counter()
        fit = tr.fit(train, val)
        t_fit = time.perf_counter() - t0
        fit_steps = tr.step - steps0
        h = fit["history"]
        res["fit_launches"] = {"K10": oj.jpeg_subset_.launches,
                               "K10_bf16": oj.jpeg_subset_.bf16_launches}
        res["fit_steps"] = fit_steps
        log(f"{tag} fit, 1 epoch of {fit_steps} steps and {val.steps} eval batch: "
            f"{t_fit:.1f} s; train loss {h['train_loss'][0]:.4f}, val loss "
            f"{h['val_loss'][0]:.4f} acc {h['val_acc'][0]:.4f}; K10 launches "
            f"{res['fit_launches']}")
        if not all(np.isfinite(h[k][0]) for k in ("train_loss", "val_loss")):
            raise AssertionError(f"{tag}: losses not finite: {h}")
        want = fit_steps if aug_on else 0
        if res["fit_launches"] != {"K10": want,
                                   "K10_bf16": want if dtype == "bfloat16" else 0}:
            raise AssertionError(f"{tag}: K10 launches {res['fit_launches']} in {fit_steps} "
                                 f"steps, aug {aug_on}")

        ev = tr.eval_step({"image": val.images, "label": val.labels, "mask": ones})
        ev = {k: float(v) for k, v in ev.items()}
        tr.cfg.data.augment.enabled = False
        model.load_state_dict(start[0])
        tr.optimizer.load_state_dict(start[1])
        del start
        fixed = batch(0)
        losses = [float(tr.train_step(fixed, gen)["loss"]) for _ in range(S3D_FIXED_STEPS)]
        tr.cfg.data.augment.enabled = aug_on
        res.update(fixed_losses=losses, eval_batch=ev)
        log(f"{tag} {S3D_FIXED_STEPS} steps on one fixed batch, augmentation off, from the "
            f"phase's starting weights and optimizer: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(first at least {S3D_FIXED_FIRST_LOSS}); one eval batch after fit {ev}")
        if not (all(np.isfinite(losses)) and losses[0] >= S3D_FIXED_FIRST_LOSS
                and losses[-1] < losses[0] and np.isfinite(ev["loss"]) and ev["count"] == bs):
            raise AssertionError(f"{name}: fixed-batch losses {losses}, eval {ev}")
        out[name] = res
        del tr, model, train, val
    torch.cuda.empty_cache()
    return out


def s3d_train_vs_cpu(seed, rng, dev, dtype: str = "float32",
                     names=("ca_s3d", "msca_s3d")) -> dict:
    """S4 (with ``dtype`` bfloat16, B3's check of ``ca_s3d``: both steps
    bf16, held layer by layer by `replay_layers` and as a whole by its
    gradient, its logits (`logit_rule`) and its loss (`loss_rule`), the
    running stats and card-vs-CPU quantities printed): one train step of
    ``ca_s3d`` and
    ``msca_s3d`` at full width, batch
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
    for name in names:
        cfg = Config()
        cfg.model.name, cfg.model.num_class = name, 1
        cfg.model.dtype = dtype
        cfg.data.normalize = "raw255"
        cfg.data.augment.enabled = False
        cfg.train.loss = "bce_weighted"
        cfg.train.checkpoint_dir = ""
        model = build_model(cfg.model, device="cpu", seed=seed)
        u8 = torch.from_numpy(side.integers(
            0, 256, (S3D_CHECK_BATCH, S3D_CHECK_T, S3D_TRAIN_HW, S3D_TRAIN_HW, 3), dtype=np.uint8))
        b = {"image": u8, "label": torch.arange(S3D_CHECK_BATCH) % 2,
             "mask": torch.ones(S3D_CHECK_BATCH)}
        side_res, layers = {}, None
        for where, d, dt in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                             ("f64", "cpu", torch.float64)):
            m = copy.deepcopy(model).to(d if where != "f64" else "cpu")
            tr = Trainer(m, cfg, device=d, loss_kwargs={"pos_weight": 0.3})
            if where == "card" and dtype == "bfloat16":
                before = copy.deepcopy(m)
                rec, hooks = record_layers(m)
            t0 = time.perf_counter()
            if where == "f64":
                m.dtype = torch.float32          # the parameters' dtype, float64 below
                m = m.double().train()
                x = (b["image"].double() / torch.full((1,), 255.0, dtype=torch.float64)
                     * 255.0).permute(0, 4, 1, 2, 3)
                logits = m(x)
                loss = tr.loss_fn(logits, b["label"], b["mask"].double())
                loss.backward()
                loss, kept = float(loss.detach()), [logits.detach()]
            else:
                kept, logit_hook = step_logits(m)
                met = tr.train_step({k: v.to(d) for k, v in b.items()},
                                    torch.Generator(device=d).manual_seed(0))
                logit_hook.remove()
                loss = float(met["loss"])
            side_res[where] = dict(
                t=time.perf_counter() - t0, loss=loss, logits=kept[0],
                grads={k: p.grad.double().cpu() for k, p in m.named_parameters()},
                bufs={k: v.double().cpu() for k, v in m.named_buffers()
                      if k.endswith(("running_mean", "running_var"))})
            if where == "card" and dtype == "bfloat16":
                for h in hooks:
                    h.remove()
                layers = replay_layers(before, rec, name)
                del before, rec
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
        res["dtype"], res["layers"] = dtype, layers
        res["card_loss_vs_f64"] = abs(g["loss"] - f["loss"]) / abs(f["loss"])
        res["cpu_loss_vs_f64"] = abs(c["loss"] - f["loss"]) / abs(f["loss"])
        log(f"{name}{'' if dtype == 'float32' else ' ' + dtype} one train step card vs CPU, "
            f"batch {S3D_CHECK_BATCH} x {S3D_CHECK_T} x "
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
        if dtype == "float32":
            ok = (res["loss_rel"] <= S3D_LOSS_RTOL and res["stats_tol_share"] <= 1.0
                  and res["stats_f64_over"] <= 1.0
                  and res["card_vs_f64"] <= TRAIN_GRAD_F64_RATIO * res["cpu_vs_f64"]
                  + TRAIN_GRAD_F64_SLACK)
        else:
            res.update(logit_rule(g["logits"], c["logits"], f["logits"]))
            ok = (res["card_vs_f64"] <= TRAIN_GRAD_F64_RATIO * res["cpu_vs_f64"]
                  + TRAIN_BF16_GRAD_F64_SLACK and res["logit_rule_holds"] and loss_rule(res))
            log(f"{name} {dtype}: held to float64: gradient card {res['card_vs_f64']:.3g} <= "
                f"{TRAIN_GRAD_F64_RATIO} x CPU {res['cpu_vs_f64']:.3g} + "
                f"{TRAIN_BF16_GRAD_F64_SLACK}; " + bf16_rules(res, loss_held=True))
        if not ok:
            raise AssertionError(f"{name}: one train step card vs CPU out of bounds: {res}")
        out[name] = res
    return out


def msca_int8(name, model, clips, dev, dtype: str = "float32") -> dict:
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
    (`int8_lockstep`) within LOGIT_TOL. With ``dtype`` bfloat16 (B4; also
    ``ca_s3d``): the engine's walk in bf16 (K5's bf16 out), the fp head
    input within S3D_BF16_FEATURE_RATIO of the CPU's bf16-vs-fp32
    difference (`b4_bf16_rule`), lock-step within S3D_FP_BLOCK_RTOL_BF16
    and LOGIT_TOL_BF16."""
    import torch
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant3d as q3
    bf16 = dtype == "bfloat16"
    tag = f"{'B4' if bf16 else 'S5'} {name}{' ' + dtype if bf16 else ''}"
    ev8 = S3DEvaluator(model, degrade=False, quantize="int8", device=dev)
    ev8.predict_batch(clips[:2])                   # calibrates on these two clips
    ev8.predict_batch(clips)                       # warm at the timed batch
    torch.cuda.synchronize()
    if ev8.engine.dtype != getattr(torch, dtype):
        raise AssertionError(f"{tag}: the int8 engine's walk in {ev8.engine.dtype}")
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
    log(f"{tag} int8 (SRM {model.srm}): predict_batch {S3D_BATCH} clips {rate:.2f} "
        f"clips/s; launches {launches} over {forwards} forwards; a forward: {want}")
    if forwards < 1 or any(launches[k] != forwards * v for k, v in per.items()) \
            or min(launches[k] for k in ("K5", "K5_relu6", "K5_quantize", "K6")
                   if per[k]) < 1 \
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
    log(f"{tag} int8 forward: {len(calls['conv'])} conv shapes; K2's raw entry and every "
        f"K5/K6 call bit-equal to their plain versions on the same clips and activations "
        f"(ReLU6 and fused epilogues included): {checked}")
    with torch.no_grad():
        x32 = torch.from_numpy(clips).to(dev).permute(0, 4, 1, 2, 3)
        a, b = model(x32.float()).double(), ev8.engine(x32).double()
    del x32
    ac, bc = a - a.mean(), b - b.mean()
    int8_vs_fp32 = float((a - b).abs().max())
    log(f"{tag} int8 vs fp logits on {S3D_BATCH} clips (information): max abs "
        f"{int8_vs_fp32:.4g} centred cosine "
        f"{float((ac * bc).sum() / (ac.norm() * bc.norm())):.6f} (|logit| max "
        f"{float(a.abs().max()):.3g}, spread {float(a.max() - a.min()):.3g})")

    u1 = torch.from_numpy(clips[:1]).permute(0, 4, 1, 2, 3)
    feats, errs = {}, {}
    if bf16:       # the fp32 model of the same weights, on the CPU: bf16's own difference
        m32 = copy.deepcopy(model).cpu()
        m32.dtype = torch.float32
        f32_ref = head_input(m32, u1.float())[1].double()
        del m32
    for label, mod in (("fp32", model), ("int8", ev8.engine)):
        one = u1.float() if label == "fp32" else u1
        gpu_l, gpu_f = head_input(mod, one.to(dev))
        t_cpu = time.perf_counter()
        cpu_l, cpu_f = head_input(copy.deepcopy(mod).cpu(), one)
        t_cpu = time.perf_counter() - t_cpu
        gpu_l, gpu_f, cpu_f = gpu_l.cpu(), gpu_f.cpu().double(), cpu_f.double()
        feats[label] = gpu_f, cpu_f
        errs[label] = float((gpu_l - cpu_l).abs().max())
        log(f"{tag} {label if not bf16 else label.replace('fp32', 'fp')} logits card vs "
            f"CPU, batch 1 ({t_cpu:.1f} s on the CPU): max abs {errs[label]:.3g} (logit "
            f"{float(cpu_l[0, 0]):.6g})")
        if not torch.isfinite(gpu_l).all() or (label == "fp32" and not bf16
                                               and errs[label] > LOGIT_TOL):
            raise AssertionError(f"{name} {label} logits differ: {errs[label]} > {LOGIT_TOL}")
    (g32, c32), (g8, c8) = feats["fp32"], feats["int8"]
    f32_err = float((g32 - c32).norm() / c32.norm())
    f8_err = float((g8 - c8).norm() / (c8 - c32).norm())
    if bf16:
        # phase 14's rule for the bf16 fp head input: card vs CPU within the
        # CPU's own bf16-vs-fp32 difference
        f32_err = float((g32 - c32).norm() / (c32 - f32_ref).norm())
        log(f"{tag} head input card vs CPU: fp error {f32_err:.3g} of the CPU's bf16-vs-fp32 "
            f"difference (limit {S3D_BF16_FEATURE_RATIO}; that difference is "
            f"{float((c32 - f32_ref).norm() / f32_ref.norm()):.3g} of the fp32 norm, the "
            f"card's bf16 {float((g32 - f32_ref).norm() / (c32 - f32_ref).norm()):.3g} of it)")
        if not b4_bf16_rule(f32_err):
            raise AssertionError(f"{tag} fp head input differs card vs CPU: {f32_err} of the "
                                 f"bf16-vs-fp32 difference")
    # fp32: information (the iFormer blocks round further apart than
    # ca_s3d's layers: 1.8-2.7e-5 of the norm on an H100, ca_s3d's 7.7e-7);
    # fp32 is held by its logits above
    log(f"{tag} head input card vs CPU: fp error {f32_err:.3g} of "
        f"{'the bf16-vs-fp32 difference' if bf16 else 'its norm (information)'}; int8 error "
        f"{f8_err:.3g} of the CPU's int8-vs-fp difference (limit {S3D_INT8_FEATURE_RATIO}; "
        f"that difference is {float((c8 - c32).norm() / c32.norm()):.3g} of the fp norm)")
    if not f8_err <= S3D_INT8_FEATURE_RATIO:
        raise AssertionError(f"{name} int8 head input differs card vs CPU: {f8_err} of the "
                             f"int8-vs-fp32 difference")
    lock = int8_lockstep(ev8.engine, u1, dev)
    block_tol, logit_tol = ((S3D_FP_BLOCK_RTOL_BF16, LOGIT_TOL_BF16) if bf16
                            else (S3D_FP_BLOCK_RTOL, LOGIT_TOL))
    log(f"{tag} int8 card vs CPU in lock-step (the CPU's walk fed the card's fp-block "
        f"and SRM outputs, each within {lock['block_err']:.3g} of the CPU's own, bound "
        f"{block_tol}, of its largest value): logits max abs {lock['logit_err']:.3g} "
        f"(bound {logit_tol}); free-running, above: {errs['int8']:.3g}")
    if not (lock["block_err"] <= block_tol and lock["logit_err"] <= logit_tol):
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


def msca_scoring(seed, rng, dev, dtype: str = "float32", profile: bool = False) -> dict:
    """S5: `S3DEvaluator` with the full-width ``msca_s3d`` and ``msca_s3d_srm``
    (the residual 3-filter SRM input), seeded weights: `predict_batch`
    clips/s at batch S3D_BATCH in fp32 beside ``ca_s3d``'s at the same
    frames, and in int8 with what `msca_int8` checks (the launches, every
    K5/K6 call bit-equal to its plain version, logits and head input card
    vs CPU at batch 1, S3D_MSCA_T frames). Inputs from `side_rng`. With
    ``dtype`` bfloat16, B4: the three models in bf16 (``model.dtype``), fp
    and int8 each (`msca_int8` in bf16)."""
    import torch
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.models import build_model
    side = side_rng(rng)
    clips = side.integers(0, 256, (S3D_BATCH, S3D_MSCA_T, S3D_TRAIN_HW, S3D_TRAIN_HW, 3),
                          dtype=np.uint8)
    out = {}
    bf16 = dtype == "bfloat16"
    for name, srm in (("ca_s3d", False), ("msca_s3d", False), ("msca_s3d_srm", True)):
        mc = ModelConfig(name=name, num_class=1, srm_net=srm, dtype=dtype)
        model = build_model(mc, device=dev, seed=seed)
        ev = S3DEvaluator(model, degrade=False, device=dev)
        # warm cuDNN at the timed batch: a first call at a new shape pays its
        # algorithm search (bf16 ca_s3d on an H100: 148 clips/s timed cold,
        # a traced warm call 90.9 ms)
        ev.predict_batch(clips)
        rate, probs = clips_per_s(ev, clips, n_it=2)
        if profile:
            profile_forward(lambda: ev.predict_batch(clips),
                            f"{name} {dtype} predict_batch {S3D_BATCH}")
        if not np.isfinite(probs).all():
            raise AssertionError(f"{name}: fp32 scores {probs}")
        res = dict(clips_per_s=rate, srm=model.srm, dtype=dtype)
        log(f"{'B4' if bf16 else 'S5'} {name} {dtype} (SRM {model.srm}), {S3D_MSCA_T} x "
            f"{S3D_TRAIN_HW}^2: predict_batch {S3D_BATCH} clips {rate:.2f} clips/s")
        del ev
        if name != "ca_s3d" or bf16:
            res.update(msca_int8(name, model, clips, dev, dtype))
        out[name] = res
        del model
        torch.cuda.empty_cache()
    return out


def zoo_scorer(name, seed, dev, det, reader, quantize: str = "none"):
    """Z1-Z3: the registry entry ``name`` at its published widths, seeded,
    its weights carried through the key map of a reference checkpoint
    (``{"state_dict": {"module." + key: ...}}``, `load_reference_pth`) into
    a second build and loaded strictly, then a `VideoScorer` (which folds
    it) with ``infer.quantize``."""
    import torch
    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model
    cfg = Config()
    cfg.model.name = name
    cfg.infer.quantize = quantize
    src = build_model(cfg.model, device=dev, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.pth")
        torch.save({"epoch": 0, "state_dict": {f"module.{k}": v
                                               for k, v in src.state_dict().items()}}, path)
        model = build_model(cfg.model, device=dev, seed=seed + 1)
        model.load_state_dict(load_reference_pth(path), strict=True)
    want = src.state_dict()
    if not all(torch.equal(v, want[k]) for k, v in model.state_dict().items()):
        raise AssertionError(f"{name}: the reference checkpoint did not carry every tensor")
    del src, want
    return VideoScorer(model, cfg, detector=det, reader=reader)


def zoo_crops_per_s(scorer, crops) -> tuple:
    """crops/s through ``score_crops`` over ZOO_TIMED_CALLS calls after one
    to warm up, and the last score."""
    import torch
    scorer.score_crops(crops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_TIMED_CALLS):
        p = scorer.score_crops(crops)
    torch.cuda.synchronize()
    return len(crops) * ZOO_TIMED_CALLS / (time.perf_counter() - t0), p


def zoo_fp32(seed, dev, det, reader, crops, four) -> dict:
    """Z1: every zoo entry at its published widths (`zoo_scorer`): fp32
    logits of the folded model card vs CPU at batch ZOO_CHECK_BATCH within
    ZOO_LOGIT_ATOL + ZOO_LOGIT_RTOL·|logit|, and crops/s through ``score_crops`` (29 crops, capacity 96)
    beside base cvit's, timed the same way in this phase."""
    import torch
    out = {}
    for name in ("cvit",) + ZOO:
        scorer = zoo_scorer(name, seed, dev, det, reader)
        err = 0.0 if name == "cvit" else logits_vs_cpu(
            scorer.model, four[:ZOO_CHECK_BATCH], f"Z1 {name} fp32 logits (folded)",
            rtol=ZOO_LOGIT_RTOL, atol=ZOO_LOGIT_ATOL)
        rate, p = zoo_crops_per_s(scorer, crops)
        n_par = sum(t.numel() for t in scorer.model.state_dict().values())
        out[name] = dict(crops_per_s=rate, logit_err=err, score=p)
        log(f"Z1 {name}: {rate:.1f} crops/s ({rate / out['cvit']['crops_per_s']:.3f} of cvit's); "
            f"score {p:.4f}; {n_par / 1e6:.1f} M values folded")
        if not (np.isfinite(p) and 0.0 <= p <= 1.0):
            raise AssertionError(f"Z1 {name}: score {p} is not a probability")
        del scorer
        torch.cuda.empty_cache()
    return out


def zoo_int8(seed, dev, det, reader, crops, four, fp32: dict) -> dict:
    """Z3: int8_full on the three entries of ZOO_INT8_WALKS (`zoo_scorer`;
    the first ``score_crops`` calibrates): crops/s beside the entry's fp32
    rate of Z1; launches through ``score_crops`` whole forwards of the
    planned walk; one forward from the uint8 crops at batch QBATCH runs the
    walk (`forward_counts`: ``CViT.walk_counts`` as ZOO_INT8_WALKS and
    `int8_denses` K4 launches) and every K3 and K4 call of one more, K2's
    int8 entry and any quantize pass, is bit-equal to its plain version on
    the real crops and activations (`check_k3_calls`); int8_full logits card
    vs CPU (plain versions) at batch ZOO_CHECK_BATCH in lock-step
    (`cvit_int8_lockstep`) within LOGIT_TOL, each fp step within
    ZOO_FP_STEP_RTOL; int8_full vs fp32 logits for information."""
    import torch
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    out = {}
    u96, pos96 = crops_96(crops, dev)
    for name, want in ZOO_INT8_WALKS.items():
        qs = zoo_scorer(name, seed, dev, det, reader, "int8_full")
        fp_model = qs.model
        t_cal = time.perf_counter()
        qs.score_crops(crops)                       # calibrates
        torch.cuda.synchronize()
        walk = qs.model.walk_counts()
        n_q = sum(op[0] == "qconv" for op in qs.model.stem_ops())
        log(f"Z3 {name} int8_full: calibrated and scored in {time.perf_counter() - t_cal:.2f} s; "
            f"{n_q} convs quantized, the walk {walk}")
        if qs._quant_pending or not qs.model.quant_dense or walk != want or n_q != want["convs"]:
            raise AssertionError(f"Z3 {name}: quantized {n_q} convs, walk {walk}; want {want}")
        q.int8_conv3x3.launches = q3.quantize_pad.launches = q.quant_dense.launches = 0
        pp.quantize_crops.launches = pp.normalize_imagenet.launches = 0
        rate, p = zoo_crops_per_s(qs, crops)
        calls = ZOO_TIMED_CALLS + 1
        launches = {"K2": pp.normalize_imagenet.launches, "K2_int8": pp.quantize_crops.launches,
                    "K3": q.int8_conv3x3.launches, "K3_quantize": q3.quantize_pad.launches,
                    "K4": q.quant_dense.launches}
        n_dense = sum(int8_denses(name).values())
        whole = {"K2": calls * want["k2_int8"], "K2_int8": calls * want["k2_int8"],
                 "K3": calls * want["convs"], "K3_quantize": calls * want["quantize"],
                 "K4": calls * n_dense}
        log(f"Z3 {name} int8_full: {rate:.1f} crops/s (fp32 {fp32[name]['crops_per_s']:.1f}); "
            f"score {p:.4f}; launches over {calls} score_crops calls {launches}")
        if launches != whole or not (np.isfinite(p) and 0.0 <= p <= 1.0):
            raise AssertionError(f"Z3 {name}: launches {launches}, whole forwards {whole}; "
                                 f"score {p}")
        one = forward_counts(qs.model, u96, pos96)
        want_one = dict({k: want[k] for k in FORWARD_KEYS}, K4=n_dense)
        checked, _ = check_k3_calls(qs.model, u96, pos96, denses=True)
        want_checked = dict({k: want[k] for k in CHECKED_KEYS}, K4=n_dense)
        log(f"Z3 {name} forward at batch {QBATCH}: runs {one}; K2's int8 entry, every K3 and "
            f"K4 call bit-equal to the plain versions on the same crops and activations: "
            f"{checked}")
        if one != want_one or checked != want_checked:
            raise AssertionError(f"Z3 {name}: ran {one}, checked {checked}; want {want_one}, "
                                 f"{want_checked}")
        lock = cvit_int8_lockstep(qs.model, four[:ZOO_CHECK_BATCH])
        log(f"Z3 {name} int8_full card vs CPU at batch {ZOO_CHECK_BATCH} in lock-step (the "
            f"CPU's walk fed the card's input at each of its {lock['points']} fp quantize "
            f"points): logits max abs {lock['logit_err']:.3g}, fp steps within "
            f"{lock['step_err']:.3g} of their largest value; free-running (information: a "
            f"code flips where an fp step's rounding meets a .5 tie) {lock['free_err']:.3g}")
        if not (lock["logit_err"] <= LOGIT_TOL and lock["step_err"] <= ZOO_FP_STEP_RTOL):
            raise AssertionError(f"Z3 {name}: int8_full card vs CPU in lock-step {lock}")
        with torch.inference_mode():
            u29, pos29 = torch.from_numpy(crops).to(dev), torch.arange(29, device=dev)
            a = fp_model.forward_crops(u29, torch.float32, pos29).double()
            b = qs.model.forward_crops(u29, torch.float32, pos29).double()
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        log(f"Z3 {name} int8_full vs fp32 logits on 29 crops (information): max abs "
            f"{float((a - b).abs().max()):.4g} cosine {cos:.6f} "
            f"(|logit| max {float(a.abs().max()):.3g})")
        out[name] = dict(crops_per_s=rate, fp32_crops_per_s=fp32[name]["crops_per_s"],
                         launches=launches, per_forward=one, lockstep=lock,
                         int8_vs_fp32_max_abs=float((a - b).abs().max()), cosine=cos)
        del qs, fp_model
        torch.cuda.empty_cache()
    return out


def cvit_int8_lockstep(model, u8) -> dict:
    """Z3: the int8_full CViT ``model``'s forward from the uint8 crops ``u8``
    (on the CPU), card against CPU in lock-step. K2's int8 entry and the K3
    walk are exact either way (each kernel equals its plain version), but
    the fp steps between the int8 layers (a stem's fp tail, the blocks,
    LayerNorm, attention, GELU) round differently on the two devices, and
    free-running such a difference flips a code wherever a value sits on a
    .5 tie of a quantize point. Here the card's forward records the fp input
    of each quantize point (each K4 dense, each quantize pass); the CPU's
    runs its own, holds it to the card's (``step_err``: the largest
    difference over the card's largest value, any point) and goes on with
    the card's. Returns that, the logits' max abs difference, the number of
    points, and the free-running logits' max abs difference."""
    import torch
    from fac_fake_torch.ops import quant as q
    from fac_fake_torch.ops import quant3d as q3
    dev = model.cls_token.device
    pos = torch.arange(u8.shape[0])
    real, seen = (q.quant_dense, q3.quantize_pad), []

    def record(kind, fn):
        def run(x, *args, **kw):
            seen.append((kind, x.detach().cpu()))
            return fn(x, *args, **kw)
        run.launches = 0
        return run

    q.quant_dense, q3.quantize_pad = record("K4", real[0]), record("quantize", real[1])
    try:
        with torch.inference_mode():
            gpu = model.forward_crops(u8.to(dev), torch.float32, pos.to(dev)).cpu()
    finally:
        q.quant_dense, q3.quantize_pad = real
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        free = cpu_model.forward_crops(u8, torch.float32, pos)
    steps, worst = iter(seen), [0.0]

    def carried(kind, fn):
        def run(x, *args, **kw):
            k, ref = next(steps)
            if k != kind or ref.shape != x.shape:
                raise AssertionError(f"quantize points out of order: the card's {k} "
                                     f"{tuple(ref.shape)}, the CPU's {kind} {tuple(x.shape)}")
            worst[0] = max(worst[0], float((x.float() - ref.float()).abs().max()
                                           / ref.float().abs().max().clamp_min(1e-30)))
            return fn(ref, *args, **kw)
        run.launches = 0
        return run

    q.quant_dense, q3.quantize_pad = carried("K4", real[0]), carried("quantize", real[1])
    try:
        with torch.inference_mode():
            cpu = cpu_model.forward_crops(u8, torch.float32, pos)
    finally:
        q.quant_dense, q3.quantize_pad = real
    if next(steps, None) is not None:
        raise AssertionError("the CPU's forward passed fewer quantize points than the card's")
    return dict(logit_err=float((gpu - cpu).abs().max()), step_err=worst[0], points=len(seen),
                free_err=float((gpu - free).abs().max()))


def zoo_phases(seed, rng, dev, det, reader, crops, stacks, paths, with_faces, four) -> dict:
    """Z1-Z3, the variant zoo at full width (seeded weights, TF32 off): Z1
    every entry (`zoo_fp32`); Z2 ZOO_VIDEO_ENTRY end to end through
    `VideoScorer` over the videos of phase 5 (`fp32_path`: videos/min, K1
    and K2 launches); K3 and K4 at the new shapes of cvit_ggca_sla's and
    cvit_ggca_add_glu's int8_full walks (`k3_phase`, `k4_phase`: each
    distinct conv and dense bit-equal to its plain version, fp32 and bf16,
    and timed); Z3 int8_full on three entries (`zoo_int8`)."""
    import torch
    t0 = time.perf_counter()
    z1 = zoo_fp32(seed, dev, det, reader, crops, four)
    log(f"[Z1 {time.perf_counter() - t0:.1f} s]")
    scorer = zoo_scorer(ZOO_VIDEO_ENTRY, seed, dev, det, reader)
    z2_rates = {}
    z2 = fp32_path(scorer, paths, crops, stacks, with_faces, ZOO_VIDEO_ENTRY, z2_rates)
    del scorer
    torch.cuda.empty_cache()
    log(f"[Z2 {time.perf_counter() - t0:.1f} s]")
    done = {}
    k3 = {n: k3_phase(rng, dev, n, done) for n in ("cvit_ggca_sla", "cvit_ggca_add_glu")}
    k4 = {n: k4_phase(rng, dev, n) for n in ("cvit_ggca_sla", "cvit_ggca_add_glu")}
    torch.cuda.empty_cache()
    log(f"[K3, K4 at the zoo's shapes {time.perf_counter() - t0:.1f} s]")
    z3 = zoo_int8(seed, dev, det, reader, crops, four, z1)
    log(f"[Z3 {time.perf_counter() - t0:.1f} s]")
    log(json.dumps({"zoo": {"fp32": z1, "video_path": dict(z2_rates, entry=ZOO_VIDEO_ENTRY,
                                                           launches=z2),
                            "int8_full": z3}}, default=str))
    return dict(z1=z1, z2=z2, z2_rates=z2_rates, k3=k3, k4=k4, z3=z3)


def zoo_bf16_scoring(seed, dev, det, reader, crops, four, z1: dict) -> dict:
    """Z6's scoring half: every zoo entry at its published widths, seeded,
    through `VideoScorer` at ``model.dtype=bfloat16`` (fp32 weights, folded;
    K2's bf16 normalize feeds the bf16 activations; UFFC's FFTs stay fp32):
    crops/s through ``score_crops`` (29 crops, capacity 96) beside Z1's fp32
    rate of this run, one K2 launch a call; then, on ZOO_CHECK_BATCH of the
    uint8 crops ``four``, the folded model: the head's input on the card in
    bf16 no further (error norm) from the CPU's fp32 one than
    ZOO_BF16_FEATURE_RATIO x the CPU's bf16 one; the logits finite, card vs
    CPU printed."""
    import torch
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model
    from fac_fake_torch.ops import preprocess as pp
    out = {}
    pos = torch.arange(ZOO_CHECK_BATCH)

    def head_in(model, u8, dtype):
        """The logits and the head's input of ``model`` on the crops ``u8``."""
        seen = []
        hook = model.mlp_head.register_forward_pre_hook(
            lambda _, args: seen.append(args[0].detach().cpu().double()))
        try:
            logits = model.forward_crops(u8, dtype, pos.to(u8.device)).cpu()
        finally:
            hook.remove()
        return logits, seen[0]

    for name in ZOO:
        cfg = Config()
        cfg.model.name = name
        cfg.model.dtype = "bfloat16"
        scorer = VideoScorer(build_model(cfg.model, device=dev, seed=seed), cfg, detector=det,
                             reader=reader)
        pp.normalize_imagenet.launches = 0
        rate, p = zoo_crops_per_s(scorer, crops)
        k2 = pp.normalize_imagenet.launches
        if k2 != ZOO_TIMED_CALLS + 1 or not (np.isfinite(p) and 0.0 <= p <= 1.0):
            raise AssertionError(f"Z6 {name}: {k2} K2 launches for {ZOO_TIMED_CALLS + 1} "
                                 f"calls, score {p}")
        fp32_rate = z1[name]["crops_per_s"]
        out[name] = dict(crops_per_s=rate, fp32_crops_per_s=fp32_rate, score=p, k2_launches=k2,
                         checks=[])
        log(f"Z6 {name} bf16: {rate:.1f} crops/s ({rate / fp32_rate:.3f} of its fp32 "
            f"{fp32_rate:.1f} in Z1); score {p:.4f}")
        x = four[:ZOO_CHECK_BATCH]
        with torch.inference_mode():
            card, card_f = head_in(scorer.model, x.to(dev), torch.bfloat16)
            t_cpu = time.perf_counter()
            cpu_model = copy.deepcopy(scorer.model).cpu()
            cpu, cpu_f = head_in(cpu_model, x, torch.bfloat16)
            cpu32, cpu32_f = head_in(cpu_model, x, torch.float32)
            t_cpu = time.perf_counter() - t_cpu
        err, own = float((card - cpu).abs().max()), float((cpu - cpu32).abs().max())
        f_err = float((card_f - cpu32_f).norm() / (cpu_f - cpu32_f).norm())
        f_apart = float((card_f - cpu_f).norm() / (cpu_f - cpu32_f).norm())
        out[name]["checks"].append(dict(seed=seed, logit_err=err, cpu_bf16_vs_fp32=own,
                                        head_input_err=f_err, head_input_card_vs_cpu=f_apart))
        log(f"Z6 {name} bf16, weights seed {seed}: head input: the card's bf16 from "
            f"the CPU's fp32 {f_err:.3g} of the CPU bf16's distance (limit "
            f"{ZOO_BF16_FEATURE_RATIO}), card vs CPU in bf16 {f_apart:.3g} of it; logits "
            f"card vs CPU {err:.3g}, the CPU's bf16 vs fp32 {own:.3g} (CPU {t_cpu:.1f} s)")
        if not (torch.isfinite(card).all() and f_err <= ZOO_BF16_FEATURE_RATIO):
            raise AssertionError(f"Z6 {name}: bf16 head input from fp32 {f_err} of the CPU "
                                 f"bf16's distance > {ZOO_BF16_FEATURE_RATIO}")
        del scorer, cpu_model
        torch.cuda.empty_cache()
    return out


def zoo_train_phases(seed, rng, dev, data, det, reader, crops, four, z1: dict,
                     profile: bool = False) -> dict:
    """Z4-Z6, the zoo trained at full width (seeded weights, TF32 off). Z4:
    each ZOO_TRAIN entry through `train_phase` at batch TRAIN_BATCH,
    strong_aug on, the dataset cached
    on the card: ZOO_TRAIN_TIMED_STEPS timed steps after a warm-up step
    (crops/s, ms a step, peak memory, the busy share of a traced step; one
    K7 call a step); ZOO_FIT_ENTRY also `fit` for one epoch with an eval
    pass (one K2 launch an eval batch, finite losses) and a fixed batch
    whose loss falls. Z5: one train step of each card vs CPU vs float64 at
    batch TRAIN_CHECK_BATCH (`train_vs_cpu`, T3's rule). Z6: every entry
    scored in bf16 (`zoo_bf16_scoring`), and ZOO_BF16_TRAIN trained in bf16
    (`train_phase`: K7's bf16 mode once a step) with one bf16 step card vs
    CPU vs float64 held layer by layer (`train_vs_cpu(..., "bfloat16")`)."""
    import torch
    t0 = time.perf_counter()
    z4, z5 = {}, {}
    for name in ZOO_TRAIN:
        fit = name == ZOO_FIT_ENTRY
        z4[name], model = train_phase(name, seed, dev, data, profile=profile and fit,
                                      timed_steps=ZOO_TRAIN_TIMED_STEPS, fit=fit)
        z5[name] = train_vs_cpu(model, name, rng, zoo=True)
        del model
        torch.cuda.empty_cache()
        log(f"[Z4-Z5 {name} {time.perf_counter() - t0:.1f} s]")
    z6 = zoo_bf16_scoring(seed, dev, det, reader, crops, four, z1)
    log(f"[Z6 scoring {time.perf_counter() - t0:.1f} s]")
    z6_train, z6_cpu = {}, {}
    for name in ZOO_BF16_TRAIN:
        z6_train[name], model = train_phase(name, seed, dev, data, dtype="bfloat16",
                                            timed_steps=ZOO_TRAIN_TIMED_STEPS, fit=False)
        z6_cpu[name] = train_vs_cpu(model, name, rng, "bfloat16", zoo=True)
        del model
        torch.cuda.empty_cache()
    log(f"[Z6 training {time.perf_counter() - t0:.1f} s]")
    for name in ZOO_BF16_TRAIN:
        bf, fp32 = z6_train[name], z4[name]
        log(f"Z6 {name} at batch {bf['batch']}: bf16 {bf['crops_per_s']:.1f} train crops/s, "
            f"{bf['step_ms']:.2f} ms a step, {bf['busy_share']:.1%} busy, {bf['peak_gb']:.2f} GB; "
            f"fp32 (Z4, this run) {fp32['crops_per_s']:.1f}, {fp32['step_ms']:.2f} ms, "
            f"{fp32['busy_share']:.1%}, {fp32['peak_gb']:.2f} GB")
    log(json.dumps({"zoo_training": {"fp32": {n: dict(z4[n], vs_cpu=z5[n]) for n in z4},
                                     "bf16_scoring": z6,
                                     "bf16": {n: dict(z6_train[n], vs_cpu=z6_cpu[n])
                                              for n in z6_train}}}, default=str))
    return dict(z4=z4, z5=z5, z6=z6, z6_train=z6_train, z6_cpu=z6_cpu)


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
    t_start = time.perf_counter()
    clock = lambda what: log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    # ---- 2. build ---------------------------------------------------------
    kernels.build(verbose=True)
    log(f"build: {kernels.last_build_s:.1f} s for {', '.join(kernels.SOURCES)}")

    # ---- 3. K2 in its five modes against their plain versions -------------
    k2 = k2_phase(rng, dev)
    clock("build, K2")

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
    scores = {}
    launches = fp32_path(scorer, paths, crops, stacks, with_faces, scores=scores)

    # ---- E1. the scores' CSV evaluated against a seeded metadata.json --------
    e1 = evaluation_phase(args.seed, scores, with_faces, launches)

    # ---- 6. full-width logits, card against CPU ---------------------------
    four = torch.from_numpy(rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8))
    logits_vs_cpu(scorer.model, four, "full-width logits")

    # ---- G1, U1. Grad-CAM card against CPU; the profiling helpers -----------
    g1 = gradcam_phase(args.seed, dev, four)
    u1 = profiling_phase(scorer, crops, dev, smi)
    clock("phases 4-6, E1, G1, U1")
    x1 = export_phase(args.seed, model, four, dev)
    torch.cuda.empty_cache()
    clock("X1")

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
    clock("phases 7-10")

    # ---- M1-M3. MTCNN with K8, its video path, the serving entry point ----------
    k8 = k8_phase(rng, dev)
    m_scorer, m2 = mtcnn_path(args.seed, dev, reader)
    m3 = serve_phase(m_scorer)
    del m_scorer
    torch.cuda.empty_cache()
    clock("M1-M3")

    # ---- P1-P2. face-crop datasets and detector agreement --------------------------
    videos = paths + ["video_8"]
    p1 = dataset_phase(args.seed, dev, det, reader, videos, with_faces, smi)
    p2 = agreement_phase(args.seed, dev, det, reader, videos, with_faces, smi)
    clock("P1-P2")

    # ---- F1-F4. the flagship cvit_repbn8 -----------------------------------------
    flag = flagship_phases(args.seed, rng, dev, det, reader, crops, stacks, paths, with_faces,
                           four, args.profile)
    torch.cuda.empty_cache()
    clock("F1-F4")
    s3d = s3d_phases(args.seed, rng, dev, args.profile)
    torch.cuda.empty_cache()
    clock("phases 11-14")

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
    clock("T1-T2")
    t3 = train_vs_cpu(model, "cvit", rng)
    del model
    torch.cuda.empty_cache()
    t4, model = train_phase("cvit_repbn8", args.seed, dev, data, args.profile)
    t4_cpu = train_vs_cpu(model, "cvit_repbn8", rng)
    clock("T3-T4")
    log(json.dumps({"t3_t4_tensors": {n: {k: r[k] for k in (
        "left_out_share", "left_out_share_abs_floor", "equal_under_floor_share",
        "card_vs_f64", "cpu_vs_f64", "card_beyond_cpu_tensors")}
        for n, r in (("cvit", t3), ("cvit_repbn8", t4_cpu))}}))
    del model
    torch.cuda.empty_cache()

    # ---- R1-R3. the ResNet/KAN family with K9 -------------------------------------
    k9 = k9_phase(rng, dev)
    r2 = resvitkan_path(args.seed, rng, dev, det, reader, paths, with_faces, launches["K2"])
    torch.cuda.empty_cache()
    r3 = family_forwards(args.seed, rng, dev)
    torch.cuda.empty_cache()
    clock("R1-R3")
    r4 = kan_grid_phase(r2.pop("kan_head"), r2.pop("kan_x"), dev)
    clock("R4")

    # ---- S1-S5. S3D training with K10 ---------------------------------------------
    k10 = k10_phase(rng, dev)
    s3d_aug = s3d_augment_phase(rng, dev)
    s3_clips = {}
    s3 = s3d_train_phase(args.seed, rng, dev, det, face, args.profile, clips_cache=s3_clips)
    s4 = s3d_train_vs_cpu(args.seed, rng, dev)
    s5 = msca_scoring(args.seed, rng, dev)
    clock("S1-S5")

    # ---- B1-B4. bf16: K7 and K10 in their bf16 modes, bf16 training, bf16 S3D scoring
    b_rng = side_rng(rng)
    k7b = k7_phase(b_rng, dev, "bfloat16")
    k10b = k10_phase(b_rng, dev, "bfloat16")
    clock("B1")
    b2, b2_cpu = {}, {}
    for name in ("cvit", "cvit_repbn8"):
        b2[name], model = train_phase(name, args.seed, dev, data, args.profile, dtype="bfloat16")
        b2_cpu[name] = train_vs_cpu(model, name, b_rng, "bfloat16")
        del model
        torch.cuda.empty_cache()
    clock("B2")
    b3 = s3d_train_phase(args.seed, b_rng, dev, det, face, args.profile, dtype="bfloat16",
                         clips_cache=s3_clips)
    del s3_clips
    b3_cpu = s3d_train_vs_cpu(args.seed, b_rng, dev, "bfloat16", names=("ca_s3d",))
    clock("B3")
    b4 = msca_scoring(args.seed, b_rng, dev, "bfloat16", args.profile)
    clock("B4")

    # ---- Z1-Z3. the variant zoo ------------------------------------------------------
    zoo = zoo_phases(args.seed, side_rng(rng), dev, det, reader, crops, stacks, paths,
                     with_faces, four)
    clock("Z1-Z3")

    # ---- Z4-Z6. the variant zoo trained, and scored in bf16 ---------------------------
    zt = zoo_train_phases(args.seed, side_rng(rng), dev, data, det, reader, crops, four,
                          zoo["z1"], args.profile)
    clock("Z4-Z6")
    for name, fp32, bf in (("cvit", t2, b2["cvit"]), ("cvit_repbn8", t4, b2["cvit_repbn8"])):
        log(f"B2 {name} at batch {TRAIN_BATCH}: bf16 {bf['crops_per_s']:.1f} train crops/s, "
            f"{bf['step_ms']:.2f} ms a step, {bf['busy_share']:.1%} busy, {bf['peak_gb']:.2f} GB; "
            f"fp32 (T2/T4, this run) {fp32['crops_per_s']:.1f}, {fp32['step_ms']:.2f} ms, "
            f"{fp32['busy_share']:.1%}, {fp32['peak_gb']:.2f} GB")
    for name in b3:
        bf, fp32 = b3[name], s3[name]
        log(f"B3 {name} ({bf['plan']}, batch {bf['batch']}): bf16 {bf['clips_per_s']:.2f} train "
            f"clips/s, {bf['step_ms']:.1f} ms a step, {bf['busy_share']:.1%} busy, "
            f"{bf['peak_gb']:.2f} GB; fp32 (S3, this run) {fp32['clips_per_s']:.2f}, "
            f"{fp32['step_ms']:.1f} ms, {fp32['busy_share']:.1%}, {fp32['peak_gb']:.2f} GB")
    for name in b4:
        log(f"B4 {name}: bf16 fp {b4[name]['clips_per_s']:.2f} clips/s, int8 "
            f"{b4[name]['int8_clips_per_s']:.2f}; fp32 (S5, this run) "
            f"{s5[name]['clips_per_s']:.2f}"
            + (f", int8 {s5[name]['int8_clips_per_s']:.2f}" if "int8_clips_per_s" in s5[name]
               else ""))

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
    # the bf16 modes: K7 on B2's cvit epoch, K10 on B3's plan1_2 epoch
    rows += [
        {"name": "K7_clahe_luma_bf16", "route": "cuda", "source": "fac_fake_torch/csrc/clahe.cu",
         "replaces": "fac_fake_tpu/data/augment.py:805",
         "launches": b2["cvit"]["launches"]["K7"], "train_steps": b2["cvit"]["fit_steps"],
         "flagship_launches": b2["cvit_repbn8"]["launches"]["K7"],
         "max_abs_err": k7b["err"], "ms": k7b["subset_ms"], "kernel_ms": k7b["subset_ms"],
         "warm_ms": k7b["subset_warm_ms"], "plain_ms": k7b["subset_plain_ms"],
         "bound_ms": k7b["subset_bound_ms"], "bound_by": k7b["subset_bound_by"],
         "library_ms": None, "copy_ms": k7b["subset_copy_ms"],
         "fp32_ms": k7["subset_ms"], "fp32_warm_ms": k7["subset_warm_ms"],
         "all_taken_ms": k7b["ms"], "all_taken_warm_ms": k7b["warm_ms"],
         "all_taken_fp32_ms": k7["ms"], "all_taken_bound_ms": k7b["bound_ms"],
         "timing": "ms: cold (buffers beyond twice the L2), the trainer's step; copy_ms: copy_ of "
                   "the taken images' bf16 bytes, cold; fp32_ms: K7's fp32 mode at the same "
                   "step in this run; bit-equal to the plain version (clahe_luma_plain of the "
                   "images in fp32, rounded to bf16) in every case of B1",
         "shapes": f"ms: clahe_subset_ in place on ({TRAIN_BATCH}, 224, 224, 3) bf16, "
                   f"{K7_TRAIN_TAKERS} takers, a budget of 8; all_taken: clahe_luma on (8, 224, "
                   "224, 3) bf16; launches: one bf16 training epoch of cvit (B2), one a step; "
                   "flagship_launches: the same of cvit_repbn8"},
        {"name": "K10_jpeg_subset_bf16", "route": "cuda", "source": "fac_fake_torch/csrc/jpeg.cu",
         "replaces": "fac_fake_tpu/data/augment.py:707",
         "launches": b3["s3d"]["fit_launches"]["K10_bf16"], "train_steps": b3["s3d"]["fit_steps"],
         "max_abs_err": k10b["err"], "bit_equal": True, "ms": k10b["ms"],
         "kernel_ms": k10b["ms"], "warm_ms": k10b["warm_ms"], "plain_ms": k10b["plain_ms"],
         "bound_ms": k10b["bound_ms"], "bound_by": k10b["bound_by"], "library_ms": None,
         "copy_ms": k10b["copy_ms"], "fp32_ms": k10["ms"], "fp32_warm_ms": k10["warm_ms"],
         "k10_digest": k10b["k10_digest"],
         "timing": "ms: cold (buffers beyond twice the L2); copy_ms: copy_ of the taken frames' "
                   "bf16 bytes, cold; fp32_ms: K10's fp32 mode at the same step in this run; "
                   "bit-equal to the plain version (JAX's bf16 JPEG steps spelled out) in every "
                   "case of B1",
         "shapes": f"ms: jpeg_subset_ in place on ({K10_FRAMES}, 224, 224, 3) bf16, "
                   f"{K10_TAKEN} taken, plan1_2's step; launches: one bf16 training epoch of "
                   "s3d under plan1_2 (B3), one a step"},
    ]
    rows[1]["bf16_train_eval_launches"] = b2["cvit"]["launches"]["K2"]
    # the variant zoo: Z2's fp32 video path (K1, K2), Z3's int8_full paths
    # (K2's int8 entry, K3, K4), K3 and K4 at cvit_ggca_sla's and
    # cvit_ggca_add_glu's walks
    z3 = zoo["z3"]
    rows[0]["zoo_launches"] = {ZOO_VIDEO_ENTRY: zoo["z2"]["K1"]}
    rows[1]["zoo_launches"] = {ZOO_VIDEO_ENTRY: zoo["z2"]["K2"]}
    rows[1]["zoo_int8_launches"] = {n: z3[n]["launches"]["K2_int8"] for n in z3}
    for row, kern in ((rows[2], "k3"), (rows[3], "k4")):
        key = "K3" if kern == "k3" else "K4"
        row["zoo_launches"] = {n: z3[n]["launches"][key] for n in z3}
        row["zoo_launches_per_forward"] = {n: z3[n]["per_forward"]["convs" if kern == "k3"
                                                                   else "K4"] for n in z3}
        row["zoo"] = {n: {f: v for f, v in zoo[kern][n].items()
                          if f in ("ms", "conv_ms", "quantize_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "err", "convs", "fused")}
                      for n in zoo[kern]}
    rows[2]["zoo_quantize_launches"] = {n: z3[n]["launches"]["K3_quantize"] for n in z3}
    rows[2]["zoo_shapes"] = ("zoo: the convs (and stem 2's quantize pass) of one int8 forward "
                             "from the crops at batch 96, fp32, of cvit_ggca_sla (28^2 256- and "
                             "512-channel convs) and cvit_ggca_add_glu (56^2); zoo_launches: "
                             "Z3's int8_full paths")
    rows[3]["zoo_shapes"] = ("zoo: the 26 denses of one int8_full forward at batch 96 of "
                             "cvit_ggca_sla (96 x 16 patch rows, 96 x 17 token rows) and "
                             "cvit_ggca_add_glu (96 x 64, 96 x 65); zoo_launches: Z3's paths")
    rows[4]["bf16_launches"] = {n: b4[n]["int8_launches"]["K5"] for n in b4}
    # the zoo trained (Z4, Z6): K7 over each entry's timed steps, K2 over the
    # fit entry's eval batches and Z6's bf16 scoring
    z4, z6t, z6 = zt["z4"], zt["z6_train"], zt["z6"]
    k7_row = next(r for r in rows if r["name"] == "K7_clahe_luma")
    k7_row["zoo_train_launches"] = {n: z4[n]["step_launches"]["K7"] for n in z4}
    k7_row["zoo_train_steps"] = ZOO_TRAIN_TIMED_STEPS
    k7_row["zoo_fit_launches"] = {ZOO_FIT_ENTRY: z4[ZOO_FIT_ENTRY]["launches"]["K7"]}
    k7_row["zoo_fit_steps"] = z4[ZOO_FIT_ENTRY]["fit_steps"]
    k7_bf16_row = next(r for r in rows if r["name"] == "K7_clahe_luma_bf16")
    k7_bf16_row["zoo_train_launches"] = {n: z6t[n]["step_launches"]["K7_bf16"] for n in z6t}
    k7_bf16_row["zoo_train_steps"] = ZOO_TRAIN_TIMED_STEPS
    rows[1]["zoo_train_eval_launches"] = {ZOO_FIT_ENTRY: z4[ZOO_FIT_ENTRY]["launches"]["K2"]}
    rows[1]["zoo_bf16_launches"] = {n: z6[n]["k2_launches"] for n in z6}
    log(json.dumps({"training": {"cvit": dict(t2, vs_cpu=t3),
                                 "cvit_repbn8": dict(t4, vs_cpu=t4_cpu),
                                 "s3d_family": s3, "s3d_vs_cpu": s4, "s3d_scoring": s5,
                                 "bf16": {"cvit": dict(b2["cvit"], vs_cpu=b2_cpu["cvit"]),
                                          "cvit_repbn8": dict(b2["cvit_repbn8"],
                                                              vs_cpu=b2_cpu["cvit_repbn8"]),
                                          "s3d_family": b3, "s3d_vs_cpu": b3_cpu,
                                          "s3d_scoring": b4}}}, default=str))
    rows[0]["dataset_launches"] = {b: p1[b]["k1_launches"] for b in p1}
    rows[0]["agreement_launches"] = {"report": p2["launches"]["K1"],
                                     "mask_geometry": p2["mask_k1"]}
    k8_row = next(r for r in rows if r["name"] == "K8_hard_nms")
    k8_row["agreement_launches"] = p2["launches"]["K8"]
    k8_row["agreement_frames"] = p2["frames"]
    rows[0]["evaluation_launches"] = e1["launches"]["K1"]
    rows[1]["evaluation_launches"] = e1["launches"]["K2"]
    rows[1]["gradcam_launches"] = {n: {m: g1[n][m]["k2_launches"] for m in ("cnn", "tokens")}
                                   for n in CAM_MODELS}
    rows[1]["profiling_launches"] = u1["k2_launches"]
    rows[1]["export_launches"] = x1["k2_launches"]
    k9_row = next(r for r in rows if r["name"] == "K9_kan_bases")
    k9_row["kan_grid_launches"] = r4["k9_launches"]
    k9_row["kan_grid"] = r4
    log(json.dumps({"datasets": p1, "agreement": p2, "evaluation": e1, "gradcam": g1,
                    "profiling": u1, "export": x1, "card": smi}, default=str))
    log(json.dumps({"kernels": rows}))
    # ---- 16. result -----------------------------------------------------------
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
