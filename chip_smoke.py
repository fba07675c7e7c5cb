#!/usr/bin/env python3
"""Drive fac_fake_torch on one NVIDIA H100: build the hand-written kernels,
hold each against its plain PyTorch version, score videos end to end with the
full-width base CViT in fp32 and under int8 post-training quantization, and
print what it measured.

    python3 chip_smoke.py [--seed N] [--profile]     # all phases, one card

``--profile`` adds a torch.profiler breakdown, by kernel, of one fp32 and
one int8_full CViT forward at batch 96 to phase 9, and of one fp32 and one
int8 S3D `predict_batch` at batch 32 to phase 13.

Phases, in order (any failure exits non-zero; no phase's exception is caught):
  1. environment: require CUDA, print the card's name and power limit, turn
     TF32 off for matmul and cuDNN;
  2. build the six kernels (K1-K6) from fac_fake_torch/csrc, in parallel;
  3. K2 (normalize) against its plain version at (96|256, 224, 224, 3), fp32
     and bf16;
  4. K1 (frame detections) against its plain version on real BlazeFace dets
     of seeded 1920x1080 frames and on planted dets (F=16, T=3: clusters,
     exact score ties, a zero-area box);
  5. main path: `VideoScorer` with the full-width `cvit` (seeded weights) and
     the packaged BlazeFace over an in-memory reader of seeded 1080p noise
     frames, most videos with a synthetic face the detector finds (made by
     gradient ascent on BlazeFace, `synth_face`):
     `score_videos_batched` over 8 videos, `score_video` over 1, then 29
     seeded crops through `score_crops` and 8 x 29 through
     `score_crop_stacks`; launch counts of K1 and K2 must both be > 0;
  6. full-width logits on the card against the same module on the CPU;
  7. K3 (int8 3x3 conv) against its plain version at each distinct conv of
     the folded base stem at batch 96, fp32 and bf16 (bit-equal), timed
     over the 17 convs of one forward;
  8. K4 (int8 dense) against its plain version at the 26 denses of one
     int8_full forward at batch 96 (bit-equal), beside torch._int_mm on the
     same int8 operands (the GEMM alone);
  9. int8 main path: `VideoScorer` with infer.quantize="int8_full" (it
     calibrates on its first batch) runs `score_videos_batched` over the 8
     videos, `score_video`, `score_crops` and `score_crop_stacks`; launch
     counts of K1-K4 must all be > 0; then infer.quantize="int8" through
     `score_crops` and `score_crop_stacks`; int8 vs fp32 logits for
     information;
 10. full-width int8_full logits on the card against the same quantized
     module on the CPU (plain versions);
 11. S3D fp32 main path: `S3DEvaluator` with the full-width `ca_s3d` (seeded
     weights, one logit, 20 x 224^2 clips): `predict_batch` on 32 seeded
     uint8 clips (clips/s), `predict_video` on one clip (no degradation: the
     card's machine has no cv2), `evaluate` over an in-memory dataset;
 12. K5 (quantize + int8 3D conv) and K6 (int8 max-pool) against their
     plain versions at every conv, quantize and pool of one ca_s3d int8
     forward, the shapes recorded from the wrapper calls, at batches 2 and
     32, fp32 and bf16 (bit-equal); timed over the 77 convs, 50 quantize
     passes and 9 pools of a forward at batch 32, beside torch._int_mm on
     the 1x1x1 convs' pre-quantized operands;
 13. S3D int8 main path: `S3DEvaluator(quantize="int8")` (its first batch
     calibrates), then `predict_batch` at batch 32 (clips/s),
     `predict_video` and `evaluate`; K5 and K6 must launch; int8 vs fp32
     logits for information; then one more int8 forward at batch 32 in
     which every K5 and K6 call is held bit-equal to its plain version on
     the same real activations;
 14. full-width ca_s3d on the card against the same module on the CPU,
     fp32 and int8 (plain versions), batch 1: the logits, and the head's
     input features (int8: against the int8-vs-fp32 difference);
 15. the kernels line; 16. the result line.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
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
S3D_BATCH = 32                                     # clips a predict_batch
S3D_CHECK_BATCH = 2                                # clips a K5/K6 bit-equality check
S3D_T, S3D_HW = 20, 224                            # frames, pixels (ca_s3d's input)
# ca_s3d's head input (the pooled last mix), card vs CPU, by error norm: fp32
# over the features' norm; int8 over the CPU's int8-vs-fp32 difference, since
# the int8 walk turns a rounding difference in its fp layers (the ctx blocks)
# into quantization steps that flip, and those spread as int8 noise does
S3D_FP32_FEATURE_RTOL = 1e-5
S3D_INT8_FEATURE_RATIO = 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms a call of ``fn``: CUDA events around ``iters`` calls that
    are queued behind a ~50 ms sleep kernel, so that the host has enqueued
    them all before the first runs and the events time the card, not the
    host's launch overhead (which exceeds the device time of a small
    kernel). A call that synchronizes falls back to timing both."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
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


def k3_phase(rng, dev) -> dict:
    """K3 against its plain version at every distinct stem conv, batch 96;
    totals over the 17 convs of one forward (fp32)."""
    import torch
    from fac_fake_torch.ops import quant as q
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, bound_sum=0.0, err=0.0)
    for (hw, cin, cout), mult in STEM_CONVS.items():
        x, wq, sw, sx, b = quant_inputs(rng, dev, (QBATCH, hw, hw, cin), cout, 9 * cin)
        kq = wq.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)       # OIHW, O-HW-I memory
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt).permute(0, 3, 1, 2)
            got = q.quant_conv3x3(xd, kq, sw, sx, b)
            ref = q.quant_conv3x3_plain(xd, kq, sw, sx, b)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tot["err"] = max(tot["err"], err)
            if not torch.equal(got, ref):
                raise AssertionError(f"K3 {hw}x{hw} {cin}->{cout} {dt}: differs from plain, "
                                     f"max abs {err}")
            del got, ref
        xd = x.permute(0, 3, 1, 2)
        k_ms = cuda_ms(lambda: q.quant_conv3x3(xd, kq, sw, sx, b), iters=10)
        p_ms = cuda_ms(lambda: q.quant_conv3x3_plain(xd, kq, sw, sx, b), iters=2, warmup=1)
        m = QBATCH * hw * hw
        nbytes = m * cin * 4 + kq.numel() + 8 * cout + 4 + m * cout * 4
        ops = 2.0 * m * cout * 9 * cin
        bms, by = bound_ms(nbytes, ops, INT8_TC_OPS)
        log(f"K3 quant_conv3x3 ({QBATCH},{hw},{hw},{cin})->{cout} x{mult}: equal fp32+bf16; "
            f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {bms:.4f} ms ({by}) "
            f"{ops / k_ms / 1e9:.1f} TOP/s")
        tot["ms"] += mult * k_ms
        tot["plain_ms"] += mult * p_ms
        tot["bytes"] += mult * nbytes
        tot["ops"] += mult * ops
        tot["bound_sum"] += mult * bms
        del x, xd, wq, kq
        torch.cuda.empty_cache()
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["ops"], INT8_TC_OPS)
    log(f"K3 over one forward's 17 convs: kernel {tot['ms']:.4f} ms plain "
        f"{tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}; "
        f"sum of per-conv bounds {tot['bound_sum']:.4f} ms)")
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
            got = q.quant_dense(xd, wq, sw, sx, b)
            ref = q.quant_dense_plain(xd, wq, sw, sx, b)
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
            f"(splits {q.dense_splits(m, n, k)}): equal fp32+bf16; kernel {k_ms:.4f} ms "
            f"plain {p_ms:.4f} ms torch._int_mm {l_ms:.4f} ms bound {bms:.4f} ms ({by})")
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


def profile_forward(fn, label: str, top: int = 12) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    busy share of its wall time, and the ``top`` kernels. A first call is
    traced and dropped (the profiler's warm-up step): without it the trace
    loses the kernels at the start of the window."""
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

    with torch.inference_mode():
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
    w_q shape, stride, padding, relu, real input channels, whether its
    input is a K6 pool's output), a quantize's (x shape) and a pool's (xq
    shape, real channels). The real channel count of an int8 tensor is that
    of the fp tensor its quantize pass read."""
    import torch
    from fac_fake_torch.ops import quant3d as q3
    calls = {"conv": {}, "quantize": {}, "pool": {}}
    orig = (q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8)
    made = {}                                   # data_ptr of an int8 tensor -> (C, pooled)

    def bump(kind, key):
        calls[kind][key] = calls[kind].get(key, 0) + 1

    def conv(xq, w_q, s, b, stride, padding, relu, dtype, out=None, c0=0):
        c, pooled = made[xq.data_ptr()]
        bump("conv", (tuple(xq.shape), tuple(w_q.shape), tuple(stride), tuple(padding), relu,
                      c, pooled))
        return orig[0](xq, w_q, s, b, stride, padding, relu, dtype, out, c0)

    def quantize(x, s_x):
        bump("quantize", tuple(x.shape))
        xq = orig[1](x, s_x)
        made[xq.data_ptr()] = (x.shape[-1], False)
        return xq

    def pool(xq):
        c = made[xq.data_ptr()][0]
        bump("pool", (tuple(xq.shape), c))
        y = orig[2](xq)
        made[y.data_ptr()] = (c, True)
        return y

    # each wrapper counts its launches on the function its module's name is
    # bound to: here the recorder's, so that recording launches do not count
    conv.launches = quantize.launches = pool.launches = 0
    q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8 = conv, quantize, pool
    try:
        with torch.no_grad():
            engine(x)
    finally:
        q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8 = orig
    return calls


def check_s3d_calls(engine, x) -> dict:
    """One int8 forward of ``engine`` on ``x`` in which every K5 and K6
    call is also run through its plain version on the same (real,
    calibrated) inputs and must be bit-equal: {kind: calls checked}."""
    import torch
    from fac_fake_torch.ops import quant3d as q3
    n = {"conv": 0, "quantize": 0, "pool": 0}
    orig = (q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8)

    def same(kind, got, ref, what):
        if not torch.equal(got, ref):
            err = float((got.float() - ref.float()).abs().max())
            raise AssertionError(f"K5/K6 {kind} {what} on real activations: differs from "
                                 f"plain, max abs {err}")
        n[kind] += 1

    def conv(xq, w_q, s, b, stride, padding, relu, dtype, out=None, c0=0):
        ref = q3.int8_conv3d_plain(xq, w_q, s, b, stride, padding, relu, dtype)
        y = orig[0](xq, w_q, s, b, stride, padding, relu, dtype, out, c0)
        same("conv", y[..., c0:c0 + ref.shape[-1]], ref, f"{tuple(xq.shape)} * {tuple(w_q.shape)}")
        return y

    def quantize(x, s_x):
        y = orig[1](x, s_x)
        same("quantize", y, q3.quantize_pad_plain(x, s_x), tuple(x.shape))
        return y

    def pool(xq):
        y = orig[2](xq)
        same("pool", y, q3.max_pool3d_i8_plain(xq), tuple(xq.shape))
        return y

    # launches made here count on the checker's functions, not the wrappers'
    conv.launches = quantize.launches = pool.launches = 0
    q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8 = conv, quantize, pool
    try:
        with torch.no_grad():
            engine(x)
    finally:
        q3.int8_conv3d, q3.quantize_pad, q3.max_pool3d_i8 = orig
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


def k5_k6_phase(rng, dev, calls) -> tuple:
    """K5 and K6 against their plain versions at every recorded call shape
    (batches S3D_CHECK_BATCH and S3D_BATCH, fp32 and bf16, bit-equal), then
    timed at batch S3D_BATCH, each shape times its count in one forward.
    Returns the K5 and K6 totals.

    The bounds count each tensor at its real channel count (the zero
    channels K5 pads to 16 are not work the function needs). K5's bytes
    are those of quantize + conv as one function, as K3's are: the fp32
    inputs of the quantize passes, the pooled int8 inputs of the mixes'
    fourth-branch convs (K6's outputs), the weights, scales, biases and
    fp32 outputs; the int8 tensor between a quantize pass and its convs is
    not counted."""
    import torch
    from fac_fake_torch.ops import quant3d as q3
    k5 = dict(ms=0.0, conv_ms=0.0, quantize_ms=0.0, plain_ms=0.0, ms_1x1x1=0.0,
              library_ms=0.0, bytes=0.0, ops=0.0, err=0.0, convs=0, quantizes=0)
    k6 = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, err=0.0, pools=0)
    t = lambda a: torch.from_numpy(a).to(dev)

    def int8_image(shape, c):
        """int8 values of a quantized activation, zero in the padded channels."""
        xq = rng.integers(-127, 128, shape, dtype=np.int8)
        xq[..., c:] = 0
        return t(xq)

    for (xs, ws, stride, padding, relu, cin, pooled), mult in calls["conv"].items():
        n, kt, kh, kw, cp = ws
        w_q = rng.integers(-127, 128, ws, dtype=np.int8)
        w_q[..., cin:] = 0
        w_q = t(w_q)
        s = t(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
        b = t(rng.standard_normal(n, dtype=np.float32))
        for batch in (S3D_CHECK_BATCH, S3D_BATCH):
            xq = int8_image(_at_batch(xs, batch), cin)
            for dt in (torch.float32, torch.bfloat16):
                got = q3.int8_conv3d(xq, w_q, s, b, stride, padding, relu, dt)
                ref = q3.int8_conv3d_plain(xq, w_q, s, b, stride, padding, relu, dt)
                torch.cuda.synchronize()
                k5["err"] = max(k5["err"], float((got.float() - ref.float()).abs().max()))
                if not torch.equal(got, ref):
                    raise AssertionError(f"K5 conv {_at_batch(xs, batch)} * {ws} s{stride} "
                                         f"p{padding} {dt}: differs from plain, max abs "
                                         f"{k5['err']}")
                del got, ref
        k_ms = cuda_ms(lambda: q3.int8_conv3d(xq, w_q, s, b, stride, padding, relu,
                                              torch.float32), iters=10)
        p_ms = cuda_ms(lambda: q3.int8_conv3d_plain(xq, w_q, s, b, stride, padding, relu,
                                                    torch.float32), iters=1, warmup=1)
        out = q3.conv3d_out_shape(xq.shape[:4], (kt, kh, kw), stride, padding)
        m = float(np.prod(out))
        taps = kt * kh * kw
        k5["ops"] += mult * 2.0 * m * n * taps * cin
        x_bytes = xq.numel() // cp * cin if pooled else 0
        k5["bytes"] += mult * (x_bytes + n * taps * cin + 8 * n + 4 * m * n)
        k5["conv_ms"] += mult * k_ms
        k5["plain_ms"] += mult * p_ms
        k5["convs"] += mult
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
        k5["quantizes"] += mult
        del x
    for (xs, c), mult in calls["pool"].items():
        for batch in (S3D_CHECK_BATCH, S3D_BATCH):
            xq = int8_image(_at_batch(xs, batch), c)
            got, ref = q3.max_pool3d_i8(xq), q3.max_pool3d_i8_plain(xq)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K6 {tuple(xq.shape)}: differs from plain")
            del got, ref
        k_ms = cuda_ms(lambda: q3.max_pool3d_i8(xq))
        p_ms = cuda_ms(lambda: q3.max_pool3d_i8_plain(xq), iters=3)
        real = xq.numel() // xs[-1] * c
        k6["ms"] += mult * k_ms
        k6["plain_ms"] += mult * p_ms
        k6["bytes"] += mult * 2.0 * real
        k6["ops"] += mult * 26.0 * real          # byte maxima, outside the tensor cores
        k6["pools"] += mult
        log(f"K6 max_pool3d_i8 {tuple(xq.shape)} x{mult}: equal; kernel {k_ms:.4f} ms "
            f"plain {p_ms:.4f} ms bound {bound_ms(2.0 * real, 26.0 * real)[0]:.4f} ms")
    k5["ms"] = k5["conv_ms"] + k5["quantize_ms"]
    k5["bound_ms"], k5["bound_by"] = bound_ms(k5["bytes"], k5["ops"], INT8_TC_OPS)
    k6["bound_ms"], k6["bound_by"] = bound_ms(k6["bytes"], k6["ops"])
    log(f"K5 over one forward at batch {S3D_BATCH}: {k5['convs']} convs {k5['conv_ms']:.4f} ms "
        f"+ {k5['quantizes']} quantize passes {k5['quantize_ms']:.4f} ms = {k5['ms']:.4f} ms; "
        f"plain {k5['plain_ms']:.4f} ms; bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}; "
        f"{k5['ops'] / 1e12:.3f} T int8 ops, {k5['bytes'] / 1e9:.3f} GB); "
        f"{k5['ops'] / k5['conv_ms'] / 1e9:.1f} int8 TOP/s; the 1x1x1 convs {k5['ms_1x1x1']:.4f} "
        f"ms against torch._int_mm's GEMMs alone {k5['library_ms']:.4f} ms")
    log(f"K6 over one forward's {k6['pools']} pools at batch {S3D_BATCH}: kernel "
        f"{k6['ms']:.4f} ms plain {k6['plain_ms']:.4f} ms bound {k6['bound_ms']:.4f} ms "
        f"({k6['bound_by']})")
    return k5, k6


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
        q.quant_conv3x3.launches = q.quant_dense.launches = 0
        q3.int8_conv3d.launches = q3.quantize_pad.launches = q3.max_pool3d_i8.launches = 0

    def read_counts():
        return {"K1": ex.frame_detections.launches, "K2": pp.normalize_imagenet.launches,
                "K3": q.quant_conv3x3.launches, "K4": q.quant_dense.launches,
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
    x_check = torch.from_numpy(clips[:S3D_CHECK_BATCH]).to(dev).float().permute(0, 4, 1, 2, 3)
    calls = record_s3d_calls(quantize_s3d(s3d, x_check), x_check)
    log(f"S3D int8 forward: {sum(calls['conv'].values())} convs ({len(calls['conv'])} "
        f"shapes), {sum(calls['quantize'].values())} quantize passes, "
        f"{sum(calls['pool'].values())} int8 pools")
    k5, k6 = k5_k6_phase(rng, dev, calls)
    if (k5["convs"], k6["pools"]) != (77, 9):
        raise AssertionError(f"a ca_s3d int8 forward has 77 convs and 9 int8 pools, "
                             f"recorded {k5['convs']} and {k6['pools']}")
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
    if min(s3d8_launches[k] for k in ("K5", "K5_quantize", "K6")) <= 0:
        raise AssertionError(f"S3D int8: a kernel of the path never launched: {s3d8_launches}")
    if profile:
        profile_forward(lambda: ev.predict_batch(clips), f"S3D fp32 predict_batch {S3D_BATCH}")
        profile_forward(lambda: ev8.predict_batch(clips), f"S3D int8 predict_batch {S3D_BATCH}")
    with torch.no_grad():
        x32 = torch.from_numpy(clips).to(dev).float().permute(0, 4, 1, 2, 3)
        a, b = s3d(x32).double(), ev8.engine(x32).double()
    checked = check_s3d_calls(ev8.engine, x32)
    log(f"S3D int8 forward at batch {S3D_BATCH} on the seeded clips: every K5/K6 call "
        f"bit-equal to its plain version on the same activations: {checked}")
    if checked != {"conv": 77, "quantize": 50, "pool": 9}:
        raise AssertionError(f"S3D int8: checked {checked}, not every call of a forward")
    del x32
    ac, bc = a - a.mean(), b - b.mean()
    log(f"S3D int8 vs fp32 logits on {S3D_BATCH} clips (information): max abs "
        f"{float((a - b).abs().max()):.4g} cosine {float((a * b).sum() / (a.norm() * b.norm())):.6f} "
        f"centred cosine {float((ac * bc).sum() / (ac.norm() * bc.norm())):.6f} "
        f"(|logit| max {float(a.abs().max()):.3g}, spread {float(a.max() - a.min()):.3g})")

    # ---- 14. full-width ca_s3d logits and features, card against CPU -------------
    one = torch.from_numpy(clips[:1]).float().permute(0, 4, 1, 2, 3)
    feats = {}
    for label, mod in (("fp32", s3d), ("int8", ev8.engine)):
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
    from fac_fake_torch.ops import preprocess as pp
    from fac_fake_torch.ops import quant as q

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

    # ---- 3. K2 against its plain version ---------------------------------
    k2 = {}
    for b in (96, 256):
        u8 = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            got = pp.normalize_imagenet(u8, dt)
            ref = pp.normalize_imagenet_plain(u8, dt)
            torch.cuda.synchronize()
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError("K2 output is not channels_last")
            err = float((got.float() - ref.float()).abs().max())
            if err > K2_TOL[name]:
                raise AssertionError(f"K2 {b} {name}: max abs err {err} > {K2_TOL[name]}")
            k_ms = cuda_ms(lambda: pp.normalize_imagenet(u8, dt))
            p_ms = cuda_ms(lambda: pp.normalize_imagenet_plain(u8, dt))
            nbytes = u8.numel() * (1 + got.element_size())
            bms, by = bound_ms(nbytes, 3 * u8.numel())
            k2[(b, name)] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by)
            log(f"K2 normalize ({b},224,224,3)->{name}: max_abs_err {err:.3g} "
                f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {bms:.4f} ms ({by})")

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
    offsets = torch.as_tensor(offs, device=dev)
    err_a, n_a, ms_a, pms_a, _ = compare_k1(dets, valid, float(split), offsets, (1080.0, 1920.0), 3)
    log(f"K1 real dets (16 frames, 8 with the synthetic face, T=3): faces {n_a} "
        f"max_abs_err {err_a:.3g} kernel {ms_a:.4f} ms plain {pms_a:.4f} ms")
    pd_, pv_ = planted_dets(rng)
    pd = torch.from_numpy(pd_).to(dev)
    pv = torch.from_numpy(pv_).to(dev)
    err_b, n_b, ms_b, pms_b, nbytes_b = compare_k1(pd, pv, 1080.0, offsets, (1080.0, 1920.0), 3)
    if n_b == 0:
        raise AssertionError("K1 planted dets produced no faces")
    k1_bound, k1_by = bound_ms(nbytes_b, 8 * pd.shape[0] // 3 * 2688 * 20)
    log(f"K1 planted dets (16 frames, T=3): faces {n_b} max_abs_err {err_b:.3g} "
        f"kernel {ms_b:.4f} ms plain {pms_b:.4f} ms bound {k1_bound:.5f} ms ({k1_by})")

    # ---- 5. main path ------------------------------------------------------
    cfg = Config()
    model = build_model(cfg.model, device=dev, seed=args.seed)
    scorer = VideoScorer(model, cfg, detector=det, reader=reader)
    scorer.enable_stage_stats()
    crops = rng.integers(0, 256, (29, 224, 224, 3), dtype=np.uint8)
    stacks = [rng.integers(0, 256, (29, 224, 224, 3), dtype=np.uint8) for _ in range(8)]
    scorer.score_crops(crops)                    # warm cuDNN/cuBLAS before timing
    scorer.score_crop_stacks(stacks)
    torch.cuda.synchronize()

    ex.frame_detections.launches = 0
    pp.normalize_imagenet.launches = 0
    t0 = time.perf_counter()
    paths = [f"video_{i}" for i in range(8)]
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

    log(f"videos (batched): scores {batched} faces "
        f"{[scorer.crop_counts[p] for p in paths]} "
        f"{len(paths) / t_batched * 60:.1f} videos/min ({t_batched:.2f} s)")
    log(f"video_8 (score_video): score {single} faces {scorer.crop_counts['video_8']}")
    log(f"stage stats: {json.dumps(scorer.stage_stats)}")
    log(f"score_crops 29 crops (capacity {scorer.capacity}): score {p_crops} "
        f"{29 * n_it / t_crops:.1f} crops/s")
    log(f"score_crop_stacks 8x29 crops: scores {p_stacks} "
        f"{8 * 29 * n_it / t_stacks:.1f} crops/s")
    log(f"main-path launches: {launches}")
    probs = batched + [single, p_crops] + p_stacks
    if not all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in probs):
        raise AssertionError(f"scores out of [0, 1]: {probs}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    found = {p: scorer.crop_counts[p] for p in paths + ["video_8"]}
    if not (all(found[p] > 0 for p in with_faces)
            and all(found[p] == 0 for p in found if p not in with_faces)):
        raise AssertionError(f"faces found per video {found}; the synthetic face is "
                             f"in {with_faces} only")

    # ---- 6. full-width logits, card against CPU ---------------------------
    four = torch.from_numpy(rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8))
    pos = torch.arange(4)
    with torch.inference_mode():
        gpu = scorer.model(pp.normalize_imagenet(four.to(dev)), pos.to(dev)).cpu()
        cpu_model = copy.deepcopy(scorer.model).cpu()
        cpu = cpu_model(pp.normalize_imagenet(four), pos)
    logit_err = float((gpu - cpu).abs().max())
    log(f"full-width logits card vs CPU: max abs {logit_err:.3g} "
        f"(|logit| max {float(cpu.abs().max()):.3g})")
    if not (torch.isfinite(gpu).all() and logit_err <= LOGIT_TOL):
        raise AssertionError(f"logits differ: {logit_err} > {LOGIT_TOL}")

    # ---- 7-8. K3 and K4 against their plain versions -----------------------
    fp32_rates = crops_per_s(scorer, crops, stacks)
    log(f"fp32 beside the int8 runs: score_crops {fp32_rates[0]:.1f} crops/s, "
        f"score_crop_stacks {fp32_rates[1]:.1f} crops/s")
    k3 = k3_phase(rng, dev)
    k4 = k4_phase(rng, dev)

    # ---- 9. int8 main path -----------------------------------------------------
    n_convs = sum(op[0] == "conv" for op in scorer.model.stem_spec)
    rates = {}
    for mode in ("int8_full", "int8"):
        qcfg = Config()
        qcfg.infer.quantize = mode
        qscorer = VideoScorer(model, qcfg, detector=det, reader=reader)
        t_cal = time.perf_counter()
        qscorer.score_crops(crops)           # the first batch of >= 8 crops calibrates
        torch.cuda.synchronize()
        n_q = sum(op[0] == "qconv" for op in qscorer.model.stem_spec)
        log(f"{mode}: first score_crops calibrated and scored in "
            f"{time.perf_counter() - t_cal:.2f} s: {n_q} convs quantized, "
            f"quant_dense={qscorer.model.quant_dense}")
        if qscorer._quant_pending or n_q != n_convs:
            raise AssertionError(f"{mode}: the first batch did not quantize the stem")
        qscorer.score_crop_stacks(stacks)    # warm up
        torch.cuda.synchronize()
        ex.frame_detections.launches = pp.normalize_imagenet.launches = 0
        q.quant_conv3x3.launches = q.quant_dense.launches = 0
        qprobs = []
        if mode == "int8_full":
            qscorer.enable_stage_stats()
            t0 = time.perf_counter()
            qprobs += qscorer.score_videos_batched(paths)
            t_q = time.perf_counter() - t0
            qprobs.append(qscorer.score_video("video_8"))
            log(f"{mode} videos (batched): scores {qprobs[:len(paths)]} "
                f"{len(paths) / t_q * 60:.1f} videos/min ({t_q:.2f} s); video_8 "
                f"{qprobs[-1]}; stage stats {json.dumps(qscorer.stage_stats)}")
        rates[mode] = crops_per_s(qscorer, crops, stacks)
        qprobs += [rates[mode][2]] + rates[mode][3]
        qlaunch = {"K1": ex.frame_detections.launches, "K2": pp.normalize_imagenet.launches,
                   "K3": q.quant_conv3x3.launches, "K4": q.quant_dense.launches}
        log(f"{mode}: score_crops {rates[mode][0]:.1f} crops/s (fp32 {fp32_rates[0]:.1f}), "
            f"score_crop_stacks {rates[mode][1]:.1f} crops/s (fp32 {fp32_rates[1]:.1f}); "
            f"launches {qlaunch}")
        if not all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in qprobs):
            raise AssertionError(f"{mode} scores out of [0, 1]: {qprobs}")
        want = ("K1", "K2", "K3", "K4") if mode == "int8_full" else ("K2", "K3")
        if min(qlaunch[k] for k in want) <= 0:
            raise AssertionError(f"{mode}: a kernel of the path never launched: {qlaunch}")
        if mode == "int8_full":
            int8_launches, full = qlaunch, qscorer
        with torch.inference_mode():
            x29 = pp.normalize_imagenet(torch.from_numpy(crops).to(dev))
            pos29 = torch.arange(29, device=dev)
            a = scorer.model(x29, pos29).double()
            b = qscorer.model(x29, pos29).double()
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        log(f"{mode} vs fp32 logits on 29 crops (information): max abs "
            f"{float((a - b).abs().max()):.4g} cosine {cos:.6f} "
            f"(|logit| max {float(a.abs().max()):.3g})")

    if args.profile:
        with torch.inference_mode():
            x96 = pp.normalize_imagenet(torch.from_numpy(
                np.concatenate([crops] * 4)[:QBATCH]).to(dev))
        pos96 = torch.arange(QBATCH, device=dev) % 32
        profile_forward(lambda: scorer.model(x96, pos96), f"fp32 forward, batch {QBATCH}")
        profile_forward(lambda: full.model(x96, pos96), f"int8_full forward, batch {QBATCH}")

    # ---- 10. full-width int8_full logits, card against CPU ------------------
    with torch.inference_mode():
        gpu8 = full.model(pp.normalize_imagenet(four.to(dev)), pos.to(dev)).cpu()
        t_cpu = time.perf_counter()
        cpu8 = copy.deepcopy(full.model).cpu()(pp.normalize_imagenet(four), pos)
    err8 = float((gpu8 - cpu8).abs().max())
    log(f"full-width int8_full logits card vs CPU (plain versions, "
        f"{time.perf_counter() - t_cpu:.1f} s on the CPU): max abs {err8:.3g} "
        f"(|logit| max {float(cpu8.abs().max()):.3g})")
    if not (torch.isfinite(gpu8).all() and err8 <= LOGIT_TOL):
        raise AssertionError(f"int8_full logits differ: {err8} > {LOGIT_TOL}")

    del scorer, qscorer, full, model
    torch.cuda.empty_cache()
    s3d = s3d_phases(args.seed, rng, dev, args.profile)

    # ---- 15. kernels line -----------------------------------------------------
    k2_main = k2[(96, "float32")]
    k5, k6 = s3d["k5"], s3d["k6"]
    rows = [
        {"name": "K1_frame_detections", "route": "cuda",
         "source": "fac_fake_torch/csrc/frame_detections.cu",
         "replaces": "fac_fake_tpu/detect/extractor.py:73",
         "launches": launches["K1"], "max_abs_err": max(err_a, err_b),
         "ms": ms_b, "kernel_ms": ms_b, "plain_ms": pms_b, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2_normalize_imagenet", "route": "cuda",
         "source": "fac_fake_torch/csrc/normalize.cu",
         "replaces": "fac_fake_tpu/ops/preprocess.py:25",
         "launches": launches["K2"], "max_abs_err": max(v["err"] for v in k2.values()),
         "ms": k2_main["ms"], "kernel_ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": None},
        {"name": "K3_quant_conv3x3", "route": "cuda",
         "source": "fac_fake_torch/csrc/quant_conv.cu",
         "replaces": "fac_fake_tpu/models/layers.py:106",
         "launches": int8_launches["K3"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "kernel_ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
         "shapes": "the 17 stem convs of one forward, batch 96, fp32"},
        {"name": "K4_quant_dense", "route": "cuda",
         "source": "fac_fake_torch/csrc/quant_dense.cu",
         "replaces": "fac_fake_tpu/models/layers.py:142",
         "launches": int8_launches["K4"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "kernel_ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"], "library": "torch._int_mm, the GEMM alone",
         "shapes": "the 26 denses of one int8_full forward, batch 96, fp32"},
        {"name": "K5_quant_conv3d", "route": "cuda",
         "source": "fac_fake_torch/csrc/quant_conv3d.cu",
         "replaces": "fac_fake_tpu/compat/quantize_s3d.py:59",
         "launches": s3d["launches"]["K5"], "quantize_launches": s3d["launches"]["K5_quantize"],
         "max_abs_err": k5["err"], "ms": k5["ms"], "kernel_ms": k5["ms"],
         "conv_ms": k5["conv_ms"], "quantize_ms": k5["quantize_ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "bound_counts": "real channels; quantize + conv as one function (fp32 in, "
                         "fp32 out), the int8 tensor between them not counted, as for K3",
         "library_ms": k5["library_ms"], "ms_1x1x1": k5["ms_1x1x1"],
         "library": "torch._int_mm, the GEMMs of the 1x1x1 convs alone (pre-quantized)",
         "shapes": f"the 77 convs and 50 quantize passes of one ca_s3d int8 forward, "
                   f"batch {S3D_BATCH}, fp32"},
        {"name": "K6_max_pool3d_i8", "route": "cuda",
         "source": "fac_fake_torch/csrc/max_pool3d_i8.cu",
         "replaces": "fac_fake_tpu/compat/quantize_s3d.py:85",
         "launches": s3d["launches"]["K6"], "max_abs_err": k6["err"],
         "ms": k6["ms"], "kernel_ms": k6["ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"], "library_ms": None,
         "shapes": f"the 9 int8 pools of one ca_s3d int8 forward, batch {S3D_BATCH}"},
    ]
    log(json.dumps({"kernels": rows}))
    # ---- 16. result -----------------------------------------------------------
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
