#!/usr/bin/env python3
"""Drive fac_fake_torch on one NVIDIA H100: build the hand-written kernels,
hold each against its plain PyTorch version, score videos end to end with the
full-width base CViT, and print what it measured.

    python3 chip_smoke.py [--seed N]     # all phases, one card

Phases, in order (any failure exits non-zero; no phase's exception is caught):
  1. environment: require CUDA, print the card's name and power limit, turn
     TF32 off for matmul and cuDNN;
  2. build both kernels from fac_fake_torch/csrc;
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
  7. the kernels line; 8. the result line.
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
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM
FP32_FLOPS = 67e12                                 # H100 SXM, outside tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
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

    # ---- 7. kernels line -----------------------------------------------------
    k2_main = k2[(96, "float32")]
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
    ]
    log(json.dumps({"kernels": rows}))
    # ---- 8. result -----------------------------------------------------------
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
