"""The port's VideoScorer against the JAX one on the CPU: the same in-memory
reader, the same stub detector (planted detections), the tiny CViT with the
same weights."""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

torch.set_num_threads(2)

HW = (160, 284)   # small landscape frames: T = 3 tiles, split 160


class Reader:
    """In-memory reader: ``n`` seeded frames per video (0 for "empty")."""

    def __init__(self, n=300):
        self.n = n

    def frame_count(self, path):
        return 0 if "empty" in path else self.n

    def stream_frames_at_indices(self, path, idxs, chunk=16, stop=None):
        seed = sum(map(ord, path))
        for s in range(0, len(idxs), chunk):
            fr = [np.random.default_rng([seed, i]).integers(0, 256, (*HW, 3), dtype=np.uint8)
                  for i in idxs[s:s + chunk]]
            yield np.stack(fr), list(idxs[s:s + chunk])


def _planted(n_tiles, seed=0):
    """Per tile: three clusters of 4 boxes (score ≥ 0.75), the rest invalid."""
    rng = np.random.default_rng(seed)
    dets = rng.uniform(0, 0.7, (n_tiles, 896, 17)).astype(np.float32)
    dets[..., 2:4] = dets[..., 0:2] + 0.2
    dets[..., 16] = rng.uniform(0, 0.6, (n_tiles, 896))
    for k in range(n_tiles):
        for c in range(3):
            y, x = rng.uniform(0.05, 0.55, 2)
            s = rng.uniform(0.25, 0.4)
            for j in range(4):
                a = 100 * c + j
                jit = rng.normal(0, 0.005, 2)
                dets[k, a, :4] = [y + jit[0], x + jit[1], y + s + jit[0], x + s + jit[1]]
                dets[k, a, 16] = rng.uniform(0.76, 0.99)
    return dets


PLANTED = _planted(3 * 128)


class JaxStub:
    def predict_on_batch(self, tiles, apply_nms=False):
        d = PLANTED[: len(tiles)]
        return jnp.asarray(d), jnp.asarray(d[..., 16] >= 0.75)


class TorchStub:
    def predict_on_batch(self, tiles, apply_nms=False):
        d = torch.from_numpy(PLANTED[: len(tiles)].copy())
        return d, d[..., 16] >= 0.75


def _scorers(batch_crops=96):
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_tpu.core.config import Config as JaxConfig
    from fac_fake_tpu.infer.predictor import VideoScorer as JaxScorer
    from fac_fake_torch.compat.weights import cvit_state_dict_from_flax
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models.cvit import CViT
    from helpers import tiny_cvit

    jm = tiny_cvit()
    v = jm.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    flat = {"/".join(k): np.asarray(x) for k, x in traverse_util.flatten_dict(v).items()}
    tm = CViT(jm.stem_spec, dim=64, depth=1, heads=2, mlp_dim=64)
    tm.load_state_dict(cvit_state_dict_from_flax(flat), strict=True)
    jcfg, tcfg = JaxConfig(), Config()
    jcfg.infer.batch_crops = tcfg.infer.batch_crops = batch_crops
    js = JaxScorer(jm, v, jcfg, detector=JaxStub(), reader=Reader())
    ts = VideoScorer(tm, tcfg, detector=TorchStub(), reader=Reader(), device="cpu")
    return js, ts, export_cvit(v)


@pytest.fixture(scope="module")
def scorers():
    return _scorers()


def test_gather_crops_equal_jax(scorers):
    js, ts, _ = scorers
    a = js.gather_crops("vid_a.mp4")
    b = ts.gather_crops("vid_a.mp4")
    assert a.shape == b.shape == (29, 224, 224, 3)
    # same boxes, cv2 vs the port's INTER_AREA: at most 1 LSB
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    assert ts.crop_counts["vid_a.mp4"] == 29


def test_video_scores_match_jax_and_batched_equals_per_video(scorers):
    js, ts, _ = scorers
    paths = ["vid_a.mp4", "vid_b.mp4", "vid_c.mp4", "empty.mp4"]
    ref = [js.score_video(p) for p in paths]
    got = [ts.score_video(p) for p in paths]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)   # BASELINE.md bar
    assert got[-1] == 0.5                                      # no frames, no crops
    batched = ts.score_videos_batched(paths, num_workers=2)
    np.testing.assert_allclose(batched, got, rtol=0, atol=1e-6)
    jb = js.score_videos_batched(paths, num_workers=2)
    np.testing.assert_allclose(batched, jb, rtol=0, atol=1e-4)
    assert ts.latency_stats()["count"] == 2 * len(paths)


def test_counts_below_three_and_zero_crops_score_half(scorers):
    _, ts, _ = scorers
    crops = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
    assert ts.score_crops(crops[:0]) == 0.5
    assert ts.score_crops(crops[:1]) == 0.5
    assert ts.score_crops(crops[:2]) == 0.5
    assert ts.score_crops(crops) != 0.5
    assert ts.score_crop_stacks([crops[:2], crops]) [0] == 0.5


def test_score_crops_capacity_and_upper_bound_match_jax():
    """40 crops at capacity 32: rows past the capacity are dropped, as in
    the JAX scorer; 100 crops at 96: the 90-row upper bound."""
    rng = np.random.default_rng(1)
    for cap, n in ((32, 40), (96, 100)):
        js, ts, _ = _scorers(cap)
        crops = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        assert abs(ts.score_crops(crops) - js.score_crops(crops)) <= 1e-4


def test_bfloat16_model_dtype_scores_near_fp32(scorers):
    """``model.dtype="bfloat16"``: K2's path writes bf16 and every layer
    follows its input's dtype; the score stays within 2e-2 of fp32 (bf16
    keeps 8 bits of mantissa)."""
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer

    _, ts, _ = scorers
    cfg = Config()
    cfg.model.dtype = "bfloat16"
    bf = VideoScorer(ts.model, cfg, detector=TorchStub(), reader=Reader(),
                     fold_bn=False, device="cpu")
    crops = np.random.default_rng(2).integers(0, 256, (12, 224, 224, 3), dtype=np.uint8)
    assert abs(bf.score_crops(crops) - ts.score_crops(crops)) <= 2e-2


def test_predict_to_csv_schema(scorers, tmp_path):
    _, ts, _ = scorers
    vdir = tmp_path / "videos"
    vdir.mkdir()
    for name in ("b.mp4", "a.mp4", "notes.txt"):
        (vdir / name).write_bytes(b"")
    out = tmp_path / "out" / "pred.csv"
    rows = ts.predict_to_csv(str(vdir), str(out))
    with open(out) as fh:
        got = list(csv.reader(fh))
    assert got[0] == ["filename", "label"]
    assert [r[0] for r in got[1:]] == ["a.mp4", "b.mp4"]
    assert [float(r[1]) for r in got[1:]] == [p for _, p in rows]


def test_cli_predict_on_exported_pth(tmp_path, capsys):
    """`cli/predict.py --device cpu` on a .pth that export_cvit wrote, over a
    directory with one synthetic mp4 (noise: no faces, score 0.5)."""
    import cv2
    from fac_fake_tpu.compat.torch_export import export_cvit
    from fac_fake_tpu.core.config import ModelConfig
    from fac_fake_tpu.models import build_model as jax_build
    from fac_fake_torch.cli import predict

    small = dict(dim=64, depth=1, heads=2, mlp_dim=64)
    jm = jax_build(ModelConfig(name="cvit", **small))
    v = jm.init(jax.random.key(5), jnp.zeros((1, 224, 224, 3)))
    torch.save({k: torch.from_numpy(a.copy()) for k, a in export_cvit(v).items()},
               tmp_path / "w.pth")
    vdir = tmp_path / "videos"
    vdir.mkdir()
    wr = cv2.VideoWriter(str(vdir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(0)
    for _ in range(20):
        wr.write(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    wr.release()
    out = tmp_path / "pred.csv"
    rows = predict.main(["--videos", str(vdir), "--weights", str(tmp_path / "w.pth"),
                         "--save-csv", str(out), "--device", "cpu", "--workers", "1",
                         "--set"] + [f"model.{k}={x}" for k, x in small.items()])
    assert [r[0] for r in rows] == ["clip.mp4"] and rows[0][1] == 0.5
    assert out.read_text().splitlines()[0] == "filename,label"
    with pytest.raises(SystemExit, match="fac_fake_tpu.cli.export torch"):
        predict.main(["--videos", str(vdir), "--weights", str(tmp_path), "--device", "cpu",
                      "--set"] + [f"model.{k}={x}" for k, x in small.items()])


def test_video_scorer_defaults_to_cuda_and_raises_without_it():
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models.cvit import CViT

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoScorer(CViT(spec, dim=64, depth=1, heads=2, mlp_dim=64))
