"""The port's dataset preprocessing (`fac_fake_torch/data/preprocess.py`,
`cli/preprocess.py`) against the JAX package on the CPU: the same small
cv2-written videos and the same stub detector (planted detections) on both
sides must give the same file names, byte-identical crop files, the same
returned counts and the same metadata JSON; then a crop tree written by the
port's CLI trains one step through the port's loaders and `Trainer`."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_FRAMES, W, H = 40, 96, 64          # landscape: 3 tiles of 64², x offsets 0, 16, 32


def _planted(n_tiles, seed=0):
    """Per tile: two clusters of 3 equal boxes (scores ≥ 0.75) whose frame
    coordinates sit on half pixels (so no edge is near an integer), the rest
    below the score threshold."""
    rng = np.random.default_rng(seed)
    dets = rng.uniform(0, 0.7, (n_tiles, 896, 17)).astype(np.float32)
    dets[..., 2:4] = dets[..., 0:2] + 0.2
    dets[..., 16] = rng.uniform(0, 0.6, (n_tiles, 896))
    for k in range(n_tiles):
        for c in range(2):
            y, x = (rng.integers(2, 30, 2) + 0.5) / 64
            s = rng.integers(14, 26) / 64
            for j in range(3):
                a = 50 * c + j
                dets[k, a, :4] = [y, x, y + s, x + s]
                dets[k, a, 16] = rng.uniform(0.76, 0.99)
    return dets


PLANTED = _planted(3 * 64)


class JaxStub:
    def predict_on_batch(self, tiles, apply_nms=False):
        d = PLANTED[: len(tiles)]
        return jnp.asarray(d), jnp.asarray(d[..., 16] >= 0.75)


class TorchStub:
    def predict_on_batch(self, tiles, apply_nms=False):
        d = torch.from_numpy(PLANTED[: len(tiles)].copy())
        return d, d[..., 16] >= 0.75


def _video(path, seed):
    import cv2
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    for i in range(N_FRAMES):
        wr.write(np.roll(base, 3 * i, axis=1))
    wr.release()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    vids = root / "videos"
    vids.mkdir()
    for i in range(3):
        _video(str(vids / f"v{i}.mp4"), i)
    (vids / "notes.txt").write_text("not a video")
    parts = root / "parts"
    meta = {"a.mp4": {"label": "FAKE", "original": "o.mp4"},
            "b.mp4": {"label": "FAKE", "original": "o.mp4"},     # a second fake of o.mp4
            "o.mp4": {"label": "REAL"}}
    for part in ("dfdc_train_part_3", "dfdc_train_part_41", "other"):
        os.makedirs(parts / part)
        for i, name in enumerate(meta):
            _video(str(parts / part / name), 10 + i)
        with open(parts / part / "metadata.json", "w") as f:
            json.dump(meta, f)
    return root


@pytest.fixture
def seeded(monkeypatch):
    """The extract functions draw random frames with no seed, as the
    reference does: both packages' `random_indices` get seed 0 here."""
    from fac_fake_tpu.data import video as jv
    from fac_fake_torch.data import video as tv
    for mod in (jv, tv):
        orig = mod.random_indices
        monkeypatch.setattr(mod, "random_indices",
                            lambda n, k, seed=None, orig=orig: orig(n, k, 0 if seed is None else seed))


def _tree(root):
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out[rel + "/"] = None
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def _same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k
    return ta


def test_extract_faces_from_video_equal_jax(data, tmp_path):
    """A repeated random index writes its file again and still counts."""
    from fac_fake_tpu.data import preprocess as jp
    from fac_fake_torch.data import preprocess as tp
    path = str(data / "videos" / "v1.mp4")
    for seed in (0, 3):
        nj = jp.extract_faces_from_video(path, str(tmp_path / f"j{seed}"), "v1", seed=seed,
                                         detector=JaxStub())
        nt = tp.extract_faces_from_video(path, str(tmp_path / f"t{seed}"), "v1", seed=seed,
                                         detector=TorchStub())
        assert nt == nj == 10
        files = _same_tree(tmp_path / f"j{seed}", tmp_path / f"t{seed}")
        assert 1 < len(files) - 1 < 10 + 1          # repeats overwrite
    # the per-video work alone: named crops, no files; its stage timers
    from fac_fake_torch.detect.extractor import new_stage_stats
    stats = new_stage_stats()
    crops = tp.video_face_crops(path, seed=0, detector=TorchStub(), stats=stats)
    assert len(crops) == 10 and all(c.shape == (224, 224, 3) for _, c in crops)
    assert stats["frames"] == 10 and min(stats[k] for k in ("tiles_s", "detect_s", "crops_s")) > 0
    assert tp.video_face_crops(str(data / "none.mp4"), detector=TorchStub()) is None


def test_extract_functions_equal_jax(data, tmp_path, seeded, capsys):
    from fac_fake_tpu.data import preprocess as jp
    from fac_fake_torch.data import preprocess as tp
    out = {}
    for lib, tag, det in ((jp, "jax", JaxStub()), (tp, "torch", TorchStub())):
        lib.extract_dfdc(str(data / "parts"), str(tmp_path / tag / "dfdc"), detector=det)
        lib.extract_flat(str(data / "videos"), str(tmp_path / tag / "flat"), "fake",
                         num_frames=6, size=48, detector=det)
        lib.extract_video_crop_folders(str(data / "videos"), str(tmp_path / tag / "clips"),
                                       frames_per_video=12, size=40, detector=det)
        out[tag] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    files = _same_tree(tmp_path / "jax", tmp_path / "torch")
    names = sorted(k for k in files if files[k] is not None)
    assert any(n.startswith("dfdc/train/fake/a_") for n in names)
    assert any(n.startswith("dfdc/validation/real/o_") for n in names)
    assert not any("/b_" in n for n in names)               # one fake per original
    assert sum(n.startswith("clips/v0/") for n in names) == 12
    assert all(n.endswith(".png") for n in names if n.startswith("clips/"))


def test_cli_subcommands_equal_jax(data, tmp_path, seeded, monkeypatch):
    from fac_fake_tpu.cli import preprocess as jcli
    from fac_fake_tpu.detect.blazeface import BlazeFace as JaxBlazeFace
    from fac_fake_torch.cli import preprocess as tcli
    from fac_fake_torch.data import preprocess as tp

    monkeypatch.setattr(JaxBlazeFace, "from_reference_assets",
                        classmethod(lambda cls, *a, **k: JaxStub()))
    monkeypatch.setattr(tp, "default_detector", lambda device=None: TorchStub())
    v = str(data / "videos")
    for main, tag, dev in ((jcli.main, "jax", []), (tcli.main, "torch", ["--device", "cpu"])):
        o = tmp_path / tag
        main(["dfdc", "--parts-root", str(data / "parts"), "--out", str(o / "dfdc"),
              "--frames", "4", *dev])
        main(["flat", "--videos", v, "--out", str(o / "flat"), "--label", "real", *dev])
        main(["clips", "--videos", v, "--out", str(o / "clips"), "--frames", "8", *dev])
        main(["split", "--src", str(o / "flat" / "real"), "--out-a", str(o / "a"),
              "--out-b", str(o / "b")])
        main(["metadata", "--videos", v, "--label", "FAKE", "--out", str(o / "meta.json")])
    files = _same_tree(tmp_path / "jax", tmp_path / "torch")
    assert json.loads(files["./meta.json"]) == {f"v{i}.mp4": {"label": "FAKE"} for i in range(3)}
    assert len(os.listdir(tmp_path / "torch" / "a")) > len(os.listdir(tmp_path / "torch" / "b"))


def test_shuffle_split_and_metadata_equal_jax(tmp_path):
    from fac_fake_tpu.data import preprocess as jp
    from fac_fake_torch.data import preprocess as tp
    src = tmp_path / "src"
    src.mkdir()
    for i in range(23):
        (src / f"{i:02d}.jpg").write_bytes(bytes([i]) * (i + 1))
        (src / f"{i:02d}.mp4").write_bytes(b"")
    for lib, tag in ((jp, "jax"), (tp, "torch")):
        for seed, frac in ((0, 0.85), (5, 0.5)):
            lib.shuffle_split(str(src), str(tmp_path / tag / f"a{seed}"),
                              str(tmp_path / tag / f"b{seed}"), fraction=frac, seed=seed)
        meta = lib.build_metadata_for_folder(str(src), "real", str(tmp_path / tag / "m.json"))
        assert meta == {f"{i:02d}.mp4": {"label": "REAL"} for i in range(23)}
    _same_tree(tmp_path / "jax", tmp_path / "torch")
    for part in (3, 39, 40, 44, 45, 49, 50):
        assert tp.dfdc_part_split(part) == jp.dfdc_part_split(part)
    meta = {f"f{i}.mp4": {"label": "FAKE" if i % 3 else "real", "original": f"o{i % 4}.mp4"}
            for i in range(12)}
    assert tp.filter_unique_fakes(meta) == jp.filter_unique_fakes(meta)


def test_best_face_and_large_crops_equal_jax():
    from fac_fake_tpu.detect.extractor import FaceExtractor as JaxExtractor
    from fac_fake_torch.detect.extractor import FaceExtractor
    rng = np.random.default_rng(2)

    def frames():
        out = []
        for i in range(5):
            n = int(rng.integers(0, 4))
            sizes = rng.integers(1, 40, (n, 2))
            fd = {"frame_idx": i, "frame_w": 64, "frame_h": 48,
                  "faces": [np.zeros((h, w, 3), np.uint8) for h, w in sizes],
                  "scores": rng.uniform(0.7, 1.0, n).tolist()}
            if i % 2:
                fd["boxes"] = [tuple(int(v) for v in rng.integers(0, 40, 4)) for _ in range(n)]
            out.append(fd)
        return out

    def view(fds):
        return [(fd["frame_idx"], [f.shape for f in fd["faces"]], fd["scores"],
                 fd.get("boxes")) for fd in fds]

    for pct in (0.1, 0.3):
        a = frames()
        b = [dict(fd, faces=list(fd["faces"]), scores=list(fd["scores"])) for fd in a]
        JaxExtractor.remove_large_crops(a, pct)
        FaceExtractor.remove_large_crops(b, pct)
        assert view(a) == view(b)
        JaxExtractor.keep_only_best_face(a)
        FaceExtractor.keep_only_best_face(b)
        assert view(a) == view(b)


def test_the_crops_train(data, tmp_path, monkeypatch):
    """The loop users could not close: `cli/preprocess flat` and `clips`
    write a crop tree; `data/folder.py` and `data/clips.py` load it; a tiny
    CViT and S3D each take one `Trainer` step on it."""
    from fac_fake_torch.cli import preprocess as tcli
    from fac_fake_torch.core.plans import load_plan
    from fac_fake_torch.data import preprocess as tp
    from fac_fake_torch.data.clips import ClipDataset, discover_video_folders
    from fac_fake_torch.data.folder import CropFolderDataset
    from fac_fake_torch.models import build_model
    from fac_fake_torch.train.trainer import Trainer
    from test_torch_checkpoint import _tiny_trainer

    monkeypatch.setattr(tp, "default_detector", lambda device=None: TorchStub())
    v = str(data / "videos")
    crops, clips = tmp_path / "crops", tmp_path / "clips"
    for label in ("fake", "real"):
        tcli.main(["flat", "--videos", v, "--out", str(crops / "train"), "--label", label,
                   "--device", "cpu"])
    tcli.main(["clips", "--videos", v, "--out", str(clips), "--frames", "16", "--device", "cpu"])
    tcli.main(["metadata", "--videos", v, "--label", "FAKE", "--out", str(tmp_path / "m.json")])
    gen = torch.Generator().manual_seed(0)

    ds = CropFolderDataset(str(crops / "train"), 32, use_native=False)
    assert ds.classes == ["fake", "real"] and len(ds) > 4
    tr = _tiny_trainer()
    b = next(ds.batches(4, num_workers=1))
    out = tr.train_step({"image": torch.from_numpy(b["image"]),
                         "label": torch.from_numpy(b["label"]).long(),
                         "mask": torch.from_numpy(b["mask"])}, gen)
    assert np.isfinite(float(out["loss"])) and tr.step == 1

    samples = discover_video_folders(str(clips), str(tmp_path / "m.json"))
    assert [s[1:] for s in samples] == [(1, f"v{i}") for i in range(3)]
    cds = ClipDataset(samples, frames_per_video=16, image_size=32)
    b = next(cds.batches(2, num_workers=1))
    assert b["image"].shape == (2, 16, 32, 32, 3)
    cfg = load_plan("configs/plan1_2.yaml")
    cfg.model.image_size, cfg.data.augment.enabled = 32, False
    s3 = Trainer(build_model(cfg.model, device="cpu"), cfg, device="cpu")
    out = s3.train_step({"image": torch.from_numpy(b["image"]),
                         "label": torch.from_numpy(b["label"]).long(),
                         "mask": torch.from_numpy(b["mask"])}, gen)
    assert np.isfinite(float(out["loss"])) and s3.step == 1
