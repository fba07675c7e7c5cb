"""The port's frame-index policies and readers (`fac_fake_torch/data/video.py`)
against the JAX package on the CPU: the policies over many seeds, lengths
and jitters; every `VideoReader` method, with and without insets, on small
videos that cv2 writes in the test and on truncated copies of them; and the
preprocessing's error contract (a video that cannot be read is skipped, a
detector's error propagates)."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_FRAMES, W, H = 40, 96, 64


def _write(path, fourcc, n=N_FRAMES):
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 10, (W, H))
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(n):
        img = np.stack([(xx * 2 + i * 5) % 256, (yy * 3 + i * 7) % 256,
                        ((xx + yy) + i * 11) % 256], -1).astype(np.uint8)
        wr.write(img)
    wr.release()
    return path


def _truncated(src, dst, frac):
    data = open(src, "rb").read()
    with open(dst, "wb") as f:
        f.write(data[: int(len(data) * frac)])
    return dst


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    mp4 = _write(str(d / "clip.mp4"), "mp4v")
    avi = _write(str(d / "clip.avi"), "MJPG")
    return {"mp4": mp4, "avi": avi,
            "mp4_cut": _truncated(mp4, str(d / "cut.mp4"), 0.5),
            "avi_cut": _truncated(avi, str(d / "cut.avi"), 0.45),
            "garbage": _truncated(__file__, str(d / "garbage.mp4"), 1.0),
            "missing": str(d / "missing.mp4")}


def test_index_policies_equal_jax():
    from fac_fake_tpu.data import video as jv
    from fac_fake_torch.data import video as tv
    for n in (1, 2, 7, 40, 300, 1001):
        for k in (1, 5, 10, 30, 64):
            for seed in (None if n == 1 else 0, 1, 7, 123):
                if seed is not None:
                    np.testing.assert_array_equal(tv.random_indices(n, k, seed),
                                                  jv.random_indices(n, k, seed))
                for jitter in (0, 1, 3):
                    a = tv.evenly_spaced_indices(n, k, jitter, seed)
                    b = jv.evenly_spaced_indices(n, k, jitter, seed)
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    # drawn with replacement: a repeated index is part of the policy
    r = tv.random_indices(40, 30, 3)
    assert len(np.unique(r)) < len(r) and np.all(np.diff(r) >= 0)


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    np.testing.assert_array_equal(got[0], want[0])
    assert [int(i) for i in got[1]] == [int(i) for i in want[1]]


@pytest.mark.parametrize("insets", [(0.0, 0.0), (0.1, 0.2)])
@pytest.mark.parametrize("which", ["mp4", "avi", "mp4_cut", "avi_cut", "garbage", "missing"])
def test_video_reader_methods_equal_jax(videos, which, insets):
    from fac_fake_tpu.data.video import VideoReader as JaxReader
    from fac_fake_torch.data.video import VideoReader

    path = videos[which]
    for spool in (True, False):
        j = JaxReader(insets=insets, spool=spool)
        t = VideoReader(insets=insets, spool=spool)
        assert t.frame_count(path) == j.frame_count(path)
        _same(t.read_frames(path, 7), j.read_frames(path, 7))
        _same(t.read_frames(path, 9, jitter=2, seed=5), j.read_frames(path, 9, jitter=2, seed=5))
        _same(t.read_random_frames(path, 12, seed=3), j.read_random_frames(path, 12, seed=3))
        _same(t.read_middle_frame(path), j.read_middle_frame(path))
        for idx in (0, 17, N_FRAMES - 1, N_FRAMES + 5):
            _same(t.read_frame_at_index(path, idx), j.read_frame_at_index(path, idx))
        idxs = [0, 0, 3, 3, 4, 20, 39, 45]
        _same(t.read_frames_at_indices(path, idxs), j.read_frames_at_indices(path, idxs))
        got = list(t.stream_frames_at_indices(path, idxs, chunk=3))
        want = list(j.stream_frames_at_indices(path, idxs, chunk=3))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    if which in ("mp4", "avi"):
        frames, _ = t.read_frames_at_indices(path, [0])
        assert frames.shape == (1, H - 2 * int(H * insets[1]), W - 2 * int(W * insets[0]), 3)
    if which == "avi_cut":
        # the truncated file gives the frames read before the fault
        n = len(t.read_frames_at_indices(path, list(range(N_FRAMES)))[1])
        assert 0 < n < N_FRAMES


def test_spooled_copies_are_removed(videos):
    from fac_fake_torch.data.video import VideoReader
    r = VideoReader()
    r.frame_count(videos["mp4"])
    tmp = r._local(videos["mp4"])
    assert tmp != videos["mp4"] and os.path.exists(tmp)
    assert r._local(videos["mp4"]) == tmp          # one copy per path
    del r
    assert not os.path.exists(tmp)


def test_sampling_functions_drive_any_reader():
    """The sampling functions need only ``frame_count`` and
    ``stream_frames_at_indices``: an in-memory reader, as on the card."""
    from fac_fake_torch.data import video

    class Mem:
        def frame_count(self, path):
            return 50

        def stream_frames_at_indices(self, path, idxs, chunk=16, stop=None):
            for s in range(0, len(idxs), chunk):
                part = list(idxs[s:s + chunk])
                yield np.stack([np.full((4, 6, 3), i, np.uint8) for i in part]), part

    frames, idxs = video.read_random_frames(Mem(), "v", 10, seed=0)
    np.testing.assert_array_equal(idxs, video.random_indices(50, 10, 0))
    assert [int(f[0, 0, 0]) for f in frames] == [int(i) for i in idxs]
    frames, idxs = video.read_frames(Mem(), "v", 5)
    assert [int(i) for i in idxs] == [0, 12, 24, 36, 49]
    assert video.read_middle_frame(Mem(), "v")[1] == [25]


class _Raising:
    """A detector whose every call raises, as a kernel or card fault would."""

    def predict_on_batch(self, tiles, apply_nms=False):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


class _BrokenReader:
    def frame_count(self, path):
        raise OSError(f"cannot open {path}")

    def stream_frames_at_indices(self, path, idxs, chunk=16, stop=None):
        raise OSError(f"cannot open {path}")
        yield  # noqa: unreachable: a generator


def _dfdc_tree(root, src):
    import json
    import shutil
    part = os.path.join(root, "dfdc_train_part_3")
    os.makedirs(part)
    shutil.copy2(src, os.path.join(part, "a.mp4"))
    with open(os.path.join(part, "metadata.json"), "w") as f:
        json.dump({"a.mp4": {"label": "REAL"}}, f)
    return part


def test_unreadable_videos_skip_and_detector_errors_propagate(videos, tmp_path, capsys):
    import shutil
    from fac_fake_torch.data import preprocess as pp

    vids = tmp_path / "v"
    vids.mkdir()
    shutil.copy2(videos["mp4"], vids / "a.mp4")
    _dfdc_tree(str(tmp_path / "parts"), videos["mp4"])
    calls = {
        "dfdc": lambda **k: pp.extract_dfdc(str(tmp_path / "parts"), str(tmp_path / "o1"), **k),
        "flat": lambda **k: pp.extract_flat(str(vids), str(tmp_path / "o2"), "real", **k),
        "clips": lambda **k: pp.extract_video_crop_folders(str(vids), str(tmp_path / "o3"), **k),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="illegal memory access"):
            call(detector=_Raising())
        call(detector=_Raising(), reader=_BrokenReader())      # skipped, not raised
        out = capsys.readouterr().out
        assert "skip a.mp4: cannot open" in out, (name, out)
    assert not os.path.exists(tmp_path / "o3" / "a")


def test_undecodable_files_skip_as_in_jax(videos, tmp_path, capsys):
    """Files that do not decode (garbage, truncated before the first frame)
    give what JAX's give: no crops, no crop folder, the same lines (cv2
    counts -1 frames there, and the crop-folder build's index policy
    refuses that count)."""
    import shutil
    from fac_fake_tpu.data import preprocess as jp
    from fac_fake_torch.data import preprocess as tp

    vids = tmp_path / "v"
    vids.mkdir()
    shutil.copy2(videos["garbage"], vids / "g.mp4")
    shutil.copy2(videos["mp4_cut"], vids / "c.mp4")
    printed = {}
    for lib, tag in ((jp, "jax"), (tp, "torch")):
        lib.extract_flat(str(vids), str(tmp_path / tag / "flat"), "fake", detector=_Raising())
        lib.extract_video_crop_folders(str(vids), str(tmp_path / tag / "clips"),
                                       detector=_Raising())
        printed[tag] = capsys.readouterr().out
        assert not os.path.exists(tmp_path / tag)
    assert printed["torch"] == printed["jax"]
    assert printed["torch"].count("skip") == 2
