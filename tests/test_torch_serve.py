"""The port's serving CLI (`fac_fake_torch/cli/serve.py`) on loopback, on the
CPU: `tests/test_cli.py`'s serve tests for the port, over a small CViT and a
seeded MTCNN at thresholds (0, 0, 0) (so that crops come out of noise
frames), reading cv2-written mp4s."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _mp4(path, seed, n=20, hw=(64, 96)):
    import cv2
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (hw[1], hw[0]))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        wr.write(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    wr.release()
    return str(path)


@pytest.fixture(scope="module")
def scorer():
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import init_weights
    from fac_fake_torch.models.cvit import CViT

    spec = ()
    for _ in range(5):
        spec += (("conv", 8), ("bn", 8), ("relu",), ("pool",))
    cfg = Config()
    cfg.infer.batch_crops = 32
    cfg.infer.detector = "mtcnn"
    cfg.infer.mtcnn_thresholds = (0.0, 0.0, 0.0)
    model = init_weights(CViT(spec, dim=64, depth=1, heads=2, mlp_dim=64), 0)
    return VideoScorer(model, cfg, device="cpu")


def _start(argv, scorer):
    from fac_fake_torch.cli.serve import serve

    ready, box = threading.Event(), []
    t = threading.Thread(target=serve, args=(argv,),
                         kwargs=dict(scorer=scorer, ready_event=ready, server_box=box),
                         daemon=True)
    t.start()
    assert ready.wait(60)
    return t, box[0], f"http://127.0.0.1:{box[0].server_address[1]}"


def _stop(t, httpd):
    httpd.shutdown()
    t.join(30)
    assert not t.is_alive()


def _code(url, data=None):
    try:
        urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_serve_health_get_post_and_errors(scorer, tmp_path, capsys):
    """Health; GET /score equal to `score_video` on the same file; POST of
    the same bytes equal to GET; 400 for a missing path and an empty body;
    404 for an unknown endpoint."""
    video = _mp4(tmp_path / "clip.mp4", 0)
    t, httpd, base = _start(["--port", "0", "--no-warmup", "--device", "cpu",
                             "--set", "infer.detector=mtcnn"], scorer)
    try:
        assert "serving cvit on http://127.0.0.1:" in capsys.readouterr().out
        h = json.load(urllib.request.urlopen(f"{base}/health", timeout=30))
        assert h == {"status": "ok", "model": "cvit"}
        r = json.load(urllib.request.urlopen(f"{base}/score?path={video}", timeout=120))
        assert r["filename"] == "clip.mp4" and r["num_crops"] > 0
        assert r["label"] == ("FAKE" if r["prob"] >= 0.5 else "REAL")
        assert r["latency_s"] >= 0.0
        assert r["prob"] == scorer.score_video(video)
        with open(video, "rb") as fh:
            req = urllib.request.Request(f"{base}/score", data=fh.read(), method="POST")
        r2 = json.load(urllib.request.urlopen(req, timeout=120))
        assert r2["filename"] == "<uploaded>" and r2["num_crops"] == r["num_crops"]
        assert r2["prob"] == r["prob"]
        assert _code(f"{base}/score") == 400
        assert _code(f"{base}/score?path={tmp_path / 'nope.mp4'}") == 400
        assert _code(f"{base}/score", data=b"") == 400
        assert _code(f"{base}/nothing") == 404
        assert _code(f"{base}/nothing", data=b"x") == 404
    finally:
        _stop(t, httpd)


def test_serve_warmup_and_video_root_allowlist(scorer, tmp_path):
    """With the warm-up on; a path outside --video-root gets 403, one inside
    is scored; a non-loopback bind without --video-root or
    --allow-any-path is refused."""
    from fac_fake_torch.cli.serve import serve

    root = tmp_path / "videos"
    root.mkdir()
    inside = _mp4(root / "in.mp4", 1)
    outside = _mp4(tmp_path / "out.mp4", 2)
    t, httpd, base = _start(["--port", "0", "--device", "cpu", "--video-root", str(root)],
                            scorer)
    try:
        assert _code(f"{base}/score?path={outside}") == 403
        assert _code(f"{base}/score?path={inside}") == 200
    finally:
        _stop(t, httpd)
    with pytest.raises(SystemExit, match="non-loopback"):
        serve(["--host", "0.0.0.0", "--port", "0"], scorer=scorer)


def test_build_scorer_loads_pth_and_refuses_a_directory(tmp_path):
    """`build_scorer`: the port's model on --device with a .pth loaded
    strictly and --set applied (the MTCNN route); a directory (a JAX
    checkpoint) or a non-.pth file is refused before anything is built."""
    from fac_fake_torch.cli.serve import build_scorer, parse_args
    from fac_fake_torch.core.config import ModelConfig
    from fac_fake_torch.detect.mtcnn import MTCNN
    from fac_fake_torch.models import build_model

    small = ["model.depth=1", "model.dim=64", "model.mlp_dim=64", "model.heads=2"]
    src = build_model(ModelConfig(depth=1, dim=64, mlp_dim=64, heads=2), device="cpu", seed=3)
    torch.save(src.state_dict(), tmp_path / "w.pth")
    sc = build_scorer(parse_args(["--device", "cpu", "--weights", str(tmp_path / "w.pth"),
                                  "--set", *small, "infer.detector=mtcnn"]))
    assert sc.device == torch.device("cpu") and isinstance(sc.detector, MTCNN)
    assert torch.equal(sc.model.pos_embedding, src.pos_embedding)
    for bad in (str(tmp_path), str(tmp_path / "w.msgpack")):
        with pytest.raises(SystemExit, match="fac_fake_tpu.cli.export torch"):
            build_scorer(parse_args(["--device", "cpu", "--weights", bad, "--set", *small]))


def test_serve_defaults_to_the_card():
    from fac_fake_torch.cli.serve import parse_args

    assert parse_args([]).device == "cuda" and parse_args([]).host == "127.0.0.1"
