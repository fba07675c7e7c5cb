"""Video-scoring HTTP service — the port of `fac_fake_tpu/cli/serve.py`.

  python -m fac_fake_torch.cli.serve --weights cvit.pth --port 8500 \
      [--device cuda] [--model cvit_repbn8|resvitkan|resvit] \
      [--set infer.detector=mtcnn infer.mtcnn_weights=mtcnn.npz]

  GET  /health                     → {"status": "ok", "model": ...}
  GET  /score?path=/abs/video.mp4  → {"filename", "prob", "label", "num_crops",
                                      "latency_s"}
  POST /score   (body: mp4 bytes)  → the same, for an uploaded video

``prob`` follows the reference decision rule: < 0.5 REAL, ≥ 0.5 FAKE
(`CViT-main/README.md:28-30`). The scorer runs on the card unless
``--device cpu``. Its forward is serialized by a lock (one scorer, one
card); the host decode and detection of concurrent requests overlap. A
non-loopback bind needs ``--video-root`` (GET /score?path= then opens only
files under it) or ``--allow-any-path``. stdlib ``http.server`` only.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", default=None,
                    help="checkpoint: reference or exported torch .pth")
    ap.add_argument("--model", default="cvit")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent CPU path")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--video-root", default=None,
                    help="restrict GET /score?path= to files under this "
                         "directory (required for non-loopback binds)")
    ap.add_argument("--allow-any-path", action="store_true",
                    help="serve arbitrary host paths even on a non-loopback "
                         "bind (dangerous: /score opens any readable file)")
    ap.add_argument("--set", nargs="*", default=[])
    return ap.parse_args(argv)


def build_scorer(args):
    """A `VideoScorer` over the port's model (``--model``, ``--set``) with
    ``--weights`` loaded, on ``--device``."""
    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.core.config import Config, apply_dotted
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model

    cfg = Config()
    cfg.model.name = args.model
    apply_dotted(cfg, args.set)
    if args.weights and (os.path.isdir(args.weights)
                         or not args.weights.endswith((".pth", ".pt"))):
        raise SystemExit(
            f"--weights {args.weights}: the port loads torch .pth files; "
            "convert a JAX checkpoint first with `python -m "
            "fac_fake_tpu.cli.export torch out.pth --weights ckpt/`")
    model = build_model(cfg.model, device=args.device)
    if args.weights:
        model.load_state_dict(load_reference_pth(args.weights), strict=True)
    return VideoScorer(model, cfg, device=args.device)


class ScoringService:
    """Owns the scorer; serializes the forward, overlaps host work."""

    def __init__(self, scorer, model_name: str, video_root=None):
        self.scorer = scorer
        self.model_name = model_name
        # normalized allowlist root for GET /score?path= (None: any path —
        # safe only behind a loopback bind; `serve()` enforces that)
        self.video_root = os.path.realpath(video_root) if video_root else None
        self._lock = threading.Lock()

    def warmup(self):
        import numpy as np
        size = self.scorer.cfg.data.image_size
        with self._lock:
            self.scorer.score_crops(np.zeros((1, size, size, 3), np.uint8))

    def score_path(self, path: str) -> dict:
        t0 = time.perf_counter()
        crops = self.scorer.gather_crops(path)     # host decode + detect
        with self._lock:                           # the forward
            prob = self.scorer.score_crops(crops)
        return {"filename": os.path.basename(path),
                "prob": prob,
                "label": "FAKE" if prob >= 0.5 else "REAL",
                "num_crops": int(crops.shape[0]),
                "latency_s": round(time.perf_counter() - t0, 3)}


def make_handler(service: ScoringService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health":
                return self._send(200, {"status": "ok", "model": service.model_name})
            if url.path == "/score":
                path = parse_qs(url.query).get("path", [None])[0]
                if not path or not os.path.exists(path):
                    return self._send(400, {"error": f"no such file: {path}"})
                root = service.video_root
                if root is not None and not os.path.realpath(path).startswith(root + os.sep):
                    return self._send(403, {"error": f"path outside --video-root: {path}"})
                try:
                    return self._send(200, service.score_path(path))
                except Exception as e:     # surface, don't crash the server
                    return self._send(500, {"error": repr(e)[:300]})
            return self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if urlparse(self.path).path != "/score":
                return self._send(404, {"error": "unknown endpoint"})
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                return self._send(400, {"error": "empty body"})
            data = self.rfile.read(n)
            fd, tmp = tempfile.mkstemp(suffix=".mp4", prefix="fac_serve_")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                out = service.score_path(tmp)
                out["filename"] = "<uploaded>"
                return self._send(200, out)
            except Exception as e:
                return self._send(500, {"error": repr(e)[:300]})
            finally:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    return Handler


def serve(argv=None, *, scorer=None, ready_event=None, server_box=None):
    """Start the service. Hooks: a prebuilt ``scorer``, a ``ready_event``
    set once listening, and a ``server_box`` list that receives the server
    (for ``shutdown()``)."""
    args = parse_args(argv)
    loopback = args.host in ("127.0.0.1", "localhost", "::1")
    if not loopback and not args.video_root and not args.allow_any_path:
        raise SystemExit(
            "refusing a non-loopback bind without --video-root: GET /score"
            "?path= would open arbitrary host-readable files. Pass "
            "--video-root DIR (recommended) or --allow-any-path.")
    if scorer is None:
        scorer = build_scorer(args)
    service = ScoringService(scorer, args.model, video_root=args.video_root)
    if not args.no_warmup:
        service.warmup()
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    if server_box is not None:
        server_box.append(httpd)
    print(f"serving {args.model} on http://{args.host}:{httpd.server_address[1]}", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def main(argv=None):
    serve(argv)


if __name__ == "__main__":
    main()
