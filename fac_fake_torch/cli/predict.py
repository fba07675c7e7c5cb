"""Video scoring CLI — the port of `fac_fake_tpu/cli/predict.py`.

  python -m fac_fake_torch.cli.predict --videos dir/ --weights cvit.pth \
      --save-csv out.csv [--metadata meta.json] [--device cuda] \
      [--model cvit_repbn8|resvitkan|resvit]

Input a folder of mp4s (decoded with cv2, which must be installed), output a
``filename,label`` CSV of fake-probabilities; prob < 0.5 → REAL, ≥ 0.5 → FAKE.
``--model`` names a registered model that scores videos: ``cvit``,
``cvit_repbn8``, or the ResNet/KAN family's ``resvitkan`` (its KAN head runs
kernel K9) and ``resvit``; ``reskan`` takes no pos rows and is refused.
``--metadata`` evaluates the CSV just written against a metadata.json
(accuracy and AUC, `evaluate/metrics.py evaluate_prediction_csv`).
``--weights`` takes a reference or exported ``.pth``; JAX-trained weights
come over with ``python -m fac_fake_tpu.cli.export torch out.pth --weights
ckpt/``.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--videos", required=True, help="directory of .mp4 files")
    ap.add_argument("--weights", default=None,
                    help="checkpoint: reference or exported torch .pth")
    ap.add_argument("--model", default="cvit")
    ap.add_argument("--save-csv", default="predictions.csv")
    ap.add_argument("--metadata", default=None,
                    help="metadata.json to report accuracy/AUC against")
    ap.add_argument("--workers", type=int, default=None,
                    help="videos decoded/detected concurrently "
                         "(default: min(4, cpu_count))")
    ap.add_argument("--batched", action="store_true",
                    help="pack many videos per forward (throughput mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent CPU path")
    ap.add_argument("--set", nargs="*", default=[])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.core.config import Config, apply_dotted
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model

    cfg = Config()
    cfg.model.name = args.model
    apply_dotted(cfg, args.set)

    model = build_model(cfg.model, device=args.device)
    if args.weights:
        if os.path.isdir(args.weights) or not args.weights.endswith((".pth", ".pt")):
            raise SystemExit(
                f"--weights {args.weights}: the port loads torch .pth files; "
                "convert a JAX checkpoint first with `python -m "
                "fac_fake_tpu.cli.export torch out.pth --weights ckpt/`")
        model.load_state_dict(load_reference_pth(args.weights), strict=True)

    scorer = VideoScorer(model, cfg, device=args.device)
    t0 = time.perf_counter()
    rows = scorer.predict_to_csv(args.videos, args.save_csv, args.workers,
                                 batched=args.batched)
    dt = time.perf_counter() - t0
    print("filename,label")
    for name, prob in rows:
        print(f"{name},{prob}")
    print(f"--- {dt // 60:.0f} m {dt % 60:.0f} s ---")
    stats = scorer.latency_stats()
    if stats:
        print(f"per-video latency: p50 {stats['p50_s']:.2f}s "
              f"p90 {stats['p90_s']:.2f}s over {stats['count']} videos")

    if args.metadata:
        from fac_fake_torch.evaluate.metrics import evaluate_prediction_csv
        out = evaluate_prediction_csv(args.save_csv, args.metadata)
        print(f"accuracy: {out['accuracy'] * 100:.2f}%  AUC: {out['auc']:.4f} "
              f"({out['count']} scored)")
    return rows


if __name__ == "__main__":
    main()
