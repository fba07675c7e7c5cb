"""CLI for the detector-agreement harness (`detect/agreement.py`) — the
port of `tools/detector_agreement.py`.

Runs BlazeFace and MTCNN over identical sampled frames of the given videos
and prints per-video box counts, best-match IoU, mutual recall, and (with
``--score``) the end-to-end score delta through one CViT:

    python -m fac_fake_torch.cli.detector_agreement videos/*.mp4 --frames 8 --score

The repository holds no pretrained MTCNN weights, so the default cascade is
seeded; convert real ones with ``python -m fac_fake_torch.cli.import_mtcnn
out.npz --pnet pnet.pt --rnet rnet.pt --onet onet.pt`` and pass
``--mtcnn-weights out.npz``. ``--score`` uses the seeded base ``cvit`` in
bf16, as the JAX tool does. Videos decode with cv2, which must be
installed; detection and scoring run on ``--device`` (cuda by default). The
report is strict JSON: undefined statistics are null.
"""
from __future__ import annotations

import argparse
import json


def build_scorers(mtcnn_weights: str = "", device=None, reader=None, seed: int = 0) -> tuple:
    """The ``--score`` pair: one seeded bf16 ``cvit`` scored through a
    BlazeFace `VideoScorer` and an MTCNN one (``infer.mtcnn_thresholds``,
    the cascade from ``mtcnn_weights`` or seeded)."""
    import copy
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.infer.predictor import VideoScorer
    from fac_fake_torch.models import build_model

    cfg_a = Config()
    cfg_a.model.dtype = "bfloat16"
    model = build_model(cfg_a.model, device=device, seed=seed)
    cfg_b = copy.deepcopy(cfg_a)
    cfg_b.infer.detector = "mtcnn"
    cfg_b.infer.mtcnn_weights = mtcnn_weights or ""
    return (VideoScorer(model, cfg_a, reader=reader, device=device),
            VideoScorer(model, cfg_b, reader=reader, device=device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("videos", nargs="+")
    ap.add_argument("--frames", type=int, default=8, help="frames per video")
    ap.add_argument("--iou", type=float, default=0.5, help="match threshold")
    ap.add_argument("--score", action="store_true",
                    help="also score each video through the same CViT with each detector")
    ap.add_argument("--mtcnn-weights", default=None,
                    help="npz of converted facenet_pytorch P/R/O-net weights "
                         "(written by cli.import_mtcnn)")
    ap.add_argument("--masks", action="store_true",
                    help="instead of box agreement, drive the mask geometry with BlazeFace "
                         "landmarks and report hit/sanity/area stats")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent CPU path")
    args = ap.parse_args(argv)

    from fac_fake_torch.detect import agreement
    if args.masks:
        rep = agreement.mask_geometry_report(args.videos, frames_per_video=args.frames,
                                             device=args.device)
    else:
        state_dict = None
        if args.mtcnn_weights:
            from fac_fake_torch.detect.mtcnn import load_mtcnn_npz
            state_dict = load_mtcnn_npz(args.mtcnn_weights)
        scorers = (build_scorers(args.mtcnn_weights, device=args.device)
                   if args.score else None)
        rep = agreement.agreement_report(
            args.videos, agreement.blazeface_boxes_fn(device=args.device),
            agreement.mtcnn_boxes_fn(state_dict=state_dict, device=args.device),
            frames_per_video=args.frames, scorers=scorers, iou_thr=args.iou)
    print(json.dumps(rep, indent=2, allow_nan=False, default=float))
    return rep


if __name__ == "__main__":
    main()
