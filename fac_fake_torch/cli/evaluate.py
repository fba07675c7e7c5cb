"""Evaluation CLI — the port of `fac_fake_tpu/cli/evaluate.py` (the
reference's `S3D-test.py`, `figure/ROC_AUC_ACC.py`, the GradCAM scripts
`figure/gradcam_cnn.py` and `figure/gradcam_transformer.py`, and the
history plotter `figure/figure.py`):

  python -m fac_fake_torch.cli.evaluate s3d --clips-root c/ --metadata m.json \
      --checkpoint s3d.pth --plan configs/caplan1.yaml [--no-degrade] \
      [--quantize int8] [--device cuda]
  python -m fac_fake_torch.cli.evaluate csv --csv preds.csv --metadata m.json \
      [--legacy-int-labels]
  python -m fac_fake_torch.cli.evaluate gradcam --images face.jpg \
      --weights cvit.pth --mode cnn --out-dir cams/ [--device cuda]
  python -m fac_fake_torch.cli.evaluate plots --history h1.pkl h2.pkl --out h.png

``--checkpoint`` and ``--weights`` take a reference or exported ``.pth``. A
JAX (orbax) checkpoint directory cannot be read without JAX: restore it
with the JAX package and write a ``.pth`` with
`fac_fake_tpu.compat.torch_export` (``export_s3d``, ``export_cvit``).
``csv`` needs neither pandas nor scikit-learn; ``gradcam`` needs cv2 (to
read, crop and overlay the images), ``plots`` matplotlib.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("s3d")
    p.add_argument("--clips-root", required=True)
    p.add_argument("--metadata", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="reference or exported S3D torch .pth")
    p.add_argument("--plan", default=None)
    p.add_argument("--model", default="s3d")
    p.add_argument("--no-degrade", action="store_true",
                   help="skip the reference's p=1 degradation augs")
    p.add_argument("--quantize", default="none", choices=("none", "int8"),
                   help="int8: the int8 engine (compat/quantize_s3d), calibrated "
                        "on the first scored clip")
    p.add_argument("--out-prefix", default="s3d_eval")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; there is no silent CPU path")

    p = sub.add_parser("csv")
    p.add_argument("--csv", required=True)
    p.add_argument("--metadata", required=True)
    p.add_argument("--legacy-int-labels", action="store_true",
                   help="replicate the inverted int-label accuracy block "
                        "(cvit_prediction.py:363-369)")

    p = sub.add_parser("gradcam",
                       help="CAM heatmaps (figure/gradcam_{cnn,transformer}.py)")
    p.add_argument("--images", required=True, nargs="+",
                   help="face-crop image file(s)")
    p.add_argument("--model", default="cvit")
    p.add_argument("--weights", default=None,
                   help="reference or exported torch .pth")
    p.add_argument("--mode", choices=["cnn", "tokens"], default="cnn",
                   help="cnn = post-stem feature CAM (gradcam_cnn.py); "
                        "tokens = patch-token CAM (gradcam_transformer.py)")
    p.add_argument("--target-class", type=int, default=None,
                   help="class index to explain (default: each image's argmax)")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--out-dir", default="gradcam_out")
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; there is no silent CPU path")

    p = sub.add_parser("plots",
                       help="loss/accuracy curves from training histories "
                            "(figure/figure.py)")
    p.add_argument("--history", required=True, nargs="+",
                   help="history .pkl file(s) written by the trainer")
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--out", default="history.png")
    return ap.parse_args(argv)


def _pth_only(path: str, flag: str, export: str) -> None:
    if os.path.isdir(path) or not path.endswith((".pth", ".pt")):
        raise SystemExit(
            f"{flag} {path}: the port loads torch .pth files; an "
            "orbax checkpoint needs JAX to read: restore it with fac_fake_tpu and "
            f"write a .pth with fac_fake_tpu.compat.torch_export.{export}")


def main(argv=None):
    args = parse_args(argv)

    if args.cmd == "plots":
        from fac_fake_torch.evaluate.plots import plot_history
        out = plot_history(args.history, labels=args.labels or None, out_path=args.out)
        print(out)
        return out

    if args.cmd == "gradcam":
        return _gradcam(args)

    if args.cmd == "csv":
        if args.legacy_int_labels:
            from fac_fake_torch.evaluate.metrics import legacy_int_accuracy
            acc = legacy_int_accuracy(args.csv, args.metadata)
            print(f"prediction Acc: {acc * 100:.2f}%")
            return acc
        from fac_fake_torch.evaluate.metrics import evaluate_prediction_csv
        out = evaluate_prediction_csv(args.csv, args.metadata)
        print(f"accuracy: {out['accuracy'] * 100:.2f}%  "
              f"AUC: {out['auc']:.4f}  ({out['count']} scored)")
        return out

    from fac_fake_torch.compat.weights import load_reference_pth, load_s3d_state_dict
    from fac_fake_torch.core.config import Config
    from fac_fake_torch.data.clips import ClipDataset, discover_video_folders
    from fac_fake_torch.evaluate.s3d_eval import S3DEvaluator
    from fac_fake_torch.models import build_model

    if args.plan:
        from fac_fake_torch.core.plans import load_plan
        cfg = load_plan(args.plan)
    else:
        cfg = Config()
        cfg.model.name = args.model
        cfg.model.num_class = 1

    model = build_model(cfg.model, device=args.device)
    if args.checkpoint:
        _pth_only(args.checkpoint, "--checkpoint", "export_s3d")
        load_s3d_state_dict(model, load_reference_pth(args.checkpoint))

    samples = discover_video_folders(args.clips_root, args.metadata)
    ds = ClipDataset(samples, frames_per_video=cfg.data.frames_per_video,
                     image_size=cfg.model.image_size, snippet="strided")
    ev = S3DEvaluator(model, degrade=not args.no_degrade, quantize=args.quantize,
                      device=args.device)
    out = ev.evaluate(ds, out_prefix=args.out_prefix, model_name=cfg.model.name)
    print(out)
    return out


def _gradcam(args):
    """CAM overlays for face crops (`figure/gradcam_cnn.py:25-70`,
    `figure/gradcam_transformer.py:13-43`): center-crop each image to the
    model size, CAM over the requested hook (the uint8 crops normalized by
    K2 on the card), JET overlay, write ``<name>_cam.png``."""
    import cv2
    import numpy as np
    import torch

    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.core.config import Config, apply_dotted
    from fac_fake_torch.evaluate.gradcam import (center_crop_img, gradcam, gradcam_tokens,
                                                 show_cam_on_image)
    from fac_fake_torch.models import build_model

    cfg = Config()
    cfg.model.name = args.model
    apply_dotted(cfg, args.set)
    if cfg.model.dtype != "float32":
        raise ValueError(f"Grad-CAM runs fp32 models, as JAX's does: "
                         f"model.dtype={cfg.model.dtype!r}")
    size = cfg.model.image_size
    model = build_model(cfg.model, device=args.device)
    if args.weights:
        _pth_only(args.weights, "--weights", "export_cvit")
        model.load_state_dict(load_reference_pth(args.weights), strict=True)

    crops = []
    for path in args.images:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"could not read image: {path}")
        crops.append(center_crop_img(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), size))
    u8 = torch.from_numpy(np.stack(crops)).to(next(model.parameters()).device)
    fn = gradcam if args.mode == "cnn" else gradcam_tokens
    cams = fn(model, u8, target_class=args.target_class)

    os.makedirs(args.out_dir, exist_ok=True)
    outs = []
    for path, crop, cam in zip(args.images, crops, cams):
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out_dir, f"{name}_cam.png")
        overlay = show_cam_on_image(crop.astype(np.float32) / 255.0, cam, alpha=args.alpha)
        cv2.imwrite(out_path, cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
        outs.append(out_path)
        print(out_path)
    return outs


if __name__ == "__main__":
    main()
