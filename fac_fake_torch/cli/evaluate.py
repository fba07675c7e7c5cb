"""Evaluation CLI — the port of the ``s3d`` subcommand of
`fac_fake_tpu/cli/evaluate.py` (the reference's `S3D-test.py`):

  python -m fac_fake_torch.cli.evaluate s3d --clips-root c/ --metadata m.json \
      --checkpoint s3d.pth --plan configs/caplan1.yaml [--no-degrade] \
      [--quantize int8] [--device cuda]

``--checkpoint`` takes a reference or exported S3D ``.pth``. A JAX (orbax)
checkpoint directory cannot be read without JAX: restore it with the JAX
package and write a ``.pth`` with `fac_fake_tpu.compat.torch_export.export_s3d`.
The ``csv``, ``gradcam`` and ``plots`` subcommands are not ported yet
(ROADMAP queue 1 item 16).
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
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

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
        if os.path.isdir(args.checkpoint) or not args.checkpoint.endswith((".pth", ".pt")):
            raise SystemExit(
                f"--checkpoint {args.checkpoint}: the port loads torch .pth files; an "
                "orbax checkpoint needs JAX to read: restore it with fac_fake_tpu and "
                "write a .pth with fac_fake_tpu.compat.torch_export.export_s3d")
        load_s3d_state_dict(model, load_reference_pth(args.checkpoint))

    samples = discover_video_folders(args.clips_root, args.metadata)
    ds = ClipDataset(samples, frames_per_video=cfg.data.frames_per_video,
                     image_size=cfg.model.image_size, snippet="strided")
    ev = S3DEvaluator(model, degrade=not args.no_degrade, quantize=args.quantize,
                      device=args.device)
    out = ev.evaluate(ds, out_prefix=args.out_prefix, model_name=cfg.model.name)
    print(out)
    return out


if __name__ == "__main__":
    main()
