"""Model export CLI — the port of `fac_fake_tpu/cli/export.py`, one front door
for every export format:

  python -m fac_fake_torch.cli.export onnx    out.onnx --model cvit
  python -m fac_fake_torch.cli.export program out.pt2  --model cvit_repbn8 --batch 4
  python -m fac_fake_torch.cli.export torch   out.pth  --weights trained.pth

Formats:
  * onnx    — the base CViT as an opset-12 graph through the dependency-free
              protobuf writer (`compat/onnx_export.py`; the reference's
              `model/pt_to_onnx.py`), input (1, 3, 224, 224);
  * program — `torch.export` of the eval forward at (--batch, 3,
              --image-size, --image-size), saved with `torch.export.save`
              (`compat/export.py`; JAX's `stablehlo`): load it with
              `torch.export.load(path).module()`;
  * torch   — the reference-layout `state_dict` saved with `torch.save`, so
              the weights load into the reference's own `cvit.py` models and
              into the port's (`compat/weights.py export_state_dict`).

JAX's fourth format, `orbax`, is a checkpoint of flax variables: the port
has no flax variables to write, and reading one needs JAX. So it is absent,
and ``--weights`` takes a torch ``.pth`` (a reference checkpoint, a
``{'state_dict': ...}`` training checkpoint or a DDP-prefixed one); a JAX
checkpoint directory comes over as a ``.pth`` through `python -m
fac_fake_tpu.cli.export torch out.pth --weights ckpt/`. Without
``--weights`` the model has its seeded initial weights. The model is built
on ``--device`` (the card unless ``cpu`` is named).
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("format", choices=["onnx", "program", "torch"],
                    help="onnx, program (torch.export) or torch (.pth); no orbax: see above")
    ap.add_argument("output", help="output file")
    ap.add_argument("--model", default="cvit")
    ap.add_argument("--weights", default=None,
                    help="checkpoint: reference or exported torch .pth")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=1,
                    help="the program's fixed batch (the ONNX graph's is 1)")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent CPU path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.weights and (os.path.isdir(args.weights)
                         or not args.weights.endswith((".pth", ".pt"))):
        raise SystemExit(
            f"--weights {args.weights}: the port loads torch .pth files; an orbax "
            "checkpoint needs JAX to read: restore it with fac_fake_tpu and write a .pth "
            "with `python -m fac_fake_tpu.cli.export torch out.pth --weights ckpt/`")

    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.core.config import Config, apply_dotted
    from fac_fake_torch.models import build_model

    cfg = Config()
    cfg.model.name = args.model
    cfg.model.image_size = args.image_size
    apply_dotted(cfg, args.set)
    model = build_model(cfg.model, device=args.device)
    if args.weights:
        model.load_state_dict(load_reference_pth(args.weights), strict=True)

    if args.format == "onnx":
        from fac_fake_torch.compat.onnx_export import export_onnx_cvit
        blob = export_onnx_cvit(model, args.output)
        print(f"wrote {args.output} ({len(blob)} bytes, opset 12)")
    elif args.format == "program":
        from fac_fake_torch.compat.export import export_program
        size = cfg.model.image_size
        export_program(model, (args.batch, 3, size, size), args.output)
        print(f"wrote {args.output} ({os.path.getsize(args.output)} bytes, torch.export)")
    else:
        import torch
        from fac_fake_torch.compat.weights import export_state_dict
        sd = export_state_dict(model)
        torch.save(sd, args.output)
        print(f"wrote {args.output} ({len(sd)} tensors, reference layout)")
    return args.output


if __name__ == "__main__":
    main()
