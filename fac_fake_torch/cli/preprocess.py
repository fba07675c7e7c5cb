"""Dataset preprocessing CLI — the port of `fac_fake_tpu/cli/preprocess.py`.

Replaces `preprocessing/extractfaces.py`, `extractfaces_ff.py`,
`shufft_image.py`, `detect_faces.py`+`extract_crops.py`, and
`figure/video_to_label.py`:

  python -m fac_fake_torch.cli.preprocess dfdc --parts-root raw/ --out crops/
  python -m fac_fake_torch.cli.preprocess flat --videos v/ --out crops/ --label fake
  python -m fac_fake_torch.cli.preprocess clips --videos v/ --out clipcrops/
  python -m fac_fake_torch.cli.preprocess split --src a/ --out-a tr/ --out-b te/
  python -m fac_fake_torch.cli.preprocess metadata --videos v/ --label FAKE --out meta.json

``dfdc``, ``flat`` and ``clips`` decode mp4s and write crops with cv2, which
must be installed, and detect with the packaged BlazeFace on ``--device``
(cuda by default; ``cpu`` only when asked).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def detecting(name, frames):
        p = sub.add_parser(name)
        p.add_argument("--frames", type=int, default=frames)
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu; there is no silent CPU path")
        return p

    p = detecting("dfdc", 10)
    p.add_argument("--parts-root", required=True)
    p.add_argument("--out", required=True)

    p = detecting("flat", 10)
    p.add_argument("--videos", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--label", required=True, choices=["fake", "real"])

    p = detecting("clips", 30)
    p.add_argument("--videos", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("split")
    p.add_argument("--src", required=True)
    p.add_argument("--out-a", required=True)
    p.add_argument("--out-b", required=True)
    p.add_argument("--fraction", type=float, default=0.85)

    p = sub.add_parser("metadata")
    p.add_argument("--videos", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--out", required=True)

    args = ap.parse_args(argv)
    from fac_fake_torch.data import preprocess as pp

    if args.cmd == "dfdc":
        pp.extract_dfdc(args.parts_root, args.out, num_frames=args.frames, device=args.device)
    elif args.cmd == "flat":
        pp.extract_flat(args.videos, args.out, args.label, num_frames=args.frames,
                        device=args.device)
    elif args.cmd == "clips":
        pp.extract_video_crop_folders(args.videos, args.out, frames_per_video=args.frames,
                                      device=args.device)
    elif args.cmd == "split":
        pp.shuffle_split(args.src, args.out_a, args.out_b, args.fraction)
    elif args.cmd == "metadata":
        pp.build_metadata_for_folder(args.videos, args.label, args.out)


if __name__ == "__main__":
    main()
