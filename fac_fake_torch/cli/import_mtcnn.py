"""Import facenet_pytorch MTCNN weights for both packages' cascades — the port
of `fac_fake_tpu/cli/import_mtcnn.py`.

  # facenet_pytorch ships per-net dumps (data/pnet.pt, rnet.pt, onet.pt):
  python -m fac_fake_torch.cli.import_mtcnn out.npz \
      --pnet pnet.pt --rnet rnet.pt --onet onet.pt

  # or one combined state_dict with pnet./rnet./onet. prefixes:
  python -m fac_fake_torch.cli.import_mtcnn out.npz --pt mtcnn.pt

Local files only, read with ``torch.load(map_location="cpu")``. The state
dict loads into the port's `MTCNN` with ``strict=True`` (facenet_pytorch's
names), is shape-checked against the JAX layout and written as the flat-key
``.npz`` both packages read (`detect/mtcnn.py load_mtcnn_npz`, and the JAX
package's of the same name); ``infer.mtcnn_weights=out.npz`` feeds it to the
video scorer.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("output", help="output .npz path")
    ap.add_argument("--pt", default=None,
                    help="combined state_dict .pt with pnet./rnet./onet. prefixed keys")
    ap.add_argument("--pnet", default=None, help="per-net pnet.pt dump")
    ap.add_argument("--rnet", default=None, help="per-net rnet.pt dump")
    ap.add_argument("--onet", default=None, help="per-net onet.pt dump")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from fac_fake_torch.compat.weights import load_reference_pth
    from fac_fake_torch.detect.mtcnn import MTCNN, save_mtcnn_npz

    if args.pt:
        sd = load_reference_pth(args.pt)
    else:
        per_net = {"pnet": args.pnet, "rnet": args.rnet, "onet": args.onet}
        missing = [n for n, p in per_net.items() if not p]
        if missing:
            raise SystemExit(f"pass --pt, or all of --pnet/--rnet/--onet (missing: "
                             f"{', '.join(missing)})")
        sd = {f"{net}.{k}": v for net, path in per_net.items()
              for k, v in load_reference_pth(path).items()}
    mt = MTCNN(sd, device="cpu")            # strict: every layer, no extra key
    save_mtcnn_npz(mt.state_dict(), args.output)
    print(f"wrote {args.output} ({len(sd)} arrays, shape-validated cascade tree)")
    return args.output


if __name__ == "__main__":
    main()
