"""A kernel phase of `chip_smoke.py` from two trees on one card, in turns
(parent, change, change, parent), so that a change to code two kernels
share shows against the spread between runs:

    python3 -m fac_fake_torch.utils.kernel_pairs PARENT_ROOT [--root .] [--phase k3]

PARENT_ROOT is an unpacked checkout of the other tree (``git archive``).
Each turn is a process of its own that imports ``chip_smoke`` and
``fac_fake_torch`` from its tree, builds that tree's kernels into its own
build directory, runs ``chip_smoke.<phase>_phase`` on the seeded inputs of
seed 0 and prints the phase's total kernel ms. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tot = getattr(cs, {phase!r} + "_phase")(np.random.default_rng(0), torch.device("cuda"))
print("TOTAL " + json.dumps({{"ms": tot["ms"]}}), flush=True)
"""


def turn(root: Path, phase: str) -> float:
    out = subprocess.run([sys.executable, "-c", TURN.format(root=str(root), phase=phase)],
                         cwd=root, capture_output=True, text=True, timeout=900)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stdout.write(out.stderr)
        raise SystemExit(f"{phase} from {root}: exit {out.returncode}")
    last = [line for line in out.stdout.splitlines() if line.startswith("TOTAL ")][-1]
    return json.loads(last[len("TOTAL "):])["ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("parent", type=Path)
    ap.add_argument("--root", type=Path, default=Path("."))
    ap.add_argument("--phase", default="k3")
    args = ap.parse_args()
    order = [("parent", args.parent), ("change", args.root), ("change", args.root),
             ("parent", args.parent)]
    ms = {"parent": [], "change": []}
    for name, root in order:
        ms[name].append(turn(root.resolve(), args.phase))
        print(f"{args.phase} pairs: {name} {ms[name][-1]:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"phase": args.phase, "card": smi, **ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
