"""A kernel phase of `chip_smoke.py` from two trees on one card, in turns
(parent, change, change, parent), so that a change to code two kernels
share shows against the spread between runs:

    python3 -m fac_fake_torch.utils.kernel_pairs PARENT_ROOT [--root .] [--phase k3]
        [--phases-from ROOT]

(``--phase`` names any ``chip_smoke.<phase>_phase(rng, dev)``: k1, k2, k3,
k4, k5, k6, k7, k8, k9, k10, augment, s3d_augment. ``k8_phase`` builds its
seeded MTCNN itself, ``k5_phase`` records its shapes from one int8 forward
of a seeded ca_s3d.)

PARENT_ROOT is an unpacked checkout of the other tree (``git archive``).
Each turn is a process of its own that imports ``fac_fake_torch`` from its
tree, builds that tree's kernels into its own build directory, runs
``chip_smoke.<phase>_phase`` on the seeded inputs of seed 0 and prints the
phase's total kernel ms. The phase code is each tree's own
``chip_smoke.py``, or with ``--phases-from`` the one in ROOT for both
turns: a parent that predates a phase, or times it another way, then runs
the same checks and timing on its own kernels through its own wrappers
(the wrappers the phase calls must exist in both trees). ``--phases-from``
cannot pair a tree whose kernel check is stricter than its parent's: the
parent's kernel then fails the stricter check (as an older K10, whose sums
ran in another order than its plain version's, fails K10's bit-equality),
so such a pair runs each tree's own phase. A phase's ``*_digest`` numbers (a hash of an output
on the seeded input) are compared across the four turns: equal digests are
outputs equal bit for bit between the trees; a digest that one tree's phase
does not return compares as unequal. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import fac_fake_torch
print("turn: fac_fake_torch from " + fac_fake_torch.__file__ + ", phases from " + cs.__file__,
      flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tot = getattr(cs, {phase!r} + "_phase")(np.random.default_rng(0), torch.device("cuda"))
print("TOTAL " + json.dumps({{k: v for k, v in tot.items() if isinstance(v, float)}}), flush=True)
"""


def turn(root: Path, phase: str, smoke: Path) -> dict:
    code = TURN.format(root=str(root), phase=phase, smoke=str(smoke))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=900)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stdout.write(out.stderr)
        raise SystemExit(f"{phase} from {root}: exit {out.returncode}")
    last = [line for line in out.stdout.splitlines() if line.startswith("TOTAL ")][-1]
    return json.loads(last[len("TOTAL "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("parent", type=Path)
    ap.add_argument("--root", type=Path, default=Path("."))
    ap.add_argument("--phase", default="k3")
    ap.add_argument("--phases-from", type=Path, default=None,
                    help="the tree whose chip_smoke.py both turns run (default: each its own)")
    args = ap.parse_args()
    order = [("parent", args.parent), ("change", args.root), ("change", args.root),
             ("parent", args.parent)]
    ms = {"parent": [], "change": []}
    totals = {"parent": [], "change": []}
    for name, root in order:
        root = root.resolve()
        smoke = (args.phases_from.resolve() if args.phases_from else root) / "chip_smoke.py"
        tot = turn(root, args.phase, smoke)
        ms[name].append(tot["ms"])
        totals[name].append(tot)
        print(f"{args.phase} pairs: {name} {tot['ms']:.4f} ms", flush=True)
    # a digest that one tree's phase does not return compares as unequal
    digests = {k: len({t.get(k) for ts in totals.values() for t in ts}) == 1
               for k in totals["change"][0] if k.endswith("_digest")}
    if digests:
        print(f"{args.phase} pairs: outputs bit-equal between the trees: {digests}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"phase": args.phase, "card": smi, **ms, "digests_equal": digests,
                      "totals": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
