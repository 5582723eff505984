"""Run some phases of chip_smoke.py alone, from any checkout.

Runs the smoke's device, build and model phases, then the named kernel
phases (methods of chip_smoke.Smoke: k1, k2, k3, k4, k5), with the
chip_smoke.py and src/ of the checkout at --root.  Two checkouts timed in
one process each, one after the other on one card, compare a kernel's
versions: e.g. an unpacked `git archive` of the parent commit against this
tree, in the order parent, change, change, parent.

Usage: python scripts/smoke_phase.py [--root DIR] [k3 k2 ...]
(default: this checkout, k3).  Exits non-zero if a check failed.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose chip_smoke.py and src/ to run")
    ap.add_argument("phases", nargs="*", default=["k3"])
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("smoke_phase: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"checkout {root}")
    s = chip_smoke.Smoke()
    for name in ["device_info", "build", "model", "seamless_model",
                 *a.phases]:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        getattr(s, name)()
        s.sync()
        print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)
    if s.failures:
        print(f"smoke_phase FAILED: {s.failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
