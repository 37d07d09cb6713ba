"""One run of one benchmark cell, from the root of a checkout:

    python3 benchmark/run.py --workload rescue-prod80.f24 --seed 7 --seconds 30 --trace 0

Sets the cell up (the statement's trace, the kernels loaded or built into
the program's own build directory inside the checkout, warm-up proves),
proves back to back for --seconds, checks every proof and the statement
against the plain reference, and prints the result as the last line of
standard output: one JSON object with correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones read
from proves under torch.profiler), device, [breakdown] and checks. The
numbers compared and their limits are also the last lines of standard
error. Exits non-zero and prints no result without the CUDA cards the cell
asks for, or when JAX or the JAX package was loaded.

Heavy imports stay inside main(): the reference's worker processes import
this file again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    t_start = harness.process_start()
    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    finally:
        killed = harness.reap_children()
        if killed:
            print(f"killed child processes still running after the run: {killed}", file=sys.stderr)
    left = harness.children()
    if left:
        print(f"child processes outlived the run: {left}: no result", file=sys.stderr)
        return 4
    foreign = harness.foreign_modules()
    if foreign:
        print(f"the run's process loaded {', '.join(foreign)}: no result", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    sys.exit(main())
