"""The control of a cell's correctness check: the program run with one of the
configuration's guarantees broken (the configuration file's "control"), its
proofs judged by the reference against the configuration as stated. Beside
it, in the same process and on the same statements, proofs of the program as
configured: the sound readings.

    python3 benchmark/control.py --workload rescue-prod80.f24 --seeds 11,12,13 --proves 3

Prints one JSON line a seed and a summary: the largest sound reading and the
smallest control reading of every number compared. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, proves: int, device: str, workers: int) -> dict:
    """The numbers compared for `proves` sound and `proves` control proofs
    of the run's statements."""
    from benchmark import harness
    from stark_anatomy_tpu_torch.iop.stark import Stark

    plan = harness.make_plan(cell, seed)
    program = harness.Program(cell.config, plan, device)
    sound_stark = program.stark
    control_stark = Stark(program.air, device=device,
                          **{**cell.config["stark"], **cell.config["control"]["stark"]})
    out = {}
    for side, stark in (("sound", sound_stark), ("control", control_stark)):
        program.stark = stark
        program.prove(plan, -1)  # warm-up
        proofs = [program.prove(plan, i)[:2] for i in range(proves)]
        checks, _ = harness.check(cell.config, plan, [t for t, _ in program.statements], proofs, workers)
        out[side] = {k: v["value"] for k, v in checks.items()}
    program.free()
    return out


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--proves", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    lines, per_seed = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.proves, "cuda", min(8, os.cpu_count() or 1))
        per_seed.append(r)
        lines.append(json.dumps({"workload": args.workload, "seed": seed, **r}))
        print(lines[-1], flush=True)
    names = per_seed[0]["sound"].keys()
    summary = {
        "workload": args.workload, "seeds": len(per_seed), "proves": args.proves,
        "breaks": cell.config["control"]["breaks"],
        "sound_max": {k: max(r["sound"][k] for r in per_seed) for k in names},
        "control_min": {k: min(r["control"][k] for r in per_seed) for k in names},
        "gpu": torch.cuda.get_device_name(0),
    }
    lines.append(json.dumps(summary))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    sys.exit(main())
