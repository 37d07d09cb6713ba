"""Prove and verify a Rescue-Prime hash chain from the command line.

    python3 -m stark_anatomy_tpu_torch.prove_rescue --input 42 --chain 4 --out proof.bin
    python3 -m stark_anatomy_tpu_torch.prove_rescue --chain 1 --device cpu

Proves knowledge of `input` such that iterating the Rescue-Prime
permutation `chain` times yields the printed output, then verifies the
proof (the verifier sees only the boundary: capacity-zero start + the
output). Proves on the CUDA card by default and raises without one;
--device cpu runs the plain PyTorch versions of every kernel, with
identical proof bytes. After the prove it prints the seconds of every
telemetry span, on the host's clock and, on the card, the device's.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m stark_anatomy_tpu_torch.prove_rescue", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--input", type=int, default=1234567890)
    ap.add_argument("--chain", type=int, default=1, help="permutation chain length")
    ap.add_argument(
        "--profile", type=str, default=None,
        help="named soundness profile (test | default | production-80 | "
        "production-128; iop/stark.py PROFILES). Overrides --checks.",
    )
    ap.add_argument("--checks", type=int, default=16, help="FRI colinearity checks")
    ap.add_argument("--out", type=str, default=None, help="write proof bytes here")
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument(
        "--seed", type=str, default=None,
        help="deterministic randomizer seed (utf-8). Default: fresh entropy "
        "per run (zero-knowledge). Required for checkpoint resume across "
        "process restarts.",
    )
    ap.add_argument(
        "--device", type=str, default="cuda",
        help="where the prover's codewords live: cuda (default; raises "
        "without a card) or cpu (the plain PyTorch versions, same bytes)",
    )
    args = ap.parse_args(argv)
    if args.checkpoint_dir and args.seed is None:
        ap.error("--checkpoint-dir needs --seed (resume must re-derive the "
                 "same randomizers after a restart)")

    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
    from stark_anatomy_tpu_torch.ops.limbs import require_device
    from stark_anatomy_tpu_torch.utils import telemetry

    require_device(args.device)  # no card and no --device cpu: raise before any work
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=args.chain)
    if args.profile is not None:
        stark = Stark.from_profile(args.profile, air, device=args.device)
    else:
        stark = Stark(air, expansion_factor=4, num_colinearity_checks=args.checks,
                      device=args.device)
    print(
        f"trace {stark.trace_length} rows x {stark.num_registers} registers; "
        f"LDE domain 2^{stark.fri_domain_length.bit_length() - 1}; "
        f"security {stark.security_level()} bits conjectured "
        f"/ {stark.security_level(conjectured=False)} proven "
        f"({stark.num_colinearity_checks} queries @ blowup "
        f"{stark.expansion_factor} + {stark.grinding_bits} pow bits)"
    )

    t0 = time.perf_counter()
    trace = rp.trace_bytes(args.input, chain_length=args.chain)
    # The public output is the trace's last row: re-running the chain
    # (rp.chain_output) would double the sequential generation cost.
    output = int.from_bytes(trace[-1, 0].tobytes(), "little")
    boundary = air.boundary_constraints(output)
    print(f"trace generated in {time.perf_counter() - t0:.2f}s; output = {output}")

    telemetry.reset()  # the split below is this prove's alone
    t0 = time.perf_counter()
    proof = stark.prove(
        trace, boundary,
        randomizer_seed=args.seed.encode() if args.seed is not None else None,
        checkpoint_dir=args.checkpoint_dir,
    )
    print(f"proved in {time.perf_counter() - t0:.2f}s; proof = {len(proof)} bytes")
    split = telemetry.report()
    for name in sorted(k for k in split if not k.endswith(telemetry.DEVICE_SUFFIX)):
        device = split.get(name + telemetry.DEVICE_SUFFIX)
        on_device = "" if device is None else f" host, {device['seconds']:.2f}s device"
        print(f"  {name}: {split[name]['seconds']:.2f}s{on_device}")

    if args.out:
        with open(args.out, "wb") as fh:
            fh.write(proof)
        print(f"wrote {args.out}")

    t0 = time.perf_counter()
    ok = stark.verify(proof, boundary)
    print(f"verified in {time.perf_counter() - t0:.2f}s: {'ACCEPT' if ok else 'REJECT'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
