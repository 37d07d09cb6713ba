"""The program's side of the AIR named "rescue_prime" in a configuration:
the program's AIR object built from every field of the configuration's
"air", and statements' traces as the program's native generator makes them.

Every AIR module here (airs/<air name>.py) exposes build(air, length) ->
the program's AIR object, and statements(program_air, inputs) -> one
(trace, boundary) a statement input.
"""

from __future__ import annotations

import concurrent.futures
import hashlib

from benchmark.reference.field import P
from benchmark.reference.rescue_prime import FIELDS


def build(air: dict, length: int):
    """The program's RescuePrimeAir for a chain of `length` permutations.
    The program pins its round constants; a configuration whose
    constants_tag gives others is refused, not run as another instance."""
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir

    if set(air) != set(FIELDS):
        raise ValueError(f"a rescue_prime AIR has the fields {FIELDS}, not {sorted(air)}")
    rp = RescuePrime(m=air["state_width"], capacity=air["capacity"], N=air["rounds"],
                     alpha=air["alpha"], rows_per_perm=air["rows_per_perm"])
    tag = air["constants_tag"].encode()
    stated = [int.from_bytes(hashlib.sha256(tag + i.to_bytes(8, "big")).digest(), "big") % P
              for i in range(2 * rp.m * rp.N)]
    if rp.round_constants != stated:
        raise ValueError(f"the program's Rescue-Prime round constants are not those of {air['constants_tag']!r}")
    return RescuePrimeAir(rp, chain_length=length)


def statements(program_air, inputs: list) -> list:
    """(trace, boundary) of each chain input: the trace as (rows, m, 16)
    canonical encodings, the public output read from its last row as the
    program's command-line prover reads it. The native generator releases
    the interpreter while it runs, so the chains are made side by side."""
    from stark_anatomy_tpu_torch import native

    native.available()  # builds or loads the native library once, before the threads

    def one(x: int) -> tuple:
        trace = program_air.rp.trace_bytes(x, program_air.chain_length)
        return trace, program_air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))

    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(inputs))) as pool:
        return list(pool.map(one, inputs))
