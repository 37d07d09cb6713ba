"""The one traffic generator: a traffic file's parameters and a run's seed
give the statements and the proves of the run.

The traffic is a closed loop of one prover stream: a prove starts when the
one before it has returned. A run holds `statements` statements of the
configuration's AIR, each of the longest length whose trace rows plus the
configuration's randomizers fit 2^trace_domain_log2 rows, from inputs
drawn from the seed. Prove i proves statement i mod `statements`, with its
own randomizer seed drawn from (seed, i), so every proof differs: its
padding rows, its zk randomizer and so its commits, queries and grind.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from benchmark.reference.field import P


@dataclass(frozen=True)
class Plan:
    seed: int
    length: int
    inputs: tuple

    def statement(self, index: int) -> int:
        """The statement that prove `index` proves (negative: the warm-up
        proves)."""
        return index % len(self.inputs)

    def prove_seed(self, index: int) -> bytes:
        """Randomizer seed of prove `index` (negative: the warm-up proves)."""
        return hashlib.sha256(f"benchmark/prove/{self.seed}/{index}".encode()).digest()


def longest(rows, budget: int) -> int:
    """The largest length whose rows(length) is at most `budget` (rows
    grows with the length)."""
    if rows(1) > budget:
        raise ValueError(f"{budget} rows hold no statement")
    lo, hi = 1, 2
    while rows(hi) <= budget:
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rows(mid) <= budget else (lo, mid)
    return lo


def plan(traffic: dict, config: dict, seed: int, rows) -> Plan:
    """`rows`: the reference AIR's rows(length)."""
    budget = (1 << traffic["trace_domain_log2"]) - config["stark"]["num_randomizers"]
    inputs = tuple(int.from_bytes(hashlib.sha256(f"benchmark/statement/{seed}/{k}".encode()).digest(), "big") % P
                   for k in range(traffic["statements"]))
    return Plan(seed=seed, length=longest(rows, budget), inputs=inputs)
