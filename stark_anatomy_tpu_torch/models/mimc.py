"""MiMC sequential-function AIR: the third model family.

MiMC (Albrecht et al., the classic STARK/SNARK demo primitive) over the
same F_p as everything else (p = 1 + 407*2^119, gcd(3, p-1) = 1 so the
cubing round is a permutation): one register stepping

    x_{t+1} = (x_t + c_{t mod PERIOD})^3

for `num_steps` rows. Exists alongside Rescue-Prime (cubic, 4-column
periodic constants, 2 registers) and Fibonacci (linear, no constants) to
exercise a third AIR shape - single register, single cubic constraint,
ONE periodic constant column - through the same generic prover/verifier
(iop/stark.py). The proof shows knowledge of a preimage x with
MiMC^k(x) = y: only the OUTPUT row is a boundary constraint, so the
input stays witness-only (blinded by the zero-knowledge machinery like
every unopened trace value).

Round constants: SHA-256 counter-mode expansion of a domain-separation
tag, reduced mod p (same derivation style as models/rescue_prime.py);
c_0 = 0 as in the original MiMC so the first round is a bare cube. The
constant period is 32 - a power of two, so the column is exactly
periodic over every omicron domain and both sides evaluate it succinctly
(the periodic_columns contract of iop/stark.py, introduced for
Rescue-Prime's 32-row permutation blocks).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops.field import PRIME

#: Number of distinct round constants (power of two: divides every
#: power-of-two trace domain, keeping the constant column periodic).
PERIOD = 32

# Part of the function's definition: the tag keeps the original package's
# name so both packages derive the same constants.
_TAG = b"stark_anatomy_tpu/mimc/v1"


@lru_cache(maxsize=1)
def round_constants() -> tuple:
    """PERIOD field elements; c_0 = 0 (original-MiMC convention)."""
    out = [0]
    for i in range(1, PERIOD):
        h = hashlib.sha256(_TAG + i.to_bytes(4, "big")).digest()
        out.append(int.from_bytes(h, "big") % PRIME)
    return tuple(out)


def mimc(x: int, num_steps: int) -> int:
    """Host evaluation of the chain (the claimed public output)."""
    cs = round_constants()
    x %= PRIME
    for t in range(num_steps):
        x = pow((x + cs[t % PERIOD]) % PRIME, 3, PRIME)
    return x


@dataclass(frozen=True)
class MiMCAir:
    """AIR for `num_steps` MiMC rounds (cycle_count rows = steps + 1)."""

    num_steps: int

    @property
    def num_registers(self) -> int:
        return 1

    @property
    def cycle_count(self) -> int:
        return self.num_steps + 1

    @property
    def constraint_degree(self) -> int:
        return 3

    @property
    def num_constraints(self) -> int:
        return 1

    def periodic_columns(self):
        """(period, [round-constant column]) - the succinct-constants
        contract consumed by iop/stark.py (prover tiles one block over
        the FRI domain; verifier Horner-evaluates the degree-<32
        interpolant at x^(O/32))."""
        return PERIOD, [list(round_constants())]

    def constant_columns(self, num_rows: int) -> List[List[int]]:
        """Dense per-row expansion (tests/reference path)."""
        period, cols = self.periodic_columns()
        return [[col[r % period] for r in range(num_rows)] for col in cols]

    def trace(self, input_element: int) -> np.ndarray:
        cs = round_constants()
        x = input_element % PRIME
        rows = [[x]]
        for t in range(self.num_steps):
            x = pow((x + cs[t % PERIOD]) % PRIME, 3, PRIME)
            rows.append([x])
        return np.array(rows, dtype=object)

    def trace_bytes(self, input_element: int) -> np.ndarray:
        """The trace as (T, 1, 16) uint8 canonical little-endian encodings:
        Stark.prove's bulk input, which skips per-element int conversion."""
        cs = round_constants()
        x = input_element % PRIME
        buf = bytearray(x.to_bytes(16, "little"))
        for t in range(self.num_steps):
            x = pow((x + cs[t % PERIOD]) % PRIME, 3, PRIME)
            buf += x.to_bytes(16, "little")
        return np.frombuffer(bytes(buf), dtype=np.uint8).reshape(self.cycle_count, 1, 16)

    def boundary_constraints(self, output_element: int) -> List[tuple]:
        """Only the output row is public - the input is witness-only."""
        return [(self.cycle_count - 1, 0, output_element % PRIME)]

    def eval_transition_device(
        self,
        cur: List[torch.Tensor],
        nxt: List[torch.Tensor],
        constants: List[torch.Tensor],
    ) -> List[torch.Tensor]:
        """[next - (cur + c)^3] on (4, n) Montgomery word planes."""
        t = fk.add(cur[0], constants[0])
        return [fk.sub(nxt[0], fk.mont_mul(fk.mont_mul(t, t), t))]

    def eval_transition_host(
        self, cur: Sequence[int], nxt: Sequence[int], constants: Sequence[int]
    ) -> List[int]:
        return [(nxt[0] - pow((cur[0] + constants[0]) % PRIME, 3, PRIME)) % PRIME]
