"""Fibonacci AIR: the minimal second model family.

Two registers (a, b) stepping (a, b) -> (b, a + b); linear (degree-1)
transition constraints and three boundary constraints (both seeds pinned
at row 0, the claimed value at the last row). Exists to demonstrate that
iop/stark.py is AIR-generic - nothing in the prover/verifier is
Rescue-Prime-specific - and exercises the linear-constraint degree
accounting (Stark.max_degree).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops.field import PRIME


@dataclass(frozen=True)
class FibonacciAir:
    """AIR for `num_steps` Fibonacci steps (cycle_count rows = steps + 1)."""

    num_steps: int
    a0: int = 1
    b0: int = 1

    @property
    def num_registers(self) -> int:
        return 2

    @property
    def cycle_count(self) -> int:
        return self.num_steps + 1

    @property
    def constraint_degree(self) -> int:
        return 1

    @property
    def num_constraints(self) -> int:
        return 2

    def constant_columns(self, num_rows: int) -> List[List[int]]:
        return []

    def trace(self) -> np.ndarray:
        a, b = self.a0 % PRIME, self.b0 % PRIME
        rows = [[a, b]]
        for _ in range(self.num_steps):
            a, b = b, (a + b) % PRIME
            rows.append([a, b])
        return np.array(rows, dtype=object)

    def trace_bytes(self) -> np.ndarray:
        """The trace as (T, 2, 16) uint8 canonical little-endian encodings:
        Stark.prove's bulk input, which skips per-element int conversion."""
        a, b = self.a0 % PRIME, self.b0 % PRIME
        buf = bytearray(a.to_bytes(16, "little") + b.to_bytes(16, "little"))
        for _ in range(self.num_steps):
            a, b = b, (a + b) % PRIME
            buf += a.to_bytes(16, "little")
            buf += b.to_bytes(16, "little")
        return np.frombuffer(bytes(buf), dtype=np.uint8).reshape(self.cycle_count, 2, 16)

    def output(self) -> int:
        return int(self.trace()[-1][0])

    def boundary_constraints(self, output_element: int) -> List[tuple]:
        return [
            (0, 0, self.a0 % PRIME),
            (0, 1, self.b0 % PRIME),
            (self.cycle_count - 1, 0, output_element % PRIME),
        ]

    def eval_transition_device(
        self,
        cur: List[torch.Tensor],
        nxt: List[torch.Tensor],
        constants: List[torch.Tensor],
    ) -> List[torch.Tensor]:
        """[next_a - b, next_b - (a + b)] over the whole domain."""
        return [
            fk.sub(nxt[0], cur[1]),
            fk.sub(nxt[1], fk.add(cur[0], cur[1])),
        ]

    def eval_transition_host(
        self, cur: Sequence[int], nxt: Sequence[int], constants: Sequence[int]
    ) -> List[int]:
        return [
            (nxt[0] - cur[1]) % PRIME,
            (nxt[1] - cur[0] - cur[1]) % PRIME,
        ]
