"""The reference side of the AIR named "rescue_prime" in a configuration:
the Rescue-Prime instance, its constraints as the verifier evaluates them,
and a check of a chain's trace against it.

Every AIR module of the reference (reference/<air name>.py) exposes
`from_config(air) -> AIR`, where the AIR gives the verifier and the
generator: registers, constraints, constraint_degree, rows(length),
period and periodic_columns() (no columns: an empty list),
transition(cur, nxt, consts), boundary(length, output) as (row, register,
value) triples, output(trace), and trace_faults(trace, statement_input,
length, pool).

Rescue-Prime (Aly, Ashur, Ben-Sasson, Dhooghe, Szepieniec, ePrint 2020/1143)
as the "Anatomy of a STARK" tutorial uses it: state width m, N rounds, S-box
x^alpha and its inverse, an MDS matrix, two round-constant vectors a round.
A round maps S to S' with

    u  = M . S^alpha + C[2r]
    S' = M . u^(1/alpha) + C[2r+1]

and the chain's trace gives each permutation `rows_per_perm` rows: the
transition from row t applies round t mod rows_per_perm while that is below
N and copies the state otherwise. The pinned instance (a configuration file
states every number): Cauchy MDS M[i][j] = 1/(x_i + y_j), x = (1, 2),
y = (3, 4); round constants SHA-256(tag || be8(i)) mod p.

The trace check needs no 128-bit exponent: a round holds exactly when
M . S^alpha + C[2r] == (M^-1 . (S' - C[2r+1]))^alpha, so every row is
checked with products alone, vectorised over rows as numpy object arrays
of Python integers.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from benchmark.reference.field import P, inv

#: the keys of a configuration's "air" for this AIR, each one used
FIELDS = ("name", "state_width", "capacity", "rounds", "alpha", "rows_per_perm", "constants_tag")

#: rows of the trace checked at a time (bounds the object arrays' memory)
CHECK_BLOCK = 1 << 17


@dataclass(frozen=True)
class RescuePrime:
    m: int
    capacity: int
    rounds: int
    alpha: int
    rows_per_perm: int
    constants_tag: bytes

    @property
    def registers(self) -> int:
        return self.m

    @property
    def constraints(self) -> int:
        return self.m

    @property
    def constraint_degree(self) -> int:
        return self.alpha + 1  # the selector times the round constraint

    @property
    def period(self) -> int:
        return self.rows_per_perm

    def rows(self, length: int) -> int:
        """Trace rows of a chain of `length` permutations."""
        return length * self.rows_per_perm + 1

    def boundary(self, length: int, output: int) -> list:
        """The capacity registers are 0 at row 0, register 0 is the output
        at the last row."""
        return [(0, j, 0) for j in range(self.m - self.capacity, self.m)] + [(self.rows(length) - 1, 0, output % P)]

    def output(self, trace: np.ndarray) -> int:
        """The chain's output: the last row's first element."""
        return int.from_bytes(trace[-1, 0].tobytes(), "little")

    def trace_faults(self, trace: np.ndarray, statement_input: int, length: int, pool=None) -> int:
        return trace_faults(self, trace, statement_input, length, pool)

    @property
    def mds(self) -> list:
        if self.m != 2:
            raise ValueError("the pinned Cauchy matrix is 2 x 2")
        return [[inv(xi + yj) for yj in (3, 4)] for xi in (1, 2)]

    @property
    def mds_inv(self) -> list:
        (a, b), (c, d) = self.mds
        det_inv = inv(a * d - b * c)
        return [[d * det_inv % P, -b * det_inv % P], [-c * det_inv % P, a * det_inv % P]]

    @property
    def round_constants(self) -> list:
        return [int.from_bytes(hashlib.sha256(self.constants_tag + i.to_bytes(8, "big")).digest(), "big") % P
                for i in range(2 * self.m * self.rounds)]

    def periodic_columns(self) -> list:
        """2m + 1 columns of rows_per_perm values: the first and second
        constants of each slot's round, then the round/copy selector."""
        m, period, c = self.m, self.rows_per_perm, self.round_constants
        cols = [[0] * period for _ in range(2 * m + 1)]
        for r in range(min(self.rounds, period)):
            for i in range(m):
                cols[i][r] = c[2 * m * r + i]
                cols[m + i][r] = c[2 * m * r + m + i]
            cols[2 * m][r] = 1
        return cols

    def transition(self, cur: list, nxt: list, consts: list) -> list:
        """The AIR's m constraint values at one point (zero on every true
        transition): sel * (M.cur^a + C1 - (M^-1 (nxt - C2))^a) + (1 - sel) * (nxt - cur)."""
        m, a = self.m, self.alpha
        mds, mds_inv = self.mds, self.mds_inv
        sel = consts[2 * m]
        out = []
        for i in range(m):
            lhs = sum(mds[i][j] * pow(cur[j], a, P) for j in range(m)) + consts[i]
            rhs = pow(sum(mds_inv[i][j] * (nxt[j] - consts[m + j]) for j in range(m)) % P, a, P)
            out.append((sel * (lhs - rhs) + (1 - sel) * (nxt[i] - cur[i])) % P)
        return out


def from_config(air: dict) -> RescuePrime:
    if set(air) != set(FIELDS):
        raise ValueError(f"a rescue_prime AIR has the fields {FIELDS}, not {sorted(air)}")
    return RescuePrime(m=air["state_width"], capacity=air["capacity"], rounds=air["rounds"],
                       alpha=air["alpha"], rows_per_perm=air["rows_per_perm"],
                       constants_tag=air["constants_tag"].encode())


def _as_ints(block: np.ndarray) -> np.ndarray:
    """(rows, m, 16) uint8 little-endian encodings -> (rows, m) object ints."""
    halves = np.ascontiguousarray(block).view("<u8").astype(object)
    return halves[..., 0] + (halves[..., 1] << 64)


def _cube(x: np.ndarray) -> np.ndarray:
    return x * x % P * x % P


def _block_faults(rp: "RescuePrime", vals: np.ndarray, start: int) -> int:
    """Faulty transitions among rows start .. start + len(vals) - 2, given
    the encodings of rows start .. start + len(vals) - 1."""
    vals = _as_ints(vals)
    faults = int(np.any((vals >= P).astype(bool)))
    c, mds, mds_inv, m = rp.round_constants, rp.mds, rp.mds_inv, rp.m
    cur, nxt = vals[:-1], vals[1:]
    slot = np.arange(start, start + len(cur)) % rp.rows_per_perm
    for r in range(rp.rows_per_perm):
        at = slot == r
        cu, nx = cur[at], nxt[at]
        if r >= rp.rounds:
            faults += int(np.any((cu != nx).astype(bool), axis=1).sum())
            continue
        cubes = [_cube(cu[:, j]) for j in range(m)]
        wrong = np.zeros(len(cu), dtype=bool)
        for i in range(m):
            lhs = (sum(mds[i][j] * cubes[j] for j in range(m)) + c[2 * m * r + i]) % P
            rhs = _cube(sum(mds_inv[i][j] * ((nx[:, j] - c[2 * m * r + m + j]) % P) for j in range(m)) % P)
            wrong |= (lhs != rhs).astype(bool)
        faults += int(wrong.sum())
    return faults


def trace_faults(rp: RescuePrime, trace: np.ndarray, chain_input: int, chain: int, pool=None) -> int:
    """Rows at fault in a chain's trace, (rows, m, 16) uint8: a wrong shape
    or first row counts once, a block holding a value not below p once, and
    every transition that is neither its round nor a copy once. 0 means the
    trace is the chain's, so its last row's first element is the chain's
    output. With a concurrent.futures executor, blocks of rows are checked
    in it."""
    if rp.alpha != 3:
        raise ValueError("the vectorised check cubes: alpha must be 3")
    rows = rp.rows(chain)
    if trace.shape != (rows, rp.m, 16) or trace.dtype != np.uint8:
        return 1
    faults = int([int(v) for v in _as_ints(trace[:1])[0]] != [chain_input % P] + [0] * (rp.m - 1))
    blocks = [(rp, trace[s:min(s + CHECK_BLOCK, rows - 1) + 1], s) for s in range(0, rows - 1, CHECK_BLOCK)]
    if pool is None:
        return faults + sum(_block_faults(*b) for b in blocks)
    return faults + sum(f.result() for f in [pool.submit(_block_faults, *b) for b in blocks])
