"""The least device time of the work a prove needs, counted from its shapes.

The counts do not depend on how the program does the work: they count the
transforms and the Blake2b compressions that the prove's domains (trace
domain O, FRI domain F, degree bound D, registers, FRI rounds) call for,
whatever kernels, fusions or caches carry them. Bytes count each input read
once and each output written once; operations are 32-bit integer
instructions at the per-unit counts below. The least time is the larger of
bytes over the memory bandwidth and operations over the integer rate.

Peaks of one NVIDIA H100 SXM (data sheet, at the 700 W power limit):

- device memory: 3.35e12 B/s.
- 32-bit integer operations: 33.5e12/s, inferred. The data sheet gives
  67e12 float32 FLOP/s outside the tensor cores, i.e. 33.5e12 fused
  multiply-adds a second; integer multiply-adds run on the same pipe, and
  adds and logic on the ALU pipe beside it, so 33.5e12 integer instructions
  a second is taken as the rate. It is generous (the field product's wide
  multiply-adds appear to take two slots each), so a share against it
  stays below the real one.

Per unit of work, counted from the arithmetic (floors: what it cannot do
without):

- butterfly: one Montgomery product (4 rounds of 4 wide multiply-adds, 1
  for m*p's top word and ~5 carry adds = 40, the conditional subtract's 12,
  rounded up to 60 for the negations and carries into the fifth word), one
  modular add and one subtract (a 4-word carry chain, a second for the
  conditional +-p, 4 selects = 12 each): 84.
- Blake2b compression of one 128-byte block: 12 rounds of 8 G; a G is six
  64-bit adds and four xors at 2 operations each and rotates by 24, 16 and
  63 at 2 each (the one by 32 is free): 26; 96 G = 2496.
"""

from __future__ import annotations

import math

DEVICE_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
OPS_PER_BUTTERFLY = 84
OPS_PER_COMPRESSION = 2496
FELT_BYTES = 16
DIGEST_BYTES = 64
BLOCK_BYTES = 128


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / INT32_OPS_PER_S, nbytes / DEVICE_BYTES_PER_S)


def ntt_work(registers: int, o: int, f: int, d: int) -> tuple:
    """(butterflies, bytes) of the transforms one prove needs: per register
    the trace column's inverse transform on O points and its extension to
    the F-point coset, and the zk randomizer's D coefficients evaluated on
    the F-point coset. A transform onto n points counts (n/2) log2 n radix-2
    butterflies."""
    transforms = [(o, o, o)] * registers + [(o, f, f)] * registers + [(d, f, f)]
    butterflies = sum(n // 2 * int(math.log2(n)) for _, _, n in transforms)
    nbytes = sum(FELT_BYTES * (n_in + n_out) for n_in, n_out, _ in transforms)
    return butterflies, nbytes


def _tree(leaves: int, leaf_bytes: int) -> tuple:
    """(compressions, bytes) of a Merkle tree over `leaves` messages of
    leaf_bytes each: one compression a leaf block, one a node."""
    blocks = max(1, -(-leaf_bytes // BLOCK_BYTES))
    compressions = leaves * blocks + leaves - 1
    nbytes = leaves * (leaf_bytes + DIGEST_BYTES) + (leaves - 1) * (2 * DIGEST_BYTES + DIGEST_BYTES)
    return compressions, nbytes


def blake2b_work(registers: int, f: int, fri_rounds: int) -> tuple:
    """(compressions, bytes) of every commit of one prove. All trees have
    pair leaves (leaf j of a length-n codeword holds rows j and j + n/2):
    the boundary quotients (F/2 leaves of 2 * registers elements), the zk
    codeword (F/2 leaves of 2), and each FRI round's codeword of F >> r
    points, the rounds that finish on the host included."""
    trees = [_tree(f // 2, 2 * registers * FELT_BYTES), _tree(f // 2, 2 * FELT_BYTES)]
    trees += [_tree((f >> r) // 2, 2 * FELT_BYTES) for r in range(fri_rounds)]
    return sum(c for c, _ in trees), sum(b for _, b in trees)


def prove_work(shape) -> dict:
    """Least seconds a prove's NTT work and Blake2b work can take on the
    card; `shape` has registers, o, f, degree_target and fri_rounds."""
    butterflies, nb = ntt_work(shape.registers, shape.o, shape.f, shape.degree_target + 1)
    compressions, bb = blake2b_work(shape.registers, shape.f, shape.fri_rounds)
    return {
        "ntt": least_s(butterflies * OPS_PER_BUTTERFLY, nb),
        "blake2b": least_s(compressions * OPS_PER_COMPRESSION, bb),
    }
