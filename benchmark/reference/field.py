"""Exact arithmetic in F_p, p = 1 + 407 * 2^119, on Python integers."""

from __future__ import annotations

import hashlib

P = 1 + 407 * 2**119
#: a generator of the whole multiplicative group; it also shifts the
#: evaluation coset off every power-of-two subgroup.
GENERATOR = 3
TWO_ADICITY = 119


def inv(x: int) -> int:
    if x % P == 0:
        raise ZeroDivisionError("no inverse of zero")
    return pow(x, P - 2, P)


def root_of_unity(n: int) -> int:
    """An element of multiplicative order n (a power of two)."""
    if n < 1 or n & (n - 1) or n > 1 << TWO_ADICITY:
        raise ValueError(f"no subgroup of order {n}")
    return pow(GENERATOR, (P - 1) // n, P)


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def interpolate_subgroup(values: list) -> list:
    """Coefficients (low first) of the polynomial of degree < n that takes
    values[k] at w^k, w of order n: the inverse DFT, O(n^2) (n is small)."""
    n = len(values)
    w_inv = inv(root_of_unity(n))
    n_inv = inv(n)
    coeffs = []
    for i in range(n):
        step = pow(w_inv, i, P)
        acc, x = 0, 1
        for v in values:
            acc += v * x
            x = x * step % P
        coeffs.append(acc % P * n_inv % P)
    return coeffs


def horner(coeffs: list, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def challenge(data: bytes) -> int:
    """The transcript's field challenge: SHA-256 of data, big-endian, mod p."""
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % P


def challenge_indices(seed: bytes, size: int, reduced: int, number: int) -> list:
    """`number` indices below `size`, distinct modulo `reduced`, from SHA-256
    in counter mode."""
    if number > reduced:
        raise ValueError("more indices than distinct residues")
    out, seen, counter = [], set(), 0
    while len(out) < number:
        digest = hashlib.sha256(seed + counter.to_bytes(8, "big")).digest()
        idx = int.from_bytes(digest, "big") % size
        counter += 1
        if idx % reduced not in seen:
            seen.add(idx % reduced)
            out.append(idx)
    return out
