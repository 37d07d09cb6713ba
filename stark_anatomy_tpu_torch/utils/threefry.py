"""Bit-exact threefry2x32 random bits in torch integer ops.

The zero-knowledge randomizer's coefficients are defined as the stream
``jax.random.bits(key, (rows, n), uint32)`` of a threefry2x32 key under the
partitionable layout (jax 0.9.0's default): element (r, c) encrypts the
64-bit flat index r*n + c, split into (high, low) 32-bit counter words, and
the output word is the XOR of the two cipher words. Proof bytes depend on
it, so this module reproduces it exactly; tests hold it against jax.

This stream was an XLA-fused elementwise computation in the JAX package, not
a hand-written kernel, so plain torch ops are its port. uint32 arithmetic is
carried in int64 and masked.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """One threefry2x32 block per element. key: two ints < 2^32; x0, x1:
    int64 tensors of counter words in [0, 2^32). Returns two such tensors."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(key, rows: int, n: int, device, columns: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, n) int64 tensor of the uint32 words jax.random.bits draws for
    shape (rows, n) from threefry key `key` (two uint32 words).

    columns: an int64 tensor of column indices in [0, n); then only those
    columns are drawn, ``(rows, columns.numel())`` in their order, bit for
    bit the same words as those columns of the whole draw (every word is
    its own flat counter r*n + c): a process draws the part it holds."""
    if columns is None:
        flat = torch.arange(rows * n, dtype=torch.int64, device=device).reshape(rows, n)
    else:
        cols = columns.to(device=device, dtype=torch.int64).reshape(1, -1)
        flat = torch.arange(rows, dtype=torch.int64, device=device).reshape(rows, 1) * n + cols
    b0, b1 = threefry2x32(key, flat >> 32, flat & _M32)
    return b0 ^ b1
