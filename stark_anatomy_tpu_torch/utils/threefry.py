"""Bit-exact threefry2x32 random bits, and the zk randomizer's coefficients
drawn from them.

The zero-knowledge randomizer's coefficients are defined as the stream
``jax.random.bits(key, (rows, n), uint32)`` of a threefry2x32 key under the
partitionable layout (jax 0.9.0's default): element (r, c) encrypts the
64-bit flat index r*n + c, split into (high, low) 32-bit counter words, and
the output word is the XOR of the two cipher words. Proof bytes depend on
it, so this module reproduces it exactly; tests hold it against jax.

``zk_coefficients`` turns 16 rows of that stream into field elements. For a
CUDA device it launches csrc/zk.cu's ``zk_coefficients`` (threefry, digit
packing and the Montgomery lift in one kernel) or raises; for the CPU, and
only because the device is the CPU, it takes ``zk_coefficients_plain``:
``random_bits`` and the plain field ops, uint32 arithmetic carried in int64
and masked, one torch pass per step.
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.limbs import pack_words

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


#: rows of the draw a zk coefficient takes: 16 digits of 16 bits
ZK_ROWS = 16


def zk_coefficients_plain(key, n: int, device, columns=None, out=None) -> torch.Tensor:
    """zk_coefficients in plain torch ops (any device): the 16 x m draw,
    digits paired into the words of lo (rows 0..7) and hi (rows 8..15), each
    canonicalised with add(., 0), then to_mont(to_mont(hi) + lo)."""
    if isinstance(columns, range):
        columns = torch.arange(columns.start, columns.stop, device=device)
    raw = random_bits(key, ZK_ROWS, n, device, columns=columns) & 0xFFFF
    halves = raw[0::2] | (raw[1::2] << 16)  # (8, m): words of lo, then hi
    lo = ft.add(pack_words(list(halves[:4])), 0)
    hi = ft.add(pack_words(list(halves[4:])), 0)
    del raw, halves
    res = ft.to_mont(ft.add(ft.to_mont(hi), lo))
    return res if out is None else out.copy_(res)


def zk_coefficients(key, n: int, device, columns=None, out=None) -> torch.Tensor:
    """(4, m) Montgomery coefficients X = hi*2^128 + lo mod p of the given
    columns of the 16 x n draw under `key` (two uint32 words).

    columns: None (all n), a ``range`` of step 1, or an int64 tensor of
    indices in [0, n), in its order. out: a (4, m) int32 tensor or view
    (planes may be strided, elements within a plane contiguous) to write."""
    if isinstance(columns, range) and columns.step != 1:
        raise ValueError("zk_coefficients: a range of columns must have step 1")
    dev = torch.device(device)
    if dev.type != "cuda":
        return zk_coefficients_plain(key, n, dev, columns, out)
    start, cols, m = 0, None, n
    if isinstance(columns, range):
        start, m = columns.start, len(columns)
    elif columns is not None:
        cols = columns.to(device=dev, dtype=torch.int64).contiguous()
        m = cols.numel()
    if out is None:
        out = torch.empty((4, m), dtype=torch.int32, device=dev)
    _build.check_planes(out, 4, "zk_coefficients.out")
    if out.device.type != "cuda" or out.shape[1] != m:
        raise ValueError(f"zk_coefficients: out must be a (4, {m}) CUDA tensor, got "
                         f"{tuple(out.shape)} on {out.device}")
    with torch.cuda.device(out.device):
        _build.launch("zk_coefficients", int(key[0]) & _M32, int(key[1]) & _M32, n, start,
                      None if cols is None else cols.data_ptr(), m, out.data_ptr(), out.stride(0))
    return out
