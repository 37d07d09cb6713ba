"""NTT / iNTT, coset evaluation and low-degree extension over F_p.

Counterpart of the JAX package's ops/ntt.py. Codewords are Montgomery-form
``(4, n) int32`` word planes (ops/limbs.py). ``ntt`` maps coefficients
(natural order) to evaluations on <omega_n> in natural order
(eval[i] = P(omega^i)); ``intt`` is its exact inverse. On a CUDA tensor the
transform runs through the kernels of csrc/ntt.cu (ops/ntt_kernels.py), on a
CPU tensor through the plain constant-geometry form there. Power tables are
built on the tensor's device by repeated doubling (log n batched products).
Everything is exact integer math: outputs are bit-identical on both devices.

The only module state is the twiddle-table cache, keyed by
``(n, inverse, device)``, and beside it the cache of the mesh transforms'
tables (``cached_table``; parallel/ntt_sharded.py); ``clear_twiddle_cache``
empties both.
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops import ntt_kernels
from stark_anatomy_tpu_torch.ops.field import PRIME, finv, primitive_root_of_unity
from stark_anatomy_tpu_torch.ops.limbs import mont, require_device

__all__ = ["ntt", "intt", "grouped_ntt", "coset_lde", "coset_evaluate", "coset_interpolate", "powers",
           "poly_mul", "cached_table", "clear_twiddle_cache"]

_ntt_core = ntt_kernels.transform_plain


def powers(base: int, count: int, device="cuda", start: int = 0) -> torch.Tensor:
    """(4, count) Montgomery-form powers [base^start .. base^(start+count-1)].

    Doubling: the table [b^s .. b^(s+L-1)] extends to 2L with one product by
    the constant b^L, written straight into the second half of the output
    (sum of widths = count products in total). A table that starts at s is
    seeded with b^s: a block of a longer table, built alone."""
    device = require_device(device)
    if count < 1:
        raise ValueError("count must be positive")
    if start < 0:
        raise ValueError("start must not be negative")
    cap = 1
    while cap < count:
        cap *= 2
    table = torch.empty((4, cap), dtype=torch.int32, device=device)
    table[:, :1] = ft.const_column(mont(pow(base, start, PRIME)), table)
    length = 1
    while length < cap:
        fk.mont_mul(table[:, :length], mont(pow(base, length, PRIME)),
                    out=table[:, length : 2 * length])
        length *= 2
    return table if cap == count else table[:, :count].contiguous()


_TWIDDLE_CACHE: dict = {}


def _twiddles(n: int, inverse: bool, device="cuda") -> torch.Tensor:
    """(4, n//2) Montgomery table [w^0 .. w^(n/2-1)], w = omega_n^(+-1)."""
    device = require_device(device)
    key = (n, inverse, str(device))
    if key not in _TWIDDLE_CACHE:
        w = primitive_root_of_unity(n)
        if inverse:
            w = finv(w)
        _TWIDDLE_CACHE[key] = powers(w, max(n // 2, 1), device)
    return _TWIDDLE_CACHE[key]


_TABLE_CACHE: dict = {}


def cached_table(key: tuple, build) -> torch.Tensor:
    """The table cached under `key`, built with build() at first use. The
    key names everything the table depends on, its device included."""
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = build()
    return _TABLE_CACHE[key]


def clear_twiddle_cache() -> None:
    """Drop every cached twiddle table (n/2 elements each, on its device)
    and every table cached through cached_table."""
    _TWIDDLE_CACHE.clear()
    _TABLE_CACHE.clear()


def _size(x: torch.Tensor) -> int:
    n = x.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    return n


def ntt(coeffs_mont: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations on <omega_n>, natural order."""
    n = _size(coeffs_mont)
    if n == 1:
        return coeffs_mont
    return ntt_kernels.transform(coeffs_mont, _twiddles(n, False, coeffs_mont.device))


def intt(evals_mont: torch.Tensor) -> torch.Tensor:
    """Evaluations on <omega_n> -> coefficients (the 1/n folded in)."""
    n = _size(evals_mont)
    if n == 1:
        return evals_mont
    return ntt_kernels.transform(
        evals_mont, _twiddles(n, True, evals_mont.device), scale=mont(finv(n))
    )


def grouped_ntt(x_mont: torch.Tensor, group: int, inverse: bool = False) -> torch.Tensor:
    """x.shape[-1] / group independent size-`group` transforms: every aligned
    run of `group` elements is transformed on <omega_group> (forward) or back
    (inverse, the 1/group folded in), natural order in and out."""
    if group < 2 or group > 128 or group & (group - 1):
        raise ValueError(f"group must be a power of two in [2, 128], got {group}")
    return ntt_kernels.ntt_grouped(
        x_mont, _twiddles(group, inverse, x_mont.device), group,
        scale=mont(finv(group)) if inverse else None,
    )


def coset_evaluate(coeffs_mont: torch.Tensor, domain_len: int, offset: int) -> torch.Tensor:
    """Evaluate a polynomial on the coset offset*<omega_L>, L = domain_len.

    coeffs may be shorter than L (zero-padded). Returns (4, L) evaluations,
    eval[i] = P(offset * omega_L^i), Montgomery form."""
    n = coeffs_mont.shape[-1]
    if n > domain_len:
        raise ValueError("polynomial longer than the target domain")
    dev = coeffs_mont.device
    scaled = torch.zeros((4, domain_len), dtype=torch.int32, device=dev) if n < domain_len \
        else torch.empty((4, domain_len), dtype=torch.int32, device=dev)
    fk.mont_mul(coeffs_mont, powers(offset, n, dev), out=scaled[:, :n])
    return ntt(scaled)


def coset_interpolate(evals_mont: torch.Tensor, offset: int) -> torch.Tensor:
    """Inverse of coset_evaluate at the same length: evals -> coefficients."""
    n = evals_mont.shape[-1]
    return fk.mont_mul(intt(evals_mont), powers(finv(offset), n, evals_mont.device))


def coset_lde(coeffs_mont: torch.Tensor, blowup: int, offset: int) -> torch.Tensor:
    """Low-degree extension: length-n coefficients -> blowup*n coset evals."""
    if blowup < 1 or blowup & (blowup - 1):
        raise ValueError("blowup must be a power of two")
    return coset_evaluate(coeffs_mont, coeffs_mont.shape[-1] * blowup, offset)


def poly_mul(a_mont: torch.Tensor, b_mont: torch.Tensor) -> torch.Tensor:
    """Dense polynomial product via NTT. Output length = len(a)+len(b)-1."""
    la, lb = a_mont.shape[-1], b_mont.shape[-1]
    out_len = la + lb - 1
    n = 1
    while n < out_len:
        n *= 2
    pa = torch.zeros((4, n), dtype=torch.int32, device=a_mont.device)
    pb = torch.zeros_like(pa)
    pa[:, :la] = a_mont
    pb[:, :lb] = b_mont
    prod = ntt(pa)
    fk.mont_mul(prod, ntt(pb), out=prod)
    return intt(prod)[:, :out_len].contiguous()
