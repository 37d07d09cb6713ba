"""Plain PyTorch F_p arithmetic on word-plane tensors (any device).

Counterpart of the JAX package's ops/field_jnp.py. Every function takes and
returns ``(4, *batch) torch.int32`` storage (ops/limbs.py) and computes in
int64: add/sub on 32-bit words with explicit carries, Montgomery products on
16-bit digits (a 16x16 product and a column of 16 of them fit int64 with
room to spare). These are the PLAIN VERSIONS of the CUDA kernels in
csrc/field.cu: the CPU tests run them against the JAX package, and on the
card they are what each kernel is compared with. They are written for
clarity, not speed.

Semantics match field_jnp bit for bit, including on NON-canonical inputs in
[0, 2^128): add/sub/mont_mul apply exactly one conditional subtract (add) of
p, so e.g. ``add(raw, 0)`` canonicalises a raw 128-bit draw.

Montgomery convention: the pipeline keeps values as x~ = x*R mod p, R =
2^128; ``mont_mul(a~, b~) = (a*b)~``. A second operand may be a Python int:
it is used as the raw 128-bit integer (callers pass ``limbs.mont(v)`` for a
field constant v) and broadcast.
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import (
    NUM_WORDS,
    P_TOP_DIGIT,
    P_WORDS,
    R2_MOD_P,
    R_MOD_P,
    WORD_MASK,
    int_to_words,
    pack_words,
    unpack_digits,
    unpack_words,
)
from stark_anatomy_tpu_torch.utils import telemetry

_I64 = torch.int64


def const_column(value: int, like: torch.Tensor) -> torch.Tensor:
    """Raw 128-bit host int -> (4, 1, ..) int32 column broadcastable to `like`."""
    words = [w - (1 << 32) if w >= (1 << 31) else w for w in int_to_words(value)]
    with telemetry.device_wait(like.device):  # an upload from pageable memory
        col = torch.tensor(words, dtype=torch.int32, device=like.device)
    return col.reshape((NUM_WORDS,) + (1,) * (like.dim() - 1))


def _operand(b, like: torch.Tensor) -> torch.Tensor:
    return const_column(b, like) if isinstance(b, int) else b


def _check(*tensors) -> None:
    for x in tensors:
        if x.dtype != torch.int32 or x.dim() < 1 or x.shape[0] != NUM_WORDS:
            raise ValueError(
                f"expected ({NUM_WORDS}, *batch) int32 word planes, got "
                f"{tuple(x.shape)} {x.dtype}"
            )


def _add_words(a, b):
    """Word lists (int64 in [0, 2^32)) -> (sum words mod 2^128, carry-out)."""
    out, carry = [], 0
    for x, y in zip(a, b):
        s = x + y + carry
        out.append(s & WORD_MASK)
        carry = s >> 32
    return out, carry


def _sub_words(a, b):
    """(a - b) mod 2^128 as words, and the borrow-out (1 where a < b)."""
    out, borrow = [], 0
    for x, y in zip(a, b):
        d = x - y - borrow
        out.append(d & WORD_MASK)
        borrow = (d >> 32) & 1  # arithmetic shift: -1 -> 1
    return out, borrow


def _cond_sub_p(words, extra):
    """129-bit value (words + extra*2^128) -> one conditional subtract of p.

    Subtracts when the value is >= p; the result is taken mod 2^128 (the
    caller guarantees value < 2^128 + p, so nothing is lost)."""
    sub, borrow = _sub_words(words, P_WORDS)
    ge = (extra != 0) | (borrow == 0)
    return [torch.where(ge, s, w) for s, w in zip(sub, words)]


def add(a: torch.Tensor, b) -> torch.Tensor:
    """(a + b) mod p; canonical in -> canonical out."""
    b = _operand(b, a)
    _check(a, b)
    s, carry = _add_words(unpack_words(a), unpack_words(b))
    return pack_words(_cond_sub_p(s, carry))


def sub(a, b) -> torch.Tensor:
    """(a - b) mod p: the 128-bit difference, plus p where it borrowed."""
    if isinstance(a, int):
        a = const_column(a, b)
    b = _operand(b, a)
    _check(a, b)
    d, borrow = _sub_words(unpack_words(a), unpack_words(b))
    e, _ = _add_words(d, P_WORDS)
    took = borrow != 0
    return pack_words([torch.where(took, x, y) for x, y in zip(e, d)])


def is_nonzero(a: torch.Tensor) -> torch.Tensor:
    """Boolean batch mask: element != 0."""
    return (a != 0).any(dim=0)


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p = p - a, and 0 -> 0."""
    _check(a)
    words = unpack_words(a)
    d, _ = _sub_words([torch.full_like(words[0], w) for w in P_WORDS], words)
    return torch.where(is_nonzero(a)[None], pack_words(d), torch.zeros_like(a))


def mont_mul(a: torch.Tensor, b) -> torch.Tensor:
    """Montgomery product REDC(a*b) = a*b*2^-128 mod p.

    Schoolbook on 16-bit digits into 16 int64 columns, then 8 digit-serial
    REDC steps: p = 1 (mod 2^16) makes the step multiplier m = -t_i mod 2^16,
    and p's digits [1,0,..,0,52096] make adding m*p one add at digit i and
    one product at digit i+7. The high half (< 2^128 + p) takes one
    conditional subtract."""
    b = _operand(b, a)
    _check(a, b)
    ad, bd = unpack_digits(a), unpack_digits(b)
    shape = torch.broadcast_shapes(ad.shape[1:], bd.shape[1:])
    cols = torch.zeros((16,) + tuple(shape), dtype=_I64, device=a.device)
    for j in range(8):
        cols[j : j + 8] += ad * bd[j]
    t = [cols[k] for k in range(16)]
    for i in range(8):
        m = (-t[i]) & 0xFFFF
        t[i + 1] = t[i + 1] + ((t[i] + m) >> 16)
        t[i + 7] = t[i + 7] + m * P_TOP_DIGIT
    carry = 0
    digits = []
    for k in range(8, 16):
        s = t[k] + carry
        digits.append(s & 0xFFFF)
        carry = s >> 16
    words = [digits[2 * j] | (digits[2 * j + 1] << 16) for j in range(NUM_WORDS)]
    return pack_words(_cond_sub_p(words, carry))


def butterfly(even: torch.Tensor, odd: torch.Tensor, tw):
    """(even + odd*tw, even - odd*tw), Montgomery form; tw a tensor or an int."""
    t = mont_mul(odd, tw)
    return add(even, t), sub(even, t)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Standard -> Montgomery form: a*R mod p = mont_mul(a, R^2)."""
    return mont_mul(a, R2_MOD_P)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form: mont_mul(a~, 1)."""
    return mont_mul(a, 1)


def mul(a: torch.Tensor, b) -> torch.Tensor:
    """Plain (a * b) mod p on standard-form inputs (two REDC passes)."""
    return mont_mul(mont_mul(a, b), R2_MOD_P)


def pow_const(a: torch.Tensor, exponent: int, a_is_mont: bool = True) -> torch.Tensor:
    """a^exponent for a fixed int exponent, LSB-first square-and-multiply."""
    if exponent < 0:
        raise ValueError("negative exponents: use inv() then pow_const")
    base = a if a_is_mont else to_mont(a)
    result = const_column(R_MOD_P, a).expand_as(a).contiguous()
    for i in range(exponent.bit_length()):
        if (exponent >> i) & 1:
            result = mont_mul(result, base)
        if i + 1 < exponent.bit_length():
            base = mont_mul(base, base)
    return result if a_is_mont else from_mont(result)


def inv(a: torch.Tensor, a_is_mont: bool = True) -> torch.Tensor:
    """Batched modular inverse via Fermat, a^(p-2); 0 maps to 0."""
    return pow_const(a, PRIME - 2, a_is_mont=a_is_mont)


#: Montgomery products of ``inv_chain``: the fewest known for a^(p-2)
INV_CHAIN_PRODUCTS = 143


def inv_chain(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2), Montgomery in and out, 0 -> 0, by the addition chain that
    fp_batch_inv runs at its base (csrc/field.cuh ``inv_chain``, after the JAX
    package's ``field_pallas._inv_ladder``): with t_k = a^(2^k - 1) built by
    run-doubling up to t_119 and z = t_119 * a = a^(2^119),
    a^(p-2) = a^(407 * 2^119 - 1) = z^406 * t_119. 143 products."""

    def sqr_n(x, n):
        for _ in range(n):
            x = mont_mul(x, x)
        return x

    t, saved = a, {1: a}
    for k in (1, 2, 4, 8, 16, 32):  # t_2k = t_k^(2^k) * t_k
        t = mont_mul(sqr_n(t, k), t)
        saved[2 * k] = t
    for k in (32, 16, 4, 2, 1):  # 64 + 32 + 16 + 4 + 2 + 1 = 119
        t = mont_mul(sqr_n(t, k), saved[k])
    z = mont_mul(t, a)
    r = z  # z^406, MSB first over 0b110010110 (the leading 1 is z)
    for bit in (1, 0, 0, 1, 0, 1, 1, 0):
        r = mont_mul(r, r)
        if bit:
            r = mont_mul(r, z)
    return mont_mul(r, t)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean batch mask: a == b word-wise (same form, canonical)."""
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise where over word planes: mask ? a : b (mask on batch dims)."""
    return torch.where(mask[None], a, b)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros((NUM_WORDS,) + tuple(shape), dtype=torch.int32, device=device)


def full(shape, value: int, device, mont: bool = False) -> torch.Tensor:
    """Constant-filled tensor (host int -> canonical or Montgomery form)."""
    v = (value % PRIME) * R_MOD_P % PRIME if mont else value % PRIME
    like = torch.empty((NUM_WORDS,) + (1,) * len(tuple(shape)), dtype=torch.int32, device=device)
    return const_column(v, like).expand((NUM_WORDS,) + tuple(shape)).contiguous()
