"""F_p arithmetic through the CUDA kernels of csrc/field.cu.

Counterpart of the JAX package's ops/field_pallas.py. ``add``, ``sub``,
``mont_mul``, ``butterfly`` and ``pow_const`` launch ``fp_add`` / ``fp_sub``
/ ``fp_mont_mul`` / ``fp_butterfly`` / ``fp_pow_const`` for CUDA tensors; for
CPU tensors, and only because the tensor lies on the CPU, they call the plain
versions in ops/field_torch.py. Nothing falls back: a CUDA tensor either
launches the kernel or raises.

Operands are ``(4, n) int32`` word planes (ops/limbs.py) whose planes may be
strided views (e.g. ``cw[:, :half]``) as long as elements within a plane
are contiguous. Either operand may be a Python int: a raw 128-bit constant,
passed to the kernel by value (``limbs.mont(v)`` for a field constant).
``out=`` writes into an existing tensor or view. ``to_mont`` and
``from_mont`` are ``mont_mul`` by a constant. ``inv`` is Montgomery's batch
inversion built from ``mont_mul`` launches, with the Fermat power a^(p-2) at
its base: one ``fp_pow_const`` launch on the card.
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import R2_MOD_P, R_MOD_P, int_to_words

_PLAIN = {"fp_add": ft.add, "fp_sub": ft.sub, "fp_mont_mul": ft.mont_mul}


def _binary(name: str, a, b, out):
    ta = a if isinstance(a, torch.Tensor) else None
    tb = b if isinstance(b, torch.Tensor) else None
    ref = ta if ta is not None else tb
    if ref is None:
        raise TypeError(f"{name}: at least one operand must be a tensor")
    for t, what in ((ta, "a"), (tb, "b"), (out, "out")):
        if t is not None:
            _build.check_planes(t, 4, f"{name}.{what}")
            if t.device != ref.device or t.shape[1] != ref.shape[1]:
                raise ValueError(f"{name}: operands differ in device or length")
    if ref.device.type != "cuda":
        res = _PLAIN[name](a, b)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((4, ref.shape[1]), dtype=torch.int32, device=ref.device)
    c = int_to_words(int(b if ta is not None else a) if ta is None or tb is None else 0)
    with torch.cuda.device(ref.device):
        _build.launch(
            name,
            None if ta is None else ta.data_ptr(), 0 if ta is None else ta.stride(0),
            None if tb is None else tb.data_ptr(), 0 if tb is None else tb.stride(0),
            c[0], c[1], c[2], c[3],
            out.data_ptr(), out.stride(0), ref.shape[1],
        )
    return out


def add(a, b, out=None) -> torch.Tensor:
    """(a + b) mod p."""
    return _binary("fp_add", a, b, out)


def sub(a, b, out=None) -> torch.Tensor:
    """(a - b) mod p."""
    return _binary("fp_sub", a, b, out)


def mont_mul(a, b, out=None) -> torch.Tensor:
    """REDC(a * b) = a*b*2^-128 mod p."""
    return _binary("fp_mont_mul", a, b, out)


def to_mont(a: torch.Tensor, out=None) -> torch.Tensor:
    """Standard -> Montgomery form (product with the constant R^2)."""
    return mont_mul(a, R2_MOD_P, out=out)


def from_mont(a: torch.Tensor, out=None) -> torch.Tensor:
    """Montgomery -> standard form (product with the constant 1)."""
    return mont_mul(a, 1, out=out)


def butterfly(even: torch.Tensor, odd: torch.Tensor, tw, out=None):
    """(even + odd*tw, even - odd*tw) in one pass, Montgomery form.

    ``tw`` is a tensor or a raw 128-bit int passed by value. ``out`` is an
    optional ``(hi, lo)`` pair of tensors or views to write into; ``hi`` may
    be ``even`` and ``lo`` may be ``odd``."""
    ttw = tw if isinstance(tw, torch.Tensor) else None
    hi, lo = (None, None) if out is None else out
    for t, what in ((even, "even"), (odd, "odd"), (ttw, "tw"), (hi, "hi"), (lo, "lo")):
        if t is not None:
            _build.check_planes(t, 4, f"fp_butterfly.{what}")
            if t.device != even.device or t.shape[1] != even.shape[1]:
                raise ValueError("fp_butterfly: operands differ in device or length")
    if even.device.type != "cuda":
        res_hi, res_lo = ft.butterfly(even, odd, tw)
        return (res_hi if hi is None else hi.copy_(res_hi),
                res_lo if lo is None else lo.copy_(res_lo))
    n = even.shape[1]
    if hi is None:
        hi = torch.empty((4, n), dtype=torch.int32, device=even.device)
    if lo is None:
        lo = torch.empty((4, n), dtype=torch.int32, device=even.device)
    c = int_to_words(0 if ttw is not None else int(tw))
    with torch.cuda.device(even.device):
        _build.launch(
            "fp_butterfly",
            even.data_ptr(), even.stride(0), odd.data_ptr(), odd.stride(0),
            None if ttw is None else ttw.data_ptr(), 0 if ttw is None else ttw.stride(0),
            c[0], c[1], c[2], c[3],
            hi.data_ptr(), hi.stride(0), lo.data_ptr(), lo.stride(0), n,
        )
    return hi, lo


def _pow_launch(a: torch.Tensor, exponent: int, out) -> torch.Tensor:
    """One fp_pow_const launch; 0 <= exponent < 2^128."""
    if out is None:
        out = torch.empty((4, a.shape[1]), dtype=torch.int32, device=a.device)
    e = int_to_words(exponent)
    with torch.cuda.device(a.device):
        _build.launch(
            "fp_pow_const", a.data_ptr(), a.stride(0), e[0], e[1], e[2], e[3],
            out.data_ptr(), out.stride(0), a.shape[1],
        )
    return out


def pow_const(a: torch.Tensor, exponent: int, out=None) -> torch.Tensor:
    """a^exponent for a fixed non-negative int, Montgomery in and out.

    exponent 0 gives Montgomery one (R mod p) everywhere, also where a is 0.
    On the card an exponent below 2^128 is ONE launch: the kernel takes it by
    value as four words. A longer one is walked in 64-bit windows from the
    top: r = r^(2^64) (one launch), then r = r * a^window."""
    if exponent < 0:
        raise ValueError("negative exponents: use inv() then pow_const")
    _build.check_planes(a, 4, "fp_pow_const.a")
    if out is not None:
        _build.check_planes(out, 4, "fp_pow_const.out")
        if out.device != a.device or out.shape[1] != a.shape[1]:
            raise ValueError("fp_pow_const: operands differ in device or length")
    if a.device.type != "cuda":
        res = ft.pow_const(a, exponent)
        return res if out is None else out.copy_(res)
    if exponent < (1 << 128):
        return _pow_launch(a, exponent, out)
    windows = []
    while exponent:
        windows.append(exponent & ((1 << 64) - 1))
        exponent >>= 64
    r = _pow_launch(a, windows.pop(), None)
    while windows:
        w = windows.pop()
        _pow_launch(r, 1 << 64, r)
        if w:
            mont_mul(r, _pow_launch(a, w, None), out=r)
    return r if out is None else out.copy_(r)


def _inv_ladder(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2), canonical; 0 maps to 0. ONE fp_pow_const
    launch on the card."""
    return pow_const(a, PRIME - 2)


#: number of groups of the batched inversion's scans.
_BATCH_INV_GROUPS = 128
#: below this length the Fermat power beats the scans' 3 * 128 launches.
_BATCH_INV_MIN = 1 << 14


def _batch_inv_nonzero(a: torch.Tensor) -> torch.Tensor:
    """Montgomery's batch inversion of an array with NO zeros: ~3 full-size
    passes instead of the Fermat power's 250 products.

    The n elements are cut into G contiguous chunks of m = n/G. A forward
    scan over the chunks builds, per lane, the exclusive prefix products
    and the lane totals; the m totals are inverted recursively (ladder at
    the base); a backward scan with carry c_k = (x_0..x_k)^-1 emits
    x_k^-1 = c_k * prefix_k and steps c_{k-1} = c_k * x_k. Chunks are
    column slices, so no transposes: the kernels take strided planes. A
    unit's inverse is unique and every product is canonical, so the result
    equals the ladder's bit for bit."""
    n = a.shape[1]
    g = _BATCH_INV_GROUPS
    if n < _BATCH_INV_MIN or n % g:
        return _inv_ladder(a)
    m = n // g
    excl = torch.empty_like(a)  # chunk k: product of chunks 0..k-1
    run = a[:, :m]
    for k in range(1, g):
        excl[:, k * m : (k + 1) * m].copy_(run)
        run = mont_mul(run, a[:, k * m : (k + 1) * m])
    carry = _batch_inv_nonzero(run.contiguous())
    out = torch.empty_like(a)
    for k in range(g - 1, 0, -1):
        sl = slice(k * m, (k + 1) * m)
        mont_mul(carry, excl[:, sl], out=out[:, sl])
        carry = mont_mul(carry, a[:, sl])
    out[:, :m].copy_(carry)
    return out


def inv(a: torch.Tensor) -> torch.Tensor:
    """Batched field inverse, Montgomery form; 0 maps to 0.

    Long arrays take the batch-inversion scans (zeros masked to 1 on the way
    in and back to 0 on the way out) down to a base of fewer than 2^14
    elements, which like a short array takes the Fermat power directly."""
    _build.check_planes(a, 4, "inv.a")
    n = a.shape[1]
    if n < _BATCH_INV_MIN or n % _BATCH_INV_GROUPS:
        return _inv_ladder(a)
    is_zero = (a == 0).all(dim=0, keepdim=True)
    a1 = torch.where(is_zero, ft.const_column(R_MOD_P, a), a)
    return torch.where(is_zero, torch.zeros_like(a), _batch_inv_nonzero(a1))
