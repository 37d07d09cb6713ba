"""F_p arithmetic through the CUDA kernels of csrc/field.cu and csrc/inv.cu.

Counterpart of the JAX package's ops/field_pallas.py. ``add``, ``sub``,
``mont_mul``, ``butterfly``, ``pow_const`` and ``inv`` launch ``fp_add`` /
``fp_sub`` / ``fp_mont_mul`` / ``fp_butterfly`` / ``fp_pow_const`` /
``fp_batch_inv`` for CUDA tensors; for CPU tensors, and only because the
tensor lies on the CPU, they call the plain versions in ops/field_torch.py.
Nothing falls back: a CUDA tensor either launches the kernel or raises.

Operands are ``(4, n) int32`` word planes (ops/limbs.py) whose planes may be
strided views (e.g. ``cw[:, :half]``) as long as elements within a plane
are contiguous. Either operand may be a Python int: a raw 128-bit constant,
passed to the kernel by value (``limbs.mont(v)`` for a field constant).
``out=`` writes into an existing tensor or view. ``to_mont`` and
``from_mont`` are ``mont_mul`` by a constant. ``inv`` is Montgomery's batch
inversion in ``fp_batch_inv`` launches alone (csrc/inv.cu), at most 2 L + 1
of them for the L + 1 levels of ``inv_plan``.
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.limbs import R2_MOD_P, int_to_words

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


#: bits of a window of fp_pow_const
POW_WINDOW_BITS = 4


def pow_windows(exponent: int) -> list:
    """The 4-bit digits of 0 <= exponent < 2^128, most significant first (none
    for 0): fp_pow_const's schedule. The kernel takes x^top from its table of
    x^1..x^15, then for every later digit d squares four times and, if d > 0,
    multiplies by x^d."""
    if not 0 <= exponent < (1 << 128):
        raise ValueError("fp_pow_const takes exponents in [0, 2^128)")
    digits = []
    while exponent:
        digits.append(exponent & ((1 << POW_WINDOW_BITS) - 1))
        exponent >>= POW_WINDOW_BITS
    return digits[::-1]


def pow_products(exponent: int) -> int:
    """Montgomery products fp_pow_const does per element for `exponent`: 14
    for the table, then 4 squarings a window and one product a non-zero digit
    after the top one."""
    digits = pow_windows(exponent)
    if not digits:
        return 0
    return 14 + POW_WINDOW_BITS * (len(digits) - 1) + sum(1 for d in digits[1:] if d)


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
    value as four words and walks its 4-bit windows (``pow_windows``). A
    longer one is walked in 64-bit windows from the top: r = r^(2^64) (one
    launch), then r = r * a^window."""
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


#: elements a thread of fp_batch_inv takes (K) and threads a block (B): a
#: block's tile is K * B elements. The kernel is built for these two numbers
#: (csrc/inv.cu `K`, `B`); 4 x 128 was the fastest of K in {4, 8, 16} x B in
#: {64, 128, 256} at n = 2^24 on an H100 (PERF.md): small tiles keep more
#: blocks resident for the serial product chains of each thread and of the
#: block's tree.
INV_PER_THREAD = 4
INV_THREADS = 128


def inv_plan(n: int, per_thread: int = INV_PER_THREAD, threads: int = INV_THREADS) -> list:
    """Lengths of the levels of fp_batch_inv for n elements: level 0 is the
    input, level l + 1 holds the products of level l's tiles of
    per_thread * threads elements, and the last fits one tile. A call launches
    the up phase on every level but the last, the base on the last, and the
    down phase back to level 0: 2 * len - 1 launches (5 at n = 2^24:
    [2^24, 32768, 64])."""
    if n < 1:
        raise ValueError("inv of an empty batch")
    tile = per_thread * threads
    levels = [n]
    while levels[-1] > tile:
        levels.append(-(-levels[-1] // tile))
    return levels


def inv_tile_index(first: int, k, t, threads: int = INV_THREADS):
    """Element of a level that thread t of the tile starting at `first` takes
    at step k: thread t owns first + k * threads + t, so a warp's loads are
    adjacent; the products run thread-major (t, then k)."""
    return first + k * threads + t


def _batch_inv(a: torch.Tensor) -> torch.Tensor:
    """fp_batch_inv over the levels of inv_plan: up, base, down. The
    products of the tiles of every level above 0 share one scratch tensor;
    the base and down phases there write the inverses over them."""
    levels = inv_plan(a.shape[1])
    out = torch.empty((4, levels[0]), dtype=torch.int32, device=a.device)
    scratch = torch.empty((4, max(sum(levels[1:]), 1)), dtype=torch.int32, device=a.device)
    bufs = [a]
    for m in levels[1:]:
        off = sum(b.shape[1] for b in bufs[1:])
        bufs.append(scratch[:, off : off + m])
    outs = [out] + bufs[1:]

    def phase(p: int, level: int) -> None:
        x, y = bufs[level], outs[level]
        above = bufs[level + 1] if level + 1 < len(bufs) else None
        _build.launch(
            "fp_batch_inv", x.data_ptr(), x.stride(0), x.shape[1],
            None if above is None else above.data_ptr(), 0 if above is None else above.stride(0),
            y.data_ptr(), y.stride(0), p,
        )

    with torch.cuda.device(a.device):
        for level in range(len(levels) - 1):
            phase(0, level)
        phase(1, len(levels) - 1)
        for level in range(len(levels) - 2, -1, -1):
            phase(2, level)
    return out


def inv(a: torch.Tensor) -> torch.Tensor:
    """Batched field inverse, Montgomery form in and out; 0 maps to 0.

    On the card: Montgomery's batch inversion in fp_batch_inv launches only
    (``inv_plan``; the 143-product chain at its base), any n. Inputs are
    canonical, as on the prove path: only the word pattern 0 is taken for 0.
    On the CPU: the plain Fermat power ``field_torch.inv``."""
    _build.check_planes(a, 4, "inv.a")
    if a.device.type != "cuda":
        return ft.inv(a)
    return _batch_inv(a)
