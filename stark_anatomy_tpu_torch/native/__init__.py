"""ctypes bindings for the host field library (the repo's native/field128.cpp).

The trace of a Rescue-Prime chain is inherently sequential host work, and
the last FRI rounds are too small to be worth a launch; both run in the C++
library the repository already carries. This port builds that source,
unchanged, with the system ``g++`` into the package's own ``_build/``
directory on first use and binds the two entry points the prover needs
(``rescue_chain_trace``, ``fri_fold``), the output-only chain, and the
library's host batch ops (``add_batch``, ``sub_batch``, ``mul_batch``,
``pow_batch``, ``inv_batch``, ``powers``: lists of ints in, lists out). Each
has a pure-Python fallback with identical values when no compiler is
present; ``available()`` says which is active.

Values cross as numpy (n, 16) uint8 arrays of 16-byte little-endian field
elements, the canonical encoding (utils/encoding.py).

The C code keeps the round constants in a fixed array of 4*64 entries and
silently drops any beyond it; this wrapper REFUSES ``n_rounds > 64`` instead
of returning a wrong trace.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

from stark_anatomy_tpu_torch.ops.field import PRIME

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "field128.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(_BUILD_DIR, "libfield128.so")
#: capacity of the C library's constant table, in rounds.
MAX_ROUNDS = 64

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    stale = not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
    if stale:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = _LIB + f".{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, _LIB)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64 = ctypes.c_uint64
    size = ctypes.c_size_t
    for name, argtypes in (
        ("felt_add_batch", [u8p, u8p, u8p, size]),
        ("felt_sub_batch", [u8p, u8p, u8p, size]),
        ("felt_mul_batch", [u8p, u8p, u8p, size]),
        ("felt_pow_batch", [u8p, u8p, u8p, size]),
        ("felt_inv_batch", [u8p, u8p, size]),
        ("felt_powers", [u8p, u8p, size]),
        ("rescue_chain_trace", [u8p, u64, u64, u64, u8p, u8p, u8p, u8p]),
        ("fri_fold", [u8p, u64, u8p, u8p, u8p, u8p]),
        ("rescue_chain_output", [u8p, u64, u64, u8p, u8p, u8p, u8p]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """True when the C++ library is built and loaded (else Python fallbacks)."""
    return _load() is not None


def _enc(values: List[int]) -> np.ndarray:
    buf = b"".join((int(v) % PRIME).to_bytes(16, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint8).reshape(-1, 16).copy()


def _dec(buf: np.ndarray) -> List[int]:
    raw = np.ascontiguousarray(buf).tobytes()
    return [int.from_bytes(raw[i : i + 16], "little") for i in range(0, len(raw), 16)]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _binary(name: str, a: List[int], b: List[int], py) -> List[int]:
    if len(a) != len(b):
        raise ValueError(f"operands differ in length: {len(a)} and {len(b)}")
    lib = _load()
    if lib is None:
        return [py(x, y) for x, y in zip(a, b)]
    ea, eb = _enc(a), _enc(b)
    out = np.empty_like(ea)
    getattr(lib, name)(_ptr(ea), _ptr(eb), _ptr(out), len(a))
    return _dec(out)


def add_batch(a: List[int], b: List[int]) -> List[int]:
    return _binary("felt_add_batch", a, b, lambda x, y: (x + y) % PRIME)


def sub_batch(a: List[int], b: List[int]) -> List[int]:
    return _binary("felt_sub_batch", a, b, lambda x, y: (x - y) % PRIME)


def mul_batch(a: List[int], b: List[int]) -> List[int]:
    return _binary("felt_mul_batch", a, b, lambda x, y: (x * y) % PRIME)


def pow_batch(base: List[int], exponent: int) -> List[int]:
    """[x^exponent mod p], one shared exponent, 0 <= exponent < 2^128.

    The exponent crosses as its own 16 bytes, NOT reduced mod p: x^e and
    x^(e mod p) differ for e >= p (they differ by a factor x^(e div p))."""
    if not 0 <= exponent < 1 << 128:
        raise ValueError("exponent must be in [0, 2^128)")
    lib = _load()
    if lib is None:
        return [pow(x % PRIME, exponent, PRIME) for x in base]
    eb = _enc(base)
    ee = np.frombuffer(exponent.to_bytes(16, "little"), dtype=np.uint8).reshape(1, 16).copy()
    out = np.empty_like(eb)
    lib.felt_pow_batch(_ptr(eb), _ptr(ee), _ptr(out), len(base))
    return _dec(out)


def inv_batch(a: List[int]) -> List[int]:
    """Fermat inverses x^(p-2); 0 maps to 0."""
    lib = _load()
    if lib is None:
        return [pow(x % PRIME, PRIME - 2, PRIME) for x in a]
    ea = _enc(a)
    out = np.empty_like(ea)
    lib.felt_inv_batch(_ptr(ea), _ptr(out), len(a))
    return _dec(out)


def powers(base: int, count: int) -> List[int]:
    """[base^0, ..., base^(count-1)] mod p."""
    lib = _load()
    if lib is None:
        out, cur = [], 1
        for _ in range(count):
            out.append(cur)
            cur = cur * base % PRIME
        return out
    eb = _enc([base])
    out = np.empty((count, 16), dtype=np.uint8)
    lib.felt_powers(_ptr(eb), _ptr(out), count)
    return _dec(out)


def _check_rounds(rp) -> None:
    if rp.N > MAX_ROUNDS:
        raise ValueError(
            f"the native library holds constants for at most {MAX_ROUNDS} rounds, "
            f"got N={rp.N}"
        )


def fri_fold_values(values: List[int], alpha: int, offset_inv: int, omega_inv: int) -> List[int]:
    """One FRI fold round on host values:
    out[i] = 2^-1 * ((1+a_i)*v[i] + (1-a_i)*v[i+n/2]),
    a_i = alpha * offset_inv * omega_inv^i."""
    n = len(values)
    half = n // 2
    lib = _load()
    if lib is None:
        inv2 = pow(2, PRIME - 2, PRIME)
        out, d_inv = [], offset_inv % PRIME
        for i in range(half):
            au = alpha * d_inv % PRIME
            out.append(inv2 * ((1 + au) * values[i] + (1 - au) * values[i + half]) % PRIME)
            d_inv = d_inv * omega_inv % PRIME
        return out
    ev = _enc(values)
    ea, eo, ew = _enc([alpha]), _enc([offset_inv]), _enc([omega_inv])
    out = np.empty((half, 16), dtype=np.uint8)
    lib.fri_fold(_ptr(ev), n, _ptr(ea), _ptr(eo), _ptr(ew), _ptr(out))
    return _dec(out)


def _rescue_args(rp, input_element: int):
    mds = _enc([rp.mds[i][j] for i in range(2) for j in range(2)])
    return _enc([input_element]), mds, _enc(rp.round_constants), _enc([rp.alpha_inv])


def rescue_chain_output(rp, input_element: int, chain_length: int) -> Optional[List[int]]:
    """Final chain state without materialising trace rows (None: no library)."""
    lib = _load()
    if lib is None or rp.m != 2:
        return None
    _check_rounds(rp)
    inp, mds, consts, ainv = _rescue_args(rp, input_element)
    out = np.empty((2, 16), dtype=np.uint8)
    lib.rescue_chain_output(_ptr(inp), chain_length, rp.N, _ptr(mds), _ptr(consts), _ptr(ainv), _ptr(out))
    return _dec(out)


def rescue_chain_trace_bytes(rp, input_element: int, chain_length: int) -> np.ndarray:
    """Trace as (rows, m, 16) uint8 canonical encodings (the bulk path: at
    2^20 rows decoding to Python ints would cost seconds)."""
    lib = _load()
    if lib is None or rp.m != 2:
        rows = rp._trace_py(input_element, chain_length)
        flat = [int(v) for row in rows for v in row]
        return _enc(flat).reshape(rows.shape[0], rp.m, 16)
    _check_rounds(rp)
    inp, mds, consts, ainv = _rescue_args(rp, input_element)
    rows = chain_length * rp.rows_per_perm + 1
    out = np.empty((rows * rp.m, 16), dtype=np.uint8)
    lib.rescue_chain_trace(
        _ptr(inp), chain_length, rp.N, rp.rows_per_perm, _ptr(mds), _ptr(consts), _ptr(ainv), _ptr(out)
    )
    return out.reshape(rows, rp.m, 16)


def rescue_chain_trace(rp, input_element: int, chain_length: int) -> np.ndarray:
    """Trace as a (rows, m) object array of ints; Python fallback otherwise."""
    lib = _load()
    if lib is None or rp.m != 2:
        return rp._trace_py(input_element, chain_length)
    out = rescue_chain_trace_bytes(rp, input_element, chain_length)
    return np.array(_dec(out.reshape(-1, 16)), dtype=object).reshape(-1, rp.m)
