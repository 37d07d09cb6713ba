"""Element storage for F_p tensors, and the numpy helpers around it.

STORAGE LAYOUT (both devices): a batch of n field elements is a
``(4, n) torch.int32`` tensor of word PLANES: plane j holds the j-th
little-endian 32-bit word of every element, as a bit pattern (a word with
its top bit set reads as a negative int32). Planes-first keeps the batch on
the fastest axis: thread i of a CUDA kernel reads word j of element i at
``base + j * plane_stride + i`` (coalesced), and a Merkle leaf word plane
is the codeword plane itself, with no repacking before hashing.

torch's unsigned integer types lack arithmetic on the CPU, so the plain
PyTorch routines (ops/field_torch.py) widen to int64, mask to 32 bits or
split into 16-bit digits, compute there and pack back; the CUDA kernels
(csrc/) reinterpret the same memory as uint32.

The Montgomery radix is R = 2^128 whatever the limb width, so Montgomery
integers equal the JAX package's 8x16-bit-digit ones; ops that cross to it
(reference.py) only re-slice words into digits. Canonical 16-byte
little-endian encodings at the commit/serialise boundaries are the contract.

p = 1 + 407 * 2^119 has words [1, 0, 0, 0xCB800000]: p = 1 (mod 2^32), so
the per-word Montgomery constant -p^-1 mod 2^32 is 0xFFFFFFFF (m = -t) and
adding m*p is one add plus ONE 32x32 multiply (m * 0xCB800000).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.utils import telemetry

NUM_WORDS = 4
WORD_BITS = 32
WORD_MASK = 0xFFFFFFFF
R = 1 << 128  # Montgomery radix
R_MOD_P = R % PRIME
R2_MOD_P = (R * R) % PRIME
R_INV = pow(R, -1, PRIME)
#: p's only nonzero high word: p = 1 + P_TOP_WORD * 2^96.
P_TOP_WORD = 0xCB800000
assert PRIME == 1 + P_TOP_WORD * (1 << 96)
P_WORDS = tuple((PRIME >> (WORD_BITS * i)) & WORD_MASK for i in range(NUM_WORDS))
assert P_WORDS == (1, 0, 0, P_TOP_WORD)
#: p's top 16-bit digit (p = 1 + P_TOP_DIGIT * 2^112), for the digit REDC.
P_TOP_DIGIT = 52096
assert PRIME == 1 + P_TOP_DIGIT * (1 << 112)


def mont(value: int) -> int:
    """Host int -> its Montgomery representative x*R mod p (a host int)."""
    return (value % PRIME) * R_MOD_P % PRIME


def int_to_words(value: int) -> tuple:
    """A 128-bit host int (NOT reduced) -> its four u32 words, low first."""
    if not 0 <= value < R:
        raise ValueError("value out of the 128-bit range")
    return tuple((value >> (WORD_BITS * i)) & WORD_MASK for i in range(NUM_WORDS))


def ints_to_bytes(values: Sequence[int] | np.ndarray) -> np.ndarray:
    """Batch of field elements (reduced mod p here) -> (n, 16) uint8
    little-endian encodings, in the batch's row-major order."""
    flat = [int(v) % PRIME for v in np.asarray(values, dtype=object).reshape(-1)]
    buf = b"".join(v.to_bytes(16, "little") for v in flat)
    return np.frombuffer(buf, dtype=np.uint8).reshape(-1, 16)


def ints_to_words(values: Sequence[int] | np.ndarray) -> np.ndarray:
    """Batch of field elements (reduced mod p here) -> (4, n) uint32."""
    return bytes_to_words(ints_to_bytes(values))


def words_to_ints(words: np.ndarray) -> np.ndarray:
    """(4, n) uint32/int32 word planes -> (n,) object array of Python ints."""
    raw = words_to_bytes(words).tobytes()
    out = np.empty(len(raw) // 16, dtype=object)
    for i in range(out.shape[0]):
        out[i] = int.from_bytes(raw[16 * i : 16 * i + 16], "little")
    return out


def bytes_to_words(data: np.ndarray) -> np.ndarray:
    """(n, 16) uint8 little-endian encodings -> (4, n) uint32 planes."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim != 2 or data.shape[1] != 16:
        raise ValueError("expected (n, 16) byte rows")
    return np.ascontiguousarray(data.view("<u4").T)


def words_to_bytes(words: np.ndarray) -> np.ndarray:
    """(4, n) uint32/int32 planes -> (n, 16) uint8 little-endian encodings."""
    words = np.asarray(words)
    if words.ndim != 2 or words.shape[0] != NUM_WORDS:
        raise ValueError(f"expected ({NUM_WORDS}, n) word planes")
    w = np.ascontiguousarray(words.view(np.uint32).T if words.dtype == np.int32 else words.T.astype(np.uint32))
    return w.astype("<u4", copy=False).view(np.uint8).reshape(-1, 16)


def random_felt_words(rng: np.random.Generator, n: int) -> np.ndarray:
    """n uniform canonical elements as (4, n) uint32 (top word < p's, so
    every draw is < p; the excluded boundary slice is ~2^-96 of the field)."""
    out = rng.integers(0, 1 << 32, size=(NUM_WORDS, n), dtype=np.uint32)
    out[NUM_WORDS - 1] = rng.integers(0, P_TOP_WORD, size=n, dtype=np.uint32)
    return out


# -- numpy <-> tensor ------------------------------------------------------


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """(k, n) uint32 numpy planes -> int32 tensor (same bits) on `device`
    (to a CUDA device a copy from pageable memory, after which torch
    synchronises the stream: a device-wait)."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    host = torch.from_numpy(arr.copy())
    with telemetry.device_wait(device):
        return host.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> uint32 numpy array of the same bits
    (from a CUDA tensor a blocking copy: a device-wait)."""
    with telemetry.device_wait(t.device):
        host = t.detach().to("cpu")
    return host.contiguous().numpy().view(np.uint32)


def copy_to_numpy(dst: np.ndarray, src: torch.Tensor) -> None:
    """Copy the (k, m) int32 tensor `src` (any device) into the uint32 numpy
    view `dst` of the same shape, one plane at a time straight into dst's
    memory (its planes must be contiguous): no host tensor in between."""
    with telemetry.device_wait(src.device):
        for j in range(src.shape[0]):
            torch.from_numpy(dst[j].view(np.int32)).copy_(src[j])


# -- storage pack/unpack used by the plain int64 routines -------------------


def unpack_words(x: torch.Tensor) -> list:
    """(4, ...) int32 storage -> list of four int64 tensors in [0, 2^32)."""
    x64 = x.to(torch.int64) & WORD_MASK
    return [x64[j] for j in range(NUM_WORDS)]


def unpack_digits(x: torch.Tensor) -> torch.Tensor:
    """(4, ...) int32 storage -> (8, ...) int64 16-bit digits, low first."""
    x64 = x.to(torch.int64) & WORD_MASK
    return torch.stack([x64 & 0xFFFF, x64 >> 16], dim=1).reshape((8,) + tuple(x.shape[1:]))


def pack_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Four int64 tensors in [0, 2^32) -> (4, ...) int32 storage."""
    w = torch.stack(list(words))
    return ((w << 32) >> 32).to(torch.int32)  # sign-extend bit 31


def require_device(device) -> torch.device:
    """Resolve an entry point's ``device`` argument; a CUDA device that is
    not there is an error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return dev
