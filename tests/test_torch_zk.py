"""PyTorch port: the zk randomizer's coefficients.

A pure-Python model of csrc/zk.cu's per-column route (16 counters r*n + c
split into their high and low words, a threefry2x32 block each, 16-bit
digits paired into words, lo and hi canonicalised, the Montgomery lift with
the kernel's own R^2 words) is held against ``Stark._zk_coefficients`` on the
CPU (utils/threefry.py's plain route), against the field's definition
(X = hi*2^128 + lo mod p), and against the JAX package's draw. Columns come
whole, as a range, as an index tensor, as the cyclic indices of an 8-shard
mesh, and at n = 2^29, where r*n + c passes 2^32 and the counter's high word
is not zero."""

import hashlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from stark_anatomy_tpu.ops import field_jnp as fj
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import R2_MOD_P, to_tensor, words_to_ints
from stark_anatomy_tpu_torch.parallel import make_mesh
from stark_anatomy_tpu_torch.parallel.ntt_sharded import cyclic_indices
from stark_anatomy_tpu_torch.utils import threefry

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ZK_TAG = b"stark_anatomy_tpu/zk-fri-randomizer/v1"
KEYS = {
    "golden": np.frombuffer(hashlib.sha256(ZK_TAG + b"golden-v1").digest()[:8], dtype="<u4").copy(),
    "extreme": np.array([0xFFFFFFFF, 0x80000000], dtype=np.uint32),
}


def kernel_source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as fh:
        return fh.read()


def kernel_constants() -> tuple:
    """(R^2 mod p as csrc/field.cuh writes it for zk.cu, the key-schedule
    parity as csrc/zk.cu writes it)."""
    header = kernel_source("field.cuh")
    body = header[header.index("Fe r2_mod_p()"):]
    words = [int(w, 16) for w in re.findall(r"r\.w\[\d\] = (0x[0-9A-Fa-f]+)u;", body)[:4]]
    parity = int(re.search(r"kParity = (0x[0-9A-Fa-f]+)u;", kernel_source("zk.cu")).group(1), 16)
    return sum(w << (32 * j) for j, w in enumerate(words)), parity


R2_KERNEL, PARITY = kernel_constants()


def rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry_xor(ks: tuple, x0: int, x1: int) -> int:
    """The kernel's threefry_xor: one block, the xor of its two words."""
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0 ^ x1


def column_words(key, n: int, c: int) -> list:
    """The eight 32-bit words one thread of the kernel packs for column c."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    d = []
    for r in range(16):
        ctr = r * n + c
        d.append(threefry_xor(ks, ctr >> 32, ctr & M32) & 0xFFFF)
    return [d[2 * k] | (d[2 * k + 1] << 16) for k in range(8)]


def model(key, n: int, columns) -> torch.Tensor:
    """(4, m) Montgomery coefficients by the kernel's route, the lift over
    the plain field ops with the kernel's R^2."""
    words = np.array([column_words(key, n, int(c)) for c in columns], dtype=np.uint32).reshape(-1, 8).T
    lo = ft.add(to_tensor(np.ascontiguousarray(words[:4]), "cpu"), 0)
    hi = ft.add(to_tensor(np.ascontiguousarray(words[4:]), "cpu"), 0)
    return ft.mont_mul(ft.add(ft.mont_mul(hi, R2_KERNEL), lo), R2_KERNEL)


def by_definition(key, n: int, columns) -> list:
    """X = hi*2^128 + lo mod p of each column, times 2^128 (Montgomery)."""
    out = []
    for c in columns:
        w = column_words(key, n, int(c))
        x = sum(v << (32 * j) for j, v in enumerate(w))
        out.append(x % PRIME * pow(2, 128, PRIME) % PRIME)
    return out


def jax_coefficients(key, n: int) -> list:
    """The JAX package's draw (iop/stark.py _zk_codeword's lines, field_jnp)."""
    jkey = jax.random.wrap_key_data(jnp.asarray(key), impl="threefry2x32")
    raw = jax.random.bits(jkey, (16, n), dtype=jnp.uint32) & jnp.uint32(0xFFFF)
    z = fj.zeros((n,))
    coeffs = np.asarray(fj.to_mont(fj.add(fj.to_mont(fj.add(raw[8:], z)), fj.add(raw[:8], z))))
    return [sum(int(coeffs[k, i]) << (16 * k) for k in range(8)) for i in range(n)]


def check(key, n: int, columns, got: torch.Tensor) -> None:
    cols = list(range(n)) if columns is None else [int(c) for c in columns]
    want = model(key, n, cols)
    assert got.dtype == torch.int32 and got.shape == (4, len(cols))
    assert torch.equal(got, want)
    assert list(words_to_ints(got.numpy())) == by_definition(key, n, cols)


def test_the_kernel_constants_are_r2_mod_p_and_threefrys_parity():
    assert "fp::r2_mod_p()" in kernel_source("zk.cu")
    assert R2_KERNEL == R2_MOD_P
    assert PARITY == 0x1BD11BDA


@pytest.mark.parametrize("key", sorted(KEYS))
@pytest.mark.parametrize("n", [1, 8, 1000, 4096])
def test_the_model_equals_the_plain_route_and_the_jax_package(n, key):
    got = Stark._zk_coefficients(KEYS[key], n, "cpu")
    check(KEYS[key], n, None, got)
    assert list(words_to_ints(got.numpy())) == jax_coefficients(KEYS[key], n)


@pytest.mark.parametrize("cols", [range(0, 1000), range(3, 900), range(999, 1000)],
                         ids=["whole", "inner", "last"])
def test_columns_as_a_range_and_as_an_index_tensor(cols):
    key, n = KEYS["golden"], 1000
    got = Stark._zk_coefficients(key, n, "cpu", columns=cols)
    check(key, n, cols, got)
    assert torch.equal(got, Stark._zk_coefficients(key, n, "cpu", columns=torch.arange(cols.start, cols.stop)))
    assert torch.equal(got, Stark._zk_coefficients(key, n, "cpu")[:, cols.start:cols.stop])


@pytest.mark.parametrize("n", [64, 1024])
def test_the_cyclic_indices_of_an_8_shard_mesh(n):
    key = KEYS["extreme"]
    cols = cyclic_indices(n, make_mesh(8, "cpu"))
    assert sorted(cols.tolist()) == list(range(n)) and cols.tolist() != list(range(n))
    got = Stark._zk_coefficients(key, n, "cpu", columns=cols)
    check(key, n, cols.tolist(), got)
    assert torch.equal(got, Stark._zk_coefficients(key, n, "cpu")[:, cols])


@pytest.mark.parametrize("key", sorted(KEYS))
def test_counters_past_2_32_take_their_high_word(key):
    # n = 2^29: row r >= 8 counts past 2^32 for every column; nothing of
    # size n is built
    n = 1 << 29
    cols = [0, 1, 12345, (1 << 28) + 5, n - 2, n - 1]
    assert 15 * n + cols[-1] >= 1 << 32
    got = Stark._zk_coefficients(KEYS[key], n, "cpu", columns=torch.tensor(cols))
    check(KEYS[key], n, cols, got)
    check(KEYS[key], n, range(n - 3, n), Stark._zk_coefficients(KEYS[key], n, "cpu", columns=range(n - 3, n)))
    # the model's block against jax's threefry2x32 at those counters
    k0, k1 = (int(k) for k in KEYS[key])
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    for c in cols:
        for r in (0, 8, 15):
            ctr = r * n + c
            b = np.asarray(threefry_2x32(jnp.asarray(KEYS[key]), jnp.array([ctr >> 32, ctr & M32], dtype=jnp.uint32)))
            assert threefry_xor(ks, ctr >> 32, ctr & M32) == int(b[0] ^ b[1])


def test_out_writes_a_strided_view_and_returns_it():
    key, n = KEYS["golden"], 256
    whole = Stark._zk_coefficients(key, n, "cpu")
    buf = torch.zeros((4, 2 * n), dtype=torch.int32)
    got = Stark._zk_coefficients(key, n, "cpu", columns=range(64, 192), out=buf[:, 10:138])
    assert got.data_ptr() == buf[:, 10:138].data_ptr()
    assert torch.equal(buf[:, 10:138], whole[:, 64:192])
    assert not buf[:, :10].any() and not buf[:, 138:].any()
    with pytest.raises(ValueError, match="step 1"):
        threefry.zk_coefficients(key, n, "cpu", columns=range(0, n, 2))
