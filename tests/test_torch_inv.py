"""PyTorch port, the batched inverse and the windowed power: fp_batch_inv's
plan, index map, product tree and 143-product chain (a model of csrc/inv.cu
on the plain field ops of ops/field_torch.py, and the launcher fk._batch_inv
driving that model as its kernel), and fp_pow_const's window schedule, each
held bit for bit (tolerance 0: exact integer math) against the JAX
package's field_pallas.inv, _inv_ladder and field_jnp, or against
field_torch's Fermat power. One numpy input feeds both packages."""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.ops import field_jnp as fj
from stark_anatomy_tpu.ops import field_pallas as fp
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.field import PRIME
from stark_anatomy_tpu_torch.ops.limbs import R_MOD_P, random_felt_words, to_tensor
from stark_anatomy_tpu_torch.reference import to_reference_limbs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain ops here run ~10^3 int64 passes over 2^14..2^16 elements: with
    torch's intra-op threads in every parallel test worker they oversubscribe
    the host's cores and the file takes several times longer; one thread is
    steady."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _felts(n: int, seed: int, zeros: bool = True) -> torch.Tensor:
    """(4, n) canonical Montgomery words; zeros at the first and last index
    and in a run in the middle."""
    w = random_felt_words(np.random.default_rng(seed), n)
    if zeros:
        w[:, 0] = 0
        w[:, n - 1] = 0
        w[:, n // 2 : n // 2 + min(5, n // 3)] = 0
    return to_tensor(w, "cpu")


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(to_reference_limbs(got), np.asarray(want))


def _one_like(x: torch.Tensor) -> torch.Tensor:
    return ft.const_column(R_MOD_P, x).expand_as(x).contiguous()


# -- a model of csrc/inv.cu on the plain field ops -----------------------------


def _tiles(x: torch.Tensor, per_thread: int, threads: int):
    """A level's elements in the kernel's layout: (4, blocks, threads, K),
    element k of thread t of block b at inv_tile_index(b * tile, k, t); zeros
    and positions past the end as one. Returns it, the index and the masks."""
    m, tile = x.shape[1], per_thread * threads
    blocks = -(-m // tile)
    idx = fk.inv_tile_index(torch.arange(blocks)[:, None, None] * tile,
                            torch.arange(per_thread)[None, None, :],
                            torch.arange(threads)[None, :, None], threads)
    valid = idx < m
    y = x[:, idx.clamp(max=m - 1)]
    zero = valid & (y == 0).all(dim=0)
    return torch.where((~valid | zero)[None], _one_like(y), y), idx, valid, zero


def _prefixes(y: torch.Tensor) -> list:
    pre = [y[..., 0]]
    for k in range(1, y.shape[-1]):
        pre.append(ft.mont_mul(pre[-1], y[..., k]))
    return pre


def _tree(leaves: torch.Tensor, inv_root=None) -> torch.Tensor:
    """The kernel's heap-order tree over the last axis (threads): without
    inv_root the root (the block's product); with it, the leaves' inverses
    from the root's inverse, walked down in place."""
    b = leaves.shape[-1]
    node = torch.cat([torch.zeros_like(leaves), leaves], dim=-1)
    half = b // 2
    while half >= (1 if inv_root is None else 2):
        i = torch.arange(half, 2 * half)
        node[..., i] = ft.mont_mul(node[..., 2 * i], node[..., 2 * i + 1])
        half //= 2
    if inv_root is None:
        return node[..., 1]
    node[..., 1] = inv_root
    half = 1
    while half < b:
        i = torch.arange(half, 2 * half)
        v, l, r = node[..., i], node[..., 2 * i], node[..., 2 * i + 1]
        node[..., 2 * i], node[..., 2 * i + 1] = ft.mont_mul(v, r), ft.mont_mul(v, l)
        half *= 2
    return node[..., b:]


def _walk_back(x, y, pre, c, idx, valid, zero) -> torch.Tensor:
    out = [None] * y.shape[-1]
    for k in range(y.shape[-1] - 1, 0, -1):
        out[k] = ft.mont_mul(c, pre[k - 1])
        c = ft.mont_mul(c, y[..., k])
    out[0] = c
    res = torch.where(zero[None], torch.zeros_like(y), torch.stack(out, dim=-1))
    level = torch.empty_like(x)
    level[:, idx[valid]] = res[:, valid]
    return level


def model_batch_inv(a: torch.Tensor, per_thread: int, threads: int) -> torch.Tensor:
    """fk.inv's launches on the plain ops: up on every level of inv_plan but
    the last, the base (chain per thread) on the last, down back to level 0."""
    levels = fk.inv_plan(a.shape[1], per_thread, threads)
    xs = [a]
    for _ in levels[1:]:
        y, *_ = _tiles(xs[-1], per_thread, threads)
        thread_products = _prefixes(y)[-1]  # the kernel pairs them up: same product
        xs.append(_tree(thread_products))
    assert [x.shape[1] for x in xs] == levels
    y, idx, valid, zero = _tiles(xs[-1], per_thread, threads)
    pre = _prefixes(y)
    inv = _walk_back(xs[-1], y, pre, ft.inv_chain(pre[-1]), idx, valid, zero)
    for x in reversed(xs[:-1]):
        y, idx, valid, zero = _tiles(x, per_thread, threads)
        pre = _prefixes(y)
        inv = _walk_back(x, y, pre, _tree(pre[-1], inv), idx, valid, zero)
    return inv


_FERMAT: dict = {}


def _fermat(n: int) -> tuple:
    if n not in _FERMAT:
        a = _felts(n, n)
        _FERMAT[n] = (a, ft.inv(a))
    return _FERMAT[n]


# -- fk.inv against the JAX package ---------------------------------------------

INV_LENGTHS = [1, 7, 1000, 1 << 14, (1 << 15) + 128]


@pytest.fixture(scope="module")
def jax_inverses():
    """field_pallas.inv and field_jnp.inv of every length's input, compiled as
    few times as their branches allow (a compile costs ~20 s here): below 2^14
    elements field_pallas.inv is the elementwise ladder, so the short inputs go
    through it in ONE call on their concatenation; the long ones (n % 128 == 0:
    its batch scans) each alone. field_jnp.inv (elementwise) takes the short
    inputs and both ends of the long ones in one call."""
    inputs = {n: _felts(n, 100 + n) for n in INV_LENGTHS}
    short = [n for n in INV_LENGTHS if n < 1 << 14]
    sample = {n: torch.cat([inputs[n][:, :500], inputs[n][:, -500:]], dim=1)
              for n in INV_LENGTHS if n >= 1 << 14}

    def jax_of(t):
        return jnp.asarray(to_reference_limbs(t))

    def split(limbs, lengths):
        offsets = np.cumsum([0] + lengths)
        return [limbs[:, offsets[i] : offsets[i + 1]] for i in range(len(lengths))]

    pallas = dict(zip(short, split(np.asarray(fp.inv(jax_of(torch.cat([inputs[n] for n in short], dim=1)))),
                                   short)))
    for n in sample:
        pallas[n] = np.asarray(fp.inv(jax_of(inputs[n])))
    jnp_parts = [inputs[n] for n in short] + list(sample.values())
    jnp_inv = split(np.asarray(fj.inv(jax_of(torch.cat(jnp_parts, dim=1)))),
                    [t.shape[1] for t in jnp_parts])
    return inputs, pallas, dict(zip(short + list(sample), jnp_inv))


# -- the kernel's route on the plain ops -----------------------------------------


@pytest.mark.parametrize("shape", [(fk.INV_PER_THREAD, fk.INV_THREADS), (4, 4)],
                         ids=["kernel-tile", "shrunk-tile"])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, (1 << 12) + 3, 1 << 16])
def test_plan_model_on_plain_ops_equals_field_torch_inv(n, shape):
    a, want = _fermat(n)
    assert torch.equal(model_batch_inv(a, *shape), want)


def _planes(ptr: int, stride: int, n: int) -> torch.Tensor:
    """The (4, n) int32 planes at a host address (a CPU tensor's data_ptr)."""
    raw = (ctypes.c_int32 * (3 * stride + n)).from_address(ptr)
    flat = torch.from_numpy(np.frombuffer(raw, dtype=np.int32))
    return flat.as_strided((4, n), (stride, 1))


def _emulated_fp_batch_inv(shape, name, x, x_stride, n, totals, t_stride, out, out_stride,
                           phase):
    """csrc/inv.cu's C entry on the model, built for the tile `shape` (K, B),
    reading and writing the memory the launcher points it at."""
    assert name == "fp_batch_inv"
    per_thread, threads = shape
    xs = _planes(x, x_stride, n)
    y, idx, valid, zero = _tiles(xs, per_thread, threads)
    blocks = y.shape[1]
    pre = _prefixes(y)
    if phase == 0:
        _planes(totals, t_stride, blocks).copy_(_tree(pre[-1]))
        return
    if phase == 1:
        assert blocks == 1 and totals is None
        c = ft.inv_chain(pre[-1])
    else:
        c = _tree(pre[-1], _planes(totals, t_stride, blocks).clone())
    _planes(out, out_stride, n).copy_(_walk_back(xs, y, pre, c, idx, valid, zero))


def _on_emulated_kernel(monkeypatch, shape=(fk.INV_PER_THREAD, fk.INV_THREADS)) -> list:
    """Points fk's launches at _emulated_fp_batch_inv built for `shape` (and
    inv_plan at that tile); returns the list the phases launched go to."""
    calls = []

    def launch(*args):
        calls.append(args[8])
        _emulated_fp_batch_inv(shape, *args)

    plan = fk.inv_plan
    monkeypatch.setattr(fk._build, "launch", launch)
    monkeypatch.setattr(fk, "inv_plan", lambda n: plan(n, *shape))
    monkeypatch.setattr(fk.torch.cuda, "device", lambda device: contextlib.nullcontext())
    return calls


@pytest.mark.parametrize("n,shape", [(1, (8, 256)), (2049, (8, 256)), (5000, (4, 32)),
                                     ((1 << 12) + 3, (4, 4))])
def test_launch_sequence_on_an_emulated_kernel(n, shape, monkeypatch):
    a = _felts(n, 50 + n)
    wide = torch.cat([_felts(n, 7, zeros=False), a], dim=1)  # a strided view as input
    calls = _on_emulated_kernel(monkeypatch, shape)
    got = fk._batch_inv(wide[:, n:])
    levels = fk.inv_plan(n)
    assert calls == [0] * (len(levels) - 1) + [1] + [2] * (len(levels) - 1)
    assert torch.equal(got, ft.inv(a))
    assert torch.equal(wide[:, n:], a)  # the input is left as it was


# -- the kernel's route against the JAX package -----------------------------------


@pytest.mark.parametrize("n", INV_LENGTHS)
def test_inv_matches_field_pallas_inv_and_field_jnp(n, jax_inverses, monkeypatch):
    """fp_batch_inv's route held to field_pallas.inv (and field_jnp.inv) on
    the same input: the model at the kernel's tile and at a shrunk one (more
    levels), and the launcher's own launches on the emulated kernel."""
    inputs, pallas, jnp_inv = jax_inverses
    a = inputs[n]

    def sample(t):  # what jnp_inv holds of the long inputs: both ends
        return t if n < 1 << 14 else torch.cat([t[:, :500], t[:, -500:]], dim=1)

    routes = {
        "model, kernel tile": model_batch_inv(a, fk.INV_PER_THREAD, fk.INV_THREADS),
        "model, 4 x 4 tile": model_batch_inv(a, 4, 4),
        "fk.inv on the CPU (field_torch.inv)": fk.inv(a),
    }
    _on_emulated_kernel(monkeypatch)
    routes["fk._batch_inv on the emulated kernel"] = fk._batch_inv(a)
    monkeypatch.undo()
    for route, got in routes.items():
        try:
            _same(got, pallas[n])  # n >= 2^14 and n % 128 == 0: its batch scans
            _same(sample(got), jnp_inv[n])
        except AssertionError as e:
            raise AssertionError(f"{route}: {e}") from None
    got = routes["model, kernel tile"]
    assert not got[:, 0].any() and not got[:, n - 1].any()
    nz = ft.is_nonzero(a)
    assert torch.equal(ft.mont_mul(got, a)[:, nz], _one_like(a)[:, nz])


@pytest.mark.parametrize("n", [1, 1000, (1 << 16) + 3])
def test_all_zero_input_maps_to_zero(n):
    a = torch.zeros((4, n), dtype=torch.int32)
    assert not model_batch_inv(a, 4, 4).any()
    assert not fk.inv(a[:, : min(n, 1000)]).any()


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 1 << 22, 1 << 24, 1 << 26, (1 << 31) - 1])
def test_inv_plan_levels_and_launches(n):
    levels = fk.inv_plan(n)
    tile = fk.INV_PER_THREAD * fk.INV_THREADS
    assert levels[0] == n and levels[-1] <= tile
    assert all(levels[i + 1] == -(-levels[i] // tile) for i in range(len(levels) - 1))
    assert 2 * len(levels) - 1 <= (5 if n <= 1 << 27 else 8)  # launches a call
    if n == 1 << 24:
        assert levels == [1 << 24, 1 << 15, 64]
    with pytest.raises(ValueError):
        fk.inv_plan(0)


@pytest.mark.parametrize("per_thread,threads", [(4, 32), (8, 256), (16, 64)])
def test_tile_index_covers_a_tile_once_in_coalesced_steps(per_thread, threads):
    k = np.arange(per_thread)[:, None]
    t = np.arange(threads)[None, :]
    idx = fk.inv_tile_index(3 * per_thread * threads, k, t, threads)
    assert sorted(idx.ravel()) == list(range(3 * per_thread * threads, 4 * per_thread * threads))
    assert (np.diff(idx, axis=1) == 1).all()  # a step: adjacent threads, adjacent elements


# -- the 143-product chain ---------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_inv_chain_matches_inv_ladder_and_fermat(seed, monkeypatch):
    a = _felts(64, seed)  # one length: the ladder's scans compile once
    ja = jnp.asarray(to_reference_limbs(a))
    want = fp._inv_ladder(ja, fj.mont_mul)
    calls = []
    mont_mul = ft.mont_mul
    monkeypatch.setattr(ft, "mont_mul", lambda x, y: calls.append(1) or mont_mul(x, y))
    got = ft.inv_chain(a)
    assert len(calls) == ft.INV_CHAIN_PRODUCTS == 143
    monkeypatch.undo()
    _same(got, want)
    assert torch.equal(got, ft.pow_const(a, PRIME - 2))


# -- fp_pow_const's window schedule -------------------------------------------------


def _pow_by_windows(a: torch.Tensor, exponent: int) -> tuple:
    """fp_pow_const on the plain ops: canonicalise, table x^1..x^15, then
    per window four squarings and a table product. (result, products)."""
    digits = fk.pow_windows(exponent)
    if not digits:
        return _one_like(a), 0
    x = ft.add(a, 0)
    table = [None, x]
    for _ in range(14):
        table.append(ft.mont_mul(table[-1], x))
    products = 14
    r = table[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            r = ft.mont_mul(r, r)
        products += 4
        if d:
            r = ft.mont_mul(r, table[d])
            products += 1
    return r, products


_SEEDED = [int(v) for v in np.random.default_rng(7).integers(0, 1 << 62, size=3, dtype=np.int64)]


@pytest.mark.parametrize("exponent", [0, 1, 15, 16, 17, PRIME - 2, (1 << 128) - 1,
                                      _SEEDED[0], _SEEDED[1] << 64 | _SEEDED[2]])
@pytest.mark.parametrize("canonical", [True, False])
def test_window_schedule_matches_pow_const(exponent, canonical):
    rng = np.random.default_rng(exponent % 1000)
    if canonical:
        a = _felts(48, exponent % 997)
    else:  # any 128-bit input, p and 2^128 - 1 among them
        w = rng.integers(0, 1 << 32, size=(4, 48), dtype=np.uint32)
        for i, e in enumerate((0, PRIME, (1 << 128) - 1, PRIME + 1)):
            w[:, i] = [(e >> (32 * j)) & 0xFFFFFFFF for j in range(4)]
        a = to_tensor(w, "cpu")
    got, products = _pow_by_windows(a, exponent)
    assert torch.equal(got, ft.pow_const(a, exponent))
    assert products == fk.pow_products(exponent) <= 169


def test_window_schedule_digits_and_limits():
    assert fk.pow_windows(0) == [] and fk.pow_windows(1) == [1]
    assert fk.pow_windows(16) == [1, 0] and fk.pow_windows(0xCB7) == [0xC, 0xB, 0x7]
    # 250 by bits; inv takes the 143-product chain
    assert fk.pow_products(PRIME - 2) == 169 > ft.INV_CHAIN_PRODUCTS
    assert fk.pow_products((1 << 128) - 1) == 169
    for e in (-1, 1 << 128):
        with pytest.raises(ValueError):
            fk.pow_windows(e)
