"""PyTorch port, NTT: transforms, coset evaluation and the per-kernel plain
versions against the JAX package, bit for bit (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.ops import ntt as ref_ntt
from stark_anatomy_tpu.ops import ntt_pallas as ntp
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops import ntt_kernels
from stark_anatomy_tpu_torch.ops.field import GENERATOR, PRIME, finv, primitive_root_of_unity
from stark_anatomy_tpu_torch.ops.limbs import mont, random_felt_words, to_tensor
from stark_anatomy_tpu_torch.reference import to_reference_limbs

SIZES = [2, 4, 8, 64, 512, 4096]


def _codeword(n: int, seed: int = 0):
    t = to_tensor(random_felt_words(np.random.default_rng(seed), n), "cpu")
    return t, jnp.asarray(to_reference_limbs(t))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(to_reference_limbs(got), np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_ntt_and_intt_match_reference(n):
    x, jx = _codeword(n, seed=n)
    y = nttmod.ntt(x)
    _same(y, ref_ntt.ntt(jx))
    _same(nttmod.intt(x), ref_ntt.intt(jx))
    assert torch.equal(nttmod.intt(y), x)


@pytest.mark.parametrize("n", [4, 256, 2048])
def test_coset_evaluate_interpolate_lde_match_reference(n):
    x, jx = _codeword(n, seed=n + 1)
    _same(nttmod.coset_evaluate(x, 4 * n, GENERATOR), ref_ntt.coset_evaluate(jx, 4 * n, GENERATOR))
    _same(nttmod.coset_lde(x, 2, GENERATOR), ref_ntt.coset_lde(jx, 2, GENERATOR))
    _same(nttmod.coset_interpolate(x, GENERATOR), ref_ntt.coset_interpolate(jx, GENERATOR))
    assert torch.equal(
        nttmod.coset_interpolate(nttmod.coset_evaluate(x, n, GENERATOR), GENERATOR), x)


def test_matches_pallas_interpret_at_2048():
    # one direction only: interpret-executing the Pallas NTT takes ~20 s
    x, jx = _codeword(2048, seed=9)
    _same(nttmod.ntt(x), ntp._ntt_pallas_impl(jx, False, True))


@pytest.mark.parametrize("n,inverse", [(8, False), (1024, False), (1024, True), (4096, True)])
def test_twiddles_and_powers_match_reference(n, inverse):
    _same(nttmod._twiddles(n, inverse, "cpu"), ref_ntt._twiddles(n, inverse))
    base = 0x1234567 if not inverse else PRIME - 5
    _same(nttmod.powers(base, n - 3, "cpu"), ref_ntt.powers(base, n - 3))


@pytest.mark.parametrize("n,log_block", [(2, 1), (32, 5), (1024, 10), (4096, 3), (4096, 10)])
@pytest.mark.parametrize("inverse", [False, True])
def test_block_then_stage_kernels_plain_versions_compose_to_the_transform(n, log_block, inverse):
    # ntt_block / ntt_stage given CPU tensors take their plain versions; their
    # composition is the decimation-in-time form the CUDA kernels implement.
    x, _ = _codeword(n, seed=3)
    tw = nttmod._twiddles(n, inverse, "cpu")
    scale = mont(finv(n)) if inverse else None
    y = ntt_kernels.ntt_block(x, tw, log_block, scale)
    for s in range(log_block + 1, n.bit_length()):
        assert ntt_kernels.ntt_stage(y, tw, s) is y  # in place
    assert torch.equal(y, ntt_kernels.transform_plain(x, tw, scale))
    assert torch.equal(y, ntt_kernels.transform(x, tw, scale))


def test_rejects_bad_sizes_and_tables():
    x, _ = _codeword(8)
    with pytest.raises(ValueError):
        nttmod.ntt(x[:, :6].contiguous())
    with pytest.raises(ValueError):
        ntt_kernels.transform(x, nttmod._twiddles(16, False, "cpu"))
    with pytest.raises(ValueError):
        ntt_kernels.ntt_block(x, nttmod._twiddles(8, False, "cpu"), 4)
    with pytest.raises(ValueError):
        nttmod.coset_evaluate(x, 4, GENERATOR)


def _grouped_reference(jx, group: int, inverse: bool):
    """grouped_ntt_with_tables in interpret mode; the TPU kernel wants every
    group handed over bit-reversed, the port's takes natural order."""
    n = jx.shape[-1]
    rev = ref_ntt.bit_reverse_indices(group)
    flat = jnp.asarray(np.asarray(jx).reshape(8, n // group, group)[:, :, rev].reshape(8, n))
    early = ntp.stage_tables(group, inverse)[0]
    return ntp.grouped_ntt_with_tables(flat, early, group, inverse, interpret=True)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("group", [2, 8, 128])
@pytest.mark.parametrize("n", [1024, 2048])
def test_grouped_plain_matches_pallas_interpret(n, group, inverse):
    x, jx = _codeword(n, seed=n + group)
    got = nttmod.grouped_ntt(x, group, inverse)
    _same(got, _grouped_reference(jx, group, inverse))
    tw = nttmod._twiddles(group, inverse, "cpu")
    scale = mont(finv(group)) if inverse else None
    assert torch.equal(got, ntt_kernels.ntt_grouped_plain(x, tw, group, scale))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("group,n", [(2, 2), (2, 6), (4, 1028), (16, 48), (64, 4096), (128, 128)])
def test_grouped_is_the_transform_of_every_group(group, n, inverse):
    x, _ = _codeword(n, seed=group + n)
    single = nttmod.intt if inverse else nttmod.ntt
    want = torch.cat([single(x[:, i : i + group].contiguous()) for i in range(0, n, group)], dim=1)
    assert torch.equal(nttmod.grouped_ntt(x, group, inverse), want)


@pytest.mark.parametrize("log_n", [4, 10, 20, 24])
@pytest.mark.parametrize("group", [2, 8, 128])
def test_group_root_is_the_root_the_whole_transform_implies(log_n, group):
    # the four-step NTT's column transforms use w_g = w_n^(n/g)
    n = 1 << log_n
    if group <= n:
        assert pow(primitive_root_of_unity(n), n // group, PRIME) == primitive_root_of_unity(group)


def test_grouped_rejects_bad_groups_and_tables():
    x, _ = _codeword(256)
    for group in (0, 1, 3, 12, 256):
        with pytest.raises(ValueError, match="power of two in"):
            nttmod.grouped_ntt(x, group)
    with pytest.raises(ValueError, match="whole number of groups"):
        nttmod.grouped_ntt(x[:, :100].contiguous(), 8)
    with pytest.raises(ValueError, match="whole number of groups"):
        ntt_kernels.ntt_grouped(x, nttmod._twiddles(16, False, "cpu"), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_kernels.ntt_grouped(x[:, ::2], nttmod._twiddles(8, False, "cpu"), 8)
    with pytest.raises(TypeError):
        ntt_kernels.ntt_grouped(x.to(torch.int64), nttmod._twiddles(8, False, "cpu"), 8)


# -- the pass plan, the multi-stage ntt_stage and the kernels' index model ----


@pytest.mark.parametrize("log_n", range(1, 32))
def test_pass_plan_covers_every_stage_once_within_the_limits(log_n):
    plan = ntt_kernels.pass_plan(log_n)
    assert plan[0][0] == 1 and plan[-1][1] == log_n
    for (_, last), (first, _) in zip(plan, plan[1:]):
        assert first == last + 1
    assert plan[0][1] <= ntt_kernels.LOG_BLOCK_MAX
    assert all(1 <= last - first + 1 <= ntt_kernels.LOG_PASS_MAX for first, last in plan[1:])
    assert len(plan) <= (1 if log_n <= 10 else 2 if log_n <= 20 else 3 if log_n <= 24 else 4)
    for first, last in plan[1:]:
        # a later pass's tile is as wide as tile_cols wants: first - 1 >= t
        assert ntt_kernels.tile_cols(first - 1) >= 3


def test_pass_plan_rejects_sizes_outside_the_kernels():
    for log_n in (0, 32):
        with pytest.raises(ValueError):
            ntt_kernels.pass_plan(log_n)


def _ranges(log_n: int):
    """The plan's passes and a few cuts of 1..log_n that are not the plan's."""
    cuts = [ntt_kernels.pass_plan(log_n)]
    if log_n >= 2:
        cuts.append([(1, 1), (2, log_n)] if log_n - 1 <= ntt_kernels.LOG_PASS_MAX
                    else [(1, 1), (2, 4), (5, log_n)])
        cuts.append([(1, 1)] + [(s, s) for s in range(2, log_n + 1)])
    if log_n >= 8:
        cuts.append([(1, 3), (4, 5), (6, 6), (7, log_n)])
    return cuts


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 8, 1024, 1 << 11, 1 << 13])
def test_block_then_multi_stage_passes_equal_the_transform_and_the_reference(n, inverse):
    x, jx = _codeword(n, seed=n + 17)
    tw = nttmod._twiddles(n, inverse, "cpu")
    scale = mont(finv(n)) if inverse else None
    want = ntt_kernels.transform_plain(x, tw, scale)
    _same(want, (ref_ntt.intt if inverse else ref_ntt.ntt)(jx))
    for cut in _ranges(n.bit_length() - 1):
        y = ntt_kernels.ntt_block(x, tw, cut[0][1], scale)
        for s, last in cut[1:]:
            assert ntt_kernels.ntt_stage(y, tw, s, last) is y  # in place
        assert torch.equal(y, want), cut


@pytest.mark.parametrize("piece", [1, 8, 1 << 7])
def test_the_plain_stage_in_pieces_equals_the_transform_and_the_reference(monkeypatch, piece):
    # ntt_stage_plain bounds its int64 temporaries by computing at most
    # PLAIN_PIECE butterflies at a time: pieces across groups (early stages)
    # and inside a group (late stages) give the stage's values.
    n = 1 << 10
    x, jx = _codeword(n, seed=23)
    tw = nttmod._twiddles(n, False, "cpu")
    monkeypatch.setattr(ntt_kernels, "PLAIN_PIECE", piece)
    got = ntt_kernels.ntt_block_plain(x, tw, 10)
    assert torch.equal(got, ntt_kernels.transform_plain(x, tw))
    _same(got, ref_ntt.ntt(jx))


def test_multi_stage_rejects_bad_ranges():
    x, _ = _codeword(1 << 12)
    tw = nttmod._twiddles(1 << 12, False, "cpu")
    for s, last in ((0, 3), (5, 4), (3, 13), (1, 11)):
        with pytest.raises(ValueError, match="stages must satisfy"):
            ntt_kernels.ntt_stage(x, tw, s, last)


@pytest.mark.parametrize("log_n", [11, 17, 20, 24, 30])
def test_row_and_column_factors_are_entries_of_the_master_table(log_n):
    # what the passes of a 2^log_n-point transform read of the master table:
    # in range, w_(2^m)^e = w_n^(e * n / 2^m), and few (2^(k-1) + 2^(s-1) a pass)
    half = 1 << (log_n - 1)
    w = primitive_root_of_unity(1 << log_n)
    for s, last in ntt_kernels.pass_plan(log_n):
        k = last - s + 1
        for log_m, count in ((k, 1 << (k - 1)), (last, 1 << (s - 1))):
            e = np.unique(np.concatenate([np.arange(min(count, 4)), [count - 1]])).astype(np.int64)
            index = ntt_kernels.master_index(log_n, log_m, e)
            assert index.max() < half and len(np.unique(index)) == len(e)
            w_m = primitive_root_of_unity(1 << log_m)
            for ee, ii in zip(e.tolist(), index.tolist()):
                assert pow(w_m, ee, PRIME) == pow(w, ii, PRIME)


def _grid(tiles: int, rows: int, cols: int):
    """Index arrays (tile, row, column) of shape (tiles, rows, cols)."""
    return np.meshgrid(np.arange(tiles), np.arange(rows), np.arange(cols), indexing="ij")


def _is_permutation(idx: np.ndarray, size: int) -> bool:
    return np.array_equal(np.sort(idx.reshape(-1)), np.arange(size))


BLOCK_TILES = [(12, 4, 2), (12, 3, 0), (12, 5, 3), (6, 6, 0), (5, 1, 4), (12, 10, 2)]
STAGE_TILES = [(12, 4, 4, 2), (12, 4, 8, 3), (12, 8, 4, 4), (12, 3, 1, 3), (12, 0, 2, 0), (12, 9, 3, 3)]


@pytest.mark.parametrize("log_n,k,t", BLOCK_TILES)
def test_block_index_maps_are_permutations(log_n, k, t):
    tile, r, c = _grid(1 << (log_n - k - t), 1 << k, 1 << t)
    assert _is_permutation(ntt_kernels.block_source_index(log_n, k, t, tile, r, c), 1 << log_n)
    assert _is_permutation(ntt_kernels.block_output_index(log_n, k, t, tile, r, c), 1 << log_n)
    shared = ntt_kernels.block_shared_index(k, t, r[0], c[0])
    assert len(np.unique(shared)) == shared.size and shared.max() < ((1 << t) | 1) << k
    # a column is one transform: its results are one run of 2^k outputs
    out = ntt_kernels.block_output_index(log_n, k, t, tile, r, c)
    assert np.array_equal(out[:, 1:, :] - out[:, :-1, :], np.ones_like(out[:, 1:, :]))


@pytest.mark.parametrize("log_n,s0,k,t", STAGE_TILES)
def test_stage_index_map_is_a_permutation_in_runs_of_the_tile_row(log_n, s0, k, t):
    tile, i, c = _grid(1 << (log_n - k - t), 1 << k, 1 << t)
    g = ntt_kernels.stage_global_index(s0, k, t, tile, i, c)
    assert _is_permutation(g, 1 << log_n)
    assert np.array_equal(g[:, :, 1:] - g[:, :, :-1], np.ones_like(g[:, :, 1:]))
    assert np.array_equal(g[:, 1:, :] - g[:, :-1, :], np.full_like(g[:, 1:, :], 1 << s0))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_pair_rows_cover_the_tile_once_a_stage(k):
    rp = np.arange(1 << (k - 1))
    for u in range(1, k + 1):
        lo, hi, ip = ntt_kernels.pair_rows(u, rp)
        assert _is_permutation(np.concatenate([lo, hi]), 1 << k)
        assert np.array_equal(hi - lo, np.full_like(lo, 1 << (u - 1)))
        assert np.array_equal(ip, lo % (1 << (u - 1)))
        assert ntt_kernels.row_twiddle_index(k, u, ip).max() < max(1, 1 << (k - 1))


@pytest.mark.parametrize("k", [2, 3, 8])
def test_quad_rows_are_the_pairs_of_two_stages(k):
    rq = np.arange(1 << (k - 2))
    for u in range(1, k):
        (r0, r1, r2, r3), ip = ntt_kernels.quad_rows(u, rq)
        assert _is_permutation(np.concatenate([r0, r1, r2, r3]), 1 << k)

        def pairs_of(stage):
            lo, hi, i_prime = ntt_kernels.pair_rows(stage, np.arange(1 << (k - 1)))
            return set(zip(lo.tolist(), hi.tolist(), i_prime.tolist()))

        h = 1 << (u - 1)
        assert pairs_of(u) == set(zip(r0.tolist(), r1.tolist(), ip.tolist())) | \
            set(zip(r2.tolist(), r3.tolist(), ip.tolist()))
        assert pairs_of(u + 1) == set(zip(r0.tolist(), r2.tolist(), ip.tolist())) | \
            set(zip(r1.tolist(), r3.tolist(), (ip + h).tolist()))


def _model_stages(sm, row_stride, k, t, row_tab, col_tab=None):
    """The kernels' tile_stages on (4, tiles, shared size) words, through the
    index maps and the plain field operations: stages two at a time over row
    quads, a last single stage over row pairs where k is odd."""
    from stark_anatomy_tpu_torch.ops import field_torch as ft

    tiles = sm.shape[1]

    def twiddle(u, ip, c):
        w = row_tab[:, torch.from_numpy(ntt_kernels.row_twiddle_index(k, u, ip).reshape(-1))]
        w = w[:, None, :].expand(4, tiles, -1)
        if col_tab is None:
            return w.reshape(4, -1)
        factor = col_tab.reshape(4, -1)  # (4, tiles, 2^t): the tile's column entries
        for _ in range(ntt_kernels.column_twiddle_power(k, u).bit_length() - 1):
            factor = ft.mont_mul(factor, factor)
        factor = factor.reshape(4, tiles, 1 << t)[:, :, torch.from_numpy(c.reshape(-1))]
        return ft.mont_mul(w.reshape(4, -1), factor.reshape(4, -1))

    def butterfly(lo, hi, c, w):
        lo_i = torch.from_numpy((lo * row_stride + c).reshape(-1))
        hi_i = torch.from_numpy((hi * row_stride + c).reshape(-1))
        e = sm[:, :, lo_i].reshape(4, -1)
        o = ft.mont_mul(sm[:, :, hi_i].reshape(4, -1), w)
        sm[:, :, lo_i] = ft.add(e, o).reshape(4, tiles, -1)
        sm[:, :, hi_i] = ft.sub(e, o).reshape(4, tiles, -1)

    u = 1
    while u < k:
        rq, c = np.meshgrid(np.arange(1 << (k - 2)), np.arange(1 << t), indexing="ij")
        (r0, r1, r2, r3), ip = ntt_kernels.quad_rows(u, rq)
        w0, w1, w2 = twiddle(u, ip, c), twiddle(u + 1, ip, c), twiddle(u + 1, ip + (1 << (u - 1)), c)
        butterfly(r0, r1, c, w0)
        butterfly(r2, r3, c, w0)
        butterfly(r0, r2, c, w1)
        butterfly(r1, r3, c, w2)
        u += 2
    if u == k:
        rp, c = np.meshgrid(np.arange(1 << (k - 1)), np.arange(1 << t), indexing="ij")
        lo, hi, ip = ntt_kernels.pair_rows(u, rp)
        butterfly(lo, hi, c, twiddle(u, ip, c))
    return sm


def _master(log_n, log_m, count):
    """Where the first `count` powers of w_(2^log_m) lie in the master table."""
    return torch.from_numpy(ntt_kernels.master_index(log_n, log_m, np.arange(count, dtype=np.int64)))


def _model_block(x, tw, k, t, scale):
    from stark_anatomy_tpu_torch.ops import field_torch as ft

    log_n = x.shape[1].bit_length() - 1
    tiles = 1 << (log_n - k - t)
    tile, r, c = _grid(tiles, 1 << k, 1 << t)
    row_stride = (1 << t) | 1
    v = x[:, torch.from_numpy(ntt_kernels.block_source_index(log_n, k, t, tile, r, c).reshape(-1))]
    if scale is not None:
        v = ft.mont_mul(v, scale)
    sm = torch.zeros((4, tiles, row_stride << k), dtype=torch.int32)
    shared = torch.from_numpy(ntt_kernels.block_shared_index(k, t, r[0], c[0]).reshape(-1))
    sm[:, :, shared] = v.reshape(4, tiles, -1)
    row_tab = tw[:, _master(log_n, k, max(1, 1 << (k - 1)))]
    sm = _model_stages(sm, row_stride, k, t, row_tab)
    out = torch.zeros_like(x)
    where = torch.from_numpy(ntt_kernels.block_output_index(log_n, k, t, tile, r, c).reshape(-1))
    out[:, where] = sm[:, :, torch.from_numpy((r[0] * row_stride + c[0]).reshape(-1))].reshape(4, -1)
    return out


def _model_stage(y, tw, s, last, t):
    log_n = y.shape[1].bit_length() - 1
    s0, k = s - 1, last - s + 1
    tiles = 1 << (log_n - k - t)
    tile, i, c = _grid(tiles, 1 << k, 1 << t)
    where = torch.from_numpy(ntt_kernels.stage_global_index(s0, k, t, tile, i, c).reshape(-1))
    sm = y[:, where].reshape(4, tiles, -1).clone()  # shared index i * 2^t + c
    row_tab = tw[:, _master(log_n, k, max(1, 1 << (k - 1)))]
    col_all = tw[:, _master(log_n, last, 1 << s0)]
    c0 = (np.arange(tiles) & ((1 << (s0 - t)) - 1)) << t
    col_tab = col_all[:, torch.from_numpy((c0[:, None] + np.arange(1 << t)[None, :]).reshape(-1))]
    sm = _model_stages(sm, 1 << t, k, t, row_tab, col_tab.reshape(4, tiles, 1 << t))
    out = torch.zeros_like(y)
    out[:, where] = sm.reshape(4, -1)
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("passes", [
    [(4, 2), (4, 2), (4, 3)],     # three passes of four stages
    [(3, 0), (5, 3), (4, 1)],     # narrow and single-column tiles
    [(5, 3), (1, 0), (6, 4)],     # a single-stage pass in the middle
    [(12, 0)],                    # one block
    [(2, 4), (10, 2)],            # a tile taller than it is wide
])
def test_index_model_through_plain_field_ops_reproduces_the_transform(passes, inverse):
    n = 1 << 12
    x, _ = _codeword(n, seed=41)
    tw = nttmod._twiddles(n, inverse, "cpu")
    scale = mont(finv(n)) if inverse else None
    (k0, t0), later = passes[0], passes[1:]
    y = _model_block(x, tw, k0, t0, scale)
    assert torch.equal(y, ntt_kernels.ntt_block_plain(x, tw, k0, scale))
    s = k0 + 1
    for k, t in later:
        got = _model_stage(y, tw, s, s + k - 1, t)
        assert torch.equal(got, ntt_kernels.ntt_stage(y, tw, s, s + k - 1))
        y, s = got, s + k
    assert s == 13 and torch.equal(y, ntt_kernels.transform_plain(x, tw, scale))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,s0,k", [(12, 4, 8), (12, 4, 4), (13, 0, 5), (10, 9, 1), (16, 8, 8)])
def test_twiddle_factorisation_equals_the_master_table(log_n, s0, k, inverse):
    # w_(2^(s0+u))^c * w_(2^u)^i' = tw[(i' * 2^s0 + c) << (log_n - s0 - u)]
    from stark_anatomy_tpu_torch.ops import field_torch as ft

    tw = nttmod._twiddles(1 << log_n, inverse, "cpu")
    row_tab = tw[:, _master(log_n, k, max(1, 1 << (k - 1)))]
    col_tab = tw[:, _master(log_n, s0 + k, 1 << s0)]
    cs = np.unique(np.concatenate([np.arange(min(1 << s0, 8)), [(1 << s0) - 1]]))
    for u in range(1, k + 1):
        ip, c = np.meshgrid(np.arange(1 << (u - 1)), cs, indexing="ij")
        factor = ft.pow_const(col_tab[:, torch.from_numpy(c.reshape(-1))],
                              ntt_kernels.column_twiddle_power(k, u))
        row = row_tab[:, torch.from_numpy(ntt_kernels.row_twiddle_index(k, u, ip).reshape(-1))]
        master = tw[:, torch.from_numpy((((ip << s0) + c) << (log_n - s0 - u)).reshape(-1))]
        assert torch.equal(ft.mont_mul(row, factor), master)
