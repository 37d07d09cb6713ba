"""PyTorch port, the mesh path: sharded NTT / LDE / commit and Stark(mesh=)
against the JAX package on its 8-virtual-device CPU mesh and against the
port's own single-device path, bit for bit (tolerance 0: exact integer math).
The port's mesh here is S shards in a world of one process on the CPU, made
without a process group or through a one-process gloo group; two and four
processes: tests/test_torch_multiprocess.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.iop.stark import Stark as RefStark
from stark_anatomy_tpu.models.rescue_prime import RescuePrime as RefRescuePrime
from stark_anatomy_tpu.models.rescue_prime import RescuePrimeAir as RefRescuePrimeAir
from stark_anatomy_tpu.ops import ntt as ref_ntt
from stark_anatomy_tpu.parallel import merkle_sharded as ref_merkle
from stark_anatomy_tpu.parallel import mesh as ref_mesh
from stark_anatomy_tpu.parallel import ntt_sharded as ref_sharded
from stark_anatomy_tpu_torch.iop.merkle import commit_columns
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops.field import GENERATOR
from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_numpy, to_tensor
from stark_anatomy_tpu_torch.parallel import (
    CYCLIC,
    NATURAL,
    Mesh,
    commit_sharded,
    distributed,
    make_mesh,
    sharded_coset_evaluate,
    sharded_lde,
    sharded_ntt,
)
from stark_anatomy_tpu_torch.iop import stark as stark_module
from stark_anatomy_tpu_torch.parallel import mesh as meshmod
from stark_anatomy_tpu_torch.parallel.mesh import block_start, gather, pair_exchange, roll_left, upload_block
from stark_anatomy_tpu_torch.parallel.ntt_sharded import gathered_powers
from stark_anatomy_tpu_torch.reference import (
    cyclic_to_natural,
    from_reference_limbs,
    merkle_levels_as_rows,
    natural_to_cyclic,
    to_reference_limbs,
)

LAYOUTS = [(NATURAL, NATURAL), (NATURAL, CYCLIC), (CYCLIC, NATURAL)]
SEED = b"mesh"


@pytest.fixture(scope="module")
def ref_mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return ref_mesh.make_mesh(8)


def _codeword(n: int, seed: int) -> torch.Tensor:
    """Montgomery-form (4, n) planes from seeded numpy draws."""
    return fk.to_mont(to_tensor(random_felt_words(np.random.default_rng(seed), n), "cpu"))


def _on_ref_mesh(t: torch.Tensor, mesh):
    return jax.device_put(jnp.asarray(to_reference_limbs(t)), ref_mesh.codeword_sharding(mesh))


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(to_reference_limbs(got), np.asarray(want))


def _relayout(t: torch.Tensor, shards: int, to_cyclic: bool) -> torch.Tensor:
    fn = natural_to_cyclic if to_cyclic else cyclic_to_natural
    return to_tensor(fn(to_numpy(t), shards), "cpu")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("layout_in,layout_out", LAYOUTS)
def test_sharded_ntt_matches_reference_in_stored_order(ref_mesh8, layout_in, layout_out, inverse):
    x = _codeword(1024, seed=1)
    if layout_in == CYCLIC:
        x = _relayout(x, 8, to_cyclic=True)
    got = sharded_ntt(x, make_mesh(8, "cpu"), inverse, layout_in, layout_out)
    want = ref_sharded.sharded_ntt(
        _on_ref_mesh(x, ref_mesh8), ref_mesh8, inverse, layout_in, layout_out)
    _same(got, want)


@pytest.mark.parametrize("layout_in,layout_out", LAYOUTS)
@pytest.mark.parametrize("shards", [2, 4, 8, 128])
def test_sharded_ntt_equals_the_single_device_transform(shards, layout_in, layout_out):
    n = max(256, shards * shards)
    x = _codeword(n, seed=shards)
    mesh = make_mesh(shards, "cpu")
    given = _relayout(x, shards, to_cyclic=True) if layout_in == CYCLIC else x
    for inverse in (False, True):
        got = sharded_ntt(given, mesh, inverse, layout_in, layout_out)
        if layout_out == CYCLIC:
            got = _relayout(got, shards, to_cyclic=False)
        assert torch.equal(got, nttmod.intt(x) if inverse else nttmod.ntt(x))
    back = sharded_ntt(sharded_ntt(x, mesh), mesh, inverse=True)
    assert torch.equal(back, x)


@pytest.mark.parametrize("layout_in", [NATURAL, CYCLIC])
def test_sharded_coset_evaluate_matches_reference(ref_mesh8, layout_in):
    coeffs = _codeword(128, seed=2)
    want_single = nttmod.coset_evaluate(coeffs, 512, GENERATOR)
    given = _relayout(coeffs, 8, to_cyclic=True) if layout_in == CYCLIC else coeffs
    got = sharded_coset_evaluate(given, 512, GENERATOR, make_mesh(8, "cpu"), layout_in)
    assert torch.equal(got, want_single)
    want = ref_sharded.sharded_coset_evaluate(
        _on_ref_mesh(given, ref_mesh8), 512, GENERATOR, ref_mesh8, layout_in)
    _same(got, want)
    # no padding: the domain is the polynomial's own length
    got = sharded_coset_evaluate(given, 128, GENERATOR, make_mesh(8, "cpu"), layout_in)
    assert torch.equal(got, nttmod.coset_evaluate(coeffs, 128, GENERATOR))


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_lde_matches_reference(shards):
    x = _codeword(512, seed=10)
    got = sharded_lde(x, 2048, GENERATOR, make_mesh(shards, "cpu"))
    assert torch.equal(got, nttmod.coset_evaluate(nttmod.intt(x), 2048, GENERATOR))
    if shards == 8:
        mesh = ref_mesh.make_mesh(shards)
        _same(got, ref_sharded.sharded_lde(_on_ref_mesh(x, mesh), 2048, GENERATOR, mesh))


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("shards", [2, 8, 64])
def test_commit_sharded_matches_reference_and_commit_columns(shards, pair):
    rng = np.random.default_rng(3)
    n = 256
    cols = [to_tensor(random_felt_words(rng, n), "cpu") for _ in range(2)]
    tree = commit_sharded(cols, make_mesh(shards, "cpu"), pair=pair)
    single = commit_columns(cols, pair=pair)
    leaves = n // 2 if pair else n
    opened = (0, 1, 100, leaves - 1)
    assert tree.root == single.root and tree.pair_leaves == pair
    assert [tree.open(i) for i in opened] == [single.open(i) for i in opened]
    assert tree.open_multi(opened) == single.open_multi(opened)
    levels, want_levels = merkle_levels_as_rows(tree), merkle_levels_as_rows(single)
    assert len(levels) == len(want_levels) == leaves.bit_length()
    for got, want in zip(levels, want_levels):
        np.testing.assert_array_equal(got, want)
    if shards <= 8:
        mesh = ref_mesh.make_mesh(shards)
        ref_tree = ref_merkle.commit_sharded(
            [jnp.asarray(to_reference_limbs(c)) for c in cols], mesh, pair=pair)
        assert tree.root == ref_tree.root
        assert [tree.open(i) for i in opened] == [ref_tree.open(i) for i in opened]
        assert tree.open_multi(opened) == ref_tree.open_multi(opened)
        for got, want in zip(levels, merkle_levels_as_rows(ref_tree)):
            np.testing.assert_array_equal(got, want)


def test_commit_sharded_falls_through_for_tiny_or_indivisible_blocks():
    rng = np.random.default_rng(4)
    cols = [to_tensor(random_felt_words(rng, 8), "cpu")]
    for shards in (1, 8, 16, 3):  # one shard, one leaf a shard (pair), none, indivisible
        tree = commit_sharded(cols, make_mesh(shards, "cpu"), pair=True)
        assert tree.root == commit_columns(cols, pair=True).root


@pytest.mark.parametrize("layout_in,layout_out,exchanges", [
    (NATURAL, CYCLIC, 2), (CYCLIC, NATURAL, 2), (NATURAL, NATURAL, 3)])
def test_sharded_ntt_exchange_counts(layout_in, layout_out, exchanges):
    # the layout-typed transforms spend exactly two all-to-alls, the least for
    # a factorised transform; only natural -> natural pays the reorder
    mesh = make_mesh(8, "cpu")
    x = _codeword(4096, seed=5)
    assert mesh.exchanges == 0
    sharded_ntt(x, mesh, layout_in=layout_in, layout_out=layout_out)
    assert mesh.exchanges == exchanges
    before = mesh.exchanges
    sharded_lde(x, 4 * 4096, GENERATOR, mesh)
    assert mesh.exchanges - before == 4


@pytest.mark.parametrize("layout_in,layout_out", LAYOUTS)
def test_sharded_ntt_on_more_than_128_shards_equals_the_single_device_transforms(layout_in, layout_out):
    # S = 256 > 128: the column transforms leave grouped_ntt for one
    # transform a column; the reference takes the same meshes
    shards, n = 256, 1 << 16
    x = _codeword(n, seed=12)
    mesh = make_mesh(shards, "cpu")
    given = _relayout(x, shards, to_cyclic=True) if layout_in == CYCLIC else x
    jx = jnp.asarray(to_reference_limbs(x))
    for inverse in (False, True):
        got = sharded_ntt(given, mesh, inverse, layout_in, layout_out)
        if layout_out == CYCLIC:
            got = _relayout(got, shards, to_cyclic=False)
        assert torch.equal(got, nttmod.intt(x) if inverse else nttmod.ntt(x))
        _same(got, (ref_ntt.intt if inverse else ref_ntt.ntt)(jx))


def test_sharded_ntt_rejects_what_the_four_step_does_not_take():
    # n = 32 on 8 shards: S | n but not n/S = 4
    with pytest.raises(ValueError, match="divide"):
        sharded_ntt(_codeword(32, seed=6), make_mesh(8, "cpu"))
    with pytest.raises(ValueError, match="cyclic->cyclic"):
        sharded_ntt(_codeword(256, seed=6), make_mesh(8, "cpu"), layout_in=CYCLIC, layout_out=CYCLIC)
    with pytest.raises(ValueError, match="unknown layout"):
        sharded_ntt(_codeword(256, seed=6), make_mesh(8, "cpu"), layout_out="strided")
    with pytest.raises(ValueError, match="longer than the target domain"):
        sharded_coset_evaluate(_codeword(256, seed=6), 128, GENERATOR, make_mesh(8, "cpu"))


def test_mesh_of_one_shard_is_the_single_device_transform():
    x = _codeword(64, seed=4)
    mesh = make_mesh(1, "cpu")
    assert torch.equal(sharded_ntt(x, mesh), nttmod.ntt(x))
    assert torch.equal(sharded_ntt(x, mesh, inverse=True), nttmod.intt(x))
    assert mesh.exchanges == 0


def _tiled_all_to_all(blocks, split_axis, concat_axis):
    """jax.lax.all_to_all(..., tiled=True) on a list of per-shard numpy arrays."""
    s = len(blocks)
    chunks = [np.split(b, s, axis=split_axis) for b in blocks]
    return [np.concatenate([chunks[src][dst] for src in range(s)], axis=concat_axis)
            for dst in range(s)]


@pytest.mark.parametrize("split_axis,concat_axis", [(2, 2), (3, 2), (2, 3), (3, 3)])
def test_all_to_all_is_the_tiled_exchange_over_the_shards(split_axis, concat_axis):
    s = 4
    rng = np.random.default_rng(7)
    y = rng.integers(0, 1 << 31, size=(3, s, 8, 12), dtype=np.int64).astype(np.int32)
    mesh = make_mesh(s, "cpu")
    got = mesh.all_to_all(torch.from_numpy(y), split_axis, concat_axis).numpy()
    want = _tiled_all_to_all([y[:, d] for d in range(s)], split_axis - 1, concat_axis - 1)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    assert mesh.exchanges == 1
    with pytest.raises(ValueError, match="does not split"):
        mesh.all_to_all(torch.zeros((3, s, 6, 12), dtype=torch.int32), 2, 2)
    with pytest.raises(ValueError, match="axes >= 2"):
        mesh.all_to_all(torch.from_numpy(y), 1, 2)


def test_mesh_defaults_to_the_card_and_checks_its_shape(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(8)
    mesh = make_mesh(8, "cpu")
    assert (mesh.shards, mesh.world, mesh.rank, mesh.local_shards) == (8, 1, 0, 8)
    assert mesh == make_mesh(8, "cpu") and mesh != make_mesh(4, "cpu")
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, "cpu")
    # a group of three processes cannot share eight shards
    monkeypatch.setattr(meshmod.dist, "get_world_size", lambda group: 3)
    with pytest.raises(ValueError, match="must divide"):
        Mesh(8, torch.device("cpu"), group=object())


def test_mesh_tables_are_cached_and_cleared_with_the_twiddles():
    nttmod.clear_twiddle_cache()
    mesh = make_mesh(8, "cpu")
    x = _codeword(256, seed=8)
    sharded_ntt(x, mesh, layout_out=CYCLIC)
    cached = len(nttmod._TABLE_CACHE)
    assert cached == 1 and nttmod._TWIDDLE_CACHE
    sharded_ntt(x, make_mesh(8, "cpu"), layout_out=CYCLIC)  # another mesh, the same tables
    assert len(nttmod._TABLE_CACHE) == cached
    sharded_ntt(x, mesh, inverse=True, layout_out=CYCLIC)
    assert len(nttmod._TABLE_CACHE) == cached + 1
    nttmod.clear_twiddle_cache()
    assert not nttmod._TABLE_CACHE and not nttmod._TWIDDLE_CACHE


def test_the_mesh_launches_nothing_on_the_cpu():
    before = _build.launch_counts()
    sharded_ntt(_codeword(256, seed=9), make_mesh(8, "cpu"))
    assert _build.launch_counts() == before and before["ntt_grouped"] == 0


def _no_distributed_env(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)


def test_distributed_init_single_process(monkeypatch):
    # no configuration: a no-op returning False; rank 0 is the controller
    _no_distributed_env(monkeypatch)
    assert distributed.init() is False
    assert distributed.init(device="cpu") is False
    assert distributed.world_group() is None
    assert distributed.process_index() == 0
    assert distributed.is_controller()


def test_distributed_init_requires_coordinator(monkeypatch):
    # a multi-process run without a coordinator is a configuration error,
    # not a silent single-process run
    _no_distributed_env(monkeypatch)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init(num_processes=4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init(device="cpu")


@pytest.fixture(scope="module")
def chain1():
    """Chain 1, two colinearity checks: the inputs, the port's single-device
    proof and the JAX package's, one seed."""
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    trace = rp.trace(4242)
    boundary = air.boundary_constraints(rp.hash(4242))
    single = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    ref_rp = RefRescuePrime()
    ref_air = RefRescuePrimeAir(ref_rp, chain_length=1)
    ref = RefStark(ref_air, expansion_factor=4, num_colinearity_checks=2)
    ref_proof = ref.prove(ref_rp.trace(4242), ref_air.boundary_constraints(ref_rp.hash(4242)),
                          randomizer_seed=SEED)
    return air, trace, boundary, single.prove(trace, boundary, randomizer_seed=SEED), ref_proof


@pytest.fixture
def one_process_group(tmp_path, monkeypatch):
    """A torch.distributed group of this process alone (gloo), destroyed
    after the test."""
    _no_distributed_env(monkeypatch)
    assert distributed.init("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    yield distributed.world_group()
    torch.distributed.destroy_process_group()


#: how a mesh's world of one process is made: without a process group, or
#: through a torch.distributed group of this process alone
GROUPS = ["no-group", "one-process-group"]


def _group(request, how: str):
    return request.getfixturevalue("one_process_group") if how == "one-process-group" else None


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("shards", [2, 8])
def test_prove_on_a_mesh_gives_the_single_device_bytes(chain1, request, shards, group):
    # a mesh is block-local in every world, one process with or without a group
    air, trace, boundary, single_proof, ref_proof = chain1
    mesh = make_mesh(shards, "cpu", group=_group(request, group))
    assert (mesh.world, mesh.rank) == (1, 0)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=mesh)
    assert stark.device == "cpu" and stark.fri.mesh is mesh
    proof = stark.prove(trace, boundary, randomizer_seed=SEED)
    # four exchanges a trace column's LDE, two a coset evaluation from
    # cyclic coefficients: the zk randomizer, the excluded-row factor
    assert mesh.exchanges == 4 * air.num_registers + 2 * 2
    assert proof == single_proof
    assert proof == ref_proof
    assert stark.verify(proof, boundary)
    assert Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu").verify(proof, boundary)


def test_prove_on_a_mesh_too_wide_for_the_domain_takes_the_single_device_transform(chain1):
    air, trace, boundary, single_proof, _ = chain1
    mesh = make_mesh(32, "cpu")  # 32 does not divide O / 32: no four-step transform
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=mesh)
    assert stark.prove(trace, boundary, randomizer_seed=SEED) == single_proof
    # the trace columns (O = 64) and the zk coefficients (256) are shorter
    # than S^2 = 1024 and are transformed whole; the excluded-row factor's
    # coefficients are zero-padded to S^2 = F, which the four-step takes
    assert mesh.exchanges == 2


@pytest.mark.parametrize("group", GROUPS)
def test_resume_under_a_mesh_gives_the_same_bytes(chain1, tmp_path, request, group):
    air, trace, boundary, single_proof, _ = chain1
    group, ckpt = _group(request, group), tmp_path / "ckpt"
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=make_mesh(8, "cpu", group=group))
    first = stark.prove(trace, boundary, randomizer_seed=SEED, checkpoint_dir=str(ckpt))
    assert first == single_proof and (ckpt / "stark-pre-fri.npz").exists()
    mesh = make_mesh(8, "cpu", group=group)
    resumed = Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=mesh).prove(
        trace, boundary, randomizer_seed=SEED, checkpoint_dir=str(ckpt))
    assert resumed == single_proof
    assert mesh.exchanges == 0  # nothing was transformed again
    # the snapshot does not depend on the mesh: a prover without one resumes from it
    plain = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    assert plain.prove(trace, boundary, randomizer_seed=SEED,
                       checkpoint_dir=str(ckpt)) == single_proof


@pytest.mark.parametrize("count,start", [(1, 0), (7, 5), (64, 0), (100, 29), (256, 1000)])
def test_powers_from_a_start_exponent_are_a_block_of_the_longer_table(count, start):
    base = GENERATOR
    assert torch.equal(nttmod.powers(base, count, "cpu", start=start),
                       nttmod.powers(base, start + count, "cpu")[:, start:])
    with pytest.raises(ValueError, match="start"):
        nttmod.powers(base, count, "cpu", start=-1)


@pytest.mark.parametrize("n", [1, 2, 8, 512, 4096])
def test_gathered_powers_equal_entries_of_the_whole_table(n):
    # the block-local tables take base^e as a product of two entries of
    # tables about sqrt(n) long; the values are the whole table's
    rng = np.random.default_rng(n)
    e = torch.from_numpy(rng.integers(0, n, size=300)).reshape(3, 100)
    want = nttmod.powers(GENERATOR, n, "cpu").index_select(1, e.reshape(-1))
    assert torch.equal(gathered_powers(GENERATOR, n, e), want)


def test_block_helpers_without_a_group_see_one_whole_block():
    mesh = make_mesh(8, "cpu")
    x = _codeword(64, seed=13)
    assert block_start(64, mesh) == 0
    assert torch.equal(gather(x, mesh), x) and torch.equal(pair_exchange(x, mesh), torch.cat([x[:, :32], x[:, 32:]]))
    for e in (0, 5, 64, 70):
        assert torch.equal(roll_left(x, e, mesh), torch.roll(x, -e, 1))
    got = mesh.owner_gather([(x, [63, 0, 9, 9]), (x[:2].contiguous(), torch.tensor([3]))])
    assert [tuple(g.shape) for g in got] == [(4, 4), (2, 1)]
    assert torch.equal(got[0], x[:, [63, 0, 9, 9]]) and torch.equal(got[1], x[:2, [3]])
    assert torch.equal(upload_block(to_numpy(x), mesh, "cpu"), x)


@pytest.mark.parametrize("start,count", [(0, 96), (8, 40), (30, 7), (0, 12)])
def test_a_tile_of_a_period_is_the_slice_of_the_repeated_period(start, count):
    period = _codeword(12, seed=14)
    want = period.repeat(1, (start + count) // 12 + 1)[:, start : start + count]
    assert torch.equal(stark_module._tile(period, start, count), want)


def test_reference_index_maps_are_inverse_and_match_the_documented_layout():
    arr = np.arange(2 * 32, dtype=np.uint32).reshape(2, 32)
    cyc = natural_to_cyclic(arr, 8)
    # stored index i1 * n/S + j holds element i1 + S * j
    assert cyc[0, 3 * 4 + 2] == arr[0, 3 + 8 * 2]
    np.testing.assert_array_equal(cyclic_to_natural(cyc, 8), arr)
    x = from_reference_limbs(to_reference_limbs(_codeword(32, seed=11)), device="cpu")
    assert torch.equal(_relayout(_relayout(x, 8, True), 8, False), x)
