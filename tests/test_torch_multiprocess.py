"""PyTorch port, the mesh across processes: OS processes joined by
``torch.distributed`` (gloo, CPU tensors) share one mesh.

Two processes hold S = 8 and S = 2 shards between them and run the sharded
NTT in its three layouts, the sharded LDE and coset evaluation, the sharded
pair-leaf commit, the three collectives of the block-local prover
(``roll_left``, ``Mesh.owner_gather``, ``pair_exchange``), the prover's
next-row codeword and a FRI fold of a block; what every process gathers equals the single-device result bit for
bit (tolerance 0).

Then ``Stark.prove`` itself on a mesh of 8 shards spread over W processes,
each holding only its (4, F/W) block of every codeword: Rescue-Prime chain 1
on W = 1, 2 and 4 processes (one process is a group of one: the code path a
single card runs) gives the golden bytes of the JAX package on every rank;
Fibonacci, MiMC and MiMC with dense constant columns on W = 2 give the
single-device port proof; a checkpointed W = 2 prove writes the files of a
single-process prove and resumes to the same bytes; and at W = 2 no 4-plane
int32 tensor wider than F/W columns is created inside ``prove``.

This file is also the worker: ``python tests/test_torch_multiprocess.py
STORE WORLD RANK OUT TASKS`` joins the group through the ``file://`` store
STORE, runs the comma-separated TASKS and writes its results to OUT (an
``.npz``)."""

import filecmp
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from stark_anatomy_tpu_torch.iop.fri import fold  # noqa: E402
from stark_anatomy_tpu_torch.iop.merkle import commit_columns  # noqa: E402
from stark_anatomy_tpu_torch.iop.stark import Stark  # noqa: E402
from stark_anatomy_tpu_torch.models.fibonacci import FibonacciAir  # noqa: E402
from stark_anatomy_tpu_torch.models.mimc import MiMCAir, mimc  # noqa: E402
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir  # noqa: E402
from stark_anatomy_tpu_torch.ops import ntt as nttmod  # noqa: E402
from stark_anatomy_tpu_torch.ops.field import GENERATOR, primitive_root_of_unity  # noqa: E402
from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_numpy, to_tensor  # noqa: E402
from stark_anatomy_tpu_torch.parallel import (  # noqa: E402
    CYCLIC,
    commit_sharded,
    distributed,
    host_gather,
    make_mesh,
    shard,
    sharded_coset_evaluate,
    sharded_lde,
    sharded_ntt,
)
from stark_anatomy_tpu_torch.parallel.mesh import pair_exchange, roll_left  # noqa: E402
from stark_anatomy_tpu_torch.reference import merkle_levels_as_rows, natural_to_cyclic  # noqa: E402

WORLD = 2
SHARD_COUNTS = (8, 2)
N = 1024
OPENED = (0, 5, N // 2 - 1)
#: the prove's mesh, and the worlds that share it
PROVE_SHARDS = 8
PROVE_WORLDS = (1, 2, 4)
#: FRI codewords of at most this length finish on the host: 1024, 512, 256
#: and 128 fold on the device, so folds cross processes at every W
HOST_TAIL_N = 64
GOLDEN = os.path.join(ROOT, "tests", "golden", "proof_rescue_chain1.json")
INPUT = 20260817
SEED = b"golden-v1"
MIMC_INPUT = 31337
AIRS = ("fibonacci", "mimc", "mimc-dense")
#: shifts of roll_left on N columns over WORLD processes: none, within a block
#: (a halo from the next one), a whole block, past one, past the whole array
ROLL_SHIFTS = (0, 3, N // WORLD - 1, N // WORLD, N // WORLD + 5, N - 1, N + 3)
#: next-row shifts of Stark._next_rows: within a block and past one
NEXT_ROW_SHIFTS = (3, N // WORLD + 5)
#: seconds each worker may take (the W = 2 worker, the longest, proves nine
#: times: about 25 s on one core of an x86 server)
WORKER_TIMEOUT = 600


def _codeword(seed: int, n: int = N) -> torch.Tensor:
    return to_tensor(random_felt_words(np.random.default_rng(seed), n), "cpu")


def _tree_arrays(tree, prefix: str) -> dict:
    """A MerkleTree as arrays: root, every level as (m, 16) rows, openings."""
    out = {prefix + "root": np.frombuffer(tree.root, dtype=np.uint8)}
    for i, level in enumerate(merkle_levels_as_rows(tree)):
        out[f"{prefix}level{i}"] = level
    paths = [b"".join(tree.open(i)) for i in OPENED] + [b"".join(tree.open_multi(OPENED))]
    out[prefix + "openings"] = np.frombuffer(b"".join(paths), dtype=np.uint8)
    return out


def _fold_args(s: int) -> tuple:
    return 12345 + s, GENERATOR, primitive_root_of_unity(N)


def expected(s: int) -> dict:
    """Every result of the sharded task, computed on one device without a mesh."""
    x, cols = _codeword(s), [_codeword(s + 1), _codeword(s + 2)]
    out = {}
    for inverse in (False, True):
        want = nttmod.intt(x) if inverse else nttmod.ntt(x)
        out[f"nat_nat_{inverse}"] = to_numpy(want)
        out[f"nat_cyc_{inverse}"] = natural_to_cyclic(to_numpy(want), s)
        out[f"cyc_nat_{inverse}"] = to_numpy(want)
    out["lde"] = to_numpy(nttmod.coset_evaluate(nttmod.intt(x), 4 * N, GENERATOR))
    out["coset"] = to_numpy(nttmod.coset_evaluate(x, 4 * N, GENERATOR))
    for pair in (False, True):
        out.update(_tree_arrays(commit_columns(cols, pair=pair), f"tree_{pair}_"))
    out["roll"] = to_numpy(torch.cat([torch.roll(x, -e, dims=1) for e in ROLL_SHIFTS]))
    out["owner"] = to_numpy(x[:, [N - 1, 0, 7, N // 2, 7]])
    out["pairs"] = to_numpy(torch.cat([x[:, : N // 2], x[:, N // 2 :]]))
    out["fold"] = to_numpy(fold(x, *_fold_args(s)))
    out["next_rows"] = to_numpy(torch.cat([torch.roll(x, -e, dims=1) for e in NEXT_ROW_SHIFTS]))
    return out


class _Dense:
    """An AIR seen without its periodic_columns(): only the dense
    constant_columns(num_rows) remain, which sends the prover down its
    column-LDE path for the constants."""

    def __init__(self, air):
        self._air = air

    def __getattr__(self, name):
        if name in ("periodic_columns", "constant_columns_bytes"):
            raise AttributeError(name)
        return getattr(self._air, name)


def air_case(name: str) -> tuple:
    """(air, trace, boundary) of one AIR shape (the sizes of test_torch_airs.py)."""
    if name == "rescue":
        rp = RescuePrime()
        air = RescuePrimeAir(rp, chain_length=1)
        return air, rp.trace(INPUT), air.boundary_constraints(rp.hash(INPUT))
    if name == "fibonacci":
        air = FibonacciAir(num_steps=40)
        return air, air.trace(), air.boundary_constraints(air.output())
    air = MiMCAir(num_steps=60)
    boundary = air.boundary_constraints(mimc(MIMC_INPUT, 60))
    return (air if name == "mimc" else _Dense(air)), air.trace(MIMC_INPUT), boundary


def stark_for(air, **kw) -> Stark:
    return Stark(air, expansion_factor=4, num_colinearity_checks=2, fri_host_tail_n=HOST_TAIL_N, **kw)


class WidthGuard(TorchDispatchMode):
    """Records every int32 tensor whose leading dimension is 4 that an op
    creates while the mode is on, by width (numel // 4): the widest, and
    every one wider than `limit` with the op that made it."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit, self.widest, self.over = limit, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.dim() and t.shape[0] == 4:
                width = t.numel() // 4
                self.widest = max(self.widest, width)
                if width > self.limit:
                    self.over.append((width, str(func)))
        return out


def _sharded_task(world: int, rank: int, results: dict) -> None:
    for s in SHARD_COUNTS:
        mesh = make_mesh(s, "cpu", group=distributed.world_group())
        assert (mesh.world, mesh.rank, mesh.local_shards) == (world, rank, s // world)
        x, cols = _codeword(s), [_codeword(s + 1), _codeword(s + 2)]
        x_cyclic = to_tensor(natural_to_cyclic(to_numpy(x), s), "cpu")
        for inverse in (False, True):
            before = mesh.exchanges
            y = sharded_ntt(shard(x, mesh), mesh, inverse)
            counts = [mesh.exchanges - before]
            results[f"s{s}_nat_nat_{inverse}"] = host_gather(y, mesh)
            y = sharded_ntt(shard(x, mesh), mesh, inverse, layout_out=CYCLIC)
            counts.append(mesh.exchanges - before)
            results[f"s{s}_nat_cyc_{inverse}"] = host_gather(y, mesh)
            y = sharded_ntt(shard(x_cyclic, mesh), mesh, inverse, layout_in=CYCLIC)
            counts.append(mesh.exchanges - before)
            results[f"s{s}_cyc_nat_{inverse}"] = host_gather(y, mesh)
            assert counts == [3, 5, 7], counts
        results[f"s{s}_lde"] = host_gather(sharded_lde(shard(x, mesh), 4 * N, GENERATOR, mesh), mesh)
        results[f"s{s}_coset"] = host_gather(
            sharded_coset_evaluate(shard(x, mesh), 4 * N, GENERATOR, mesh), mesh)
        for pair in (False, True):
            tree = commit_sharded([shard(c, mesh) for c in cols], mesh, pair=pair)
            results.update(_tree_arrays(tree, f"s{s}_tree_{pair}_"))
        # the block-local prover's collectives, each on this process's block
        block = shard(x, mesh)
        results[f"s{s}_roll"] = np.concatenate(
            [host_gather(roll_left(block, e, mesh), mesh) for e in ROLL_SHIFTS])
        results[f"s{s}_owner"] = to_numpy(mesh.owner_gather([(block, [N - 1, 0, 7, N // 2, 7])])[0])
        pairs = pair_exchange(block, mesh)
        results[f"s{s}_pairs"] = np.concatenate(
            [host_gather(pairs[:4].contiguous(), mesh), host_gather(pairs[4:].contiguous(), mesh)])
        results[f"s{s}_fold"] = host_gather(fold(block, *_fold_args(s), mesh), mesh)
        # the prover's next-row codeword of a block
        rows = [Stark._next_rows(SimpleNamespace(expansion_shift=e, mesh=mesh), block)
                for e in NEXT_ROW_SHIFTS]
        results[f"s{s}_next_rows"] = np.concatenate([host_gather(r, mesh) for r in rows])


def _proof(results: dict, name: str, proof: bytes) -> None:
    results[name] = np.frombuffer(proof, dtype=np.uint8)


def _prove_task(results: dict, airs, guard: bool) -> None:
    mesh = make_mesh(PROVE_SHARDS, "cpu", group=distributed.world_group())
    for name in airs:
        air, trace, boundary = air_case(name)
        stark = stark_for(air, mesh=mesh)
        before = mesh.exchanges
        _proof(results, f"prove_{name}", stark.prove(trace, boundary, randomizer_seed=SEED))
        results[f"exchanges_{name}"] = np.array([mesh.exchanges - before])
        results[f"verifies_{name}"] = np.array([stark.verify(results[f"prove_{name}"].tobytes(), boundary)])
    if guard:
        air, trace, boundary = air_case("rescue")
        stark = stark_for(air, mesh=mesh)
        limit = stark.fri_domain_length // mesh.world
        with WidthGuard(limit) as seen:
            _proof(results, "guard_proof", stark.prove(trace, boundary, randomizer_seed=SEED))
        results["guard_limit"] = np.array([limit])
        results["guard_widest"] = np.array([seen.widest])
        results["guard_over"] = np.array([w for w, _ in seen.over] or [0])
        results["guard_over_ops"] = np.array(sorted({op for _, op in seen.over}) or [""])
        # the guard has teeth: the single-device prover makes F-wide tensors
        with WidthGuard(limit) as plain:
            stark_for(air, device="cpu").prove(trace, boundary, randomizer_seed=SEED)
        results["guard_single_device_widest"] = np.array([plain.widest])


def _checkpoint_task(results: dict, directory: str) -> None:
    mesh = make_mesh(PROVE_SHARDS, "cpu", group=distributed.world_group())
    air, trace, boundary = air_case("rescue")
    stark = stark_for(air, mesh=mesh)
    _proof(results, "ckpt_first", stark.prove(trace, boundary, randomizer_seed=SEED,
                                              checkpoint_dir=directory))
    before = mesh.exchanges
    _proof(results, "ckpt_resumed", stark.prove(trace, boundary, randomizer_seed=SEED,
                                                checkpoint_dir=directory))
    results["ckpt_resumed_exchanges"] = np.array([mesh.exchanges - before])
    # mid-FRI: without the last two rounds' snapshots the replay ends on a
    # host-tail round and the live rounds continue from its fold
    rounds = stark.fri.num_rounds
    if mesh.rank == 0:
        for r in (rounds - 1, rounds - 2):
            for ext in ("npz", "json"):
                os.remove(os.path.join(directory, f"stark-fri-r{r}.{ext}"))
    torch.distributed.barrier()
    _proof(results, "ckpt_mid_fri", stark.prove(trace, boundary, randomizer_seed=SEED,
                                                checkpoint_dir=directory))


def worker(store: str, world: int, rank: int, out_path: str, tasks: str) -> None:
    torch.set_num_threads(1)
    assert distributed.init("file://" + store, world, rank, device="cpu")
    assert distributed.process_index() == rank
    results = {}
    for task in tasks.split(","):
        if task == "sharded":
            _sharded_task(world, rank, results)
        elif task == "roll":
            mesh = make_mesh(PROVE_SHARDS, "cpu", group=distributed.world_group())
            block = shard(_codeword(PROVE_SHARDS), mesh)
            results["roll"] = np.concatenate(
                [host_gather(roll_left(block, e, mesh), mesh) for e in ROLL_SHIFTS])
        elif task == "rescue":
            _prove_task(results, ("rescue",), guard=False)
        elif task == "airs":
            _prove_task(results, AIRS, guard=False)
        elif task == "guard":
            _prove_task(results, (), guard=True)
        elif task.startswith("checkpoint="):
            _checkpoint_task(results, task.split("=", 1)[1])
        else:
            raise ValueError(f"unknown task {task!r}")
    np.savez(out_path, **results)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's workers, started together; what each rank wrote, by W."""
    tmp = tmp_path_factory.mktemp("mesh_processes")
    tasks = {w: "roll,rescue" for w in PROVE_WORLDS}
    tasks[WORLD] = f"sharded,roll,rescue,airs,guard,checkpoint={tmp / 'ckpt'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, outs = [], {}
    for w in PROVE_WORLDS:
        outs[w] = [tmp / f"w{w}_rank{r}.npz" for r in range(w)]
        procs += [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(tmp / f"store{w}"), str(w), str(r),
                 str(outs[w][r]), tasks[w]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(w)
        ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-8000:]
    return {w: [dict(np.load(out)) for out in outs[w]] for w in PROVE_WORLDS}, tmp / "ckpt"


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0][WORLD]


@pytest.fixture(scope="module")
def wanted():
    return {s: expected(s) for s in SHARD_COUNTS}


@pytest.fixture(scope="module")
def single_device(tmp_path_factory):
    """The port's single-device proofs of every AIR case, and the snapshot
    directory of a single-process checkpointed Rescue prove."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        proofs = {}
        for name in ("rescue",) + AIRS:
            air, trace, boundary = air_case(name)
            proofs[name] = stark_for(air, device="cpu").prove(trace, boundary, randomizer_seed=SEED)
        directory = tmp_path_factory.mktemp("single_ckpt")
        air, trace, boundary = air_case("rescue")
        assert stark_for(air, device="cpu").prove(
            trace, boundary, randomizer_seed=SEED, checkpoint_dir=str(directory)) == proofs["rescue"]
    finally:
        torch.set_num_threads(threads)
    return proofs, directory


@pytest.mark.parametrize("what", ["nat_nat", "nat_cyc", "cyc_nat", "lde", "coset",
                                  "tree_False", "tree_True"])
@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_two_processes_give_the_single_device_result(ranks, wanted, shards, what):
    names = [name for name in wanted[shards] if name.startswith(what)]
    assert names
    for got in ranks:
        for name in names:
            np.testing.assert_array_equal(got[f"s{shards}_{name}"], wanted[shards][name],
                                          err_msg=f"S={shards} {name}")


@pytest.mark.parametrize("what", ["roll", "owner", "pairs", "fold", "next_rows"])
@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_the_block_local_collectives_and_fold_give_the_single_device_result(ranks, wanted, shards,
                                                                             what):
    # roll_left: every block of torch.roll, for shifts within, across and
    # past blocks; owner_gather: values at global indices on every rank;
    # pair_exchange: rows i and i + n/2 at the owner of row i; a fold of the
    # blocks = the fold of the whole codeword; the prover's next-row codeword
    # = torch.roll
    for got in ranks:
        np.testing.assert_array_equal(got[f"s{shards}_{what}"], wanted[shards][what],
                                      err_msg=f"S={shards} {what}")


def test_every_result_was_compared(ranks, wanted):
    for got in ranks:
        sharded = [k for k in got if k[0] == "s" and k[1].isdigit()]
        assert len(sharded) == sum(len(w) for w in wanted.values())


@pytest.mark.parametrize("world", PROVE_WORLDS)
def test_roll_left_is_torch_roll_cut_into_blocks_on_every_world(runs, wanted, world):
    # W = 1 sends both parts to itself; W = 4 takes shifts of several blocks
    for got in runs[0][world]:
        np.testing.assert_array_equal(got["roll"], wanted[PROVE_SHARDS]["roll"])


@pytest.mark.parametrize("world", PROVE_WORLDS)
def test_prove_over_processes_gives_the_golden_bytes_on_every_rank(runs, single_device, world):
    # chain 1, seed golden-v1: the JAX package's bytes (tests/golden/), the
    # port's single-device bytes, on every one of W ranks
    with open(GOLDEN, "rb") as fh:
        golden = fh.read()
    assert single_device[0]["rescue"] == golden
    for got in runs[0][world]:
        assert got["prove_rescue"].tobytes() == golden
        assert bool(got["verifies_rescue"][0])
        # the trace, zk and excluded-row codewords went through the mesh:
        # four exchanges a trace column's LDE, two a coset evaluation
        assert int(got["exchanges_rescue"][0]) == 4 * 2 + 2 * 2


@pytest.mark.parametrize("name", AIRS)
def test_prove_of_other_airs_over_two_processes_gives_the_single_device_bytes(ranks, single_device,
                                                                              name):
    for got in ranks:
        assert got[f"prove_{name}"].tobytes() == single_device[0][name]
        assert bool(got[f"verifies_{name}"][0])


def test_checkpoint_over_two_processes_writes_the_single_process_files_and_resumes(runs, ranks,
                                                                                   single_device):
    proofs, single_dir = single_device
    ckpt = runs[1]
    names = sorted(os.listdir(single_dir))
    assert names == sorted(os.listdir(ckpt)) and "stark-pre-fri.npz" in names
    for name in names:
        assert filecmp.cmp(single_dir / name, ckpt / name, shallow=False), name
    for got in ranks:
        assert got["ckpt_first"].tobytes() == proofs["rescue"]
        assert got["ckpt_resumed"].tobytes() == proofs["rescue"]
        assert int(got["ckpt_resumed_exchanges"][0]) == 0  # nothing transformed again
        assert got["ckpt_mid_fri"].tobytes() == proofs["rescue"]


def test_no_process_creates_a_tensor_wider_than_its_block(ranks, single_device):
    # Every (4, ...) int32 tensor created inside prove on W = 2 spans at
    # most F/W columns. Exempt by name: the host tail's gather of at most
    # fri_host_tail_n columns and owner_gather's values at the opened
    # indices, both narrower than F/W here, so nothing wider passes.
    exempt = HOST_TAIL_N
    for got in ranks:
        limit = int(got["guard_limit"][0])
        assert exempt < limit
        assert [int(w) for w in got["guard_over"] if w > exempt] == [], got["guard_over_ops"]
        assert 0 < int(got["guard_widest"][0]) <= limit
        assert got["guard_proof"].tobytes() == single_device[0]["rescue"]
        # the guard sees the single-device prover's F-wide codewords
        assert int(got["guard_single_device_widest"][0]) >= 2 * limit


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
