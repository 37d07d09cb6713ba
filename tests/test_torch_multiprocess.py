"""PyTorch port, the mesh across processes: two OS processes joined by
``torch.distributed`` (gloo, CPU tensors) hold S = 8 and S = 2 shards between
them and run the sharded NTT in its three layouts, the sharded LDE and coset
evaluation and the sharded pair-leaf commit; what every process gathers equals
the single-device result bit for bit (tolerance 0).

This file is also the worker: ``python tests/test_torch_multiprocess.py
STORE WORLD RANK OUT`` joins the group through the ``file://`` store STORE
and writes its gathered results to OUT (an ``.npz``)."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from stark_anatomy_tpu_torch.iop.merkle import commit_columns  # noqa: E402
from stark_anatomy_tpu_torch.iop.stark import Stark  # noqa: E402
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir  # noqa: E402
from stark_anatomy_tpu_torch.ops import ntt as nttmod  # noqa: E402
from stark_anatomy_tpu_torch.ops.field import GENERATOR  # noqa: E402
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
from stark_anatomy_tpu_torch.reference import merkle_levels_as_rows, natural_to_cyclic  # noqa: E402

WORLD = 2
SHARD_COUNTS = (8, 2)
N = 1024
OPENED = (0, 5, N // 2 - 1)


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


def expected(s: int) -> dict:
    """Every result of the worker, computed on one device without a mesh."""
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
    return out


def worker(store: str, world: int, rank: int, out_path: str) -> None:
    assert distributed.init("file://" + store, world, rank, device="cpu")
    assert distributed.process_index() == rank
    results = {}
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
    # Stark.prove on a mesh spread over processes is refused before any work
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    before = mesh.exchanges
    try:
        Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=mesh).prove(
            rp.trace(1), air.boundary_constraints(rp.hash(1)), randomizer_seed=b"mesh")
        refused = False
    except NotImplementedError:
        refused = mesh.exchanges == before
    results["prove_refused"] = np.array([refused])
    np.savez(out_path, **results)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two workers once; what each wrote, by rank."""
    tmp = tmp_path_factory.mktemp("mesh_two_processes")
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp / "store"), str(WORLD), str(r),
             str(outs[r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-8000:]
    return [dict(np.load(out)) for out in outs]


@pytest.fixture(scope="module")
def wanted():
    return {s: expected(s) for s in SHARD_COUNTS}


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


def test_every_result_was_compared_and_the_prove_was_refused(ranks, wanted):
    for got in ranks:
        assert bool(got["prove_refused"][0])
        assert len(got) == 1 + sum(len(w) for w in wanted.values())


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
