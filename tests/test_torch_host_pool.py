"""PyTorch port, the big path's host arrays (ops/host_pool.py): one HostPool
per Stark, made by its first big prove and reused by every later one.

Proves as tests/test_torch_big_prod80.py does: Rescue-Prime chain 59 under
production-80, the big path forced at F = 2^15 in chunks of 2^13 columns.
One instance proves seed A, then seed B, then seed A again into the same
arrays; a fresh instance proves seed B; the standard path proves both seeds.
Every proof of a seed has the same bytes, so nothing of an earlier prove
survives in the arrays. On the CPU the pool is plain host memory: its copies
count as pageable. Tolerance 0: all exact integer math."""

import gc
import json
import os
import threading
import weakref

import numpy as np
import pytest
import torch

from stark_anatomy_tpu_torch.iop import fri as fri_mod
from stark_anatomy_tpu_torch.iop import stark as stark_mod
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.ops import host_pool
from stark_anatomy_tpu_torch.ops.host_pool import HostPool
from stark_anatomy_tpu_torch.utils import telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = 59
INPUT = 2**31 + 1501
F = 1 << 15
BLK = 1 << 13
SEEDS = {"A": b"pool-a", "B": b"pool-b"}
W = 2  # registers
CPU = torch.device("cpu")


def _stark() -> Stark:
    with open(os.path.join(ROOT, "benchmark", "configs", "rescue-prod80-f28.json")) as fh:
        params = json.load(fh)["stark"]
    return Stark(RescuePrimeAir(RescuePrime(), chain_length=CHAIN), device="cpu", **params)


@pytest.fixture(scope="module")
def proves():
    """Per prove: (proof, report, the host arrays its codewords were copied
    into), under the names standard-A, standard-B, pooled-A, pooled-B,
    pooled-A-again and fresh-B; and the pooled instance's arrays after each
    of its proves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    dsts = []

    def recording(real):
        def copy(dst, src):
            dsts.append(dst)
            real(dst, src)
        return copy

    def prove(stark, seed):
        telemetry.reset()
        dsts.clear()
        proof = stark.prove(trace, boundary, randomizer_seed=SEEDS[seed])
        return proof, telemetry.report(), list(dsts)

    try:
        pooled, fresh, standard = _stark(), _stark(), _stark()
        trace = pooled.air.rp.trace_bytes(INPUT, CHAIN)
        boundary = pooled.air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))
        out = {f"standard-{s}": prove(standard, s) for s in SEEDS}
        mp.setattr(stark_mod, "_BIG_F_MIN", 1)
        mp.setattr(stark_mod, "_BIG_CHUNK", BLK)
        mp.setattr(stark_mod, "copy_to_numpy", recording(stark_mod.copy_to_numpy))
        mp.setattr(fri_mod, "copy_to_numpy", recording(fri_mod.copy_to_numpy))
        assert pooled._big and pooled._big_chunk_len() == BLK
        arrays = []
        for name, seed in (("pooled-A", "A"), ("pooled-B", "B"), ("pooled-A-again", "A")):
            out[name] = prove(pooled, seed)
            arrays.append(list(pooled._host_pool.arrays))
        out["fresh-B"] = prove(fresh, "B")
        return {"out": out, "arrays": arrays, "fresh": list(fresh._host_pool.arrays), "stark": pooled,
                "boundary": boundary}
    finally:
        mp.undo()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,name", [("A", "pooled-A"), ("B", "pooled-B"), ("A", "pooled-A-again"),
                                       ("B", "fresh-B")])
def test_a_big_prove_gives_the_standard_paths_bytes_whatever_the_buffers_held(proves, seed, name):
    out = proves["out"]
    assert out[name][0] == out[f"standard-{seed}"][0] != b""
    assert out["standard-A"][0] != out["standard-B"][0]
    assert proves["stark"].verify(out[name][0], proves["boundary"])


def test_every_prove_of_an_instance_copies_into_the_same_buffers(proves):
    first, *later = proves["arrays"]
    assert [(a.shape, a.dtype) for a in first] == [((4, F), np.uint32)] * (W + 2)
    assert all(len(arrays) == W + 2 and all(a is b for a, b in zip(first, arrays)) for arrays in later)
    # quotient chunks by register, then the zk codeword and FRI round 0
    want = [j for _ in range(F // BLK) for j in range(W)] + [W, W + 1]
    for name in ("pooled-A", "pooled-B", "pooled-A-again"):
        dsts = proves["out"][name][2]
        assert [next(i for i, a in enumerate(first) if np.shares_memory(d, a)) for d in dsts] == want
    fresh = proves["fresh"]
    assert not any(np.shares_memory(a, b) for a in fresh for b in first)
    assert all(any(np.shares_memory(d, a) for a in fresh) for d in proves["out"]["fresh-B"][2])


@pytest.mark.parametrize("name", ["pooled-A", "pooled-B", "pooled-A-again", "fresh-B"])
def test_each_big_prove_copies_w_f_over_blk_plus_2_codeword_pieces_to_the_host(proves, name):
    report = proves["out"][name][1]
    calls = {k: v["calls"] for k, v in report.items() if k.endswith(".to-host")}
    assert calls == {"prove.boundary-quotients.to-host": W * F // BLK, "prove.host-offload.to-host": 1,
                     "prove.fri.to-host": 1}
    routes = {k: v for k, v in report.items() if k.endswith((".to-host.pinned", ".to-host.pageable"))}
    assert {k: v["calls"] for k, v in routes.items()} == {f"{span}.pageable": n for span, n in calls.items()}
    assert all(v["seconds"] == 0.0 for v in routes.values())


def test_a_standard_prove_counts_no_copy_to_the_host(proves):
    assert not any(k.endswith(("pinned", "pageable")) for k in proves["out"]["standard-A"][1])
    assert proves["out"]["standard-A"][2] == []


# -- the pool alone ---------------------------------------------------------------------------


def _released(monkeypatch) -> list:
    calls = []
    monkeypatch.setattr(host_pool, "_release_pinned", lambda: calls.append(1))
    return calls


def test_the_pool_allocates_once_per_shape_and_frees_the_old_arrays(monkeypatch):
    released, pool = _released(monkeypatch), HostPool()
    with pool.checkout(64, 3, CPU) as arrays:
        assert [(a.shape, a.dtype, host_pool.is_pinned(a)) for a in arrays] == [((4, 64), np.uint32, False)] * 3
        first, owners = list(arrays), [weakref.ref(a.base) for a in arrays]
    with pool.checkout(64, 3, CPU) as again:
        assert all(a is b for a, b in zip(first, again)) and len(again) == 3
    assert len(released) == 1  # the first allocation found an empty pool
    del first, arrays, again
    with pool.checkout(128, 3, CPU) as wider:
        assert [a.shape for a in wider] == [(4, 128)] * 3 and pool.arrays is wider
    gc.collect()
    assert len(released) == 2 and all(ref() is None for ref in owners)


def test_a_collected_pool_frees_its_arrays(monkeypatch):
    released, pool = _released(monkeypatch), HostPool()
    with pool.checkout(64, 2, CPU) as arrays:
        owners = [weakref.ref(a.base) for a in arrays]
    del arrays, pool
    gc.collect()
    assert len(released) == 2 and all(ref() is None for ref in owners)


def test_a_second_checkout_waits_for_the_first():
    pool, held, order = HostPool(), threading.Event(), []

    def second():
        held.wait()
        with pool.checkout(64, 2, CPU) as arrays:
            order.append(("second", arrays[0].shape))

    thread = threading.Thread(target=second)
    thread.start()
    with pool.checkout(64, 2, CPU) as arrays:
        held.set()
        thread.join(0.2)
        assert thread.is_alive()  # still waiting for the pool
        order.append(("first", arrays[0].shape))
    thread.join(10)
    assert order == [("first", (4, 64)), ("second", (4, 64))]


def test_a_failed_page_locked_allocation_gives_plain_memory(monkeypatch):
    released, real_empty, pinned = _released(monkeypatch), torch.empty, []

    def empty(*args, pin_memory=False, **kwargs):
        if pin_memory:
            pinned.append(1)
            if len(pinned) == 2:
                raise RuntimeError("CUDA error: out of memory")
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", empty)
    arrays = host_pool._allocate(64, 3, True)
    assert [(a.shape, a.dtype) for a in arrays] == [((4, 64), np.uint32)] * 3
    assert len(pinned) == 2 and released == [1]  # the one made is handed back


@pytest.mark.parametrize("pinned,name", [(False, "pageable"), (True, "pinned")])
def test_copied_counts_a_copy_by_its_destinations_memory(monkeypatch, pinned, name):
    monkeypatch.setattr(host_pool, "is_pinned", lambda array: pinned)
    telemetry.reset()
    with telemetry.phase("to-host"):
        host_pool.copied(np.zeros((4, 8), np.uint32))
    assert telemetry.report()[f"to-host.{name}"] == {"seconds": 0.0, "calls": 1}
