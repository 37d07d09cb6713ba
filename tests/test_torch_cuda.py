"""PyTorch port on the card: every CUDA kernel against its plain version and
the golden proof through the kernels. Needs an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a card every test here skips (decided inside the fixture, never at
import or collection time)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repo root)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels have no CPU mode: needs an NVIDIA GPU")


def test_every_kernel_equals_its_plain_version(card):
    results = {}
    chip_smoke.phase_kernels(results)
    assert results and all(r["max_abs_err"] == 0 for r in results.values())


@pytest.mark.parametrize("n", [1, 1000, 2048, 2049, (1 << 16) + 3])
def test_inv_is_fp_batch_inv_alone_and_equals_its_plain_version(card, n):
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.ops import field_kernels as fk
    from stark_anatomy_tpu_torch.ops import field_torch as ft

    a = chip_smoke.inv_input(n, 3)
    _build.reset_launch_counts()
    got = fk.inv(a)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    assert counts == {"fp_batch_inv": 2 * len(fk.inv_plan(n)) - 1}
    assert torch.equal(got, ft.inv(a))
    assert torch.equal(fk.inv(torch.zeros_like(a)), torch.zeros_like(a))


def test_inv_at_the_prove_shape(card):
    chip_smoke.phase_inv(log_n=20)


def test_golden_proof_bytes_through_the_kernels(card):
    chip_smoke.phase_golden()


def test_cuda_and_cpu_provers_agree_with_device_fri_rounds(card):
    chip_smoke.phase_mid()


def test_fibonacci_and_mimc_prove_through_the_kernels_and_agree_with_the_cpu(card):
    chip_smoke.phase_airs(4000)


def test_checkpoint_resume_on_the_card_gives_identical_bytes(card):
    chip_smoke.phase_resume()


def test_the_mesh_path_on_the_card_equals_the_single_device_path(card):
    chip_smoke.phase_mesh(chain=125, log_n=16)  # 256 shards need 256^2 | n


def test_the_forced_big_path_on_the_card_gives_the_golden_bytes(card, monkeypatch):
    from stark_anatomy_tpu_torch.iop import stark as stark_mod

    monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
    monkeypatch.setattr(stark_mod, "_BIG_CHUNK", 256)
    chip_smoke.phase_golden()


def test_the_forced_big_path_with_the_chunked_pair_commit_on_the_card_equals_the_cpu(card, monkeypatch):
    from stark_anatomy_tpu_torch.iop import stark as stark_mod

    proofs = {}
    for device in ("cpu", "cuda"):
        rp, air, stark = chip_smoke.rescue_setup(15, 2, device)
        boundary = air.boundary_constraints(rp.chain_output(7, 15))
        if device == "cuda":
            monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
            monkeypatch.setattr(stark_mod, "_BIG_CHUNK", 1 << 12)  # F = 2^13: ChunkedPairCommit engaged
        proofs[device] = stark.prove(rp.trace(7, 15), boundary, randomizer_seed=b"big-card")
    assert proofs["cuda"] == proofs["cpu"] and stark.verify(proofs["cuda"], boundary)


_ZK_N = [1, 1000, (1 << 16) + 3, 1 << 22]
_ZK_CASES = ([(n, "all") for n in _ZK_N] + [(n, "range") for n in _ZK_N] + [(n, "out-view") for n in _ZK_N]
             + [(n, "cyclic") for n in (1000, 1 << 16, 1 << 22)])


@pytest.mark.parametrize("n,cols", _ZK_CASES)
def test_zk_coefficients_is_one_launch_equal_to_its_plain_version(card, n, cols):
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.parallel import make_mesh
    from stark_anatomy_tpu_torch.parallel.ntt_sharded import cyclic_indices
    from stark_anatomy_tpu_torch.utils import threefry

    key = chip_smoke.ZK_KEY
    columns = {"range": range(n // 3, n), "cyclic": cyclic_indices(n, make_mesh(8, "cuda"))}.get(cols)
    m = n if columns is None else len(columns)
    buf = torch.zeros((4, m + 7), dtype=torch.int32, device="cuda")
    out = buf[:, 7:] if cols == "out-view" else None
    _build.reset_launch_counts()
    got = threefry.zk_coefficients(key, n, "cuda", columns, out=out)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launch_counts().items() if v} == {"zk_coefficients": 1}
    plain_cols = torch.arange(columns.start, columns.stop, device="cuda") if cols == "range" else columns
    want = threefry.zk_coefficients_plain(key, n, "cuda", plain_cols)
    assert got.shape == (4, m) and torch.equal(got, want)
    if out is not None:
        assert got.data_ptr() == out.data_ptr() and not buf[:, :7].any()
    if columns is not None and n <= 1 << 16:
        whole = threefry.zk_coefficients_plain(key, n, "cuda")
        assert torch.equal(got, whole[:, plain_cols])


def test_the_golden_proof_draws_its_zk_coefficients_in_one_kernel_launch(card):
    from stark_anatomy_tpu_torch.ops import _build

    _build.reset_launch_counts()
    chip_smoke.phase_golden()
    assert _build.launch_counts()["zk_coefficients"] == 1


@pytest.mark.parametrize("o,t_len,w", [(1 << 16, (1 << 16) - 128, 2), (1 << 16, (1 << 16) - 159, 3),
                                       (1 << 16, 1 << 16, 1), (1 << 20, 1048417, 2)])
def test_trace_layout_is_one_launch_equal_to_the_cpu_route(card, o, t_len, w):
    import numpy as np

    from stark_anatomy_tpu_torch.ops import _build, trace_layout
    from stark_anatomy_tpu_torch.ops.field import PRIME
    from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, words_to_bytes

    rng = np.random.default_rng(o + t_len + w)
    trace = words_to_bytes(random_felt_words(rng, t_len * w)).reshape(t_len, w, 16).copy()
    trace[0, 0] = np.frombuffer((PRIME - 1).to_bytes(16, "little"), np.uint8)
    trace[-1, w - 1] = 0
    pad = np.stack([random_felt_words(rng, o - t_len) for _ in range(w)])
    body, tail = trace_layout.upload(trace, pad, "cuda")
    _build.reset_launch_counts()
    got = trace_layout.mont_planes(body, tail)
    torch.cuda.synchronize()  # a fault during the run surfaces here
    assert {k: v for k, v in _build.launch_counts().items() if v} == {"trace_layout": 1}
    want = trace_layout.mont_planes(*trace_layout.upload(trace, pad, "cpu"))
    assert got.shape == (w, 4, o) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("route", ["byte trace", "int trace", "forced big path", "mesh"])
def test_every_route_proves_through_one_trace_layout_launch_to_the_cpu_bytes(card, monkeypatch, route):
    from stark_anatomy_tpu_torch.iop import stark as stark_mod
    from stark_anatomy_tpu_torch.ops import _build
    from stark_anatomy_tpu_torch.parallel.mesh import make_mesh

    proofs = {}
    for device in ("cpu", "cuda"):
        rp, air, stark = chip_smoke.rescue_setup(15, 2, device)
        boundary = air.boundary_constraints(rp.chain_output(7, 15))
        trace = rp.trace(7, 15) if device == "cuda" and route == "int trace" else rp.trace_bytes(7, 15)
        if device == "cuda" and route == "forced big path":
            monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
            monkeypatch.setattr(stark_mod, "_BIG_CHUNK", 1 << 12)
        if device == "cuda" and route == "mesh":
            stark = stark_mod.Stark(air, expansion_factor=4, num_colinearity_checks=2, mesh=make_mesh(8))
        _build.reset_launch_counts()
        proofs[device] = stark.prove(trace, boundary, randomizer_seed=b"layout-card")
    assert _build.launch_counts()["trace_layout"] == 1
    assert proofs["cuda"] == proofs["cpu"] and stark.verify(proofs["cuda"], boundary)


def _big_inputs(chain, device):
    rp, air, stark = chip_smoke.rescue_setup(chain, 2, device)
    if chain == 1:
        return stark, rp.trace(20260817), air.boundary_constraints(rp.hash(20260817)), b"golden-v1"
    return stark, rp.trace(7, chain), air.boundary_constraints(rp.chain_output(7, chain)), b"big-card"


def _card_stark(chain):
    stark = _big_inputs(chain, "cuda")[0]
    stark.fri_host_tail_n = 64  # FRI's round 0 on the card, then to the host: the same bytes
    return stark


def _pinned_bytes() -> int:
    """Bytes of page-locked blocks torch's host allocator holds, in use or cached."""
    return torch.cuda.host_memory_stats()["allocated_bytes.current"]


@pytest.mark.parametrize("chain,chunk", [(1, 256), (15, 1 << 12)], ids=["golden", "chunked-pair-commit"])
def test_the_forced_big_path_copies_into_pinned_buffers_kept_across_proves(card, monkeypatch, chain, chunk):
    from stark_anatomy_tpu_torch.iop import stark as stark_mod
    from stark_anatomy_tpu_torch.ops.host_pool import is_pinned
    from stark_anatomy_tpu_torch.utils import telemetry

    stark, trace, boundary, seed = _big_inputs(chain, "cpu")
    want = stark.prove(trace, boundary, randomizer_seed=seed)
    if chain == 1:
        with open(chip_smoke.GOLDEN, "rb") as fh:
            assert want == fh.read()
    monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
    monkeypatch.setattr(stark_mod, "_BIG_CHUNK", chunk)

    def prove(stark) -> tuple:
        telemetry.reset()
        proof = stark.prove(trace, boundary, randomizer_seed=seed)
        rep = telemetry.report()
        return proof, {r: sum(v["calls"] for k, v in rep.items() if k.endswith(".to-host." + r))
                       for r in ("pinned", "pageable")}

    stark = _card_stark(chain)
    f = stark.fri_domain_length
    copies = 2 * f // min(chunk, f // 2) + 2  # w F/blk + 2
    pointers = []
    for _ in range(2):
        proof, routes = prove(stark)
        assert proof == want and routes == {"pinned": copies, "pageable": 0}
        arrays = stark._host_pool.arrays
        assert len(arrays) == 4 and all(is_pinned(a) and a.shape == (4, f) for a in arrays)
        pointers.append([a.ctypes.data for a in arrays])
    assert pointers[0] == pointers[1]

    # the page-locked allocation fails: the pool is plain memory, the same bytes
    real_empty = torch.empty

    def empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            raise RuntimeError("CUDA error: out of memory")
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", empty)
    fresh = _card_stark(chain)
    proof, routes = prove(fresh)
    assert proof == want and routes == {"pinned": 0, "pageable": copies}
    assert not any(is_pinned(a) for a in fresh._host_pool.arrays)


def test_a_dropped_or_reshaped_pool_hands_its_page_locked_memory_back(card, monkeypatch):
    import gc

    from stark_anatomy_tpu_torch.iop import stark as stark_mod
    from stark_anatomy_tpu_torch.ops.host_pool import HostPool

    monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
    monkeypatch.setattr(stark_mod, "_BIG_CHUNK", 1 << 12)
    gc.collect()
    torch.cuda.init()
    torch._C._host_emptyCache()
    base = _pinned_bytes()
    held = []
    for chain in (1, 15):  # two provers, two F sizes, one after the other
        stark, trace, boundary, seed = _big_inputs(chain, "cuda")
        stark.prove(trace, boundary, randomizer_seed=seed)
        held.append((stark, 4 * 4 * 4 * stark.fri_domain_length))  # w + 2 = 4 arrays of (4, F) words
        assert _pinned_bytes() == base + sum(b for _, b in held)
    del stark
    for _ in range(2):
        held.pop(0)
        gc.collect()
        assert _pinned_bytes() == base + sum(b for _, b in held)

    pool, cuda = HostPool(), torch.device("cuda")
    with pool.checkout(1 << 14, 3, cuda):
        assert _pinned_bytes() == base + 3 * 16 * (1 << 14)
    with pool.checkout(1 << 12, 2, cuda):  # another shape: the old arrays go back first
        assert _pinned_bytes() == base + 2 * 16 * (1 << 12)
    del pool
    gc.collect()
    assert _pinned_bytes() == base
