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
