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


def test_golden_proof_bytes_through_the_kernels(card):
    chip_smoke.phase_golden()


def test_cuda_and_cpu_provers_agree_with_device_fri_rounds(card):
    chip_smoke.phase_mid()


def test_fibonacci_and_mimc_prove_through_the_kernels_and_agree_with_the_cpu(card):
    chip_smoke.phase_airs(4000)


def test_checkpoint_resume_on_the_card_gives_identical_bytes(card):
    chip_smoke.phase_resume()


def test_the_mesh_path_on_the_card_equals_the_single_device_path(card):
    chip_smoke.phase_mesh(chain=125, log_n=14)
