"""The port stands alone: it imports neither jax nor the JAX package, its
entry points refuse to run on the CPU unless asked, and the kernel wrappers
take their plain versions only for CPU tensors."""

import ast
import os

import numpy as np
import pytest
import torch

from stark_anatomy_tpu_torch import prove_rescue
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import blake2b_kernels as bk
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops import ntt_kernels, trace_layout
from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_tensor, words_to_bytes
from stark_anatomy_tpu_torch.reference import from_reference_digests, from_reference_limbs
from stark_anatomy_tpu_torch.utils import threefry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "stark_anatomy_tpu")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(ROOT, "stark_anatomy_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path: str):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_port_source_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    assert os.path.join(ROOT, "stark_anatomy_tpu_torch", "prove_rescue.py") in files
    for path in files:
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def _uses_torch_distributed(path: str) -> bool:
    """Whether a source imports torch.distributed or reaches it as an
    attribute of torch."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{alias.name}" for alias in node.names]
        elif isinstance(node, ast.Attribute) and getattr(node.value, "id", "") == "torch":
            names = [f"torch.{node.attr}"]
        else:
            continue
        if any(n == "torch.distributed" or n.startswith("torch.distributed.") for n in names):
            return True
    return False


def test_only_the_mesh_and_distributed_modules_reach_torch_distributed():
    # every exchange between processes goes through parallel/mesh.py; the
    # process group is made in parallel/distributed.py
    package = os.path.join(ROOT, "stark_anatomy_tpu_torch")
    users = {os.path.relpath(p, package) for p in _port_sources()
             if p.startswith(package + os.sep) and _uses_torch_distributed(p)}
    assert users == {os.path.join("parallel", "mesh.py"), os.path.join("parallel", "distributed.py")}


def test_kernel_sources_ship_with_the_package():
    for name in _build.SOURCES + _build.HEADERS:
        assert os.path.exists(os.path.join(_build.CSRC, name)), name
    assert set(_build.SIGNATURES) == set(_build.LAUNCHES) == {
        "fp_add", "fp_sub", "fp_mont_mul", "fp_butterfly", "fp_pow_const", "fp_batch_inv",
        "ntt_block", "ntt_stage", "ntt_grouped", "blake2b_planes", "zk_coefficients", "trace_layout"}


def test_default_device_raises_without_a_card_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2)
    assert stark.device == "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        stark.prove(rp.trace(1), air.boundary_constraints(rp.hash(1)), randomizer_seed=b"x")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        nttmod.powers(3, 8)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        nttmod._twiddles(8, False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        prove_rescue.main(["--chain", "1", "--checks", "2", "--seed", "x"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        from_reference_limbs(np.zeros((8, 4), dtype=np.uint32))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        from_reference_digests(np.zeros((4, 16), dtype=np.uint32))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(0)
    a, b = (to_tensor(random_felt_words(rng, 64), "cpu") for _ in range(2))
    before = _build.launch_counts()
    assert torch.equal(fk.add(a, b), ft.add(a, b))
    assert torch.equal(fk.sub(a, b), ft.sub(a, b))
    assert torch.equal(fk.mont_mul(a, b), ft.mont_mul(a, b))
    assert torch.equal(fk.pow_const(a, 5), ft.pow_const(a, 5))
    hi, lo = fk.butterfly(a, b, 7)
    assert torch.equal(hi, ft.butterfly(a, b, 7)[0]) and torch.equal(lo, ft.butterfly(a, b, 7)[1])
    assert torch.equal(fk.inv(a), ft.inv(a))
    tw = nttmod._twiddles(64, False, "cpu")
    assert torch.equal(ntt_kernels.transform(a, tw), ntt_kernels.transform_plain(a, tw))
    tw8 = nttmod._twiddles(8, False, "cpu")
    assert torch.equal(ntt_kernels.ntt_grouped(a, tw8, 8), ntt_kernels.ntt_grouped_plain(a, tw8, 8))
    msg = torch.cat([a, b])
    from stark_anatomy_tpu_torch.ops.blake2b import blake2b_planes_plain

    assert torch.equal(bk.blake2b_planes(msg, 32), blake2b_planes_plain(msg, 32))
    key = np.array([1, 2], dtype=np.uint32)
    assert torch.equal(threefry.zk_coefficients(key, 64, "cpu"), threefry.zk_coefficients_plain(key, 64, "cpu"))
    body = torch.from_numpy(words_to_bytes(random_felt_words(rng, 128)).reshape(32, 4, 16))
    pad = a.view(4, 4, 16)
    assert torch.equal(trace_layout.mont_planes(body, pad), trace_layout.mont_planes_plain(body, pad))
    assert _build.launch_counts() == before
    assert _build._lib is None  # nothing was built or loaded for CPU work


@pytest.mark.parametrize("op", [fk.add, fk.sub, fk.mont_mul])
def test_field_wrappers_reject_what_the_kernels_do_not_take(op):
    a = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        op(a[:, ::2], a[:, ::2])
    with pytest.raises(TypeError):
        op(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        op(a, a[:, :8])
    with pytest.raises(ValueError):
        op(torch.zeros((8, 16), dtype=torch.int32), a)
    with pytest.raises(TypeError):
        op(1, 2)


def test_ntt_and_blake2b_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros((4, 16), dtype=torch.int32)
    tw = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_kernels.transform(torch.zeros((4, 32), dtype=torch.int32)[:, ::2], tw)
    with pytest.raises(TypeError):
        ntt_kernels.transform(a.to(torch.int64), tw)
    with pytest.raises(ValueError, match="contiguous"):
        bk.blake2b_planes(torch.zeros((8, 32), dtype=torch.int32)[:, ::2], 32)
    with pytest.raises(TypeError):
        bk.blake2b_planes(torch.zeros((8, 16), dtype=torch.int64), 32)
