"""PyTorch port, the command-line prover (stark_anatomy_tpu_torch/prove_rescue.py),
called in-process through main(argv) on the CPU: the golden proof's bytes,
which the JAX package verifies; a named profile equal to Stark.from_profile;
fresh entropy without --seed; the --checkpoint-dir rules and resume."""

import os

import pytest

from stark_anatomy_tpu.iop.stark import Stark as RefStark
from stark_anatomy_tpu.models.rescue_prime import RescuePrime as RefRescuePrime
from stark_anatomy_tpu.models.rescue_prime import RescuePrimeAir as RefRescuePrimeAir
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.prove_rescue import main

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "proof_rescue_chain1.json")
INPUT = 20260817


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _port_boundary(chain: int):
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=chain)
    trace = rp.trace_bytes(INPUT, chain)
    return rp, air, trace, air.boundary_constraints(int.from_bytes(trace[-1, 0].tobytes(), "little"))


def test_cli_writes_the_golden_proof_and_the_jax_package_verifies_it(tmp_path, capsys):
    out = tmp_path / "proof.bin"
    rc = main(["--input", str(INPUT), "--chain", "1", "--checks", "2", "--seed", "golden-v1",
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "ACCEPT" in printed and f"wrote {out}" in printed
    assert "LDE domain 2^10" in printed and "prove.trace-lde" in printed
    proof = _read(out)
    assert proof == _read(GOLDEN)
    rrp = RefRescuePrime()
    ref = RefStark(RefRescuePrimeAir(rrp, chain_length=1), expansion_factor=4, num_colinearity_checks=2)
    assert ref.verify(proof, ref.air.boundary_constraints(rrp.hash(INPUT)))


def test_cli_profile_equals_stark_from_profile(tmp_path):
    out = tmp_path / "proof.bin"
    assert main(["--input", str(INPUT), "--profile", "test", "--chain", "1", "--seed", "cli-test",
                 "--device", "cpu", "--out", str(out)]) == 0
    _, air, trace, boundary = _port_boundary(1)
    stark = Stark.from_profile("test", air, device="cpu")
    assert _read(out) == stark.prove(trace, boundary, randomizer_seed=b"cli-test")


def test_cli_without_seed_draws_fresh_entropy_and_still_verifies(tmp_path):
    paths = [tmp_path / "a.bin", tmp_path / "b.bin"]
    for path in paths:
        assert main(["--input", str(INPUT), "--chain", "1", "--checks", "2", "--device", "cpu",
                     "--out", str(path)]) == 0
    a, b = (_read(p) for p in paths)
    assert a != b  # zero-knowledge: another randomizer each run
    _, air, _, boundary = _port_boundary(1)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    assert stark.verify(a, boundary) and stark.verify(b, boundary)


def test_cli_checkpoint_dir_needs_a_seed(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--chain", "1", "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert "--checkpoint-dir needs --seed" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_cli_resumes_from_its_checkpoint_to_the_same_bytes(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    argv = ["--input", str(INPUT), "--chain", "1", "--checks", "2", "--seed", "cli-resume",
            "--device", "cpu", "--checkpoint-dir", str(ckpt)]
    assert main([*argv, "--out", str(tmp_path / "first.bin")]) == 0
    first = capsys.readouterr().out
    assert "stark-pre-fri.npz" in os.listdir(ckpt)
    assert main([*argv, "--out", str(tmp_path / "second.bin")]) == 0
    second = capsys.readouterr().out
    assert "prove.trace-lde" in first and "prove.trace-lde" not in second
    assert "prove.resume-commit" in second
    assert _read(tmp_path / "first.bin") == _read(tmp_path / "second.bin")
