"""PyTorch port, checkpoint/resume of Stark.prove: stale snapshots refused,
a prove killed mid-FRI resumes to identical bytes (the port's counterparts of
tests/test_hardening.py), and a snapshot the JAX package wrote resumes in the
port through reference.py. Exact equality throughout."""

import glob
import json
import os

import numpy as np
import pytest

from stark_anatomy_tpu.iop import stark as ref_stark
from stark_anatomy_tpu.models import rescue_prime as ref_rp
from stark_anatomy_tpu_torch.iop import fri as frimod
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.reference import snapshot_from_reference, to_reference_limbs
from stark_anatomy_tpu_torch.ops.limbs import to_tensor
from stark_anatomy_tpu_torch.utils import checkpoint as ckpt


def _small_stark(host_tail_n: int = 1 << 14):
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=1)
    return rp, Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu",
                     fri_host_tail_n=host_tail_n)


def _count_calls(monkeypatch, owner, name):
    """Wrap owner.name so that calls are counted; returns the counter dict."""
    real, calls = getattr(owner, name), {"n": 0}

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(owner, name, counting)
    return calls


def test_checkpoint_refuses_stale_trace_and_seed(tmp_path, monkeypatch):
    rp, stark = _small_stark()
    d = str(tmp_path)
    tr1 = rp.trace(31)
    b1 = stark.air.boundary_constraints(rp.hash(31))
    plain = stark.prove(tr1, b1, randomizer_seed=b"pin")
    lde = _count_calls(monkeypatch, Stark, "_trace_lde")
    p1 = stark.prove(tr1, b1, randomizer_seed=b"pin", checkpoint_dir=d)
    assert p1 == plain and lde["n"] == 1  # checkpointing changes no byte
    # resume: identical, and nothing before FRI ran again
    assert stark.prove(tr1, b1, randomizer_seed=b"pin", checkpoint_dir=d) == p1
    assert lde["n"] == 1
    # Another randomizer seed, same trace/boundary/shapes: the stale snapshot
    # must be refused and the fresh proof must still verify.
    p2 = stark.prove(tr1, b1, randomizer_seed=b"fresh", checkpoint_dir=d)
    assert p2 != p1 and lde["n"] == 2
    assert stark.verify(p2, b1)
    # Another trace under the first seed: refused as well.
    tr2 = rp.trace(32)
    b2 = stark.air.boundary_constraints(rp.hash(32))
    p3 = stark.prove(tr2, b2, randomizer_seed=b"fresh", checkpoint_dir=d)
    assert lde["n"] == 3 and stark.verify(p3, b2) and not stark.verify(p3, b1)


@pytest.mark.parametrize("host_tail_n", [0, 64])
def test_mid_fri_kill_resume(tmp_path, monkeypatch, host_tail_n):
    # A crash mid-FRI must resume from the per-round snapshots: completed
    # folds are skipped and the resumed proof is byte-identical to an
    # uninterrupted run. host_tail_n = 0 forces every round through the
    # tensor fold (the fault is injected there); 64 leaves the last rounds to
    # the host tail, whose snapshots are replayed the same way.
    rp, stark = _small_stark(host_tail_n)
    inp = 4711
    b = stark.air.boundary_constraints(rp.hash(inp))
    tr = rp.trace(inp)
    p_ref = stark.prove(tr, b, randomizer_seed=b"kr")  # no checkpointing

    real_fold = frimod.fold
    calls = {"n": 0}

    def crashing_fold(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated crash mid-FRI")
        return real_fold(*a, **k)

    monkeypatch.setattr(frimod, "fold", crashing_fold)
    with pytest.raises(RuntimeError, match="simulated crash"):
        stark.prove(tr, b, randomizer_seed=b"kr", checkpoint_dir=str(tmp_path))
    # The committed rounds before the crash were snapshotted.
    assert (tmp_path / "stark-fri-r0.npz").exists()
    assert (tmp_path / "stark-fri-r2.npz").exists()
    assert not (tmp_path / "stark-fri-r3.npz").exists()

    monkeypatch.setattr(frimod, "fold", real_fold)
    resumed = _count_calls(monkeypatch, frimod, "fold")
    lde = _count_calls(monkeypatch, Stark, "_trace_lde")
    p2 = stark.prove(tr, b, randomizer_seed=b"kr", checkpoint_dir=str(tmp_path))
    assert p2 == p_ref and lde["n"] == 0
    assert stark.verify(p2, b)
    # Rounds 0..2 replayed from disk: exactly one catch-up fold (of the last
    # snapshot) plus the live tensor folds of the remaining device rounds.
    rounds = stark.fri.num_rounds
    lengths = [stark.fri_domain_length >> r for r in range(rounds)]
    device_rounds = sum(1 for n in lengths if n > host_tail_n)
    assert resumed["n"] == 1 + max(0, min(device_rounds, rounds - 1) - 3)
    # every round is on disk now: a third call replays all of them, folds none
    assert all((tmp_path / f"stark-fri-r{r}.npz").exists() for r in range(rounds))
    before = resumed["n"]
    assert stark.prove(tr, b, randomizer_seed=b"kr", checkpoint_dir=str(tmp_path)) == p_ref
    assert resumed["n"] == before


def test_snapshot_files_layout_and_metadata(tmp_path):
    rp, stark = _small_stark()
    b = stark.air.boundary_constraints(rp.hash(5))
    stark.prove(rp.trace(5), b, randomizer_seed=b"meta", checkpoint_dir=str(tmp_path))
    with open(tmp_path / "stark-pre-fri.json") as fh:
        doc = json.load(fh)
    assert doc["stage"] == "pre-fri" and doc["meta"]["layout"] == ckpt.LAYOUT == "u32x4"
    assert doc["meta"]["seed"] == b"meta".hex() and doc["meta"]["F"] == stark.fri_domain_length
    assert [next(iter(it)) for it in doc["items"]] == ["bq_root", "zk_root"]
    arrays = np.load(tmp_path / "stark-pre-fri.npz")
    assert sorted(arrays.files) == ["bq0", "bq1", "comb", "zk"]
    for name in arrays.files:
        assert arrays[name].shape == (4, stark.fri_domain_length) and arrays[name].dtype == np.uint32
    r0 = np.load(tmp_path / "stark-fri-r0.npz")["codeword"]
    assert r0.shape == (4, stark.fri_domain_length)
    last = np.load(tmp_path / f"stark-fri-r{stark.fri.num_rounds - 1}.npz")["codeword"]
    assert last.shape == (4, stark.fri_domain_length >> (stark.fri.num_rounds - 1))
    # a truncated or foreign file is no snapshot: load says None, never raises
    assert ckpt.load(str(tmp_path), "pre-fri", dict(doc["meta"], seed="00")) is None
    (tmp_path / "stark-pre-fri.json").write_text("{not json")
    assert ckpt.load(str(tmp_path), "pre-fri", doc["meta"]) is None
    ckpt.clear(str(tmp_path), "pre-fri")
    assert not (tmp_path / "stark-pre-fri.npz").exists()


def test_resume_in_the_port_from_a_snapshot_the_jax_package_wrote(tmp_path, monkeypatch):
    inp, seed = 909, b"xpkg"
    rp, stark = _small_stark()
    rrp = ref_rp.RescuePrime()
    ref = ref_stark.Stark(ref_rp.RescuePrimeAir(rrp, chain_length=1), expansion_factor=4,
                          num_colinearity_checks=2)
    b = stark.air.boundary_constraints(rp.hash(inp))
    tr = rp.trace(inp)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_proof = ref.prove(tr, b, randomizer_seed=seed, checkpoint_dir=str(ref_dir))

    # The JAX package's files as they are: no "layout" in the metadata, so the
    # port refuses them and proves from scratch (same bytes all the same).
    lde = _count_calls(monkeypatch, Stark, "_trace_lde")
    scratch = tmp_path / "scratch"
    for path in glob.glob(str(ref_dir / "stark-pre-fri.*")):
        os.makedirs(scratch, exist_ok=True)
        with open(path, "rb") as src, open(scratch / os.path.basename(path), "wb") as dst:
            dst.write(src.read())
    assert stark.prove(tr, b, randomizer_seed=seed, checkpoint_dir=str(scratch)) == ref_proof
    assert lde["n"] == 1

    # Re-sliced through reference.py and saved under the port's metadata: the
    # port resumes (pre-FRI stage and every FRI round) without touching the
    # trace, to the JAX package's bytes.
    meta = stark._checkpoint_meta(b, stark._trace_digest(tr, False), seed)
    ref_meta = ref._checkpoint_meta(b, ref._trace_digest(tr, False), seed)
    assert {k: v for k, v in meta.items() if k != "layout"} == ref_meta
    stages = sorted(os.path.basename(p)[len("stark-"):-len(".json")]
                    for p in glob.glob(str(ref_dir / "stark-*.json")))
    assert stages == sorted(["pre-fri"] + [f"fri-r{r}" for r in range(ref.fri.num_rounds)])
    for stage in stages:
        with open(ref_dir / f"stark-{stage}.json") as fh:
            doc = json.load(fh)
        arrays = snapshot_from_reference(dict(np.load(ref_dir / f"stark-{stage}.npz")))
        ckpt.save(str(port_dir), stage, doc["items"], arrays, meta)
    comb = np.load(port_dir / "stark-pre-fri.npz")["comb"]
    np.testing.assert_array_equal(to_reference_limbs(to_tensor(comb, "cpu")),
                                  np.load(ref_dir / "stark-pre-fri.npz")["comb"])
    # at F = 1024 every live FRI round belongs to the host tail
    live = _count_calls(monkeypatch, frimod.Fri, "_host_tail")
    assert stark.prove(tr, b, randomizer_seed=seed, checkpoint_dir=str(port_dir)) == ref_proof
    assert lde["n"] == 1 and live["n"] == 0
    # only the pre-FRI stage converted: FRI runs live from the saved combination
    for path in glob.glob(str(port_dir / "stark-fri-r*")):
        os.remove(path)
    assert stark.prove(tr, b, randomizer_seed=seed, checkpoint_dir=str(port_dir)) == ref_proof
    assert lde["n"] == 1 and live["n"] == 1

    # The other way round: the JAX package refuses the port's snapshot
    # ("layout" is not in its metadata) and recomputes instead of misreading it.
    assert ref.prove(tr, b, randomizer_seed=seed, checkpoint_dir=str(port_dir)) == ref_proof
