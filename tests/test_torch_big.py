"""PyTorch port, the chunked big-domain prover (Stark._prove_big) and its
pieces, forced on at toy sizes the way tests/test_stark.py:202 forces the
JAX package's: proof bytes against the golden proof, the port's standard
path and the JAX package's big path; the chunked pair commit against
commit_columns and the JAX package's (tests/test_merkle.py:249); FRI with
round 0 committed chunked and offloaded, fresh and resumed, against the
port's own FRI (tests/test_fri.py:237, tests/test_stark.py:166;
tests/test_torch_fri.py holds that one to the JAX package's); checkpoint/resume on the big
path (tests/test_hardening.py:187). Tolerance 0: all exact integer math."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from stark_anatomy_tpu.iop import merkle as ref_merkle
from stark_anatomy_tpu.iop import stark as ref_stark
from stark_anatomy_tpu.models import rescue_prime as ref_rp
from stark_anatomy_tpu_torch.iop import merkle as merkle_mod
from stark_anatomy_tpu_torch.iop import stark as stark_mod
from stark_anatomy_tpu_torch.iop.fri import Fri
from stark_anatomy_tpu_torch.iop.merkle import (
    ChunkedPairCommit,
    commit_columns,
    commit_columns_chunked,
    verify_multiproof,
)
from stark_anatomy_tpu_torch.iop.proof_stream import ProofStream
from stark_anatomy_tpu_torch.iop.stark import Stark
from stark_anatomy_tpu_torch.models.fibonacci import FibonacciAir
from stark_anatomy_tpu_torch.models.mimc import MiMCAir, mimc
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops.limbs import random_felt_words, to_numpy, to_tensor
from stark_anatomy_tpu_torch.parallel import distributed, make_mesh
from stark_anatomy_tpu_torch.reference import to_reference_limbs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "proof_rescue_chain1.json")
INPUT = 20260817
SEED = b"golden-v1"
#: chain 15: 481 rows, O = 512, F = 2^13, the smallest Rescue-Prime domain
#: whose pair trees have 2^12 leaves, so a chunk of 2^12 columns engages
#: ChunkedPairCommit (at least 2048 leaves a chunk)
WIDE_CHAIN = 15


def _force_big(monkeypatch, chunk: int) -> None:
    monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1)
    monkeypatch.setattr(stark_mod, "_BIG_CHUNK", chunk)


def _rescue(chain: int = 1):
    rp = RescuePrime()
    air = RescuePrimeAir(rp, chain_length=chain)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    return rp, stark, air.boundary_constraints(rp.chain_output(INPUT, chain))


@pytest.fixture(scope="module")
def golden_bytes():
    with open(GOLDEN, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def jax_big_bytes():
    """The JAX package's forced big path, chain 1, seed golden-v1."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_stark, "_BIG_F_MIN", 1)
    mp.setattr(ref_stark, "_BIG_CHUNK", 256)
    try:
        rp = ref_rp.RescuePrime()
        air = ref_rp.RescuePrimeAir(rp, chain_length=1)
        stark = ref_stark.Stark(air, expansion_factor=4, num_colinearity_checks=2)
        return stark.prove(rp.trace(INPUT), air.boundary_constraints(rp.hash(INPUT)), randomizer_seed=SEED)
    finally:
        mp.undo()


# -- (a), (b): the whole prove -------------------------------------------------


@pytest.mark.parametrize("chunk", [256, 64], ids=["chunk256", "chunk64"])
@pytest.mark.parametrize("as_bytes", [False, True], ids=["int-trace", "bytes-trace"])
def test_forced_big_path_gives_the_golden_bytes_and_those_of_both_packages(
        monkeypatch, golden_bytes, jax_big_bytes, as_bytes, chunk):
    rp, stark, boundary = _rescue()
    trace = rp.trace_bytes(INPUT, 1) if as_bytes else rp.trace(INPUT)
    standard = stark.prove(trace, boundary, randomizer_seed=SEED)
    draws = []
    real_draw = Stark._zk_coefficients

    def draw(key, n, device, columns=None, out=None):
        draws.append(n if columns is None else len(columns))
        return real_draw(key, n, device, columns, out)

    monkeypatch.setattr(Stark, "_zk_coefficients", staticmethod(draw))
    _force_big(monkeypatch, chunk)  # F = 1024: 4 or 16 chunks
    assert stark._big and stark._big_chunk_len() == chunk
    big = stark.prove(trace, boundary, randomizer_seed=SEED)
    assert big == golden_bytes == standard == jax_big_bytes
    # the zk draw (degree_target + 1 = 256 columns) in chunks of the chunk length
    assert draws == [min(chunk, 256)] * (256 // min(chunk, 256))
    assert stark.verify(big, boundary)


def test_forced_big_path_with_the_chunked_pair_commit_gives_the_standard_bytes(monkeypatch):
    rp, stark, boundary = _rescue(WIDE_CHAIN)
    assert stark.fri_domain_length == 1 << 13
    trace = rp.trace(INPUT, WIDE_CHAIN)
    standard = stark.prove(trace, boundary, randomizer_seed=SEED)
    finished = []
    real_finish = ChunkedPairCommit.finish

    def finish(self, leaf_columns):
        finished.append(self.chunk_leaves)
        return real_finish(self, leaf_columns)

    monkeypatch.setattr(ChunkedPairCommit, "finish", finish)
    _force_big(monkeypatch, 1 << 12)
    big = stark.prove(trace, boundary, randomizer_seed=SEED)
    assert big == standard
    assert finished == [1 << 12, 1 << 12]  # the zk tree, then the boundary-quotient tree
    assert stark.verify(big, boundary)


class _Dense:
    """An AIR seen without its periodic_columns(): only the dense
    constant_columns(num_rows) remain."""

    def __init__(self, air):
        self._air = air

    def __getattr__(self, name):
        if name in ("periodic_columns", "constant_columns_bytes"):
            raise AttributeError(name)
        return getattr(self._air, name)


def _air_case(name: str):
    """(air, trace, boundary) at the sizes of tests/test_torch_airs.py."""
    if name == "fibonacci":
        air = FibonacciAir(num_steps=40)
        return air, air.trace(), air.boundary_constraints(air.output())
    air = MiMCAir(num_steps=60)
    boundary = air.boundary_constraints(mimc(31337, 60))
    return (_Dense(air) if name == "mimc-dense" else air), air.trace(31337), boundary


@pytest.mark.parametrize("name", ["fibonacci", "mimc", "mimc-dense"])
def test_forced_big_path_gives_the_standard_bytes_for_every_air_shape(monkeypatch, name):
    air, trace, boundary = _air_case(name)
    stark = Stark(air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    standard = stark.prove(trace, boundary, randomizer_seed=b"airs-v1")
    _force_big(monkeypatch, stark.fri_domain_length // 4)
    big = stark.prove(trace, boundary, randomizer_seed=b"airs-v1")
    assert big == standard
    assert stark.verify(big, boundary)


def test_a_single_chunk_is_never_asked_for(monkeypatch):
    rp, stark, boundary = _rescue()
    _force_big(monkeypatch, 1 << 20)  # longer than F: capped at F/2, two chunks
    assert stark._big_chunk_len() == stark.fri_domain_length // 2
    assert stark.prove(rp.trace(INPUT), boundary, randomizer_seed=SEED) == \
        stark.prove(rp.trace(INPUT), boundary, randomizer_seed=SEED) != b""


# -- (d) checkpoint and resume ---------------------------------------------------


def test_checkpoint_and_resume_on_the_big_path_give_identical_bytes(tmp_path, monkeypatch, golden_bytes):
    rp, stark, boundary = _rescue()
    _force_big(monkeypatch, 256)
    d = str(tmp_path)
    first = stark.prove(rp.trace(INPUT), boundary, randomizer_seed=SEED, checkpoint_dir=d)
    commits = []
    real = stark_mod.commit_columns_chunked

    def counting(columns, *args, **kwargs):
        commits.append(type(columns[0]))
        return real(columns, *args, **kwargs)

    monkeypatch.setattr(stark_mod, "commit_columns_chunked", counting)
    again = Stark(stark.air, expansion_factor=4, num_colinearity_checks=2, device="cpu")
    second = again.prove(rp.trace(INPUT), boundary, randomizer_seed=SEED, checkpoint_dir=d)
    assert first == second == golden_bytes
    # resumed: both trees re-committed chunk-wise from the host arrays
    assert commits == [np.ndarray, np.ndarray]
    assert again.verify(second, boundary)


# -- (e) the chunked pair commit ---------------------------------------------------


@pytest.fixture(scope="module")
def wide_columns():
    rng = np.random.default_rng(11)
    return [random_felt_words(rng, 1 << 13) for _ in range(2)]


@pytest.fixture(scope="module")
def ref_chunked_tree(wide_columns):
    cols = [jnp.asarray(to_reference_limbs(to_tensor(c, "cpu"))) for c in wide_columns]
    return ref_merkle.commit_columns_chunked(cols, chunk_leaves=2048)


@pytest.mark.parametrize("where", ["device-tensors", "host-numpy"])
def test_chunked_commit_equals_commit_columns_and_the_reference(wide_columns, ref_chunked_tree, where):
    tensors = [to_tensor(c, "cpu") for c in wide_columns]
    want = commit_columns(tensors, pair=True)
    got = commit_columns_chunked(tensors if where == "device-tensors" else wide_columns,
                                 chunk_leaves=2048, device="cpu")
    ref = ref_chunked_tree
    assert got.root == want.root == ref.root
    assert got.num_leaves == want.num_leaves == ref.num_leaves == 1 << 12
    assert all(got.levels[lv] is None for lv in range(11)) and got.levels[11] is not None
    assert got.dropped_levels == 11 and got.height == want.height
    # host columns stay on the host
    assert isinstance(got.leaf_columns[0], np.ndarray if where == "host-numpy" else torch.Tensor)
    for i in (0, 1, 2047, 2048, 4095):
        assert got.open(i) == want.open(i) == ref.open(i)
    opened = sorted({0, 5, 2048, 4095})
    nodes = got.open_multi(opened)
    assert nodes == want.open_multi(opened) == ref.open_multi(opened)
    leaves = {i: to_numpy(want.levels[0][:, i]).astype("<u4").tobytes() for i in opened}
    assert verify_multiproof(got.root, leaves, nodes, got.height)
    assert got.open_many([3, 2049, 3]) == want.open_many([3, 2049, 3]) == ref.open_many([3, 2049, 3])


def test_a_pruned_tree_rebuilds_each_opened_block_once_in_one_batch(wide_columns, monkeypatch):
    tree = commit_columns_chunked(wide_columns, chunk_leaves=2048, device="cpu")
    calls = []
    real = merkle_mod.blake2b_planes

    def counting(msg, msg_len):
        calls.append(msg.shape[1])
        return real(msg, msg_len)

    monkeypatch.setattr(merkle_mod, "blake2b_planes", counting)
    tree.open_multi([0, 7, 2048, 4000])  # two blocks of 2^11 leaves
    assert calls == [2 * 2048] and sorted(tree._blocks) == [0, 1]
    tree.open_many([1, 4095])
    tree.open(2048)
    assert calls == [2 * 2048]  # nothing rebuilt twice


def test_offloading_a_pruned_tree_repoints_its_leaf_columns_and_changes_no_opening(wide_columns):
    tensors = [to_tensor(c, "cpu") for c in wide_columns]
    want = commit_columns(tensors, pair=True)
    got = commit_columns_chunked(tensors, chunk_leaves=2048)
    with pytest.raises(ValueError, match="host copies"):
        got.offload_to_host()
    got.offload_to_host([to_numpy(t) for t in tensors])
    assert all(isinstance(c, np.ndarray) for c in got.leaf_columns)
    assert all(lv is None or isinstance(lv, np.ndarray) for lv in got.levels)
    assert got.open_multi([0, 7, 2048, 4095]) == want.open_multi([0, 7, 2048, 4095])


def test_tiny_chunked_commit_is_the_whole_commit_and_offload_changes_no_digest(wide_columns):
    small = [to_tensor(c[:, :256], "cpu") for c in wide_columns]
    want = commit_columns(small, pair=True)
    got = commit_columns_chunked(small)
    assert got.root == want.root and got.levels[0] is not None
    got.offload_to_host()
    assert all(isinstance(lv, np.ndarray) for lv in got.levels)
    assert got.open_multi([0, 9, 127]) == want.open_multi([0, 9, 127])
    with pytest.raises(ValueError):
        ChunkedPairCommit(1024, 64)


# -- (g) FRI's chunked commit and offload ----------------------------------------------


@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "resumed"])
def test_fri_with_round_0_committed_chunked_and_offloaded_gives_the_same_transcript(
        tmp_path, monkeypatch, resumed):
    n = 1 << 13
    rng = np.random.default_rng(5)
    coeffs = fk.to_mont(to_tensor(random_felt_words(rng, n // 4), "cpu"))
    cw = nttmod.coset_evaluate(coeffs, n, 3)
    fri = Fri(3, n, 4, 4, host_tail_n=1 << 9)
    ps = ProofStream()
    top = fri.prove(cw, ps)
    d = str(tmp_path) if resumed else None
    if resumed:
        # snapshots of every round, then only round 0's kept: the resumed
        # prove replays round 0 (re-committed chunked) and runs the rest
        fri.prove(cw, ProofStream(), checkpoint_dir=d, big_chunk=2048, round0_host=np.empty((4, n), np.uint32))
        for name in os.listdir(d):
            if not name.startswith("stark-fri-r0."):
                os.remove(os.path.join(d, name))
    chunked, offloaded = [], []
    real_finish, real_offload = ChunkedPairCommit.finish, Fri._offload_round0

    def finish(self, leaf_columns):
        chunked.append(self.chunk_leaves)
        return real_finish(self, leaf_columns)

    def offload(codewords, trees, dst):
        offloaded.append(len(codewords))
        real_offload(codewords, trees, dst)
        assert codewords[0] is dst and isinstance(trees[0].leaf_columns[0], np.ndarray)
        assert all(lv is None or isinstance(lv, np.ndarray) for lv in trees[0].levels)

    monkeypatch.setattr(ChunkedPairCommit, "finish", finish)
    monkeypatch.setattr(Fri, "_offload_round0", staticmethod(offload))
    forced = ProofStream()
    assert fri.prove(cw, forced, checkpoint_dir=d, big_chunk=2048, round0_host=np.empty((4, n), np.uint32)) == top
    assert forced.serialize() == ps.serialize()
    assert chunked == [2048]  # round 0 alone, in two chunks of 2048 leaves
    assert offloaded == [2]  # once round 1 is committed
    ok, _ = fri.verify(ProofStream.deserialize(forced.serialize()))
    assert ok


# -- (h) a mesh at big domains ---------------------------------------------------------


class _Recorder(TorchDispatchMode):
    """Records the ops run while on, with the widest int32 (4, ...) tensor
    any of them created."""

    def __init__(self):
        super().__init__()
        self.ops, self.widest = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(str(func))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.dim() and t.shape[0] == 4:
                self.widest = max(self.widest, t.numel() // 4)
        return out


@pytest.fixture
def one_process_group(tmp_path, monkeypatch):
    """A torch.distributed group of this process alone (gloo), destroyed
    after the test."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    yield distributed.world_group()
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("group", ["no-group", "one-process-group"])
def test_a_mesh_without_a_group_is_refused_before_any_allocation_at_big_domains(monkeypatch, request,
                                                                                 group):
    # one rule for every mesh: a block F/W at least _BIG_F_MIN is refused,
    # and a world of one process holds the whole F
    rp, stark, boundary = _rescue()
    trace = rp.trace(INPUT)
    group = request.getfixturevalue("one_process_group") if group == "one-process-group" else None
    meshed = Stark(stark.air, expansion_factor=4, num_colinearity_checks=2,
                   mesh=make_mesh(8, "cpu", group=group))
    _force_big(monkeypatch, 256)
    with _Recorder() as rec, pytest.raises(ValueError, match="F/W = .* big-domain size"):
        meshed.prove(trace, boundary, randomizer_seed=SEED)
    assert rec.ops == []
    monkeypatch.setattr(stark_mod, "_BIG_F_MIN", 1 << 20)
    assert meshed.prove(trace, boundary, randomizer_seed=SEED) == stark.prove(trace, boundary, randomizer_seed=SEED)


# -- (i) the boundary quotients reach F only on the host ---------------------------------


def test_no_f_wide_tensor_is_made_while_the_boundary_quotients_are_committed(monkeypatch):
    rp, stark, boundary = _rescue(WIDE_CHAIN)
    blk = 1 << 11  # F / 4
    real = Stark._boundary_commit_chunked
    seen = []

    def guarded(self, *args, **kwargs):
        with _Recorder() as rec:
            out = real(self, *args, **kwargs)
        seen.append(rec.widest)
        return out

    monkeypatch.setattr(Stark, "_boundary_commit_chunked", guarded)
    _force_big(monkeypatch, blk)
    proof = stark.prove(rp.trace(INPUT, WIDE_CHAIN), boundary, randomizer_seed=SEED)
    assert seen == [blk]  # chunk-wide tensors, none wider: the quotients reach F on the host only
    assert stark.verify(proof, boundary)
