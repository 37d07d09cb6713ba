"""STARK prover/verifier over an AIR, evaluation-form, on one device.

Counterpart of the JAX package's iop/stark.py (the standard branch, without
or with a mesh); same transcript and, for a fixed ``randomizer_seed``, the
same proof bytes. Protocol follows Szepieniec's "Anatomy of a STARK" parts 5/6 with no
symbolic polynomial arithmetic on the hot path: every quotient is computed
pointwise on the LDE coset domain, where zerofiers never vanish, through the
field kernels (ops/field_kernels.py) on (4, n) Montgomery word planes:

  prover pipeline (all on ``device``):
    trace columns --iNTT--> coeffs --coset NTT--> trace LDE
    boundary quotients  bq_j = (t_j - B_j) * inv(Z_boundary_j)
    transition codewords from the AIR (vectorised over the domain; the next
      row is the LDE rolled by F/O positions)
    transition quotients tq_k = C_k * inv(Z_transition)
    combination = R + sum_t (alpha_t + beta_t * x^shift_t) * term_t
      where R is the committed zero-knowledge randomizer codeword (a
      uniformly random polynomial at FRI's degree bound)
    FRI on the combination codeword (iop/fri.py)

  degree bookkeeping: terms are lifted to a common degree D-1 (D = next
  power of two above the largest quotient degree) by the random
  beta * x^shift mixing; the FRI domain is D * expansion_factor points on
  the coset g*<omega>, disjoint from the trace domain since the full-order
  generator g lies in no power-of-two subgroup.

  zero-knowledge: the trace is padded to the full power-of-two omicron
  domain with pseudorandom rows (blinding the opened boundary-quotient
  leaves), and the FRI randomizer R blinds the combination leaves. Both
  derive from randomizer_seed: fresh os.urandom entropy by default; pass a
  fixed seed for the deterministic mode.

There is ONE prover path, eager, the same ops at every size. Field math is
exact and every stored value is the canonical representative, so neither
evaluation order nor batching can change a byte.

The prover is AIR-generic: an AIR names its registers, cycle count,
constraint degree and number, evaluates its transition constraints on the
device and on the host, and describes its constant columns as
``periodic_columns()`` (succinct on both sides), else as dense
``constant_columns_bytes(O)`` or ``constant_columns(O)`` (each column
extended like a trace column; none at all is valid).

The prover has two modes. Without a mesh, every codeword is one whole
tensor on ``device``. ``Stark(mesh=...)`` (parallel/mesh.py ``make_mesh``)
cuts every column's domain into the mesh's S shards over the W processes of
its world (one process for a mesh made without a process group): the trace
columns are extended through the four-step sharded transforms
(parallel/ntt_sharded.py), every device commit is the sharded one
(parallel/merkle_sharded.py), and the prove is block-local: every process
calls ``prove`` with the same trace, boundary and seed, and holds only its
(4, F/W) natural-layout block of every codeword, global columns
[rank*F/W, (rank+1)*F/W). Tables (x^s, the
periodic constants, the zerofier tile) are built for the block alone, the
zk coefficients are drawn in the cyclic layout the sharded coset
evaluation takes, the next-row codewords take a halo of F/O columns from
the next process (``roll_left``), and the openings read the blocks through
one ``owner_gather``; domains too small for the four-step transform
(S^2 not dividing O) are computed whole and cut. Every process returns the
proof bytes of the prover without a mesh, and the verifier never looks at
it.

From ``_BIG_F_MIN`` on (F = 2^28: the first FRI domain whose standard
prove does not fit an 80 GB card) a prove without a mesh takes the CHUNKED
big-domain path (``_prove_big``): the zk randomizer codeword and its commit
first, on the empty card (its root still enters the transcript after
bq_root); the trace LDE; the boundary quotients in mirrored pairs of domain
chunks of ``_BIG_CHUNK`` columns, streamed to host numpy and committed chunk
by chunk (iop/merkle.py ``ChunkedPairCommit``: upper levels on the host,
bottom levels rebuilt on opening); the transition quotients and the
combination chunk by chunk into one preallocated codeword, the
boundary-quotient terms re-derived per chunk from the trace LDE; then the
zk codeword to the host, and FRI (its round 0 committed chunked and moved to
the host, iop/fri.py ``prove(big_chunk=)``). The copies to the host land in
the prover's HostPool (ops/host_pool.py): page-locked arrays on a CUDA
device, allocated by the first big prove and reused by every later one.
Every value is pointwise, so the chunks change no byte. The F-point coset
evaluations stay whole: at F = 2^28 they fit the card beside the rest. The
big path has no mesh form: a mesh whose block F/W reaches _BIG_F_MIN is
refused (ValueError, before any allocation); prove without a mesh, or over
more processes.

``prove(checkpoint_dir=...)`` snapshots the expensive intermediates before
FRI and after every FRI round (utils/checkpoint.py) and resumes from them.

The verifier replays the transcript in exact host arithmetic: FRI
verification, pointwise reconstruction of trace values from the opened
boundary-quotient leaves, constraint evaluation, and a combination-value
equality check at every queried index. It touches no device unless the AIR
has dense constant columns, whose values at the queried rows are gathered
from their codewords on ``device``.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
import warnings
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from stark_anatomy_tpu_torch.iop.fri import Fri, commit, snapshot
from stark_anatomy_tpu_torch.iop.merkle import (
    MIN_CHUNK_LEAVES,
    ChunkedPairCommit,
    commit_columns_chunked,
    gather_requests,
    verify_multiproof,
)
from stark_anatomy_tpu_torch.iop.proof_stream import ProofStream, ProofStreamError
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops import trace_layout
from stark_anatomy_tpu_torch.ops.field import (
    GENERATOR,
    PRIME,
    finv,
    host_intt,
    host_ntt,
    host_poly_eval,
    primitive_root_of_unity,
    sample_field_element,
)
from stark_anatomy_tpu_torch.ops.host_pool import HostPool, copied
from stark_anatomy_tpu_torch.ops.limbs import (
    bytes_to_words,
    copy_to_numpy,
    ints_to_bytes,
    ints_to_words,
    mont,
    require_device,
    to_numpy,
    to_tensor,
    words_to_ints,
)
from stark_anatomy_tpu_torch.parallel.mesh import block_start, roll_left, shard, upload_block
from stark_anatomy_tpu_torch.parallel.ntt_sharded import (
    CYCLIC,
    cyclic_indices,
    four_step_fits,
    sharded_coset_evaluate,
    sharded_lde,
)
from stark_anatomy_tpu_torch.utils import checkpoint, telemetry, threefry
from stark_anatomy_tpu_torch.utils.encoding import (
    digest_to_item,
    felt_to_item,
    hash_felts,
    item_to_digest,
    item_to_felt,
)

# Domain-separation tags are part of the proof system: they keep the
# original package's name so both packages derive the same bytes.
_RANDOMIZER_TAG = b"stark_anatomy_tpu/trace-randomizer/v1"
_ZK_TAG = b"stark_anatomy_tpu/zk-fri-randomizer/v1"

#: FRI domains at least this long are proved by the chunked big-domain path
#: when there is no mesh: 2^28, the first F whose standard prove does not fit
#: an 80 GB H100 (F = 2^27 peaks at 65.6 GB there, and the peak doubles with F).
_BIG_F_MIN = 1 << 28
#: Chunk length of the big path's pointwise phases, capped at F/2 so the
#: chunk count is even (the boundary-quotient commit walks mirrored pairs).
_BIG_CHUNK = 1 << 22


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _lagrange_coeffs(points: List[Tuple[int, int]]) -> List[int]:
    """Exact host Lagrange interpolation -> coefficient list (low first)."""
    k = len(points)
    coeffs = [0] * k
    for i, (xi, yi) in enumerate(points):
        # basis_i(x) = prod_{j!=i} (x - xj) / (xi - xj)
        basis = [1]
        denom = 1
        for j, (xj, _) in enumerate(points):
            if j == i:
                continue
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d] = (new[d] - c * xj) % PRIME
                new[d + 1] = (new[d + 1] + c) % PRIME
            basis = new
            denom = denom * (xi - xj) % PRIME
        scale = yi * finv(denom) % PRIME
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + scale * c) % PRIME
    return coeffs


def _block(n: int, mesh) -> Tuple[int, int]:
    """(first global column, width) of this process's part of a length-n
    codeword: its block under a mesh, else the whole."""
    if mesh is not None:
        return block_start(n, mesh), n // mesh.world
    return 0, n


def _chunk_tiler(period: torch.Tensor, blk: int):
    """c -> columns [c*blk, (c+1)*blk) of the periodic tiling of `period`;
    one tile serves every chunk when the period divides blk."""
    if blk % period.shape[1] == 0:
        tile = _tile(period, 0, blk)
        return lambda c: tile
    return lambda c: _tile(period, c * blk, blk)


def _rolled_slice(t: torch.Tensor, start: int, blk: int) -> torch.Tensor:
    """Columns [start, start+blk) of t with wraparound: chunk c of
    torch.roll(t, -start_0) for start = c*blk + start_0."""
    f = t.shape[1]
    start %= f
    if start + blk <= f:
        return t[:, start : start + blk]
    return torch.cat([t[:, start:], t[:, : start + blk - f]], dim=1)


def _horner(coeffs: List[int], x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out <- sum_d coeffs[d] * x^d at Montgomery points x, Montgomery form;
    host coefficients low first, at least two: 2 (len - 1) launches."""
    fk.mont_mul(x, mont(coeffs[-1]), out=out)
    for d in range(len(coeffs) - 2, -1, -1):
        if d < len(coeffs) - 2:
            fk.mont_mul(out, x, out=out)
        fk.add(out, mont(coeffs[d]), out=out)
    return out


def _add_lifted(acc, term, s: int, table, scale: int, weights) -> None:
    """acc += (alpha + beta * x^s) * term, Montgomery, in place on term and
    acc, for weights (alpha, beta). x^s = scale * table at the term's points
    (table None for s = 0): 4 launches, 2 for s = 0."""
    alpha, beta = weights
    if s:
        lift = fk.add(fk.mont_mul(table, mont(beta * scale % PRIME)), mont(alpha))
        fk.mont_mul(lift, term, out=term)
    else:
        fk.mont_mul(term, mont((alpha + beta) % PRIME), out=term)
    fk.add(acc, term, out=acc)


def _tile(period: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Columns start .. start+count-1 of the periodic tiling of `period`
    (4, blk): a repeat where the part starts and ends on the period, else a
    gather by global column (a block need not start on a period)."""
    blk = period.shape[1]
    if start % blk == 0 and count % blk == 0:
        return period.repeat(1, count // blk)
    idx = torch.arange(start, start + count, dtype=torch.int64, device=period.device) % blk
    return period.index_select(1, idx)


def sample_weights(seed: bytes, count: int) -> List[int]:
    """Deterministic transcript-derived field elements (domain-separated)."""
    return [
        sample_field_element(seed + b"weight" + k.to_bytes(8, "big"))
        for k in range(count)
    ]


@contextlib.contextmanager
def _phase(name: str, device: torch.device):
    """A telemetry phase whose host clock also covers the device work queued
    inside it (kernel launches are asynchronous): it ends with a synchronise,
    a device-wait. On a CUDA device it also starts the device clock."""
    with telemetry.device_phase(name, device):
        yield
        if device.type == "cuda":
            with telemetry.device_wait(device):
                torch.cuda.synchronize(device)


#: Named soundness profiles. Bits shown are the FRI query term, the binding
#: term of security_terms() at these sizes, under (conjectured 1-rho, proven
#: Johnson) proximity. Blowup stays at 4 across the production profiles:
#: more queries and grinding raise soundness where doubling the blowup would
#: double every codeword, commit and fold.
PROFILES = {
    # CI/toy: fast, NOT secure; for tests and examples only.
    "test": dict(
        expansion_factor=4, num_colinearity_checks=2, grinding_bits=0,
        _bits=(4, 2),
    ),
    # Historical default: ~32 bits conjectured.
    "default": dict(
        expansion_factor=4, num_colinearity_checks=16, grinding_bits=0,
        _bits=(32, 16),
    ),
    # >= 80-bit conjectured target: 32*2 + 16 = 80.
    "production-80": dict(
        expansion_factor=4, num_colinearity_checks=32, grinding_bits=16,
        _bits=(80, 48),
    ),
    # 128-bit QUERY soundness: 56*2 + 16 = 128. At production domain sizes
    # the OVERALL conjectured level reported by security_level() is capped
    # near 99 bits by the fold_sampling union term log2(p / (F * rounds)),
    # inherent to challenges drawn from this 128-bit base field.
    "production-128": dict(
        expansion_factor=4, num_colinearity_checks=56, grinding_bits=16,
        _bits=(128, 72),
    ),
}


@dataclass
class Stark:
    """STARK for one AIR shape (register count, cycle count, degree).

    device: where the prover's codewords live; ``"cuda"`` (the default)
    raises when no card is present, ``"cpu"`` runs the plain PyTorch
    versions of every kernel. The verifier is host-only either way.
    grinding_bits: transcript proof-of-work bits before query sampling
    (iop/fri.py); adds directly to the FRI soundness bits.
    fri_host_tail_n: FRI codewords of at most this length finish on the host.
    mesh: an optional parallel.Mesh; the prover then runs on the mesh's
    device (``device`` is set from it), block-local, through the sharded
    transforms and commits.
    """

    air: object
    expansion_factor: int = 4
    num_colinearity_checks: int = 16
    num_randomizers: int | None = None
    grinding_bits: int = 0
    device: str = "cuda"
    fri_host_tail_n: int = 1 << 14
    mesh: object | None = None
    _cache: dict = dc_field(default_factory=dict, repr=False)
    #: the big path's host buffers, made by its first prove (ops/host_pool.py)
    _host_pool: HostPool = dc_field(default_factory=HostPool, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.mesh is not None:
            self.device = str(self.mesh.device)
        if self.num_randomizers is None:
            self.num_randomizers = 4 * self.num_colinearity_checks
        # The transition zerofier is (x^O - 1) divided by one (x - omicron^r)
        # factor PER padding row past the trace end; the factor's coefficients
        # are multiplied out on the host in O(padding^2).
        padding = self.omicron_domain_length - self.trace_length
        if padding > 4096:
            warnings.warn(
                f"trace fills {self.trace_length}/{self.omicron_domain_length} "
                f"rows of the omicron domain; {padding} padding rows make the "
                "transition-zerofier product proportionally long: size the "
                "trace so trace_length + num_randomizers nearly fills a power "
                "of two (RescuePrime with 64 randomizers: the largest chain "
                "with 32*chain + 65 <= 2^k, e.g. 8189, 32765)",
                stacklevel=2,
            )

    # -- derived domain parameters ----------------------------------------

    @property
    def trace_length(self) -> int:
        return self.air.cycle_count

    @property
    def num_registers(self) -> int:
        return self.air.num_registers

    @property
    def omicron_domain_length(self) -> int:
        return _next_pow2(self.trace_length + self.num_randomizers)

    @property
    def omicron(self) -> int:
        return primitive_root_of_unity(self.omicron_domain_length)

    @property
    def transition_quotient_degree(self) -> int:
        o = self.omicron_domain_length
        return self.air.constraint_degree * (o - 1) - (self.trace_length - 1)

    def boundary_zerofier_degrees(self, boundary) -> List[int]:
        return [
            sum(1 for (c, r, v) in boundary if r == j)
            for j in range(self.num_registers)
        ]

    @property
    def max_degree(self) -> int:
        # Transition quotients dominate for constraint_degree >= 2; for
        # linear AIRs a boundary quotient of degree up to O-2 can be the
        # largest term.
        return max(self.transition_quotient_degree, self.omicron_domain_length - 2)

    @property
    def fri_domain_length(self) -> int:
        return _next_pow2(self.max_degree + 1) * self.expansion_factor

    @property
    def degree_target(self) -> int:
        """All combination terms are lifted to exactly this degree."""
        return _next_pow2(self.max_degree + 1) - 1

    @property
    def omega(self) -> int:
        return primitive_root_of_unity(self.fri_domain_length)

    @property
    def offset(self) -> int:
        return GENERATOR

    @property
    def expansion_shift(self) -> int:
        """Index distance on the FRI domain corresponding to one trace row."""
        return self.fri_domain_length // self.omicron_domain_length

    @property
    def fri(self) -> Fri:
        return Fri(
            offset=self.offset,
            domain_length=self.fri_domain_length,
            expansion_factor=self.expansion_factor,
            num_colinearity_tests=self.num_colinearity_checks,
            grinding_bits=self.grinding_bits,
            host_tail_n=self.fri_host_tail_n,
            mesh=self.mesh,
        )

    # -- soundness accounting ----------------------------------------------

    def security_terms(self, conjectured: bool = True) -> dict:
        """Every soundness term of the full protocol, in bits.

        The protocol's soundness error is the sum of the per-phase cheating
        probabilities; the LEVEL is the minimum term (the attacker takes the
        cheapest path):

        - fri_queries: the FRI query phase (iop/fri.py security_bits):
          q * log2(blowup) conjectured / q * log2(blowup)/2 proven, plus
          grinding_bits of transcript proof-of-work.
        - combination_sampling: the random linear combination of the
          quotients uses 2 transcript-sampled field weights per term; a
          quotient that is NOT low-degree survives only if the weighted sum
          cancels its high coefficients: probability <= max_degree / p.
        - fold_sampling: each of the ~log2(F) FRI fold challenges collapses
          a far word to a near one with probability <= domain_length / p.
        - fiat_shamir: transcripts are bound by SHA-256 => 128-bit collision
          security on challenge derivation.
        - merkle: commitments are Blake2b-512 => 256-bit collision
          resistance on every opened path.
        """
        f = self.fri
        p_bits = 128  # log2(PRIME) ~ 127.999..; floor to be conservative
        rounds = f.num_rounds
        return {
            "fri_queries": f.security_bits(conjectured),
            "combination_sampling": p_bits - math.ceil(math.log2(self.max_degree + 1)),
            "fold_sampling": p_bits
            - math.ceil(math.log2(self.fri_domain_length * max(rounds, 1))),
            "fiat_shamir": 128,
            "merkle": 256,
        }

    def security_level(self, conjectured: bool = True) -> int:
        """Overall soundness in bits = the weakest security_terms() entry."""
        return int(min(self.security_terms(conjectured).values()))

    @classmethod
    def from_profile(cls, name: str, air, **overrides) -> "Stark":
        """Construct with a named (expansion, queries, grinding) profile;
        extra keyword arguments (device=, num_randomizers=) pass through."""
        if name not in PROFILES:
            raise ValueError(f"unknown profile {name!r}; have {sorted(PROFILES)}")
        params = {k: v for k, v in PROFILES[name].items() if not k.startswith("_")}
        params.update(overrides)
        return cls(air, **params)

    # -- host precomputations ------------------------------------------------

    def _periodic_coeffs(self):
        """(period, per-column interpolant coefficients), host, exact.

        Column c's omicron-domain interpolant is Q_c(x^(O/period)) where Q_c
        (degree < period) interpolates the period values on the subgroup of
        order `period`: the identity that keeps both sides succinct (the
        verifier Horner-evaluates Q_c at x^(O/period); the prover tiles a
        period*blowup-length block over the FRI domain)."""
        if "periodic_host" not in self._cache:
            period, cols = self.air.periodic_columns()
            if self.omicron_domain_length % period:
                raise ValueError("periodic-column period must divide the omicron domain")
            self._cache["periodic_host"] = (
                period,
                [host_intt([v % PRIME for v in col]) for col in cols],
            )
        return self._cache["periodic_host"]

    def eval_periodic_at(self, x: int) -> List[int]:
        """Every periodic column's interpolant at host point x (exact)."""
        period, coeffs = self._periodic_coeffs()
        y = pow(x, self.omicron_domain_length // period, PRIME)
        return [host_poly_eval(q, y) for q in coeffs]

    def _excluded_coeffs(self) -> List[int]:
        """Host-exact coefficients of prod_{r=T-1}^{O-1}(x - omicron^r), the
        transition zerofier's excluded-row factor."""
        o = self.omicron_domain_length
        coeffs = [1]
        for r in range(self.trace_length - 1, o):
            root = pow(self.omicron, r, PRIME)
            nxt = [0] * (len(coeffs) + 1)
            for i, c in enumerate(coeffs):
                nxt[i] = (nxt[i] - c * root) % PRIME
                nxt[i + 1] = (nxt[i + 1] + c) % PRIME
            coeffs = nxt
        return coeffs

    def _boundary_polys(self, boundary) -> List[dict]:
        """Per-register interpolant coeffs + zerofier root list (host)."""
        out = []
        for j in range(self.num_registers):
            pts = [
                (pow(self.omicron, c, PRIME), v)
                for (c, r, v) in boundary
                if r == j
            ]
            out.append(
                {
                    "interpolant": _lagrange_coeffs(pts) if pts else [0],
                    "roots": [x for (x, _) in pts],
                }
            )
        return out

    def _boundary_eval_host(self, bp: dict, x: int) -> Tuple[int, int]:
        """(B_j(x), Z_boundary_j(x)) at a host point."""
        acc, xp = 0, 1
        for c in bp["interpolant"]:
            acc = (acc + c * xp) % PRIME
            xp = xp * x % PRIME
        z = 1
        for r in bp["roots"]:
            z = z * (x - r) % PRIME
        return acc, z

    # -- device codewords ----------------------------------------------------

    def _mont_column(self, values: Sequence[int], device) -> torch.Tensor:
        """Host field elements -> (4, n) Montgomery word planes on device."""
        return to_tensor(ints_to_words([mont(v) for v in values]), device)

    def _x_pow_codeword(self, s: int, device) -> torch.Tensor:
        """(4, F) Montgomery evals of x^s on the FRI coset (this process's
        block under a mesh: the powers table starts at its first column)."""
        start, count = _block(self.fri_domain_length, self.mesh)
        tab = nttmod.powers(pow(self.omega, s, PRIME), count, device, start=start)
        return fk.mont_mul(tab, mont(pow(self.offset, s, PRIME)), out=tab)

    def column_lde_words(self, words: np.ndarray, device, mesh=None) -> torch.Tensor:
        """(4, O) uint32 standard-form column -> (4, F) Montgomery LDE,
        through the sharded transforms under `mesh` (this process's block:
        only its block of the column is uploaded)."""
        o = self.omicron_domain_length
        if words.shape != (4, o):
            raise ValueError(f"expected (4, {o}) word planes, got {words.shape}")
        f = self.fri_domain_length
        if mesh is not None and four_step_fits(o, mesh.shards):
            # four exchanges: iNTT -> CYCLIC coefficients, local offset
            # scale and pad, NTT cyclic -> natural (S^2 | O gives S^2 | F)
            with telemetry.phase("lde-upload"):
                block = upload_block(words, mesh, device)
            with telemetry.phase("lde-ntt"):
                return sharded_lde(fk.to_mont(block), f, self.offset, mesh)
        # Tiny domains: the single-device transform (the same values).
        with telemetry.phase("lde-upload"):
            column = to_tensor(words, device)
        with telemetry.phase("lde-ntt"):
            lde = nttmod.coset_evaluate(nttmod.intt(fk.to_mont(column)), f, self.offset)
        return lde if mesh is None else shard(lde, mesh)

    def _constants_codewords(self, device, mesh=None) -> List[torch.Tensor]:
        """(4, F) Montgomery codewords of the AIR's constant columns
        (under a mesh: this process's blocks).

        Periodic AIRs (periodic_columns): the codeword over the FRI coset
        repeats with period blk = period * F/O, so ONE blk-length block is
        evaluated exactly on the host and tiled on the device: no
        O(F log F) transforms; a process's block is indexed by global
        column. Other AIRs give dense omicron-domain columns, as canonical
        bytes or as ints, each extended like a trace column."""
        o = self.omicron_domain_length
        f = self.fri_domain_length
        if not hasattr(self.air, "periodic_columns"):
            if hasattr(self.air, "constant_columns_bytes"):
                cols = [bytes_to_words(c) for c in self.air.constant_columns_bytes(o)]
            else:
                cols = [ints_to_words(c) for c in self.air.constant_columns(o)]
            return [self.column_lde_words(c, device, mesh) for c in cols]
        start, count = _block(f, mesh)
        return [_tile(block, start, count) for block in self._periodic_blocks(device)]

    def _periodic_blocks(self, device) -> List[torch.Tensor]:
        """Each periodic constant column's (4, period * F/O) Montgomery block,
        evaluated exactly on the host: its codeword on the FRI coset is this
        block repeated."""
        o, f = self.omicron_domain_length, self.fri_domain_length
        period, coeffs = self._periodic_coeffs()
        blk = period * f // o  # block length on the FRI domain
        a = pow(self.offset, o // period, PRIME)  # coset offset^(O/period)
        apow = [pow(a, d, PRIME) for d in range(period)]
        blocks = []
        for q in coeffs:
            scaled = [q[d] * apow[d] % PRIME for d in range(period)]
            scaled += [0] * (blk - period)
            blocks.append(self._mont_column(host_ntt(scaled), device))  # Q_c on a*<omega_blk>
        return blocks

    def _denom_inv_tile(self, device) -> torch.Tensor:
        """(4, F/O) Montgomery table of 1/(x^O - 1) over one period.

        On the coset x_i = offset * omega^i, x_i^O = offset^O * (omega^O)^i
        and omega^O has order F/O, so the transition zerofier's denominator
        takes only F/O distinct values: inverted exactly on the host."""
        o = self.omicron_domain_length
        base = pow(self.offset, o, PRIME)
        wo = pow(self.omega, o, PRIME)
        vals, cur = [], base
        for _ in range(self.fri_domain_length // o):
            vals.append(finv((cur - 1) % PRIME))
            cur = cur * wo % PRIME
        return self._mont_column(vals, device)

    def _excluded_codeword(self, device) -> torch.Tensor:
        """(4, F) Montgomery evals of the excluded-row factor on the FRI
        coset, via ONE coset NTT of _excluded_coeffs. Under a mesh: the
        coefficients zero-padded to n >= S^2, each process uploads the ones
        it holds in CYCLIC layout, and the sharded coset evaluation (local
        scale and pad) leaves its natural block."""
        coeffs, f, mesh = self._excluded_coeffs(), self.fri_domain_length, self.mesh
        n = 0 if mesh is None else max(_next_pow2(len(coeffs)), mesh.shards ** 2)
        if mesh is None or n > f or not four_step_fits(f, mesh.shards):
            cw = nttmod.coset_evaluate(self._mont_column(coeffs, device), f, self.offset)
            return cw if mesh is None else shard(cw, mesh)
        words = ints_to_words([mont(c) for c in coeffs] + [0] * (n - len(coeffs)))
        local = to_tensor(words[:, cyclic_indices(n, mesh).cpu().numpy()], device)
        return sharded_coset_evaluate(local, f, self.offset, mesh, layout_in=CYCLIC)

    def _transition_zerofier_inv(self, device) -> torch.Tensor:
        """(4, F) Montgomery evals of 1/Z_transition on the FRI coset.

        Z_t vanishes on rows 0..T-2: Z_t = (x^O - 1) / prod_excluded, so
        1/Z_t = prod_{r=T-1}^{O-1}(x - omicron^r) * inv(x^O - 1): the
        excluded-row codeword times the tiled periodic denominator inverse."""
        tile = self._denom_inv_tile(device)
        excl = self._excluded_codeword(device)
        tiled = _tile(tile, *_block(self.fri_domain_length, self.mesh))
        return fk.mont_mul(excl, tiled, out=excl)

    # -- prover ------------------------------------------------------------

    def _trace_lde(self, trace, as_bytes, randomizer, device) -> List[torch.Tensor]:
        """Pad the trace to the omicron domain with pseudorandom rows and
        extend every column to the FRI coset.

        The O rows this process transforms (under a mesh whose four-step
        transform fits the domain, its block of O/W) are uploaded as the
        trace's bytes, an int trace encoded first, beside the standard-form
        words of the pad rows among them, and laid out as Montgomery word
        planes on the device (ops/trace_layout.py: one kernel launch on a
        CUDA device)."""
        o, f, w, mesh = self.omicron_domain_length, self.fri_domain_length, self.num_registers, self.mesh
        t_len = trace.shape[0]
        sharded = mesh is not None and four_step_fits(o, mesh.shards)
        start = block_start(o, mesh) if sharded else 0
        stop = start + (o // mesh.world if sharded else o)
        telemetry.count("lde-layout.device")
        with telemetry.phase("lde-host"):
            if not as_bytes:
                trace = ints_to_bytes(trace).reshape(t_len, w, 16)
            pad = [[randomizer(r, j) for j in range(w)] for r in range(max(start, t_len), max(stop, t_len))]
            pad_words = np.stack([ints_to_words([row[j] for row in pad]) for j in range(w)])
        with telemetry.phase("lde-upload"):
            body, tail = trace_layout.upload(trace[min(start, t_len) : min(stop, t_len)], pad_words, device)
        with telemetry.phase("lde-layout"):
            planes = trace_layout.mont_planes(body, tail)
        del body, tail  # the bytes go back to the allocator before the transforms
        lde = []
        for column in planes:
            with telemetry.phase("lde-ntt"):
                if sharded:
                    lde.append(sharded_lde(column, f, self.offset, mesh))
                else:
                    cw = nttmod.coset_evaluate(nttmod.intt(column), f, self.offset)
                    lde.append(cw if mesh is None else shard(cw, mesh))
        return lde

    def _boundary_quotients(self, t_lde, bps, device, x_cw=None) -> List[torch.Tensor]:
        """Standard-form boundary quotients (t_j - B_j) / Z_j, with ONE
        batched inversion for all registers' zerofiers (every zerofier is
        nonvanishing on the FRI coset: trace and FRI domains are disjoint).
        x_cw: the Montgomery points of t_lde's columns (default: the FRI
        coset, this process's block of it under a mesh)."""
        w = len(t_lde)
        if x_cw is None:
            x_cw = self._x_pow_codeword(1, device)
        numerators, zs = [], []
        for j in range(w):
            coeffs = bps[j]["interpolant"]
            num = fk.sub(t_lde[j], mont(coeffs[0]))
            xp = x_cw
            for d in range(1, len(coeffs)):
                fk.sub(num, fk.mont_mul(xp, mont(coeffs[d])), out=num)
                if d + 1 < len(coeffs):
                    xp = fk.mont_mul(xp, x_cw)
            numerators.append(num)
            z = None
            for root in bps[j]["roots"]:
                factor = fk.sub(x_cw, mont(root))
                z = factor if z is None else fk.mont_mul(z, factor, out=z)
            zs.append(z)
        del x_cw, xp
        live = [j for j in range(w) if zs[j] is not None]
        prefix = [zs[j] for j in live[:1]]
        for j in live[1:]:
            prefix.append(fk.mont_mul(prefix[-1], zs[j]))
        invs: Dict[int, torch.Tensor] = {}
        if live:
            inv_run = fk.inv(prefix[-1])
            for pos in range(len(live) - 1, 0, -1):
                invs[live[pos]] = fk.mont_mul(inv_run, prefix[pos - 1])
                inv_run = fk.mont_mul(inv_run, zs[live[pos]])
            invs[live[0]] = inv_run
        out = []
        for j in range(w):
            q = numerators[j]
            if j in invs:
                fk.mont_mul(q, invs.pop(j), out=q)
            out.append(fk.from_mont(q, out=q))
        return out

    @staticmethod
    def _zk_coefficients(key, n: int, device, columns=None, out=None) -> torch.Tensor:
        """(4, m) Montgomery zk coefficients of the given columns of the
        16 x n draw (all n when columns is None); see _zk_codeword and
        utils/threefry.py zk_coefficients (one kernel launch on the card)."""
        return threefry.zk_coefficients(key, n, device, columns, out)

    def _zk_codeword(self, seed: bytes, device, draw_chunk: int | None = None) -> torch.Tensor:
        """(4, F) standard-form codeword of a seed-derived uniformly random
        polynomial of degree <= degree_target (the FRI bound, so adding it
        to the combination preserves FRI acceptance).

        Coefficients: 256-bit draws from a threefry2x32 stream keyed by
        sha256(tag || seed) (utils/threefry.py): 16 rows of 16-bit digits
        form X = hi*2^128 + lo with hi, lo < 2^128 < 2p, each canonicalised
        by one conditional subtract (add with zero). Multiplying by 2^128 IS
        the Montgomery lift, so X mod p = to_mont(hi) + lo.

        Under a mesh each process draws only the coefficients it holds in
        CYCLIC layout (counters of the whole draw, utils/threefry.py), and
        the sharded coset evaluation takes them as they are: no process
        holds the coefficient array.

        draw_chunk: draw the coefficients that many columns at a time (the
        same bits; the big path's bound on the plain route's int64
        temporaries, which the kernel does not have)."""
        n, f, mesh = self.degree_target + 1, self.fri_domain_length, self.mesh
        local = mesh is not None and four_step_fits(n, mesh.shards)
        digest = hashlib.sha256(_ZK_TAG + seed).digest()
        key = np.frombuffer(digest[:8], dtype="<u4")
        with telemetry.phase("zk-draw"):
            if draw_chunk is None:
                coeffs = self._zk_coefficients(key, n, device, cyclic_indices(n, mesh) if local else None)
            else:
                coeffs = torch.empty((4, n), dtype=torch.int32, device=device)
                for start in range(0, n, draw_chunk):
                    stop = min(start + draw_chunk, n)
                    self._zk_coefficients(key, n, device, torch.arange(start, stop, device=device),
                                          out=coeffs[:, start:stop])
        with telemetry.phase("zk-ntt"):
            if local:
                cw = sharded_coset_evaluate(coeffs, f, self.offset, mesh, layout_in=CYCLIC)
            else:
                cw = nttmod.coset_evaluate(coeffs, f, self.offset)
                if mesh is not None:
                    cw = shard(cw, mesh)
        return fk.from_mont(cw, out=cw)

    def _next_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The codeword one trace row on: t rolled left by e = F/O columns
        (under a mesh this process's block of it: its block shifted left
        with the next block's first e columns appended, roll_left)."""
        if self.mesh is None:
            return torch.roll(t, -self.expansion_shift, dims=1)
        return roll_left(t, self.expansion_shift, self.mesh)

    def _term_shifts(self, bps) -> List[int]:
        """The power s of x that lifts each combination term to degree_target:
        the transition quotients', then each register's boundary quotient's."""
        o = self.omicron_domain_length
        degrees = [self.transition_quotient_degree] * self.air.num_constraints + [
            o - 1 - len(bp["roots"]) for bp in bps
        ]
        return [self.degree_target - deg for deg in degrees]

    def _combination(self, t_lde, bq_standard, zk_standard, bps, weights, device):
        """Transition quotients and the weighted combination codeword, every
        term lifted to degree_target; the zk randomizer enters with weight 1."""
        nxt = [self._next_rows(t) for t in t_lde]
        terms = list(self.air.eval_transition_device(
            t_lde, nxt, self._constants_codewords(device, self.mesh)))
        del nxt
        zt_inv = self._transition_zerofier_inv(device)
        for c in terms:
            fk.mont_mul(c, zt_inv, out=c)
        del zt_inv
        shifts = self._term_shifts(bps)
        tables = {s: self._x_pow_codeword(s, device) for s in sorted({s for s in shifts if s})}
        comb = fk.to_mont(zk_standard)
        for t_idx, s in enumerate(shifts):
            if t_idx < len(terms):
                term, terms[t_idx] = terms[t_idx], None
            else:
                term = fk.to_mont(bq_standard[t_idx - len(terms)])
            _add_lifted(comb, term, s, tables.get(s), 1, weights[2 * t_idx : 2 * t_idx + 2])
        return comb

    def prove(
        self,
        trace: np.ndarray,
        boundary: List[Tuple[int, int, int]],
        proof_stream: ProofStream | None = None,
        randomizer_seed: bytes | None = None,
        checkpoint_dir: str | None = None,
    ) -> bytes:
        """Prove that `trace` satisfies the AIR + boundary. Returns bytes.

        trace: (T, w) array of ints, or (T, w, 16) uint8 of canonical
        little-endian encodings (the bulk path; see
        native.rescue_chain_trace_bytes), which skips all per-element
        Python-int work.
        boundary: (cycle, register, value) triples, public.
        randomizer_seed: entropy for the zero-knowledge blinding: the
        pseudorandom trace padding rows AND the FRI randomizer polynomial.
        Default None draws fresh entropy (os.urandom) per call; pass a fixed
        seed for reproducible proofs (required to resume across process
        restarts: the seed is part of the checkpoint metadata).
        checkpoint_dir: when set, the prover persists a snapshot before FRI
        and one per FRI round (utils/checkpoint.py), and a later call with
        the same trace, boundary and seed resumes from the latest of them to
        the same bytes. A snapshot of other inputs is refused.
        """
        if self.mesh is not None and self.fri_domain_length // self.mesh.world >= _BIG_F_MIN:
            raise ValueError(
                f"a mesh block of F/W = {self.fri_domain_length // self.mesh.world} columns reaches the "
                f"chunked big-domain size (_BIG_F_MIN = {_BIG_F_MIN}), which has no mesh form: prove "
                "without a mesh, or over more processes")
        device = require_device(self.device)
        if randomizer_seed is None:
            randomizer_seed = os.urandom(32)
        trace = np.asarray(trace) if not isinstance(trace, np.ndarray) else trace
        as_bytes = trace.dtype == np.uint8 and trace.ndim == 3
        t_len, w = trace.shape[:2]
        if t_len != self.trace_length or w != self.num_registers:
            raise ValueError("trace shape does not match the AIR")
        ckpt_meta = None
        if checkpoint_dir is not None:
            ckpt_meta = self._checkpoint_meta(
                boundary, self._trace_digest(trace, as_bytes), randomizer_seed)
            loaded = checkpoint.load(checkpoint_dir, checkpoint.STAGE_PRE_FRI, ckpt_meta)
            if loaded is not None:
                return self._resume(loaded, device, checkpoint_dir, ckpt_meta)
        ps = proof_stream if proof_stream is not None else ProofStream()

        def randomizer(r: int, j: int) -> int:
            return sample_field_element(
                _RANDOMIZER_TAG + randomizer_seed + r.to_bytes(8, "big") + j.to_bytes(4, "big")
            )

        if self._big:
            return self._prove_big(ps, trace, as_bytes, boundary, randomizer, randomizer_seed, device,
                                   checkpoint_dir, ckpt_meta)

        with _phase("prove.trace-lde", device):
            t_lde = self._trace_lde(trace, as_bytes, randomizer, device)

        bps = self._boundary_polys(boundary)
        with _phase("prove.boundary-quotients", device):
            bq_standard = self._boundary_quotients(t_lde, bps, device)

        # One tree over all boundary quotients (leaf = the w-tuple rows of a
        # mirror pair).
        with _phase("prove.bq-commit", device):
            bq_tree = commit(bq_standard, self.mesh)
        ps.push({"bq_root": digest_to_item(bq_tree.root)})

        # The zero-knowledge FRI randomizer is committed BEFORE the
        # combination weights are squeezed from the transcript, so the
        # weights bind it.
        with _phase("prove.zk-randomizer", device):
            zk_standard = self._zk_codeword(randomizer_seed, device)
            zk_tree = commit([zk_standard], self.mesh)
        ps.push({"zk_root": digest_to_item(zk_tree.root)})

        n_terms = self.air.num_constraints + w
        weights = sample_weights(ps.prover_fiat_shamir(), 2 * n_terms)
        with _phase("prove.quotients-combination", device):
            comb = self._combination(t_lde, bq_standard, zk_standard, bps, weights, device)
            t_lde.clear()

        self._checkpoint(ps, comb, bq_standard, zk_standard, device, checkpoint_dir, ckpt_meta)
        return self._fri_and_open(ps, comb, bq_standard, bq_tree, zk_standard, zk_tree,
                                  device, checkpoint_dir, ckpt_meta)

    def _checkpoint(self, ps, comb, bq_standard, zk_standard, device, checkpoint_dir, ckpt_meta) -> None:
        """The pre-FRI snapshot (when checkpoint_dir is set): the transcript so
        far, the combination and the committed codewords, from the device or
        the host."""
        if checkpoint_dir is None:
            return
        with _phase("prove.checkpoint", device):
            arrays = {"comb": comb, "zk": zk_standard}
            for j, q in enumerate(bq_standard):
                arrays[f"bq{j}"] = q
            snapshot(checkpoint_dir, checkpoint.STAGE_PRE_FRI, list(ps.items), arrays, ckpt_meta,
                     self.mesh)

    # -- the chunked big-domain prover ---------------------------------------

    @property
    def _big(self) -> bool:
        """Whether prove takes the chunked big-domain path."""
        return self.fri_domain_length >= _BIG_F_MIN and self.mesh is None

    def _big_chunk_len(self) -> int:
        """Domain chunk of the big path: _BIG_CHUNK, at most F/2 (F and the
        chunk are powers of two, so the count of chunks is even)."""
        return min(_BIG_CHUNK, self.fri_domain_length // 2)

    def _chunk_points(self, base: torch.Tensor, c: int, out: torch.Tensor) -> torch.Tensor:
        """Montgomery points x of domain chunk c: base = powers(omega, blk)
        times offset * omega^(c*blk)."""
        blk = base.shape[1]
        return fk.mont_mul(base, mont(self.offset * pow(self.omega, c * blk, PRIME)), out=out)

    def _bq_domain_chunk(self, t_lde, bps, c: int, xc: torch.Tensor, device) -> List[torch.Tensor]:
        """Standard-form boundary quotients of domain chunk c at its points xc
        (_chunk_points): _boundary_quotients on the chunk's slices of t_lde.
        The big path derives them twice a chunk, for the commit and for the
        combination, and never holds them whole on the device."""
        blk = xc.shape[1]
        return self._boundary_quotients([t[:, c * blk : (c + 1) * blk] for t in t_lde], bps, device, x_cw=xc)

    def _constant_chunks(self, blk: int, device):
        """c -> the AIR's constant columns on domain chunk c, Montgomery.
        Periodic columns: tiles of their blocks (_periodic_blocks); dense ones
        are extended whole, as _constants_codewords does, and sliced."""
        if not hasattr(self.air, "periodic_columns"):
            cws = self._constants_codewords(device)
            return lambda c: [cw[:, c * blk : (c + 1) * blk] for cw in cws]
        tilers = [_chunk_tiler(block, blk) for block in self._periodic_blocks(device)]
        return lambda c: [tiler(c) for tiler in tilers]

    def _boundary_commit_chunked(self, t_lde, bps, blk: int, device, bq_host):
        """Standard-form boundary quotients streamed to host numpy and
        committed chunk by chunk: (the w host (4, F) arrays, their tree).

        Pair leaf k packs rows k and k + F/2, so the loop walks MIRRORED
        chunk pairs c and c + n/2: each pair's quotients go to the
        ChunkedPairCommit and into the host arrays; no F-wide quotient is
        ever on the device. Trees of fewer than MIN_CHUNK_LEAVES leaves a chunk are
        committed at the end from the host arrays. bq_host: the w host (4, F)
        arrays the chunks are copied into. Spans: to-host around each chunk's
        copy, merkle-commit around each pair's add and the finish."""
        f, w = self.fri_domain_length, len(t_lde)
        half_chunks = f // blk // 2
        base = nttmod.powers(self.omega, blk, device)
        xc = torch.empty_like(base)
        builder = ChunkedPairCommit(blk, 32 * w) if blk >= MIN_CHUNK_LEAVES else None
        for k in range(half_chunks):
            pair = []
            for c in (k, k + half_chunks):
                qs = self._bq_domain_chunk(t_lde, bps, c, self._chunk_points(base, c, xc), device)
                for j, q in enumerate(qs):
                    with telemetry.phase("to-host"):
                        copy_to_numpy(bq_host[j][:, c * blk : (c + 1) * blk], q)
                        copied(bq_host[j])
                pair += qs
            if builder is not None:
                with telemetry.phase("merkle-commit"):
                    builder.add(pair)
        if builder is None:
            return bq_host, commit_columns_chunked(bq_host, blk, device)
        with telemetry.phase("merkle-commit"):
            return bq_host, builder.finish(bq_host)

    def _comb_chunked(self, t_lde, zk_standard, weights, bps, blk: int, device) -> torch.Tensor:
        """Transition quotients and the weighted combination, chunk by chunk
        into one preallocated (4, F) codeword: _combination's values.

        Per chunk: the points x from one powers table, the transition
        zerofier's inverse as the excluded-row factor by Horner in x times
        the tiled denominator inverse, the AIR on the chunk's slices of t_lde
        and of its roll by one trace row, the boundary-quotient terms
        re-derived from t_lde (_bq_domain_chunk), and the
        x^shift lifts from one table a shift scaled per chunk."""
        f, e = self.fri_domain_length, self.expansion_shift
        shifts = self._term_shifts(bps)
        shift_base = {s: nttmod.powers(pow(self.omega, s, PRIME), blk, device)
                      for s in sorted({s for s in shifts if s})}
        constants = self._constant_chunks(blk, device)
        denom_inv = _chunk_tiler(self._denom_inv_tile(device), blk)
        excluded = self._excluded_coeffs()
        base = nttmod.powers(self.omega, blk, device)
        xc, ztc = torch.empty_like(base), torch.empty_like(base)
        comb = torch.empty((4, f), dtype=torch.int32, device=device)
        for c in range(f // blk):
            sl = slice(c * blk, (c + 1) * blk)
            self._chunk_points(base, c, xc)
            with telemetry.phase("excluded-factor"):
                fk.mont_mul(_horner(excluded, xc, ztc), denom_inv(c), out=ztc)
            cur = [t[:, sl] for t in t_lde]
            nxt = [_rolled_slice(t, c * blk + e, blk) for t in t_lde]
            terms = list(self.air.eval_transition_device(cur, nxt, constants(c)))
            del nxt
            for con in terms:
                fk.mont_mul(con, ztc, out=con)
            terms += [fk.to_mont(q, out=q) for q in self._bq_domain_chunk(t_lde, bps, c, xc, device)]
            out = fk.to_mont(zk_standard[:, sl], out=comb[:, sl])
            for t_idx, s in enumerate(shifts):
                term, terms[t_idx] = terms[t_idx], None
                x_s = pow(self.offset, s, PRIME) * pow(self.omega, s * c * blk, PRIME)
                _add_lifted(out, term, s, shift_base.get(s), x_s, weights[2 * t_idx : 2 * t_idx + 2])
        return comb

    def _prove_big(self, ps, trace, as_bytes, boundary, randomizer, randomizer_seed, device,
                   checkpoint_dir, ckpt_meta) -> bytes:
        """The chunked single-device prover for F >= _BIG_F_MIN.

        Device memory at F = 2^28 (one (4, F) codeword = 4 GiB): the zk
        codeword first, on the empty card (its draw in chunks of columns, its
        commit chunked and host-resident); the trace LDE (+8 GiB); the
        boundary quotients streamed to the host and committed chunk by chunk
        (chunk transients only); the combination (+4 GiB, chunk transients);
        then the zk codeword to the host, and FRI (its first round committed
        chunked and moved to the host after the second).

        Host memory: the w + 2 codewords copied to the host (boundary
        quotients, zk codeword, FRI round 0) land in the instance's HostPool
        (ops/host_pool.py), page-locked on a CUDA device and kept from prove
        to prove."""
        f, w = self.fri_domain_length, self.num_registers
        blk = self._big_chunk_len()
        bps = self._boundary_polys(boundary)
        with self._host_pool.checkout(f, w + 2, device) as host:
            # The zk codeword depends only on the seed: made first, its root
            # pushed after bq_root all the same.
            with _phase("prove.zk-randomizer", device):
                zk_standard = self._zk_codeword(randomizer_seed, device, draw_chunk=blk)
                zk_tree = commit_columns_chunked([zk_standard], blk)
            with _phase("prove.trace-lde", device):
                t_lde = self._trace_lde(trace, as_bytes, randomizer, device)
            with _phase("prove.boundary-quotients", device):
                bq_standard, bq_tree = self._boundary_commit_chunked(t_lde, bps, blk, device, host[:w])
            ps.push({"bq_root": digest_to_item(bq_tree.root)})
            ps.push({"zk_root": digest_to_item(zk_tree.root)})
            weights = sample_weights(ps.prover_fiat_shamir(), 2 * (self.air.num_constraints + w))
            with _phase("prove.quotients-combination", device):
                comb = self._comb_chunked(t_lde, zk_standard, weights, bps, blk, device)
                t_lde.clear()
            self._checkpoint(ps, comb, bq_standard, zk_standard, device, checkpoint_dir, ckpt_meta)
            with _phase("prove.host-offload", device):
                with telemetry.phase("to-host"):
                    copy_to_numpy(host[w], zk_standard)
                    copied(host[w])
                zk_standard = host[w]
                zk_tree.offload_to_host([zk_standard])
            return self._fri_and_open(ps, comb, bq_standard, bq_tree, zk_standard, zk_tree,
                                      device, checkpoint_dir, ckpt_meta, host[w + 1])

    def _checkpoint_meta(self, boundary, trace_digest: str, randomizer_seed: bytes) -> dict:
        return {
            "T": self.trace_length,
            "w": self.num_registers,
            "O": self.omicron_domain_length,
            "F": self.fri_domain_length,
            "checks": self.num_colinearity_checks,
            "boundary": [[int(c), int(r), str(v)] for (c, r, v) in boundary],
            # Bind the inputs, not just the shapes: resuming with another
            # trace or randomizer seed must be refused, or the stale snapshot
            # would silently produce a proof of the old trace.
            "trace": trace_digest,
            "seed": randomizer_seed.hex(),
            "layout": checkpoint.LAYOUT,
        }

    @staticmethod
    def _trace_digest(trace: np.ndarray, as_bytes: bool) -> str:
        h = hashlib.blake2b(digest_size=32)
        if as_bytes:
            h.update(np.ascontiguousarray(trace).tobytes())
        else:
            for row in trace:
                for v in row:
                    h.update((int(v) % PRIME).to_bytes(16, "little"))
        return h.hexdigest()

    def _resume(self, loaded: dict, device, checkpoint_dir: str, ckpt_meta: dict) -> bytes:
        """Continue from a pre-FRI snapshot: the transcript so far and the
        combination come from disk, and the boundary-quotient and
        zk-randomizer trees are re-committed from their saved standard-form
        codewords (commitment is deterministic, so the roots already in the
        transcript are theirs). Under a mesh every process keeps its block.
        On the big path both stay host numpy and are re-committed chunk by
        chunk (commit_columns_chunked uploads one chunk at a time), and FRI's
        round 0 is copied into the instance's HostPool."""
        arrays = loaded["arrays"]
        ps = ProofStream(loaded["items"])
        with _phase("prove.resume-commit", device):
            if self._big:
                blk = self._big_chunk_len()
                bq_standard = [arrays[f"bq{j}"] for j in range(self.num_registers)]
                bq_tree = commit_columns_chunked(bq_standard, blk, device)
                zk_standard = arrays["zk"]
                zk_tree = commit_columns_chunked([zk_standard], blk, device)
            else:
                bq_standard = [upload_block(arrays[f"bq{j}"], self.mesh, device)
                               for j in range(self.num_registers)]
                bq_tree = commit(bq_standard, self.mesh)
                zk_standard = upload_block(arrays["zk"], self.mesh, device)
                zk_tree = commit([zk_standard], self.mesh)
        comb = upload_block(arrays["comb"], self.mesh, device)
        if self._big:
            f, w = self.fri_domain_length, self.num_registers
            with self._host_pool.checkout(f, w + 2, device) as host:
                return self._fri_and_open(ps, comb, bq_standard, bq_tree, zk_standard, zk_tree,
                                          device, checkpoint_dir, ckpt_meta, host[w + 1])
        return self._fri_and_open(ps, comb, bq_standard, bq_tree, zk_standard, zk_tree,
                                  device, checkpoint_dir, ckpt_meta)

    def _fri_and_open(self, ps, comb, bq_standard, bq_tree, zk_standard, zk_tree,
                      device, checkpoint_dir, ckpt_meta, round0_host=None) -> bytes:
        with _phase("prove.fri", device):
            top_indices = self.fri.prove(
                comb, ps, checkpoint_dir=checkpoint_dir, checkpoint_meta=ckpt_meta,
                big_chunk=self._big_chunk_len() if self._big else None, round0_host=round0_host)
        with _phase("prove.open", device):
            self._open(ps, top_indices, bq_standard, bq_tree, zk_standard, zk_tree)
        return ps.serialize()

    def _open(self, ps, top_indices, bq_standard, bq_tree, zk_standard, zk_tree) -> None:
        """Open the boundary-quotient rows and zk-randomizer values the
        verifier needs: ALL gathers (codeword columns + Merkle digests of
        both trees) go through one device gather and one transfer (under a
        mesh one owner_gather of the blocks; over several processes the
        tree levels are on the host, see parallel/merkle_sharded.py; host
        codewords of the big path are read where they are)."""
        f, e = self.fri_domain_length, self.expansion_shift
        need = set()
        for i in top_indices:
            for base in (i, i + f // 2):
                need.add(base % f)
                need.add((base + e) % f)
        need_list = sorted(need)
        zk_idx = sorted({i % f for i in top_indices} | {(i + f // 2) % f for i in top_indices})

        requests: List = [(q, need_list) for q in bq_standard] + [(zk_standard, zk_idx)]
        n_cols = len(requests)
        # Pair-leaf trees: row x lives in pair leaf x mod F/2, and both
        # need_list and zk_idx are mirror-closed (x in the set iff
        # (x + F/2) mod F is), so each opened leaf's full value tuple ships.
        half = f // 2
        bq_pairs = sorted({x % half for x in need_list})
        zk_pairs = sorted({x % half for x in zk_idx})
        bq_reqs, bq_fill = bq_tree._prefetch_plan(bq_pairs)
        zk_reqs, zk_fill = zk_tree._prefetch_plan(zk_pairs)
        requests.extend(bq_reqs)
        requests.extend(zk_reqs)
        fetched = gather_requests(requests, self.mesh)
        bq_fill(fetched[n_cols : n_cols + len(bq_reqs)])
        zk_fill(fetched[n_cols + len(bq_reqs) :])

        bq_cols = [words_to_ints(fetched[j]) for j in range(n_cols - 1)]
        ps.push(
            {
                "bq_leaves": [
                    [idx, [felt_to_item(int(col[s])) for col in bq_cols]]
                    for s, idx in enumerate(need_list)
                ]
            }
        )
        ps.push({"bq_multiproof": [digest_to_item(d) for d in bq_tree.open_multi(bq_pairs)]})
        zk_vals = words_to_ints(fetched[n_cols - 1])
        ps.push(
            {"zk_leaves": [[idx, felt_to_item(int(zk_vals[s]))] for s, idx in enumerate(zk_idx)]}
        )
        ps.push({"zk_multiproof": [digest_to_item(d) for d in zk_tree.open_multi(zk_pairs)]})

    # -- verifier ----------------------------------------------------------

    def verify(self, proof: bytes, boundary: List[Tuple[int, int, int]]) -> bool:
        try:
            return self._verify(proof, boundary)
        except (KeyError, TypeError, ValueError, IndexError, ProofStreamError):
            # Malformed transcripts are rejections, not crashes.
            return False

    def _verify(self, proof: bytes, boundary) -> bool:
        ps = ProofStream.deserialize(proof)
        w = self.num_registers

        bq_root = item_to_digest(ps.pull()["bq_root"])
        zk_root = item_to_digest(ps.pull()["zk_root"])
        n_terms = self.air.num_constraints + w
        weights = sample_weights(ps.verifier_fiat_shamir(), 2 * n_terms)

        with telemetry.phase("verify.fri"):
            ok, top_points = self.fri.verify(ps)
        if not ok or not top_points:
            return False
        with telemetry.phase("verify.openings"):
            opened = self._verify_openings(ps, bq_root, zk_root)
        if opened is None:
            return False
        with telemetry.phase("verify.constraints"):
            return self._verify_combination(boundary, weights, top_points, *opened)

    def _verify_openings(self, ps, bq_root: bytes, zk_root: bytes):
        """Pull the opened boundary-quotient rows and zk-randomizer values and
        bind each set to its root with one multiproof. Returns (bq_vals,
        zk_vals), or None when an opening is out of range or unbound."""
        f = self.fri_domain_length
        leaves_item = ps.pull()["bq_leaves"]
        mp_item = ps.pull()["bq_multiproof"]
        bq_vals: Dict[int, List[int]] = {}
        for idx, vals in leaves_item:
            if not 0 <= int(idx) < f:
                return None
            bq_vals[int(idx)] = [item_to_felt(v) for v in vals]
        # Pair-leaf trees: leaf j packs rows j and j + F/2, so the tree is
        # one level shorter and BOTH rows of each opened pair must be
        # present: a transcript shipping only half a pair cannot rebuild the
        # leaf digest and is rejected (KeyError -> False in verify()).
        half = f // 2
        height = f.bit_length() - 2
        if not verify_multiproof(
            bq_root,
            {
                j: hash_felts(bq_vals[j] + bq_vals[j + half])
                for j in {idx % half for idx in bq_vals}
            },
            [item_to_digest(d) for d in mp_item],
            height,
        ):
            return None

        # Zero-knowledge randomizer openings: one value per combination
        # check index, bound to the committed zk root by one multiproof.
        zk_leaves_item = ps.pull()["zk_leaves"]
        zk_mp_item = ps.pull()["zk_multiproof"]
        zk_vals: Dict[int, int] = {}
        for idx, val in zk_leaves_item:
            if not 0 <= int(idx) < f:
                return None
            zk_vals[int(idx)] = item_to_felt(val)
        if not verify_multiproof(
            zk_root,
            {
                j: hash_felts([zk_vals[j], zk_vals[j + half]])
                for j in {idx % half for idx in zk_vals}
            },
            [item_to_digest(d) for d in zk_mp_item],
            height,
        ):
            return None
        return bq_vals, zk_vals

    def _verify_combination(self, boundary, weights, top_points, bq_vals, zk_vals) -> bool:
        """Rebuild the trace values at every queried point from the opened
        quotients, evaluate the AIR there and hold the weighted combination
        against the value FRI opened."""
        o = self.omicron_domain_length
        f = self.fri_domain_length
        e = self.expansion_shift
        w = self.num_registers
        bps = self._boundary_polys(boundary)
        # Constants at the queried rows. Periodic AIRs evaluate the
        # interpolants succinctly on the host (O(period) per point); AIRs
        # with dense constant columns fall back to one gather from the
        # columns' codewords on `device`.
        query_rows = sorted({i for (i, _) in top_points})
        const_at: Dict[int, List[int]] = {}
        if hasattr(self.air, "periodic_columns"):
            for idx in query_rows:
                x = self.offset * pow(self.omega, idx, PRIME) % PRIME
                const_at[idx] = self.eval_periodic_at(x)
        else:
            const_cw = self._constants_codewords(require_device(self.device))
            rows = torch.tensor(query_rows, dtype=torch.long)
            gathered = [
                words_to_ints(to_numpy(fk.from_mont(c[:, rows.to(c.device)].contiguous())))
                for c in const_cw
            ]
            for pos, idx in enumerate(query_rows):
                const_at[idx] = [int(g[pos]) for g in gathered]

        excluded = [pow(self.omicron, r, PRIME) for r in range(self.trace_length - 1, o)]
        shifts = self._term_shifts(bps)

        for i, comb_val in top_points:
            i2 = (i + e) % f
            if i not in bq_vals or i2 not in bq_vals or i not in zk_vals:
                return False
            x = self.offset * pow(self.omega, i, PRIME) % PRIME
            x2 = self.offset * pow(self.omega, i2, PRIME) % PRIME
            cur, nxt = [], []
            for j in range(w):
                b1, z1 = self._boundary_eval_host(bps[j], x)
                b2, z2 = self._boundary_eval_host(bps[j], x2)
                cur.append((bq_vals[i][j] * z1 + b1) % PRIME)
                nxt.append((bq_vals[i2][j] * z2 + b2) % PRIME)
            cons = self.air.eval_transition_host(cur, nxt, const_at[i])
            zt_inv = 1
            for rt in excluded:
                zt_inv = zt_inv * (x - rt) % PRIME
            zt_inv = zt_inv * finv((pow(x, o, PRIME) - 1) % PRIME) % PRIME
            terms = [c * zt_inv % PRIME for c in cons] + list(bq_vals[i])
            combo = zk_vals[i]
            for t_idx, (term, shift) in enumerate(zip(terms, shifts)):
                alpha, beta = weights[2 * t_idx], weights[2 * t_idx + 1]
                combo = (combo + (alpha + beta * pow(x, shift, PRIME)) * term) % PRIME
            if combo != comb_val % PRIME:
                return False
        return True


def default_config(chain_length: int = 1, num_colinearity_checks: int = 16,
                   device: str = "cuda") -> Stark:
    """Flagship configuration: STARK over a Rescue-Prime hash chain."""
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir

    air = RescuePrimeAir(RescuePrime(), chain_length=chain_length)
    return Stark(air, expansion_factor=4, num_colinearity_checks=num_colinearity_checks,
                 device=device)
