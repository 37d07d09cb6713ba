"""FRI low-degree proof: device-folded commit phase, host query/verify.

Counterpart of the JAX package's iop/fri.py (split-and-fold FRI of
Szepieniec's "Anatomy of a STARK"), same transcript:

- each folding round is batched math on (4, n) Montgomery word planes:
  new[i] = 2^-1 * ((1 + alpha/d_i) * c[i] + (1 - alpha/d_i) * c[i+n/2]),
  d_i = offset * omega^i, through the field kernels (ops/field_kernels.py);
- codewords are committed with PAIR leaves (iop/merkle.py): leaf i of a
  length-n codeword packs c[i] and c[i + n/2], the pair every colinearity
  query opens;
- once a codeword is no longer than ``host_tail_n`` (a constructor
  argument, default 2^14) the remaining rounds run in exact host arithmetic:
  a launch per op is not worth it on a few thousand values, and the values,
  roots and transcript are identical either way;
- the Fiat-Shamir transcript, index sampling, colinearity checks and path
  verification are host-side exact integer work;
- with ``mesh`` (parallel/mesh.py) every device commit is the sharded one
  (parallel/merkle_sharded.py) and the codeword is spread over the mesh's W
  processes (one without a process group): each holds its (4, n/W) block,
  a fold brings its row pairs with one exchange (``pair_exchange``), the
  host tail starts from the gathered codeword on every process, and the
  queries read the blocks through one ``owner_gather``. Proof bytes do not
  depend on the mesh and the verifier never looks at it;
- with ``checkpoint_dir`` every committed round's standard-form codeword is
  snapshotted (utils/checkpoint.py, stage ``fri-r{r}``), host-tail rounds
  included, and a later call replays the completed rounds from disk;
- for the chunked big-domain prover (iop/stark.py ``_prove_big``,
  ``prove(big_chunk=...)``) round 0 commits through iop/merkle.py
  ``commit_columns_chunked`` (upper levels on the host, bottom levels rebuilt
  on opening) and moves its codeword and tree to the host once round 1 is
  committed; the queries then read host arrays. Neither changes a byte.

Transcript item layout (all JSON-safe, see utils/encoding.py):
  {"fri_root": b64}                            per round
  {"fri_last_codeword": [dec, ...]}            once
  {"pow_nonce": dec}                           once, iff grinding_bits > 0
  {"fri_points": [[a,b] dec, ...]}             per query round
  {"fri_multiproofs": [[b64...] per tree]}     once (trees 0..rounds-2)

The fold value c never ships: it is the NEXT round's own opened a/b (or a
fri_last_codeword slot), and the verifier reads it there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from stark_anatomy_tpu_torch import native
from stark_anatomy_tpu_torch.iop.merkle import (
    MerkleTree,
    commit_columns,
    commit_columns_chunked,
    gather_requests,
    verify_multiproof,
)
from stark_anatomy_tpu_torch.iop.proof_stream import ProofStream, ProofStreamError
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops.field import (
    PRIME,
    finv,
    host_intt,
    primitive_root_of_unity,
    sample_field_element,
    sample_indices,
)
from stark_anatomy_tpu_torch.ops.host_pool import copied
from stark_anatomy_tpu_torch.ops.limbs import (
    copy_to_numpy,
    ints_to_words,
    mont,
    words_to_ints,
)
from stark_anatomy_tpu_torch.utils import checkpoint, telemetry
from stark_anatomy_tpu_torch.utils.encoding import (
    digest_to_item,
    felt_to_item,
    grind,
    hash_felts,
    item_to_digest,
    item_to_felt,
    item_to_nonce,
    nonce_to_item,
    pow_digest_ok,
)
from stark_anatomy_tpu_torch.parallel.merkle_sharded import commit_sharded
from stark_anatomy_tpu_torch.parallel.mesh import block_start, host_gather, pair_exchange, upload_block


def commit(columns, mesh=None, pair: bool = True) -> MerkleTree:
    """Merkle-commit standard-form codeword columns: the sharded commit
    under a mesh, commit_columns without one. The same tree either way.
    Every device commit but the chunked one (commit_columns_chunked) passes
    here: the span merkle-commit."""
    with telemetry.phase("merkle-commit"):
        if mesh is None:
            return commit_columns(columns, pair=pair)
        return commit_sharded(columns, mesh, pair=pair)


def snapshot(directory: str, stage: str, items: list, arrays: dict, meta: dict, mesh=None) -> None:
    """checkpoint.save of host arrays and device tensors. Under a mesh the
    tensors are blocks: every process joins their gather, the mesh's first
    process alone writes (distributed.is_controller() for the world group),
    and all wait for the files at the mesh's barrier. The files are those a
    prove without a mesh writes."""
    host = {k: v if isinstance(v, np.ndarray) else host_gather(v, mesh) for k, v in arrays.items()}
    if mesh is None or mesh.rank == 0:
        checkpoint.save(directory, stage, items, host, meta)
    if mesh is not None:
        mesh.barrier()


def fold(codeword_mont: torch.Tensor, alpha: int, offset: int, omega: int, mesh=None) -> torch.Tensor:
    """One FRI fold. codeword: (4, n) Montgomery form on offset*<omega>.

    Returns the length-n/2 codeword of the alpha-combined even/odd parts,
    living on the squared domain offset^2 * <omega^2>. Under a mesh the
    codeword is this process's (4, n/W) block and so is the result:
    pair_exchange brings rows i and i + n/2 of the output block's rows, and
    the inverse domain starts at the block's first row. The span fri-fold."""
    with telemetry.phase("fri-fold"):
        if mesh is not None:
            pairs = pair_exchange(codeword_mont, mesh)
            half = pairs.shape[1]
            lo, hi = pairs[:4], pairs[4:]
            start = block_start(half * mesh.world, mesh)
        else:
            half = codeword_mont.shape[-1] // 2
            lo, hi = codeword_mont[:, :half], codeword_mont[:, half:]
            start = 0
        # d_i^-1 = offset^-1 * omega^-i, then alpha / d_i.
        inv_dom = nttmod.powers(finv(omega), half, codeword_mont.device, start=start)
        au = fk.mont_mul(inv_dom, mont(alpha * finv(offset)))
        t = fk.add(
            fk.mont_mul(fk.add(au, mont(1)), lo),
            fk.mont_mul(fk.sub(mont(1), au), hi),
        )
        return fk.mont_mul(t, mont(finv(2)), out=t)


def colinearity_check(points: List[Tuple[int, int]]) -> bool:
    """True iff the (exactly 3) points lie on one line over F_p."""
    (x0, y0), (x1, y1), (x2, y2) = points
    return ((y2 - y0) * (x1 - x0) - (y1 - y0) * (x2 - x0)) % PRIME == 0


@dataclass(frozen=True)
class Fri:
    """FRI prover/verifier for one fixed evaluation domain.

    offset: coset shift of the evaluation domain; domain_length: power-of-two
    size of the top codeword; expansion_factor: blowup (codeword length /
    max degree bound); num_colinearity_tests: soundness repetitions;
    grinding_bits: proof-of-work bits ground into the transcript before
    query sampling (0 = no pow item); host_tail_n: codewords of at most this
    length finish on the host (it changes no transcript byte); mesh: an
    optional parallel.Mesh; prove then takes this process's block of the
    codeword.
    """

    offset: int
    domain_length: int
    expansion_factor: int
    num_colinearity_tests: int
    grinding_bits: int = 0
    host_tail_n: int = 1 << 14
    mesh: object | None = None

    def __post_init__(self):
        if self.domain_length & (self.domain_length - 1):
            raise ValueError("domain_length must be a power of two")
        if self.expansion_factor & (self.expansion_factor - 1):
            raise ValueError("expansion_factor must be a power of two")
        # 0 rounds crashes the prover, 1 round emits no query points.
        if self.num_rounds < 2:
            raise ValueError(
                f"FRI configuration degenerates to {self.num_rounds} round(s): "
                f"domain_length={self.domain_length} must exceed both "
                f"2*expansion_factor={2 * self.expansion_factor} and "
                f"8*num_colinearity_tests={8 * self.num_colinearity_tests}"
            )

    def security_bits(self, conjectured: bool = True) -> float:
        """Soundness of the FRI query phase, in bits: per query
        log2(expansion_factor) under the standard 1-rho proximity conjecture,
        half that in the proven Johnson-bound regime, plus grinding_bits."""
        log_blowup = self.expansion_factor.bit_length() - 1
        per_query = log_blowup if conjectured else log_blowup / 2
        return self.num_colinearity_tests * per_query + self.grinding_bits

    @property
    def omega(self) -> int:
        return primitive_root_of_unity(self.domain_length)

    @property
    def num_rounds(self) -> int:
        codeword_length = self.domain_length
        num = 0
        while (
            codeword_length > self.expansion_factor
            and 4 * self.num_colinearity_tests < codeword_length
        ):
            codeword_length //= 2
            num += 1
        return num

    def eval_domain(self) -> List[int]:
        """[offset * omega^i] as host ints (verifier-side)."""
        omega = self.omega
        out, cur = [], 1
        for _ in range(self.domain_length):
            out.append(self.offset * cur % PRIME)
            cur = cur * omega % PRIME
        return out

    # -- prover ------------------------------------------------------------

    def prove(
        self,
        codeword_mont: torch.Tensor,
        proof_stream: ProofStream,
        checkpoint_dir: str | None = None,
        checkpoint_meta: dict | None = None,
        big_chunk: int | None = None,
        round0_host: np.ndarray | None = None,
    ) -> List[int]:
        """Commit + query phases. Returns the top-level query indices.

        codeword_mont: (4, domain_length) Montgomery-form codeword to be
        proven close to degree < domain_length / expansion_factor (under a
        mesh: this process's (4, domain_length / W) block).

        checkpoint_dir / checkpoint_meta: when set, each committed round's
        standard-form codeword is snapshotted; a rerun with the same meta
        replays the completed rounds from disk. Trees are re-hashed from the
        stored codewords (commitment is deterministic), so resume skips every
        completed fold and produces a byte-identical transcript.

        big_chunk: set by the chunked big-domain prover (no mesh), whose
        round-0 codeword does not fit the card beside its whole tree: round
        0 commits through commit_columns_chunked in chunks of big_chunk
        leaves and moves, with its tree, to the host once round 1 is
        committed (or at the end of the device rounds).

        round0_host: with big_chunk, the (4, domain_length) uint32 host
        array round 0's codeword is copied into (the prover's HostPool,
        ops/host_pool.py)."""
        mesh = self.mesh
        world = 1 if mesh is None else mesh.world
        if codeword_mont.shape[-1] * world != self.domain_length:
            raise ValueError("codeword length != configured domain length")
        checkpoint_meta = checkpoint_meta or {}
        rounds = self.num_rounds
        omega, offset = self.omega, self.offset
        device = codeword_mont.device

        # Per round: the committed codeword in standard form (a tensor, this
        # process's block under a mesh; or a whole (4, n) numpy array once
        # on the host tail) and its tree. `codeword` is the next round's
        # input: a Montgomery tensor, or standard host ints on the tail.
        codewords: List = []
        trees: List[MerkleTree] = []
        codeword = codeword_mont
        resume_from = 0
        if checkpoint_dir is not None:
            # Replay the longest run of snapshotted rounds from round 0:
            # re-commit each stored codeword, re-derive the fold challenges,
            # and leave `codeword` as the fold of the last replayed round so
            # the live loop continues at r = resume_from. Earlier folds are
            # skipped: their results are the later snapshots.
            snaps: List[np.ndarray] = []
            for r in range(rounds):
                snap = checkpoint.load(checkpoint_dir, f"fri-r{r}", checkpoint_meta)
                if snap is None:
                    break
                snaps.append(snap["arrays"]["codeword"])
            resume_from = len(snaps)
            for r, words in enumerate(snaps):
                on_host = self._on_host(words.shape[-1], world)
                if on_host:
                    standard = words
                    tree = self._commit_host([int(v) for v in words_to_ints(words)])
                else:
                    standard = upload_block(words, mesh, device)
                    tree = self._commit_one(standard, big_chunk if r == 0 else None)
                codewords.append(standard)
                trees.append(tree)
                proof_stream.push({"fri_root": digest_to_item(tree.root)})
                if r == rounds - 1:
                    break
                alpha = sample_field_element(proof_stream.prover_fiat_shamir())
                if r == resume_from - 1:
                    if on_host:
                        codeword = native.fri_fold_values([int(v) for v in words_to_ints(words)],
                                                          alpha, finv(offset), finv(omega))
                    else:
                        codeword = fold(fk.to_mont(standard), alpha, offset, omega, mesh)
                omega = omega * omega % PRIME
                offset = offset * offset % PRIME
        for r in range(resume_from, rounds):
            if isinstance(codeword, list) or self._on_host(codeword.shape[-1] * world, world):
                if isinstance(codeword, torch.Tensor):
                    with telemetry.phase("to-host-tail"):
                        codeword = [int(v) for v in words_to_ints(host_gather(fk.from_mont(codeword), mesh))]
                with telemetry.phase("host-tail"):
                    self._host_tail(codeword, r, rounds, omega, offset, codewords, trees,
                                    proof_stream, checkpoint_dir, checkpoint_meta, mesh)
                break
            standard = fk.from_mont(codeword)
            tree = self._commit_one(standard, big_chunk if r == 0 else None)
            if checkpoint_dir is not None:
                snapshot(checkpoint_dir, f"fri-r{r}", [], {"codeword": standard}, checkpoint_meta, mesh)
            codewords.append(standard)
            trees.append(tree)
            if big_chunk and r == 1:
                self._offload_round0(codewords, trees, round0_host)
            proof_stream.push({"fri_root": digest_to_item(tree.root)})
            if r == rounds - 1:
                break
            alpha = sample_field_element(proof_stream.prover_fiat_shamir())
            codeword = fold(codeword, alpha, offset, omega, mesh)
            omega = omega * omega % PRIME
            offset = offset * offset % PRIME
        if big_chunk and isinstance(codewords[0], torch.Tensor):
            self._offload_round0(codewords, trees, round0_host)

        last = codewords[-1]
        last_values = words_to_ints(last if isinstance(last, np.ndarray) else host_gather(last, mesh))
        proof_stream.push({"fri_last_codeword": [felt_to_item(int(v)) for v in last_values]})

        # Grinding: the nonce binds to the full commit-phase transcript and
        # enters the stream BEFORE index sampling.
        if self.grinding_bits:
            with telemetry.phase("grind"):
                nonce = grind(proof_stream.prover_fiat_shamir(), self.grinding_bits)
            proof_stream.push({"pow_nonce": nonce_to_item(nonce)})

        with telemetry.phase("queries"):
            return self._queries(proof_stream, rounds, codewords, trees, mesh)

    def _queries(self, proof_stream, rounds, codewords, trees, mesh) -> List[int]:
        """The query phase: sample the top-level indices, open every round's
        pair leaves and push the points and multiproofs. Returns the
        top-level indices."""
        top_indices = sample_indices(
            proof_stream.prover_fiat_shamir(),
            self.domain_length // 2,
            self.domain_length >> rounds,
            self.num_colinearity_tests,
        )
        # Query phase. Round r opens PAIR leaf i_r of tree r, which binds both
        # colinearity values (a = c[i], b = c[i + half]) with one path. Every
        # gather of every round (codeword columns + sibling digests) goes
        # through ONE device gather and ONE transfer; under a mesh ONE
        # owner_gather of the blocks (global indices).
        indices = list(top_indices)
        requests: List = []
        pending: List[dict] = []
        for r in range(rounds - 1):
            n = self.domain_length >> r
            indices = [i % (n // 2) for i in indices]
            a_idx = list(indices)
            b_idx = [i + n // 2 for i in indices]
            entry: dict = {"r": r, "a_idx": a_idx, "slot": len(requests)}
            requests.append((codewords[r], a_idx + b_idx))
            reqs, fill = trees[r]._prefetch_plan(a_idx)
            entry["tree_base"], entry["tree_count"], entry["fill"] = len(requests), len(reqs), fill
            requests.extend(reqs)
            pending.append(entry)
        with telemetry.phase("query-gather"):
            fetched = gather_requests(requests, mesh)
        for entry in pending:
            base = entry["tree_base"]
            entry["fill"](fetched[base : base + entry["tree_count"]])
            vals = words_to_ints(fetched[entry["slot"]])
            k = len(entry["a_idx"])
            proof_stream.push(
                {"fri_points": [[felt_to_item(int(vals[s])), felt_to_item(int(vals[s + k]))] for s in range(k)]}
            )
        multiproofs = [
            [digest_to_item(d) for d in trees[entry["r"]].open_multi(sorted(set(entry["a_idx"])))]
            for entry in pending
        ]
        if rounds > 1:
            proof_stream.push({"fri_multiproofs": multiproofs})
        return top_indices

    def _commit_one(self, standard: torch.Tensor, chunk: int | None) -> MerkleTree:
        """The pair-leaf tree of one committed round's codeword: chunked in
        chunks of `chunk` leaves when given, else commit()."""
        if chunk:
            return commit_columns_chunked([standard], chunk)
        return commit([standard], self.mesh)

    @staticmethod
    def _offload_round0(codewords, trees, dst: np.ndarray) -> None:
        """Move round 0's codeword, into the host array `dst`, and its tree
        to the host; its queries then read the host arrays. The span to-host
        times the copy."""
        with telemetry.phase("to-host"):
            copy_to_numpy(dst, codewords[0])
            copied(dst)
        codewords[0] = dst
        trees[0].offload_to_host([dst])

    @staticmethod
    def _commit_host(values: List[int]) -> MerkleTree:
        """Pair-leaf tree of a host codeword (hashlib)."""
        h0 = len(values) // 2
        tree = MerkleTree.commit_bytes(
            [hash_felts([values[i], values[i + h0]]) for i in range(h0)]
        )
        tree.pair_leaves = True
        return tree

    def _on_host(self, n: int, world: int) -> bool:
        """True for a round whose length-n codeword finishes on the host:
        at most host_tail_n, or too short to cut into pair halves of W
        blocks (n < 2W) under a mesh."""
        return n <= self.host_tail_n or n < 2 * world

    def _host_tail(self, values, start_round, rounds, omega, offset, codewords, trees,
                   proof_stream, checkpoint_dir, checkpoint_meta, mesh) -> None:
        """Run rounds start_round..rounds-1 in exact host arithmetic from the
        standard-form values of the round's codeword (one device->host copy
        of the small codeword, gathered under a mesh): native C folds and
        hashlib commits; identical values, roots and snapshots on every
        process."""
        for r in range(start_round, rounds):
            tree = self._commit_host(values)
            words = ints_to_words(values)
            if checkpoint_dir is not None:
                snapshot(checkpoint_dir, f"fri-r{r}", [], {"codeword": words}, checkpoint_meta, mesh)
            codewords.append(words)
            trees.append(tree)
            proof_stream.push({"fri_root": digest_to_item(tree.root)})
            if r == rounds - 1:
                break
            alpha = sample_field_element(proof_stream.prover_fiat_shamir())
            values = native.fri_fold_values(values, alpha, finv(offset), finv(omega))
            omega = omega * omega % PRIME
            offset = offset * offset % PRIME

    # -- verifier ----------------------------------------------------------

    def verify(self, proof_stream: ProofStream) -> Tuple[bool, List[Tuple[int, int]]]:
        """Replays the transcript. Returns (accept, top-level points).

        The returned (index, value) pairs of the TOP codeword let the STARK
        layer cross-check the combination polynomial at the queried spots.
        Malformed transcripts (bad encodings, wrong path lengths, truncated
        streams) are rejections — (False, []) — never exceptions.
        """
        try:
            return self._verify(proof_stream)
        except (KeyError, TypeError, ValueError, IndexError, ProofStreamError):
            return False, []

    def _verify(self, proof_stream: ProofStream) -> Tuple[bool, List[Tuple[int, int]]]:
        rounds = self.num_rounds
        omega, offset = self.omega, self.offset

        roots: List[bytes] = []
        alphas: List[int] = []
        for r in range(rounds):
            roots.append(item_to_digest(proof_stream.pull()["fri_root"]))
            if r == rounds - 1:
                break
            alphas.append(sample_field_element(proof_stream.verifier_fiat_shamir()))

        last_items = proof_stream.pull()["fri_last_codeword"]
        last_codeword = [item_to_felt(v) for v in last_items]
        last_len = self.domain_length >> (rounds - 1)
        if len(last_codeword) != last_len:
            return False, []

        # Last codeword must hash to the last commitment (pair leaves,
        # grammar v3). The whole verifier is host-only by design (a STARK
        # verifier must run anywhere, instantly), so both the re-commit and
        # the low-degree check below use exact host arithmetic — the last codeword is small
        # (<= max(2*expansion, 8*checks) values).
        lh = last_len // 2
        last_leaves = [
            hash_felts([last_codeword[j], last_codeword[j + lh]]) for j in range(lh)
        ]
        last_tree = MerkleTree.commit_bytes(last_leaves)
        if last_tree.root != roots[-1]:
            return False, []
        # ...and must be of low enough degree (interpolate on its coset:
        # coefficients of q(offset*x) rescaled by offset^-i).
        last_offset = pow(offset, 1 << (rounds - 1), PRIME)
        inv_off = finv(last_offset)
        q = host_intt(last_codeword)
        coeffs = [q[i] * pow(inv_off, i, PRIME) % PRIME for i in range(last_len)]
        degree_bound = last_len // self.expansion_factor  # max num coefficients
        if any(int(c) != 0 for c in coeffs[degree_bound:]):
            return False, []

        if self.grinding_bits:
            # Seed = transcript digest BEFORE the nonce item; then the
            # nonce joins the stream so index sampling commits to it.
            seed = proof_stream.verifier_fiat_shamir()
            nonce = item_to_nonce(proof_stream.pull()["pow_nonce"])
            if not pow_digest_ok(seed, nonce, self.grinding_bits):
                return False, []

        top_indices = sample_indices(
            proof_stream.verifier_fiat_shamir(),
            self.domain_length // 2,
            self.domain_length >> rounds,
            self.num_colinearity_tests,
        )
        top_points: List[Tuple[int, int]] = []
        indices = list(top_indices)
        # Collect every round's (a, b) pairs FIRST: with pair leaves
        # (grammar v3) the fold value c is never on the wire — for query s
        # at round r it is round r+1's own opened a or b (i_r folds to
        # i_{r+1} = i_r mod half_{r+1}; a if i_r < half_{r+1}, else b), or
        # a direct fri_last_codeword slot on the final query round.
        rounds_idx: List[List[int]] = []
        rounds_pts: List[List[Tuple[int, int]]] = []
        for r in range(rounds - 1):
            half = (self.domain_length >> r) // 2
            indices = [i % half for i in indices]
            points_items = proof_stream.pull()["fri_points"]
            if len(points_items) != len(indices):
                return False, []
            pts = []
            for item in points_items:
                if len(item) != 2:
                    return False, []
                pts.append((item_to_felt(item[0]), item_to_felt(item[1])))
            rounds_idx.append(list(indices))
            rounds_pts.append(pts)
        # Colinearity checks + claimed-pair consistency. Two queries that
        # land on the same pair leaf must claim the same (a, b) — a
        # conflicting transcript is rejected before any hashing.
        claimed: List[dict] = [dict() for _ in range(rounds - 1)]
        for r in range(rounds - 1):
            half = (self.domain_length >> r) // 2
            omega_r = pow(self.omega, 1 << r, PRIME)
            offset_r = pow(self.offset, 1 << r, PRIME)
            alpha = alphas[r]
            next_half = half // 2
            for s, i in enumerate(rounds_idx[r]):
                ay, by = rounds_pts[r][s]
                if r + 1 < rounds - 1:
                    a2, b2 = rounds_pts[r + 1][s]
                    cy = a2 if i < next_half else b2
                else:
                    if not 0 <= i < len(last_codeword):
                        return False, []
                    cy = int(last_codeword[i])
                ax = offset_r * pow(omega_r, i, PRIME) % PRIME
                bx = offset_r * pow(omega_r, i + half, PRIME) % PRIME
                if not colinearity_check([(ax, ay), (bx, by), (alpha, cy)]):
                    return False, []
                prev = claimed[r].setdefault(i, (ay, by))
                if prev != (ay, by):
                    return False, []
                if r == 0:
                    top_points.append((i, ay))
                    top_points.append((i + half, by))
        # ONE multiproof per tree 0..rounds-2 binds every claimed pair
        # leaf; the last tree was rebuilt from fri_last_codeword above, so
        # the final round's c values are bound by that root directly.
        if rounds > 1:
            mp_items = proof_stream.pull()["fri_multiproofs"]
            if not isinstance(mp_items, list) or len(mp_items) != rounds - 1:
                return False, []
            for t in range(rounds - 1):
                # Pair tree over a length-(domain >> t) codeword: half the
                # leaves, one level shorter.
                height = (self.domain_length >> t).bit_length() - 2
                leaf_map = {
                    pos: hash_felts([ay, by])
                    for pos, (ay, by) in claimed[t].items()
                }
                nodes = [item_to_digest(d) for d in mp_items[t]]
                if not verify_multiproof(roots[t], leaf_map, nodes, height):
                    return False, []
        return True, top_points
