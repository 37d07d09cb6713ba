"""A plain verifier of the proofs the benchmark's cells produce.

The protocol is Szepieniec's "Anatomy of a STARK" (parts 5 and 6) in the
proof format the program emits: a JSON list of items, field elements as
canonical decimal strings, Blake2b-512 digests as canonical base64,
SHA-256 Fiat-Shamir over the compact JSON of the items read so far.

    {"bq_root"}, {"zk_root"}               boundary quotients, zk randomizer
    {"fri_root"} x R, {"fri_last_codeword"}, [{"pow_nonce"}]
    {"fri_points"} x (R - 1), {"fri_multiproofs"}
    {"bq_leaves"}, {"bq_multiproof"}, {"zk_leaves"}, {"zk_multiproof"}

Every Merkle tree has pair leaves (leaf j of a length-n codeword hashes rows
j and j + n/2). The verifier takes every parameter from the configuration
(expansion factor, queries, grinding bits, randomizers) and the statement
(chain length, output), none from the proof, so a proof made under weaker
parameters is rejected. It checks: the FRI colinearity of every query at
every round and the last codeword's degree, the grinding nonce, every
opening against its root, and at every queried point the AIR's combination
rebuilt from the opened boundary quotients and zk values against FRI's.
"""

from __future__ import annotations

import base64
import hashlib
import json

from benchmark.reference.field import (
    GENERATOR,
    P,
    challenge,
    challenge_indices,
    horner,
    interpolate_subgroup,
    inv,
    next_pow2,
    root_of_unity,
)


class Rejected(Exception):
    """The proof is malformed or fails a check."""


def _felt(item) -> int:
    if not isinstance(item, str) or item != str(int(item)) or not 0 <= int(item) < P:
        raise Rejected("not a canonical field element")
    return int(item)


def _digest(item) -> bytes:
    if not isinstance(item, str) or len(item) != 88:
        raise Rejected("not a digest item")
    data = base64.b64decode(item, validate=True)
    if len(data) != 64 or base64.b64encode(data).decode("ascii") != item:
        raise Rejected("not a canonical digest")
    return data


def _leaf(values) -> bytes:
    return hashlib.blake2b(b"".join(v.to_bytes(16, "little") for v in values), digest_size=64).digest()


def _node(left: bytes, right: bytes) -> bytes:
    return hashlib.blake2b(left + right, digest_size=64).digest()


def _multiproof_root(leaves: dict, nodes: list, height: int) -> bytes:
    """Fold the known leaves up `height` levels, taking each missing sibling
    from `nodes` in order; every node must be used."""
    if not leaves or any(not 0 <= i < 1 << height for i in leaves):
        raise Rejected("leaf index out of range")
    known, pos = dict(leaves), 0
    for _ in range(height):
        up = {}
        for i in sorted(known):
            if i & 1 and i ^ 1 in known:
                continue
            if i ^ 1 in known:
                sib = known[i ^ 1]
            else:
                if pos >= len(nodes):
                    raise Rejected("multiproof too short")
                sib, pos = nodes[pos], pos + 1
            up[i >> 1] = _node(known[i], sib) if i % 2 == 0 else _node(sib, known[i])
        known = up
    if pos != len(nodes):
        raise Rejected("multiproof too long")
    return known[0]


def _zerofier(points: list, x: int) -> int:
    z = 1
    for xi, _ in points:
        z = z * (x - xi) % P
    return z


def _interpolant(points: list, x: int) -> int:
    """The Lagrange interpolant of the points, at x."""
    acc = 0
    for i, (xi, yi) in enumerate(points):
        term = yi
        for k, (xk, _) in enumerate(points):
            if k != i:
                term = term * (x - xk) % P * inv(xi - xk) % P
        acc += term
    return acc % P


def _tree_root(leaves: list) -> bytes:
    while len(leaves) > 1:
        leaves = [_node(leaves[k], leaves[k + 1]) for k in range(0, len(leaves), 2)]
    return leaves[0]


def _compact(items: list) -> bytes:
    return json.dumps(items, separators=(",", ":"), ensure_ascii=False).encode("utf-8")


class _Transcript:
    def __init__(self, proof: bytes):
        try:
            self.items = json.loads(proof.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise Rejected(f"not a JSON proof: {exc}") from exc
        if not isinstance(self.items, list):
            raise Rejected("a proof is a list of items")
        if _compact(self.items) != proof:
            raise Rejected("not the compact JSON of its items")
        self.read = 0

    def pull(self, key: str):
        if self.read >= len(self.items):
            raise Rejected(f"proof ends before {key!r}")
        item = self.items[self.read]
        if not isinstance(item, dict) or list(item) != [key]:
            raise Rejected(f"expected item {key!r} at position {self.read}")
        self.read += 1
        return item[key]

    def digest(self) -> bytes:
        return hashlib.sha256(_compact(self.items[: self.read])).digest()


class Verifier:
    """Verifier of one AIR's proofs (a reference AIR module's from_config)
    for one configuration and statement length."""

    def __init__(self, air, expansion: int, checks: int, grinding_bits: int, randomizers: int, length: int):
        self.air, self.length = air, length
        self.registers = air.registers
        self.expansion, self.checks, self.grinding_bits = expansion, checks, grinding_bits
        self.rows = air.rows(length)
        self.o = next_pow2(self.rows + randomizers)
        self.tq_degree = air.constraint_degree * (self.o - 1) - (self.rows - 1)
        d = next_pow2(max(self.tq_degree, self.o - 2) + 1)
        self.degree_target = d - 1
        self.f = d * expansion
        self.omega = root_of_unity(self.f)
        self.omicron = root_of_unity(self.o)
        self.shift = self.f // self.o  # FRI-domain positions per trace row
        n, self.fri_rounds = self.f, 0
        while n > expansion and 4 * checks < n:
            n, self.fri_rounds = n // 2, self.fri_rounds + 1
        if self.fri_rounds < 2:
            raise ValueError("FRI needs two rounds or more")
        self.periodic = [interpolate_subgroup(col) for col in air.periodic_columns()]
        if self.periodic and self.o % air.period:
            raise ValueError("the constants' period must divide the trace domain")
        self.excluded = [pow(self.omicron, r, P) for r in range(self.rows - 1, self.o)]

    def verify(self, proof: bytes, output: int) -> bool:
        try:
            self._verify(proof, output % P)
        except (Rejected, KeyError, TypeError, ValueError, IndexError, ZeroDivisionError):
            return False
        return True

    def _verify(self, proof: bytes, output: int) -> None:
        ts = _Transcript(proof)
        f = self.f
        bq_root = _digest(ts.pull("bq_root"))
        zk_root = _digest(ts.pull("zk_root"))
        m = self.registers
        seed = ts.digest()
        terms = self.air.constraints + m  # the transition constraints, m boundary quotients
        weights = [challenge(seed + b"weight" + k.to_bytes(8, "big")) for k in range(2 * terms)]

        top = self._fri(ts)
        bq_vals, zk_vals = self._openings(ts, bq_root, zk_root)
        if ts.read != len(ts.items):
            raise Rejected("items past the end of the proof")

        # register j's boundary points give its interpolant B_j and
        # zerofier Z_j, and its quotient has degree O - 1 - (its points)
        points = [[] for _ in range(m)]
        for row, j, value in self.air.boundary(self.length, output):
            points[j].append((pow(self.omicron, row, P), value % P))
        degrees = [self.tq_degree] * self.air.constraints + [self.o - 1 - len(pts) for pts in points]

        def trace_values(quotients: list, x: int) -> list:
            return [(q * _zerofier(pts, x) + _interpolant(pts, x)) % P for q, pts in zip(quotients, points)]

        for i, value in top:
            i2 = (i + self.shift) % f
            x = GENERATOR * pow(self.omega, i, P) % P
            x2 = GENERATOR * pow(self.omega, i2, P) % P
            cur, nxt = trace_values(bq_vals[i], x), trace_values(bq_vals[i2], x2)
            y = pow(x, self.o // self.air.period, P) if self.periodic else 0
            consts = [horner(q, y) for q in self.periodic]
            zt_inv = inv(pow(x, self.o, P) - 1)
            for r in self.excluded:
                zt_inv = zt_inv * (x - r) % P
            quotients = [c * zt_inv % P for c in self.air.transition(cur, nxt, consts)] + list(bq_vals[i])
            combo = zk_vals[i]
            for t, (q, deg) in enumerate(zip(quotients, degrees)):
                lift = weights[2 * t] + weights[2 * t + 1] * pow(x, self.degree_target - deg, P)
                combo = (combo + lift * q) % P
            if combo != value:
                raise Rejected(f"combination differs at index {i}")

    def _fri(self, ts: _Transcript) -> list:
        """The FRI rounds; returns the (index, value) pairs of the top
        codeword that the queries opened."""
        rounds, f = self.fri_rounds, self.f
        roots, alphas = [], []
        for r in range(rounds):
            roots.append(_digest(ts.pull("fri_root")))
            if r < rounds - 1:
                alphas.append(challenge(ts.digest()))
        last = [_felt(v) for v in ts.pull("fri_last_codeword")]
        n_last = f >> (rounds - 1)
        if len(last) != n_last:
            raise Rejected("last codeword has the wrong length")
        h = n_last // 2
        if _tree_root([_leaf([last[j], last[j + h]]) for j in range(h)]) != roots[-1]:
            raise Rejected("last codeword does not match its root")
        # on the coset c * <w> the coefficients of p(c x) are those of p
        # scaled by c^k: the high ones vanish together
        coeffs = interpolate_subgroup(last)
        if any(coeffs[n_last // self.expansion:]):
            raise Rejected("last codeword is not of low degree")
        if self.grinding_bits:
            seed = ts.digest()
            nonce_item = ts.pull("pow_nonce")
            if not isinstance(nonce_item, str) or nonce_item != str(int(nonce_item)):
                raise Rejected("not a canonical nonce")
            nonce = int(nonce_item)
            if not 0 <= nonce < 1 << 64:
                raise Rejected("nonce out of range")
            word = int.from_bytes(hashlib.sha256(seed + nonce.to_bytes(8, "big")).digest()[:8], "big")
            if word >> (64 - self.grinding_bits):
                raise Rejected("the nonce does not meet the grinding bits")
        indices = challenge_indices(ts.digest(), f // 2, f >> rounds, self.checks)
        pts = []
        for r in range(rounds - 1):
            indices = [i % ((f >> r) // 2) for i in indices]
            items = ts.pull("fri_points")
            if not isinstance(items, list) or len(items) != len(indices):
                raise Rejected("wrong number of query points")
            pts.append([(_felt(a), _felt(b)) for a, b in items])
            pts[-1] = list(zip(indices, pts[-1]))
        top, claimed = [], [dict() for _ in range(rounds - 1)]
        for r in range(rounds - 1):
            n = f >> r
            w, off = pow(self.omega, 1 << r, P), pow(GENERATOR, 1 << r, P)
            for s, (i, (ay, by)) in enumerate(pts[r]):
                if r + 1 < rounds - 1:
                    a2, b2 = pts[r + 1][s][1]
                    cy = a2 if i < n // 4 else b2
                else:
                    cy = last[i]
                ax = off * pow(w, i, P) % P
                bx = off * pow(w, i + n // 2, P) % P
                if ((by - ay) * (alphas[r] - ax) - (cy - ay) * (bx - ax)) % P:
                    raise Rejected(f"colinearity fails at round {r}")
                if claimed[r].setdefault(i, (ay, by)) != (ay, by):
                    raise Rejected("two values for one leaf")
                if r == 0:
                    top += [(i, ay), (i + n // 2, by)]
        proofs = ts.pull("fri_multiproofs")
        if not isinstance(proofs, list) or len(proofs) != rounds - 1:
            raise Rejected("wrong number of FRI multiproofs")
        for r in range(rounds - 1):
            leaves = {i: _leaf(pair) for i, pair in claimed[r].items()}
            height = (f >> r).bit_length() - 2
            if _multiproof_root(leaves, [_digest(d) for d in proofs[r]], height) != roots[r]:
                raise Rejected(f"FRI round {r} openings do not match the root")
        return top

    def _openings(self, ts: _Transcript, bq_root: bytes, zk_root: bytes) -> tuple:
        f, half, m = self.f, self.f // 2, self.registers
        height = f.bit_length() - 2
        bq = {}
        for idx, vals in ts.pull("bq_leaves"):
            if not isinstance(idx, int) or not 0 <= idx < f or len(vals) != m:
                raise Rejected("bad boundary-quotient opening")
            bq[idx] = [_felt(v) for v in vals]
        leaves = {j: _leaf(bq[j] + bq[j + half]) for j in {i % half for i in bq}}
        if _multiproof_root(leaves, [_digest(d) for d in ts.pull("bq_multiproof")], height) != bq_root:
            raise Rejected("boundary-quotient openings do not match the root")
        zk = {}
        for idx, val in ts.pull("zk_leaves"):
            if not isinstance(idx, int) or not 0 <= idx < f:
                raise Rejected("bad zk opening")
            zk[idx] = _felt(val)
        leaves = {j: _leaf([zk[j], zk[j + half]]) for j in {i % half for i in zk}}
        if _multiproof_root(leaves, [_digest(d) for d in ts.pull("zk_multiproof")], height) != zk_root:
            raise Rejected("zk openings do not match the root")
        return bq, zk


def roots(proof: bytes) -> tuple | None:
    """(bq_root, zk_root) as the proof's first two items give them, or None
    for a proof that does not begin so."""
    try:
        items = json.loads(proof.decode("utf-8"))
        return items[0]["bq_root"], items[1]["zk_root"]
    except (UnicodeDecodeError, json.JSONDecodeError, TypeError, KeyError, IndexError, AttributeError):
        return None


def judge(verifier: Verifier, proofs: list) -> tuple:
    """(rejected, roots) of (proof, output) pairs: for each proof whether
    the verifier rejects it, and its roots (a worker process's task)."""
    return [not verifier.verify(p, output) for p, output in proofs], [roots(p) for p, _ in proofs]
