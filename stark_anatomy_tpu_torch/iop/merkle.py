"""Merkle tree with batched Blake2b-512 hashing on the tensor's device.

Counterpart of the JAX package's iop/merkle.py; same roots, paths and
multiproofs. Behavioural contract (from the Rust reference's merkle.rs):

- binary tree over 64-byte leaf digests, power-of-two leaf count;
- internal node = Blake2b-512(left || right);
- ``open(index)`` returns the authentication path ordered leaf-level -> root;
- ``verify_path`` folds the leaf up by index parity and compares to the root.

``commit_columns(columns, pair)`` hashes codeword columns into leaves and
reduces every level with ONE batched hash call per level
(ops/blake2b_kernels.py: the CUDA kernel for CUDA tensors). Levels are kept
as ``(16, m) int32`` digest planes in NATURAL order on the columns' device;
the top levels (at most 16 nodes) finish on the host with hashlib, which
also brings the root to the host where the transcript needs it. Verification
is host-only hashlib, an intentionally independent implementation.

Leaf rule (proof grammar v3): a leaf is Blake2b-512 of the 16-byte
little-endian canonical encodings of its row's elements; a PAIR leaf j of
length-n columns packs row j of every column, then row j + n/2 of every
column. In this port's storage a column's four word planes ARE its leaf
message words, so building the message is a concatenation of planes.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops.blake2b_kernels import blake2b_planes, merkle_node_hash
from stark_anatomy_tpu_torch.ops.limbs import NUM_WORDS, to_numpy

__all__ = [
    "MerkleTree",
    "commit_columns",
    "pair_columns",
    "gather_requests",
    "multiproof_plan",
    "verify_multiproof",
    "verify_path",
]

#: levels of at most this many nodes are reduced on the host with hashlib.
_HOST_TOP = 16


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def pair_columns(columns: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Codeword columns -> the PAIR-LEAF column list: every column's first
    half, then every column's second half (views, no copies). Leaf j then
    packs rows j and j + n/2: the index pair every FRI query and every STARK
    opening touches together."""
    half = columns[0].shape[-1] // 2
    return [c[:, :half] for c in columns] + [c[:, half:] for c in columns]


def leaf_word_planes(columns: Sequence[torch.Tensor]) -> torch.Tensor:
    """Standard-form (4, n) columns -> (4 * len(columns), n) message planes."""
    for col in columns:
        if col.dim() != 2 or col.shape[0] != NUM_WORDS or col.dtype != torch.int32:
            raise ValueError("expected (4, n) int32 word-plane columns")
    return torch.cat(list(columns), dim=0)


def _host_hash_level(rows: np.ndarray) -> np.ndarray:
    """(m, 16) '<u4' digest rows -> (m/2, 16) parent rows, hashlib."""
    out = np.empty((rows.shape[0] // 2, 16), dtype="<u4")
    for i in range(out.shape[0]):
        d = hashlib.blake2b(rows[2 * i].tobytes() + rows[2 * i + 1].tobytes(), digest_size=64).digest()
        out[i] = np.frombuffer(d, dtype="<u4")
    return out


def gather_requests(requests, mesh=None) -> List[np.ndarray]:
    """Execute gather requests [(tensor (k, n), index list)] as ONE
    concatenated device gather and ONE device->host copy. Returns, per
    request, a (k, len(indices)) uint32 numpy array.

    mesh: a parallel.Mesh whose group spreads the codewords over processes;
    every tensor is then this process's block of a block-sharded array, the
    indices are global, and all requests go through ONE
    ``Mesh.owner_gather`` (one all_reduce). Levels a tree keeps on the
    host never become requests (MerkleTree._prefetch_plan)."""
    if not requests:
        return []
    if mesh is not None and mesh.group is not None:
        parts = [p.reshape(-1) for p in mesh.owner_gather(requests)]
    else:
        parts = []
        for arr, idx in requests:
            ix = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=arr.device)
            parts.append(arr.index_select(1, ix).reshape(-1))
    host = to_numpy(torch.cat(parts))
    out, off = [], 0
    for arr, idx in requests:
        size = arr.shape[0] * len(idx)
        out.append(host[off : off + size].reshape(arr.shape[0], len(idx)))
        off += size
    return out


class MerkleTree:
    """Committed tree. ``levels[l]`` holds level l (leaves at 0) either as a
    ``(16, m) int32`` digest-plane tensor or, for the small top, as an
    ``(m, 16) '<u4'`` numpy array of digest rows; ``levels[-1]`` is the root
    row. Digests an opening needs are gathered in one batch and cached."""

    def __init__(self, levels: List, pair_leaves: bool = False):
        self.levels = levels
        self.pair_leaves = pair_leaves
        self._fetch_cache: dict = {}

    @classmethod
    def commit(cls, leaves: torch.Tensor, pair_leaves: bool = False) -> "MerkleTree":
        """Build the tree from (16, n) int32 leaf-digest planes."""
        if leaves.dim() != 2 or leaves.shape[0] != 16 or leaves.dtype != torch.int32:
            raise ValueError("expected (16, n) int32 leaf digest planes")
        n = leaves.shape[1]
        if not _is_pow2(n):
            raise ValueError("leaf count must be a power of two")
        levels: List = []
        cur = leaves
        while cur.shape[1] > _HOST_TOP:
            levels.append(cur)
            cur = merkle_node_hash(cur)
        rows = np.ascontiguousarray(to_numpy(cur).T).astype("<u4")
        while rows.shape[0] > 1:
            levels.append(rows)
            rows = _host_hash_level(rows)
        levels.append(rows)
        return cls(levels, pair_leaves=pair_leaves)

    @classmethod
    def commit_bytes(cls, leaves: Sequence[bytes]) -> "MerkleTree":
        """Commit from 64-byte leaf digests, wholly on the host (verifiers)."""
        if not _is_pow2(len(leaves)):
            raise ValueError("leaf count must be a power of two")
        rows = np.stack([np.frombuffer(leaf, dtype="<u4") for leaf in leaves])
        levels = []
        while rows.shape[0] > 1:
            levels.append(rows)
            rows = _host_hash_level(rows)
        levels.append(rows)
        return cls(levels)

    @property
    def num_leaves(self) -> int:
        lv = self.levels[0]
        return int(lv.shape[1] if isinstance(lv, torch.Tensor) else lv.shape[0])

    @property
    def height(self) -> int:
        return len(self.levels) - 1

    @property
    def root(self) -> bytes:
        return np.ascontiguousarray(self.levels[-1][0], dtype="<u4").tobytes()

    def _prefetch_plan(self, leaf_indices: Sequence[int]):
        """(requests, fill) for the sibling digests the given opens need.

        requests are un-executed (tensor, indices) descriptors for
        gather_requests, so a caller can funnel MANY trees' needs through one
        gather and one transfer; fill(results) then populates the digest
        cache, in order. Host-resident levels are read directly."""
        keys, reqs = [], []
        for level, arr in enumerate(self.levels[:-1]):
            need = sorted({(i >> level) ^ 1 for i in leaf_indices})
            need = [i for i in need if (level, i) not in self._fetch_cache]
            if not need:
                continue
            if isinstance(arr, np.ndarray):
                for i in need:
                    self._fetch_cache[(level, i)] = arr[i].tobytes()
                continue
            keys.append((level, need))
            reqs.append((arr, need))

        def fill(results) -> None:
            for (level, need), planes in zip(keys, results):
                rows = np.ascontiguousarray(planes.T).astype("<u4")
                for pos, i in enumerate(need):
                    self._fetch_cache[(level, i)] = rows[pos].tobytes()

        return reqs, fill

    def _prefetch(self, leaf_indices: Sequence[int]) -> None:
        reqs, fill = self._prefetch_plan(leaf_indices)
        if reqs:
            fill(gather_requests(reqs))

    def _fetch(self, level: int, index: int) -> bytes:
        key = (level, index)
        if key not in self._fetch_cache:
            arr = self.levels[level]
            if isinstance(arr, np.ndarray):
                self._fetch_cache[key] = arr[index].tobytes()
            else:
                (planes,) = gather_requests([(arr, [index])])
                self._fetch_cache[key] = np.ascontiguousarray(planes.T).astype("<u4").tobytes()
        return self._fetch_cache[key]

    def open(self, index: int) -> List[bytes]:
        """Authentication path, leaf level first: element l is the sibling
        at level l, levels[l][(index >> l) ^ 1]."""
        n = self.num_leaves
        if n < 2:
            raise ValueError("cannot open a tree with fewer than 2 leaves")
        if not 0 <= index < n:
            raise IndexError(f"leaf index {index} out of range for {n} leaves")
        self._prefetch([index])
        path = []
        for level in range(self.height):
            path.append(self._fetch(level, index ^ 1))
            index >>= 1
        return path

    def open_multi(self, indices: Sequence[int]) -> List[bytes]:
        """Deduplicated batch opening: the multiproof_plan node digests, to
        be checked with verify_multiproof(root, {index: leaf}, nodes, height)."""
        idx = sorted(set(int(i) for i in indices))
        n = self.num_leaves
        if not idx:
            raise ValueError("empty multiproof index set")
        if idx[0] < 0 or idx[-1] >= n:
            raise IndexError(f"leaf index out of range for {n} leaves")
        plan = multiproof_plan(idx, self.height)
        self._prefetch(idx)
        return [self._fetch(level, i) for level, i in plan]

    def verify(self, leaf: bytes, path: Sequence[bytes], index: int) -> bool:
        return verify_path(self.root, leaf, path, index)


def commit_columns(columns: Sequence[torch.Tensor], pair: bool = False) -> MerkleTree:
    """Merkle-commit standard-form (4, n) codeword columns.

    pair=True commits PAIR leaves (see pair_columns): n/2 leaves, one level
    shorter, and the (j, j + n/2) openings every consumer makes collapse
    into one. Leaves of any width hash through the same kernel (it chains
    128-byte blocks), so wide AIRs take no other path."""
    cols = pair_columns(columns) if pair else list(columns)
    leaves = blake2b_planes(leaf_word_planes(cols), 16 * len(cols))
    return MerkleTree.commit(leaves, pair_leaves=pair)


def multiproof_plan(indices: Sequence[int], height: int) -> List[Tuple[int, int]]:
    """(level, index) of every node a batch opening must SUPPLY.

    Walking leaf-level up: at each level the known set is the indices whose
    digests the verifier can already compute; a sibling that is itself known
    is free, otherwise it must ship. Canonical order: level ascending, then
    the known node's index ascending, so the node list needs no labels."""
    if not indices:
        raise ValueError("empty multiproof index set")
    cur = sorted(set(indices))
    if cur[0] < 0 or cur[-1] >= (1 << height):
        raise ValueError("index out of range for tree height")
    out: List[Tuple[int, int]] = []
    for level in range(height):
        cur_set = set(cur)
        nxt = []
        for i in cur:
            if i & 1 and (i ^ 1) in cur_set:
                continue  # counted with its even partner
            if (i ^ 1) not in cur_set:
                out.append((level, i ^ 1))
            nxt.append(i >> 1)
        cur = sorted(set(nxt))
    return out


def verify_multiproof(root: bytes, leaves: dict, nodes: Sequence[bytes], height: int) -> bool:
    """Fold a batch of leaves up one shared frontier; True iff it reaches
    `root` consuming EXACTLY the supplied nodes (missing, extra or reordered
    nodes all fail)."""
    if not leaves:
        return False
    if any(not 0 <= i < (1 << height) for i in leaves):
        return False
    known = {int(i): bytes(d) for i, d in leaves.items()}
    pos = 0
    for _level in range(height):
        cur = sorted(known)
        nxt = {}
        for i in cur:
            if i & 1 and (i ^ 1) in known:
                continue
            if (i ^ 1) in known:
                sib = known[i ^ 1]
            else:
                if pos >= len(nodes):
                    return False
                sib = nodes[pos]
                pos += 1
            pair = known[i] + sib if i % 2 == 0 else sib + known[i]
            nxt[i >> 1] = hashlib.blake2b(pair, digest_size=64).digest()
        known = nxt
    if pos != len(nodes):
        return False
    return known.get(0) == root


def verify_path(root: bytes, leaf: bytes, path: Sequence[bytes], index: int) -> bool:
    """Fold `leaf` up `path` by index parity; True iff it reaches `root`.
    Raises ValueError on an empty path or an index beyond 2^len(path)."""
    if not path:
        raise ValueError("empty authentication path")
    if not 0 <= index < (1 << len(path)):
        raise ValueError("index out of range for path length")
    current = leaf
    for sibling in path:
        if index % 2 == 0:
            current = hashlib.blake2b(current + sibling, digest_size=64).digest()
        else:
            current = hashlib.blake2b(sibling + current, digest_size=64).digest()
        index >>= 1
    return current == root
