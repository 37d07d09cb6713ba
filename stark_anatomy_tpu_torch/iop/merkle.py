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

For codewords too long to commit in one piece (the chunked big-domain
prover, iop/stark.py), ``commit_columns_chunked`` / ``ChunkedPairCommit``
hash aligned chunks of pair columns on the device and keep only the levels
above ``prune_levels`` (on the host): the leaf level and the levels just
above it are dropped (``None``) and an opening rebuilds the aligned block of
leaves under each opened leaf from the codeword columns the tree keeps
(``leaf_columns``, device tensors or host numpy), one batch for all blocks.
``MerkleTree.offload_to_host`` moves the device levels to the host, and
repoints the leaf columns at their host copies.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops.blake2b_kernels import blake2b_planes, merkle_node_hash
from stark_anatomy_tpu_torch.ops.limbs import NUM_WORDS, require_device, to_numpy, to_tensor
from stark_anatomy_tpu_torch.utils import telemetry

__all__ = [
    "ChunkedPairCommit",
    "MerkleTree",
    "commit_columns",
    "commit_columns_chunked",
    "pair_columns",
    "gather_requests",
    "multiproof_plan",
    "verify_multiproof",
    "verify_path",
]

#: levels of at most this many nodes are reduced on the host with hashlib.
_HOST_TOP = 16
#: fewest leaves a ChunkedPairCommit chunk may have; trees with smaller
#: chunks are committed whole (commit_columns_chunked).
MIN_CHUNK_LEAVES = 2048


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
    """Execute gather requests [(array (k, n), index list)]: host numpy
    arrays are indexed where they are, every tensor goes through ONE
    concatenated device gather and ONE device->host copy. Returns, per
    request, a (k, len(indices)) uint32 numpy array.

    mesh: a parallel.Mesh; every tensor is then this process's block of a
    block-sharded array, the indices are global, and all tensor requests go
    through ONE ``Mesh.owner_gather`` (one exchange). Levels a tree keeps on the
    host never become requests (MerkleTree._prefetch_plan)."""
    out: List = [None] * len(requests)
    on_device = []
    for k, (arr, idx) in enumerate(requests):
        if isinstance(arr, np.ndarray):
            out[k] = arr[:, np.asarray(idx, dtype=np.int64)]
        else:
            on_device.append(k)
    if not on_device:
        return out
    dev_requests = [requests[k] for k in on_device]
    # One device-wait: each index list's upload from pageable memory drains
    # the stream, and so does the copy back.
    with telemetry.device_wait(dev_requests[0][0].device):
        if mesh is not None:
            parts = [p.reshape(-1) for p in mesh.owner_gather(dev_requests)]
        else:
            parts = []
            for arr, idx in dev_requests:
                ix = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=arr.device)
                parts.append(arr.index_select(1, ix).reshape(-1))
        host = to_numpy(torch.cat(parts))
    off = 0
    for k, (arr, idx) in zip(on_device, dev_requests):
        size = arr.shape[0] * len(idx)
        out[k] = host[off : off + size].reshape(arr.shape[0], len(idx))
        off += size
    return out


def _host_rows(planes: torch.Tensor) -> np.ndarray:
    """(16, m) int32 digest planes (any device) -> (m, 16) '<u4' host rows."""
    return np.ascontiguousarray(to_numpy(planes).T).astype("<u4")


class MerkleTree:
    """Committed tree. ``levels[l]`` holds level l (leaves at 0) either as a
    ``(16, m) int32`` digest-plane tensor or, on the host, as an
    ``(m, 16) '<u4'`` numpy array of digest rows; ``levels[-1]`` is the root
    row. Digests an opening needs are gathered in one batch and cached.

    The bottom levels may be dropped (``None``, levels 0 .. k-1) when the
    tree keeps the codeword columns it committed (``leaf_columns``: device
    tensors or host numpy, full length; pair leaves when ``pair_leaves``).
    Every sibling an opening of leaf i needs below level k is a node of the
    aligned block of 2^k leaves containing i: such blocks are rebuilt from
    the columns, all missing ones in one batch hashed on ``device``, and
    kept."""

    def __init__(self, levels: List, pair_leaves: bool = False, leaf_columns: List | None = None,
                 device=None):
        if levels[0] is None and leaf_columns is None:
            raise ValueError("dropped leaf level requires leaf_columns")
        self.levels = levels
        self.pair_leaves = pair_leaves
        self.leaf_columns = leaf_columns
        self.device = device
        self._fetch_cache: dict = {}
        self._blocks: dict = {}  # block index -> its rebuilt levels 0 .. k-1 as host rows

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
        rows = _host_rows(cur)
        while rows.shape[0] > 1:
            levels.append(rows)
            rows = _host_hash_level(rows)
        levels.append(rows)
        return cls(levels, pair_leaves=pair_leaves, device=leaves.device)

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
    def dropped_levels(self) -> int:
        """k: levels 0 .. k-1 are not stored."""
        k = 0
        while self.levels[k] is None:
            k += 1
        return k

    @property
    def num_leaves(self) -> int:
        k = self.dropped_levels
        lv = self.levels[k]
        return int(lv.shape[1] if isinstance(lv, torch.Tensor) else lv.shape[0]) << k

    @property
    def height(self) -> int:
        return len(self.levels) - 1

    @property
    def root(self) -> bytes:
        return np.ascontiguousarray(self.levels[-1][0], dtype="<u4").tobytes()

    def offload_to_host(self, leaf_columns: List | None = None) -> None:
        """Move every device level to host rows, freeing the device memory;
        openings then read the host arrays. A tree that keeps its leaf
        columns takes their host copies (``leaf_columns``) in their place."""
        if self.leaf_columns is not None:
            if leaf_columns is None:
                raise ValueError("a tree that keeps its leaf columns needs their host copies")
            self.leaf_columns = list(leaf_columns)
        self.levels = [lv if lv is None or isinstance(lv, np.ndarray) else _host_rows(lv)
                       for lv in self.levels]

    def _rebuild_blocks(self, blocks) -> None:
        """Rebuild the dropped levels of the given aligned leaf blocks (2^k
        leaves each) from leaf_columns: ONE gather of every block's rows, one
        batch of leaf hashes and one reduction a level, on self.device."""
        k = self.dropped_levels
        todo = sorted(set(blocks) - set(self._blocks))
        if not todo:
            return
        span = 1 << k
        idx = (np.asarray(todo, dtype=np.int64)[:, None] * span + np.arange(span)).reshape(-1)
        rows = np.concatenate([idx, idx + self.num_leaves]) if self.pair_leaves else idx
        parts = gather_requests([(c, rows) for c in self.leaf_columns])
        m = idx.shape[0]
        planes = [p[:, :m] for p in parts] + ([p[:, m:] for p in parts] if self.pair_leaves else [])
        msg = to_tensor(np.concatenate(planes, axis=0), self.device)
        level = blake2b_planes(msg, 16 * len(planes))
        for lv in range(k):
            host = _host_rows(level)
            width = span >> lv
            for pos, b in enumerate(todo):
                self._blocks.setdefault(b, []).append(host[pos * width : (pos + 1) * width])
            if lv + 1 < k:
                level = merkle_node_hash(level)

    def _dropped_node(self, level: int, index: int) -> bytes:
        k = self.dropped_levels
        b = index >> (k - level)
        self._rebuild_blocks([b])
        return self._blocks[b][level][index - (b << (k - level))].tobytes()

    def _prefetch_plan(self, leaf_indices: Sequence[int]):
        """(requests, fill) for the sibling digests the given opens need.

        requests are un-executed (tensor, indices) descriptors for
        gather_requests, so a caller can funnel MANY trees' needs through one
        gather and one transfer; fill(results) then populates the digest
        cache, in order. Host-resident levels are read directly; the blocks
        under the opened leaves are rebuilt here, in one batch, when the
        tree dropped its bottom levels."""
        k = self.dropped_levels
        if k:
            self._rebuild_blocks({i >> k for i in leaf_indices})
        keys, reqs = [], []
        for level in range(k, self.height):
            arr = self.levels[level]
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
            if arr is None:
                return self._dropped_node(level, index)
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

    def open_many(self, indices: Sequence[int]) -> List[List[bytes]]:
        """Authentication paths of several leaves, their digests gathered in
        one batch."""
        self._prefetch([int(i) for i in indices])
        return [self.open(int(i)) for i in indices]

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


class ChunkedPairCommit:
    """Streaming PAIR-leaf commit whose tree keeps only its upper levels,
    on the host.

    Feed aligned chunks of ``chunk_leaves`` leaves as PRE-SPLIT pair columns
    (every column's rows of the chunk from the first half, then every
    column's rows from the second half: the pair_columns order) through
    add(), in leaf order. Each chunk is hashed with blake2b_planes and reduced
    to its subtree root by merkle_node_hash on the device; its levels above
    ``prune_levels`` go to the host. finish() hashes the chunk roots to the
    root with hashlib and returns the tree, with levels 0 .. prune_levels
    dropped: openings rebuild them from the leaf columns (MerkleTree). Aligned
    chunk reductions ARE the blocks of the whole tree, so the root and every
    opening equal commit_columns(..., pair=True)."""

    def __init__(self, chunk_leaves: int, msg_len: int, prune_levels: int = 10):
        if chunk_leaves < MIN_CHUNK_LEAVES or not _is_pow2(chunk_leaves):
            raise ValueError(f"chunk_leaves must be a power of two >= {MIN_CHUNK_LEAVES}")
        self.chunk_leaves = chunk_leaves
        self.msg_len = msg_len
        self.chunk_levels = chunk_leaves.bit_length() - 1
        # the chunk root level is always kept
        self.prune_levels = min(prune_levels, self.chunk_levels - 1)
        self.device = None
        self._per_level: List[List[np.ndarray]] = [[] for _ in range(self.chunk_levels)]
        self._chunk_roots: List[np.ndarray] = []

    def add(self, pair_cols_chunk: Sequence[torch.Tensor]) -> None:
        """Hash one chunk to its subtree root and keep its upper levels on
        the host. The span chunk-commit: leaf hash, reduction, the kept
        levels' copy to the host."""
        with telemetry.phase("chunk-commit"):
            msg = leaf_word_planes(pair_cols_chunk)
            if msg.shape[1] != self.chunk_leaves:
                raise ValueError(f"expected chunks of {self.chunk_leaves} leaves, got {msg.shape[1]}")
            self.device = msg.device
            level = blake2b_planes(msg, self.msg_len)
            del msg
            kept = []
            for lv in range(1, self.chunk_levels + 1):
                level = merkle_node_hash(level)
                if lv > self.prune_levels:
                    kept.append(level)
            host = to_numpy(torch.cat(kept, dim=1))  # one copy for the chunk's kept levels
        off = 0
        for lv in range(self.prune_levels + 1, self.chunk_levels + 1):
            width = self.chunk_leaves >> lv
            rows = np.ascontiguousarray(host[:, off : off + width].T).astype("<u4")
            off += width
            (self._chunk_roots if lv == self.chunk_levels else self._per_level[lv]).append(rows)

    def finish(self, leaf_columns: List) -> MerkleTree:
        """The tree of every chunk added; leaf_columns are the committed
        full-length columns (device tensors or host numpy)."""
        levels: List = [None] * (self.prune_levels + 1)
        for lv in range(self.prune_levels + 1, self.chunk_levels):
            levels.append(np.concatenate(self._per_level[lv], axis=0))
        rows = np.concatenate(self._chunk_roots, axis=0)
        while rows.shape[0] > 1:
            levels.append(rows)
            rows = _host_hash_level(rows)
        levels.append(rows)
        return MerkleTree(levels, pair_leaves=True, leaf_columns=list(leaf_columns), device=self.device)


def commit_columns_chunked(columns: Sequence, chunk_leaves: int = 1 << 22, device=None) -> MerkleTree:
    """PAIR-leaf commit of full-length standard-form columns through
    ChunkedPairCommit: the root and openings of commit_columns(..., pair=True).

    columns: (4, n) device tensors, or host numpy uint32 arrays; host columns
    are sliced on the host, uploaded one chunk at a time to `device` (default
    "cuda") and kept as the tree's leaf_columns. Trees with fewer than MIN_CHUNK_LEAVES
    leaves a chunk are committed whole by commit_columns. The span
    merkle-commit, as iop/fri.py commit."""
    with telemetry.phase("merkle-commit"):
        on_host = isinstance(columns[0], np.ndarray)
        device = require_device(device or "cuda") if on_host else columns[0].device
        n = int(columns[0].shape[-1])
        half = n // 2
        n_chunks = max(1, half // max(chunk_leaves, 1))
        chunk_leaves = half // n_chunks
        if chunk_leaves < MIN_CHUNK_LEAVES:
            return commit_columns([to_tensor(c, device) if on_host else c for c in columns], pair=True)
        builder = ChunkedPairCommit(chunk_leaves, 32 * len(columns))
        for k in range(n_chunks):
            lo = [c[:, k * chunk_leaves : (k + 1) * chunk_leaves] for c in columns]
            hi = [c[:, half + k * chunk_leaves : half + (k + 1) * chunk_leaves] for c in columns]
            builder.add([to_tensor(p, device) for p in lo + hi] if on_host else lo + hi)
        return builder.finish(columns)


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
