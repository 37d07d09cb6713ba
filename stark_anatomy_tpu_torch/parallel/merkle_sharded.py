"""Sharded Merkle commitment: every shard hashes and reduces its own block.

Counterpart of the JAX package's parallel/merkle_sharded.py. Each shard
hashes its contiguous block of leaves and reduces it to its subtree root
locally (``blake2b_planes``: the CUDA kernel on a CUDA tensor); only the S
subtree roots cross shards, and the top log2(S) levels finish on the host
with hashlib. Contiguous-block sharding makes every shard's levels exact
slices of the global levels, so the tree equals iop/merkle.py
``commit_columns`` in its root, in every level and in every opening, for
every mesh.

Each process hashes the blocks of its own shards in ONE hash launch a
level; pair leaves come through ``pair_exchange`` (parallel/mesh.py), the
exchange the block-local FRI fold (iop/fri.py) shares. In a world of one
process the levels stay on the device (as ``(16, m)`` digest planes,
natural order) for the openings; over several processes every level is
gathered to the host of every process. Levels are kept in natural order;
the bit-reversed lane order of the TPU kernels is not carried over.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from stark_anatomy_tpu_torch.iop.merkle import (
    MerkleTree,
    _host_hash_level,
    commit_columns,
    leaf_word_planes,
)
from stark_anatomy_tpu_torch.ops.blake2b_kernels import blake2b_planes, merkle_node_hash
from stark_anatomy_tpu_torch.ops.limbs import to_numpy
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, gather, host_gather, pair_exchange


def _rows(level: np.ndarray) -> np.ndarray:
    """(16, m) uint32 digest planes -> (m, 16) '<u4' digest rows."""
    return np.ascontiguousarray(level.T).astype("<u4")


def commit_sharded(columns: Sequence[torch.Tensor], mesh: Mesh, pair: bool = False) -> MerkleTree:
    """Commit to the rows of standard-form codeword columns over a mesh.

    columns: this process's ``(4, n/W)`` part of every column (natural
    layout). Returns a MerkleTree whose root, levels and openings equal
    iop/merkle.py ``commit_columns(columns, pair)`` of the whole columns;
    with several processes every process holds the whole tree, on the host.
    pair=True commits pair leaves (iop/merkle.py pair_columns): row j and its
    partner j + n/2 may start on different processes, see pair_exchange."""
    s, w = mesh.shards, mesh.world
    rows = columns[0].shape[-1] * w
    leaves = rows // 2 if pair else rows
    per_shard = leaves // s
    if s == 1 or leaves % s or per_shard == 0 or per_shard & (per_shard - 1):
        # Tiny or indivisible domains (the last FRI rounds): the
        # single-device commit of the whole columns, the same tree; over
        # several processes its levels go to the host like the others.
        tree = commit_columns([gather(c, mesh) for c in columns], pair=pair)
        if w > 1:
            tree.offload_to_host()
        return tree
    msg = leaf_word_planes(columns)
    if pair:
        msg = pair_exchange(msg, mesh)
    cur = blake2b_planes(msg, 4 * msg.shape[0])
    device_levels: List[torch.Tensor] = [cur]
    while cur.shape[1] > mesh.local_shards:  # down to one root per shard
        cur = merkle_node_hash(cur)
        device_levels.append(cur)
    if w == 1:
        levels: List = device_levels[:-1]
        top = _rows(to_numpy(cur))
    else:
        levels = [_rows(host_gather(lv, mesh)) for lv in device_levels[:-1]]
        top = _rows(host_gather(cur, mesh))
    # Host top: reduce the S subtree roots.
    while top.shape[0] > 1:
        levels.append(top)
        top = _host_hash_level(top)
    levels.append(top)
    return MerkleTree(levels, pair_leaves=pair)
