"""The shard mesh: S shards of the domain spread over W processes.

Counterpart of the JAX package's parallel/mesh.py. A ``Mesh`` names how a
codeword's domain axis is cut: into ``shards`` (S) contiguous blocks, held
``local_shards`` (S / W) to a process by the ``world`` (W) processes of a
``torch.distributed`` group. A mesh made without a group is the world of
this one process (W = 1, rank 0). Every process holds the ``(4, n/W)``
block of each codeword and works on it alone; data crosses shards only
through this module, and all of it through ``Mesh._exchange``, one
``all_to_all_single`` (NCCL for CUDA tensors, gloo for CPU ones; without a
group every part is this process's own and stays where it is). The
four-step NTT (parallel/ntt_sharded.py), the sharded commit
(parallel/merkle_sharded.py) and the block-local prover are written once,
for S shards over W processes.

Layouts of a sharded ``(4, n)`` codeword (the names of ntt_sharded.py):
natural = contiguous blocks, so each process holds the ``(4, n/W)`` tensor of
its block (with W = 1 simply the ``(4, n)`` tensor); cyclic = stored index
``k1 * n/S + k2`` holds element ``k1 + S * k2``, cut the same way.

Beside the tiled exchange of the four-step transform (``Mesh.all_to_all``),
the block-local prover (``Stark.prove`` under a mesh) needs ``block_start``
(where this process's block begins), ``roll_left`` (the block of the
codeword rolled by whole columns, for the AIR's next-row codewords: a halo
from the next block), ``pair_exchange`` (rows i and i + n/2 at the owner of
row i, for pair leaves and FRI folds), ``Mesh.owner_gather`` (values at
global indices, the same on every process, for the openings), ``gather``
(the whole array on every process) and ``Mesh.barrier``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from stark_anatomy_tpu_torch.ops.limbs import require_device, to_numpy, to_tensor
from stark_anatomy_tpu_torch.utils import telemetry


@dataclass(frozen=True)
class Mesh:
    """S shards on `device`, over the processes of `group` (None: this one)."""

    shards: int
    device: torch.device
    group: object | None = None
    _counts: dict = field(default_factory=lambda: {"all_to_all": 0}, compare=False, repr=False)

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError("a mesh needs at least one shard")
        if self.shards % self.world:
            raise ValueError(
                f"the {self.world} processes of the group must divide the {self.shards} shards")

    @property
    def world(self) -> int:
        """W: the number of processes holding shards (1 without a group)."""
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_shards(self) -> int:
        """S / W: the shards this process holds, shard rank * S/W first."""
        return self.shards // self.world

    @property
    def exchanges(self) -> int:
        """all_to_all calls made on this mesh so far."""
        return self._counts["all_to_all"]

    def _exchange(self, send: torch.Tensor, send_sizes=None, recv_sizes=None) -> torch.Tensor:
        """The one exchange between processes: ``all_to_all_single`` over
        the group. Part d of `send` goes to process d and part d of the
        result came from process d: even parts along dim 0 when the sizes
        are None, else a flat tensor cut into the given sizes. Without a
        group (W = 1) every part is this process's own: `send` itself."""
        if self.group is None:
            return send
        recv = send.new_empty(send.shape if recv_sizes is None else (sum(recv_sizes),))
        dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=self.group)
        return recv

    def barrier(self) -> None:
        """Return once every process of the group has called it (at once
        without a group)."""
        if self.group is not None:
            dist.barrier(group=self.group)

    def all_to_all(self, y: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """The tiled all-to-all over the S shards.

        y: ``(planes, S/W, ...)``, the local shards' arrays stacked on dim 1;
        split_axis and concat_axis are dims of y (>= 2). Every shard cuts
        its array into S chunks along split_axis and sends chunk d to shard
        d; every shard concatenates what it receives along concat_axis in
        the order of the senders (``jax.lax.all_to_all(..., tiled=True)``):
        one ``_exchange`` of the whole local tensor and local permutes."""
        s, w, local = self.shards, self.world, self.local_shards
        if y.dim() < 3 or y.shape[1] != local or min(split_axis, concat_axis) < 2:
            raise ValueError(f"expected (planes, {local}, ...) and axes >= 2, got {tuple(y.shape)}")
        if y.shape[split_axis] % s:
            raise ValueError(f"axis {split_axis} of {tuple(y.shape)} does not split {s} ways")
        self._counts["all_to_all"] += 1
        # split axis -> (destination process, its local shard, chunk)
        y = y.unflatten(split_axis, (w, local, y.shape[split_axis] // s))
        recv = self._exchange(y.movedim(split_axis, 0).contiguous())
        # (source process, planes, its local shard, ...) -> source shard on dim 1
        y = recv.movedim(0, 1).flatten(1, 2)
        # now dim 1 = source shard (all S), split_axis = destination local
        # shard, split_axis + 1 = the chunk; the rest as before, one to the
        # right from split_axis on
        cat = concat_axis + (concat_axis >= split_axis)
        order = [0, split_axis]
        for d in range(2, y.dim()):
            if d == split_axis:
                continue
            if d == cat:
                order.append(1)
            order.append(d)
        at = order.index(1)
        return y.permute(order).contiguous().flatten(at, at + 1)

    def owner_gather(self, requests) -> List[torch.Tensor]:
        """The values of block-sharded ``(k, n/W)`` tensors at global
        indices (a sequence or an int64 tensor), for every ``(tensor,
        indices)`` request: ``(k, len(indices))`` each, the same on every
        process, with ONE exchange. Every process passes the same requests;
        each writes the values at the indices its block holds and 0 in every
        other slot, sends that to every process, and sums what it receives
        over int32. Exact: exactly one term of every sum is nonzero (at
        W = 1 the sum of one term)."""
        if not requests:
            return []
        parts, shapes = [], []
        for t, indices in requests:
            block = t.shape[-1]
            with telemetry.device_wait(t.device):  # an upload from pageable memory
                idx = torch.as_tensor(indices, dtype=torch.int64).to(t.device).reshape(-1)
            local = idx - self.rank * block
            mine = (local >= 0) & (local < block)
            vals = t.index_select(1, torch.where(mine, local, 0))
            parts.append(torch.where(mine, vals, 0).reshape(-1))
            shapes.append((t.shape[0], idx.numel()))
        flat = torch.cat(parts)
        flat = self._exchange(flat.expand(self.world, -1).contiguous()).sum(0, dtype=torch.int32)
        return [p.reshape(shape) for p, shape in zip(flat.split([a * b for a, b in shapes]), shapes)]


def make_mesh(num_shards: int, device="cuda", group=None) -> Mesh:
    """A mesh of `num_shards` shards on `device` (``"cuda"``, the default,
    raises without a card). `group`: the ``torch.distributed`` process group
    whose processes share the shards (``distributed.world_group()`` after
    ``distributed.init``); None makes the world of this one process."""
    return Mesh(int(num_shards), require_device(device), group)


def block_start(n: int, mesh: Mesh) -> int:
    """The global index of this process's first column of a length-n array
    cut into the group's contiguous blocks (0 for a world of one)."""
    if n % mesh.world:
        raise ValueError(f"the {mesh.world} processes must divide the length {n}")
    return mesh.rank * (n // mesh.world)


def roll_left(t: torch.Tensor, e: int, mesh: Mesh) -> torch.Tensor:
    """This process's block of a block-sharded ``(k, n)`` array rolled left
    by `e` columns: ``torch.roll(whole, -e, dims=1)`` cut into the same
    blocks, for any e.

    The block's columns start+e .. start+e+block-1 (mod n) lie in two
    blocks: from column o = e mod block on in the block `hops` = (e mod n)
    // block processes on, and the first o columns of the one after it.
    So every process sends its columns o.. and its first o columns to the
    two processes that need them, in ONE exchange with uneven splits
    (e < block: the first e columns of the next block, a halo; one process
    sends both parts to itself)."""
    k, block = t.shape
    w, rank = mesh.world, mesh.rank
    hops, o = divmod(e % (block * w), block)
    # (destination, part, columns): part 0 = its first columns, 1 = the rest
    parts = sorted([((rank - hops) % w, 0, t[:, o:]), ((rank - hops - 1) % w, 1, t[:, :o])],
                   key=lambda p: p[:2])
    send = torch.cat([cols.reshape(-1) for _, _, cols in parts])
    send_sizes, recv_sizes = [0] * w, [0] * w
    for dst, _, cols in parts:
        send_sizes[dst] += cols.numel()
    first_src, second_src = (rank + hops) % w, (rank + hops + 1) % w
    recv_sizes[first_src] += k * (block - o)
    recv_sizes[second_src] += k * o
    recv = mesh._exchange(send, send_sizes, recv_sizes)
    # recv holds the sources in rank order, each source's parts in part order
    start = sum(recv_sizes[:first_src])
    second_start = start + k * (block - o) if first_src == second_src else sum(recv_sizes[:second_src])
    first = recv[start : start + k * (block - o)].reshape(k, block - o)
    second = recv[second_start : second_start + k * o].reshape(k, o)
    return torch.cat([first, second], dim=1)


def pair_exchange(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows i and i + n/2 of a block-sharded ``(k, n/W)`` tensor, brought to
    the process that owns output row i of the length-n/2 half:
    ``(2k, n/(2W))``, every plane's first-half rows, then every plane's
    second-half rows (the pair leaves of a commit, the pairs of a FRI fold).

    Cut the global rows into 2W half-blocks; process p holds half-blocks 2p
    and 2p + 1, and process r needs half-block r (first halves) and W + r
    (second halves). So every process sends its two half-blocks to the
    processes 2p mod W and 2p + 1 mod W and receives two, in ONE exchange
    with uneven splits; what arrives is already in source order = first
    half, then second half. One process sends both to itself."""
    w, rank = mesh.world, mesh.rank
    k, block = t.shape
    if block % 2:
        raise ValueError(f"a block of {block} columns does not split into pair halves")
    half = block // 2
    size = k * half
    send = torch.cat([t[:, :half].reshape(-1), t[:, half:].reshape(-1)])
    send_sizes, recv_sizes = [0] * w, [0] * w
    for b in (0, 1):
        send_sizes[(2 * rank + b) % w] += size
        recv_sizes[(b * w + rank) // 2] += size
    return mesh._exchange(send, send_sizes, recv_sizes).reshape(2 * k, half)


def shard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's contiguous block (along the last axis) of a tensor
    that every process holds whole."""
    start, block = block_start(t.shape[-1], mesh), t.shape[-1] // mesh.world
    return t[..., start : start + block].contiguous()


def upload_block(words: np.ndarray, mesh: Mesh | None, device) -> torch.Tensor:
    """This process's block of host word planes (the whole array without a
    mesh), on `device`; only the block is copied."""
    if mesh is not None:
        start = block_start(words.shape[-1], mesh)
        words = words[:, start : start + words.shape[-1] // mesh.world]
    return to_tensor(words, device)


def gather(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The whole tensor (blocks joined along the last axis) on every process,
    on the device (`t` itself without a mesh, and in a world of one): every
    process sends its block to every process in one exchange."""
    if mesh is None:
        return t
    recv = mesh._exchange(t.expand(mesh.world, *t.shape).contiguous())
    return recv.movedim(0, -2).flatten(-2)


def host_gather(t: torch.Tensor, mesh: Mesh | None) -> np.ndarray:
    """The whole array as uint32 numpy on every process."""
    return to_numpy(gather(t, mesh))
