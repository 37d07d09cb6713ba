"""The shard mesh: S shards of the domain spread over W processes.

Counterpart of the JAX package's parallel/mesh.py. A ``Mesh`` names how a
codeword's domain axis is cut: into ``shards`` (S) contiguous blocks, held
``local_shards`` (S / W) to a process by the ``world`` (W) processes of a
``torch.distributed`` group. Without a group the mesh lives in one process:
all S shards are blocks of one tensor on one device and an exchange between
shards is a permuted copy on that device. With a group the same code
exchanges through ``torch.distributed`` (NCCL for CUDA tensors, gloo for
CPU ones). Nothing here depends on which: the four-step NTT
(parallel/ntt_sharded.py) and the sharded commit (parallel/merkle_sharded.py)
are written once, for S shards.

Layouts of a sharded ``(4, n)`` codeword (the names of ntt_sharded.py):
natural = contiguous blocks, so each process holds the ``(4, n/W)`` tensor of
its block (with W = 1 simply the ``(4, n)`` tensor); cyclic = stored index
``k1 * n/S + k2`` holds element ``k1 + S * k2``, cut the same way.

Beside the exchange of the four-step transform, the block-local prover
(``Stark.prove`` under a group) needs three collectives, each written once
for a group of any size, one process included: ``block_start`` (where this
process's block begins), ``roll_left`` (the block of the codeword rolled by
whole columns, for the AIR's next-row codewords: a halo from the next
block) and ``Mesh.owner_gather`` (values at global indices, the same on
every process, for the openings).
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

    def all_to_all(self, y: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """The tiled all-to-all over the S shards.

        y: ``(planes, S/W, ...)``, the local shards' arrays stacked on dim 1;
        split_axis and concat_axis are dims of y (>= 2). Every shard cuts
        its array into S chunks along split_axis and sends chunk d to shard
        d; every shard concatenates what it receives along concat_axis in
        the order of the senders (``jax.lax.all_to_all(..., tiled=True)``).
        Without a group: a permuted copy on the device. With one (of any
        size): a local permute and one ``all_to_all_single`` of the whole
        local tensor."""
        s, w, local = self.shards, self.world, self.local_shards
        if y.dim() < 3 or y.shape[1] != local or min(split_axis, concat_axis) < 2:
            raise ValueError(f"expected (planes, {local}, ...) and axes >= 2, got {tuple(y.shape)}")
        if y.shape[split_axis] % s:
            raise ValueError(f"axis {split_axis} of {tuple(y.shape)} does not split {s} ways")
        self._counts["all_to_all"] += 1
        # split axis -> (destination process, its local shard, chunk)
        y = y.unflatten(split_axis, (w, local, y.shape[split_axis] // s))
        if self.group is not None:
            send = y.movedim(split_axis, 0).contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=self.group)
            # (source process, planes, its local shard, ...) -> source shard on dim 1
            y = recv.movedim(0, 1).flatten(1, 2)
        else:
            y = y.squeeze(split_axis)
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
        process, with ONE collective. Every process passes the same
        requests; each writes the values at the indices its block holds and
        0 in every other slot, and one ``all_reduce(SUM)`` over int32 joins
        them. Exact: exactly one term of every sum is nonzero. Without a
        group the block is the whole tensor."""
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
        if self.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [p.reshape(shape) for p, shape in zip(flat.split([a * b for a, b in shapes]), shapes)]


def make_mesh(num_shards: int, device="cuda", group=None) -> Mesh:
    """A mesh of `num_shards` shards on `device` (``"cuda"``, the default,
    raises without a card). `group`: the ``torch.distributed`` process group
    whose processes share the shards (``distributed.world_group()`` after
    ``distributed.init``); None keeps every shard in this process."""
    return Mesh(int(num_shards), require_device(device), group)


def block_start(n: int, mesh: Mesh) -> int:
    """The global index of this process's first column of a length-n array
    cut into the group's contiguous blocks (0 without a group)."""
    if n % mesh.world:
        raise ValueError(f"the {mesh.world} processes must divide the length {n}")
    return mesh.rank * (n // mesh.world)


def roll_left(t: torch.Tensor, e: int, mesh: Mesh) -> torch.Tensor:
    """This process's block of a block-sharded ``(k, n)`` array rolled left
    by `e` columns: ``torch.roll(whole, -e, dims=1)`` cut into the same
    blocks, for any e. Without a group, torch.roll of the tensor.

    The block's columns start+e .. start+e+block-1 (mod n) lie in two
    blocks: from column o = e mod block on in the block `hops` = (e mod n)
    // block processes on, and the first o columns of the one after it.
    So every process sends its columns o.. and its first o columns to the
    two processes that need them, in ONE ``all_to_all_single`` with uneven
    splits (e < block: the first e columns of the next block, a halo; one
    process sends both parts to itself)."""
    if mesh.group is None:
        return torch.roll(t, -e, dims=1)
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
    recv = torch.empty(k * block, dtype=t.dtype, device=t.device)
    dist.all_to_all_single(recv, send, recv_sizes, send_sizes, group=mesh.group)
    # recv holds the sources in rank order, each source's parts in part order
    start = sum(recv_sizes[:first_src])
    second_start = start + k * (block - o) if first_src == second_src else sum(recv_sizes[:second_src])
    first = recv[start : start + k * (block - o)].reshape(k, block - o)
    second = recv[second_start : second_start + k * o].reshape(k, o)
    return torch.cat([first, second], dim=1)


def shard(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's contiguous block (along the last axis) of a tensor
    that every process holds whole."""
    start, block = block_start(t.shape[-1], mesh), t.shape[-1] // mesh.world
    return t[..., start : start + block].contiguous()


def holds_blocks(mesh: Mesh | None) -> bool:
    """True for a mesh with a process group (of any size, one process
    included): every codeword is then this process's block, and the prover
    runs block-local."""
    return mesh is not None and mesh.group is not None


def upload_block(words: np.ndarray, mesh: Mesh | None, device) -> torch.Tensor:
    """This process's block of host word planes (the whole array without a
    group), on `device`; only the block is copied."""
    if holds_blocks(mesh):
        start = block_start(words.shape[-1], mesh)
        words = words[:, start : start + words.shape[-1] // mesh.world]
    return to_tensor(words, device)


def gather(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The whole tensor (blocks joined along the last axis) on every process,
    on the device (`t` itself without a group)."""
    if not holds_blocks(mesh):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=-1)


def host_gather(t: torch.Tensor, mesh: Mesh | None) -> np.ndarray:
    """The whole array as uint32 numpy on every process."""
    return to_numpy(gather(t, mesh))
