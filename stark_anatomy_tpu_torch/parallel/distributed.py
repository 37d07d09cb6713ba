"""Joining several processes into one mesh with ``torch.distributed``.

Counterpart of the JAX package's parallel/distributed.py. Every process runs
the same program:

    from stark_anatomy_tpu_torch.parallel import distributed, make_mesh
    distributed.init(device="cuda")      # a no-op for a single process
    mesh = make_mesh(8, "cuda", group=distributed.world_group())

and the sharded transforms and commits (parallel/ntt_sharded.py,
parallel/merkle_sharded.py) then exchange through the group. The
coordinator's address, the number of processes and this process's rank come
from the arguments or from PyTorch's own environment variables
(``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend
follows the device the caller names: ``nccl`` for a CUDA mesh, ``gloo`` for a
CPU one; it is never found by trying one and catching the failure.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device="cuda",
) -> bool:
    """Initialise the default process group (idempotent).

    Returns True when a process group was (or already is) initialised,
    False for a single process with no configuration: nothing to
    coordinate, and no start-up paid by local runs and tests.

    coordinator_address: an init method URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``. backend: ``nccl`` or ``gloo``;
    default by `device`."""
    if dist.is_initialized():
        # initialised here earlier, or by a launcher or the caller
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        if num_processes in (None, 1):
            return False  # single process: nothing to initialise
        raise ValueError(
            "multi-process run requested but no coordinator address given "
            "(pass coordinator_address or set MASTER_ADDR and MASTER_PORT)"
        )
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=coordinator_address,
        world_size=1 if num_processes is None else num_processes,
        rank=0 if process_id is None else process_id,
    )
    return True


def world_group():
    """The group of all processes for ``make_mesh(group=)``; None when no
    process group is initialised (a single-process mesh)."""
    return dist.group.WORLD if dist.is_initialized() else None


def process_index() -> int:
    """This process's rank (0 for a single process)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_controller() -> bool:
    """True on the process that should keep or serve the proof bytes."""
    return process_index() == 0
