"""Host arrays for the chunked big-domain prover's copies of codewords to
the host, allocated once per prover and reused by every prove.

A big prove (iop/stark.py ``_prove_big``) moves w + 2 codewords of (4, F)
words to host numpy: the w boundary quotients chunk by chunk, the zk
codeword and FRI round 0's codeword (16 GiB at F = 2^28). Copied into
freshly allocated pageable memory, every 4 KiB page faults and is zeroed on
first touch, and CUDA stages the copy through a page-locked buffer of its
own. ``HostPool`` holds the w + 2 destinations instead, page-locked when the
prover runs on a CUDA device (plain host memory on the CPU, or when the
page-locked allocation fails), made by the first big prove and handed to
every later one. A copy into them stays ops/limbs.py ``copy_to_numpy``:
into page-locked memory CUDA runs it as one DMA.

torch keeps freed page-locked blocks in a cache of its own, so the pool
hands them back to CUDA when it drops its arrays: before it allocates for
another shape, and when the pool itself is collected.

``copied(dst)`` counts one call of ``pinned`` or ``pageable`` (the memory
of dst) under the span it runs in (utils/telemetry.py ``count``). The
standard path's small copies keep ops/limbs.py's fresh arrays: a pool there
would only add pinning cost.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import List

import numpy as np
import torch

from stark_anatomy_tpu_torch.utils import telemetry

PINNED = "pinned"
PAGEABLE = "pageable"


class HostPool:
    """`count` host (4, n) uint32 arrays for one prove at a time.

    ``checkout(n, count, device)`` yields them, allocating them when the pool
    holds none of that shape; a second prove waits until the first is done."""

    def __init__(self):
        self._lock = threading.Lock()
        self._key = None
        self.arrays: List[np.ndarray] = []  # emptied in place by _drop
        weakref.finalize(self, _drop, self.arrays).atexit = False

    @contextlib.contextmanager
    def checkout(self, n: int, count: int, device: torch.device):
        with self._lock:
            key = (n, count, device.type)
            if self._key != key:
                self._key = None
                _drop(self.arrays)
                self.arrays += _allocate(n, count, device.type == "cuda")
                self._key = key
            yield self.arrays


def _allocate(n: int, count: int, pin: bool) -> List[np.ndarray]:
    """`count` (4, n) int32 host tensors as uint32 numpy views: page-locked
    when `pin`, plain memory when not or when pinning fails."""
    if pin:
        try:
            return [_view(torch.empty((4, n), dtype=torch.int32, pin_memory=True)) for _ in range(count)]
        except RuntimeError:  # not that much page-locked memory: the part made goes back
            _release_pinned()
    return [_view(torch.empty((4, n), dtype=torch.int32)) for _ in range(count)]


def _view(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _drop(arrays: List[np.ndarray]) -> None:
    """Drop a pool's arrays and hand their page-locked memory back to CUDA."""
    arrays.clear()
    _release_pinned()


def _release_pinned() -> None:
    """Free torch's cached page-locked blocks no tensor uses any more."""
    if torch.cuda.is_initialized():
        torch._C._host_emptyCache()


def is_pinned(array: np.ndarray) -> bool:
    """Whether the host array's memory is page-locked."""
    return torch.cuda.is_initialized() and torch.from_numpy(array.view(np.int32)).is_pinned()


def copied(dst: np.ndarray) -> None:
    """Count one copy to the host into `dst` under the open span, as pinned
    or pageable by dst's memory."""
    telemetry.count(PINNED if is_pinned(dst) else PAGEABLE)
