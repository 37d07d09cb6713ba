"""Radix-2 NTT cores: the CUDA kernels of csrc/ntt.cu and their plain version.

Counterpart of the JAX package's ops/ntt_pallas.py. ``transform(x, tw,
scale)`` maps ``(4, n)`` Montgomery-form coefficients in natural order to
evaluations in natural order, given the master twiddle table ``tw`` =
``[w^0 .. w^(n/2-1)]`` as ``(4, n/2)`` planes; ``scale`` (a raw Montgomery
constant or None) is multiplied into every element, which is how the inverse
transform gets its 1/n.

For a CUDA tensor it launches ``ntt_block`` once (bit-reversed load, the
first min(10, log2 n) stages in shared memory, the scale) and ``ntt_stage``
once per remaining stage. For a CPU tensor, and only then, it runs
``transform_plain``: the constant-geometry (self-sorting) form, one gather /
product / add / sub per stage in plain torch ops. Both give the unique
canonical values of the transform, so they agree bit for bit.

``ntt_block`` and ``ntt_stage`` are also callable on their own; each has its
plain version (``ntt_block_plain``, ``ntt_stage_plain``: the same
decimation-in-time stages in torch ops) which a CPU tensor takes and which
the kernel is compared with on the card.

``ntt_grouped(x, tw, group, scale)`` is the counterpart of
``grouped_ntt_with_tables``: every aligned run of ``group`` <= 128 elements
of ``x`` is one independent transform, natural order in and out, with the
``(4, group/2)`` master table of size ``group``. One ``ntt_grouped`` launch
on the card, ``ntt_grouped_plain`` on the CPU. The mesh four-step NTT
(parallel/ntt_sharded.py) runs its column transforms through it.
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops import _build
from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import field_torch as ft
from stark_anatomy_tpu_torch.ops.limbs import int_to_words

#: log2 of the largest run of outputs one thread block transforms (16 KB of
#: shared memory at 16 B per element).
LOG_BLOCK_MAX = 10
#: log2 of the largest group ntt_grouped transforms (as the TPU kernel: 128).
LOG_GROUP_MAX = 7


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    return n.bit_length() - 1


def transform_plain(x: torch.Tensor, tw: torch.Tensor, scale: int | None = None) -> torch.Tensor:
    """Constant-geometry DIT butterflies in plain torch ops (any device).

    With m = 2^s sub-transform results laid out k-major, the combine step
    pairs positions (i', i' + halfc), halfc = n/(2m), i' = ((i & ~mask) << 1)
    | (i & mask), mask = halfc - 1, writing E + w^(i & ~mask) * O to position
    i and E - .. to i + n/2. It starts from natural input and ends in natural
    output with no bit-reversal pass."""
    n = x.shape[1]
    stages = _log2(n)
    half = n // 2
    i = torch.arange(half, dtype=torch.int64, device=x.device)
    for s in range(stages):
        halfc = n >> (s + 1)
        mask = halfc - 1
        e_idx = ((i & ~mask) << 1) | (i & mask)
        e = x.index_select(1, e_idx)
        o = x.index_select(1, e_idx + halfc)
        w = tw.index_select(1, i & ~mask)
        t = ft.mont_mul(o, w)
        x = torch.cat([ft.add(e, t), ft.sub(e, t)], dim=1)
    return x if scale is None else ft.mont_mul(x, scale)


def _bit_reverse_indices(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int,
                    size: int | None = None) -> torch.Tensor:
    """Plain version of ntt_stage: DIT stage s (m = 2^s, h = m/2) combines
    positions (pos, pos + h) of every group of m with w^(j * size/m), where
    `size` (default: all of x) is the transform length tw belongs to."""
    n = x.shape[1]
    size = n if size is None else size
    m, h = 1 << s, 1 << (s - 1)
    groups = x.reshape(4, n // m, 2, h)
    w = tw[:, :: size // m][:, None, :]
    e = groups[:, :, 0, :]
    t = ft.mont_mul(groups[:, :, 1, :], w)
    return torch.stack([ft.add(e, t), ft.sub(e, t)], dim=2).reshape(4, n)


def ntt_block_plain(x: torch.Tensor, tw: torch.Tensor, log_block: int,
                    scale: int | None = None) -> torch.Tensor:
    """Plain version of ntt_block: bit-reversed gather, the optional scale,
    then DIT stages 1..log_block."""
    x = x.index_select(1, _bit_reverse_indices(_log2(x.shape[1]), x.device))
    if scale is not None:
        x = ft.mont_mul(x, scale)
    for s in range(1, log_block + 1):
        x = ntt_stage_plain(x, tw, s)
    return x


def ntt_grouped_plain(x: torch.Tensor, tw: torch.Tensor, group: int,
                      scale: int | None = None) -> torch.Tensor:
    """Plain version of ntt_grouped: bit-reverse inside every run of `group`
    elements, the optional scale, then DIT stages 1..log2(group) over the
    whole batch (a stage of m <= group never crosses a run)."""
    n = x.shape[1]
    log_group = _log2(group)
    rev = _bit_reverse_indices(log_group, x.device)
    x = x.reshape(4, n // group, group).index_select(2, rev).reshape(4, n)
    if scale is not None:
        x = ft.mont_mul(x, scale)
    for s in range(1, log_group + 1):
        x = ntt_stage_plain(x, tw, s, size=group)
    return x


def ntt_grouped(x: torch.Tensor, tw: torch.Tensor, group: int,
                scale: int | None = None) -> torch.Tensor:
    """x.shape[1] / group independent size-`group` transforms (each aligned
    run of `group` elements, natural order in and out), times `scale`;
    returns a new tensor. tw: the (4, group/2) master table of size group."""
    _build.check_planes(x, 4, "ntt_grouped.x")
    _build.check_planes(tw, 4, "ntt_grouped.tw")
    log_group = _log2(group)
    if not 1 <= log_group <= LOG_GROUP_MAX:
        raise ValueError(f"group must be a power of two in [2, {1 << LOG_GROUP_MAX}], got {group}")
    n = x.shape[1]
    if n % group or tw.shape[1] != group // 2 or tw.device != x.device:
        raise ValueError("need a whole number of groups and a (4, group/2) twiddle table "
                         "on the input's device")
    if x.device.type != "cuda":
        return ntt_grouped_plain(x, tw, group, scale)
    out = torch.empty((4, n), dtype=torch.int32, device=x.device)
    c = int_to_words(scale if scale is not None else 0)
    with torch.cuda.device(x.device):
        _build.launch(
            "ntt_grouped", x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
            tw.data_ptr(), tw.stride(0), n, log_group, int(scale is not None),
            c[0], c[1], c[2], c[3],
        )
    return out


def _check_transform_args(x: torch.Tensor, tw: torch.Tensor) -> int:
    _build.check_planes(x, 4, "ntt.x")
    _build.check_planes(tw, 4, "ntt.tw")
    n = x.shape[1]
    log_n = _log2(n)
    if n < 2 or tw.shape[1] != n // 2 or tw.device != x.device:
        raise ValueError("need n >= 2 and a (4, n/2) twiddle table on the input's device")
    return log_n


def ntt_block(x: torch.Tensor, tw: torch.Tensor, log_block: int,
              scale: int | None = None) -> torch.Tensor:
    """Stages 1..log_block of the transform of x (natural-order input, read
    bit-reversed), times `scale`; returns a new tensor."""
    log_n = _check_transform_args(x, tw)
    if not 1 <= log_block <= min(LOG_BLOCK_MAX, log_n):
        raise ValueError(f"log_block must be in [1, {min(LOG_BLOCK_MAX, log_n)}]")
    if x.device.type != "cuda":
        return ntt_block_plain(x, tw, log_block, scale)
    out = torch.empty((4, x.shape[1]), dtype=torch.int32, device=x.device)
    c = int_to_words(scale if scale is not None else 0)
    with torch.cuda.device(x.device):
        _build.launch(
            "ntt_block", x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
            tw.data_ptr(), tw.stride(0), log_n, log_block, int(scale is not None),
            c[0], c[1], c[2], c[3],
        )
    return out


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Radix-2 stage s (m = 2^s) of x, IN PLACE; returns x."""
    log_n = _check_transform_args(x, tw)
    if not 1 <= s <= log_n:
        raise ValueError(f"stage must be in [1, {log_n}]")
    if x.device.type != "cuda":
        return x.copy_(ntt_stage_plain(x, tw, s))
    with torch.cuda.device(x.device):
        _build.launch("ntt_stage", x.data_ptr(), x.stride(0), tw.data_ptr(), tw.stride(0), log_n, s)
    return x


def transform(x: torch.Tensor, tw: torch.Tensor, scale: int | None = None) -> torch.Tensor:
    """Natural-order NTT of (4, n) planes with master twiddles tw (4, n/2)."""
    _build.check_planes(x, 4, "ntt.x")
    if x.shape[1] == 1:
        return x if scale is None else fk.mont_mul(x, scale)
    log_n = _check_transform_args(x, tw)
    if x.device.type != "cuda":
        return transform_plain(x, tw, scale)
    log_block = min(LOG_BLOCK_MAX, log_n)
    out = ntt_block(x, tw, log_block, scale)
    for s in range(log_block + 1, log_n + 1):
        ntt_stage(out, tw, s)
    return out
