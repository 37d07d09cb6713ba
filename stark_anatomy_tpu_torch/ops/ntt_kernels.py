"""Radix-2 NTT cores: the CUDA kernels of csrc/ntt.cu and their plain version.

Counterpart of the JAX package's ops/ntt_pallas.py (``_run_early`` :140 with
``_early_kernel_factory`` :95, ``_run_late_stage`` :166 with ``_late_kernel``
:128, ``grouped_ntt_with_tables`` :242). ``transform(x, tw, scale)`` maps
``(4, n)`` Montgomery-form coefficients in natural order to evaluations in
natural order, given the master twiddle table ``tw`` = ``[w^0 .. w^(n/2-1)]``
as ``(4, n/2)`` planes; ``scale`` (a raw Montgomery constant or None) is
multiplied into every element, which is how the inverse transform gets its
1/n.

For a CUDA tensor it launches the passes of ``pass_plan(log2 n)``: at most
three for n <= 2^24, two for n <= 2^20, one where the transform fits a block.
``ntt_block`` runs the first (bit-reversed gather, stages 1..k0, the scale),
``ntt_stage`` each of the others (stages s..last in ONE launch, in place), so
the codeword crosses device memory once per pass. A pass works in tiles of 2^k
rows by 2^t adjacent columns held in shared memory (``tile_cols``); every
global access is a run of 2^t (or, for ntt_block's store, 2^k) consecutive
elements of a word plane. The bound of a pass is its bytes, 32 B * n /
3.35e12 B/s (0.16 ms at n = 2^24); of the whole transform its operations,
84 * log2(n) * n/2 / 33.5e12 per s (0.505 ms at 2^24). csrc/ntt.cu's header
has the full reckoning, the twiddle choice included: inside a tile a twiddle
is the product of a row factor ``w_(2^k)^e``, e < 2^(k-1), and a power of a
column factor ``w_(2^last)^c``, c < 2^(s-1); both are entries of the master
table (``master_index``), which the kernels read where it lies: no second
table is built.

The kernels' index maps are mirrored here as small pure functions
(``block_source_index``, ``block_shared_index``, ``block_output_index``,
``stage_global_index``, ``quad_rows``, ``pair_rows``, ``row_twiddle_index``,
``column_twiddle_power``, ``master_index``), which the CPU tests drive the plain field
operations through: the only guard the index arithmetic gets off the card.

For a CPU tensor, and only then, ``transform`` runs ``transform_plain``: the
constant-geometry (self-sorting) form, one gather / product / add / sub per
stage in plain torch ops. Both give the unique canonical values of the
transform, so they agree bit for bit.

``ntt_block`` and ``ntt_stage`` are also callable on their own; each has its
plain version (``ntt_block_plain``; ``ntt_stages_plain``: ``ntt_stage_plain``
applied stage by stage) which a CPU tensor takes and which the kernel is compared with on the
card.

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

#: most stages ntt_block runs (a tile of 2^10 rows by 2^3 columns, padded,
#: and its row table are 152 KB of the 227 KB a block may take).
LOG_BLOCK_MAX = 10
#: most stages one ntt_stage launch runs (last - s + 1).
LOG_PASS_MAX = 10
#: log2 of the columns of a tile where there are that many: runs of 32 B (one
#: sector) per word plane. Wider tiles were no faster on the card and take
#: the shared memory that keeps six blocks of 2^8 rows on an SM.
LOG_COLS = 3
#: butterflies of one stage that a thread runs (log2), within 2^7..2^10
#: threads a block: four quads of a two-stage step, which share their
#: twiddles in all but the last step of a pass.
LOG_PAIRS_PER_THREAD = 3
#: log2 of the largest group ntt_grouped transforms (as the TPU kernel: 128).
LOG_GROUP_MAX = 7
#: most butterflies ntt_stage_plain computes at a time: its int64 field
#: temporaries take ~200 B a butterfly, ~3 GiB a piece.
PLAIN_PIECE = 1 << 24


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
    `size` (default: all of x) is the transform length tw belongs to. At
    most PLAIN_PIECE butterflies at a time, so the int64 temporaries stay a
    few GiB at any n."""
    n = x.shape[1]
    size = n if size is None else size
    m, h = 1 << s, 1 << (s - 1)
    groups = x.reshape(4, n // m, 2, h)
    w = tw[:, :: size // m][:, None, :]
    out = torch.empty_like(groups)
    step_g, step_h = max(1, PLAIN_PIECE // h), min(h, PLAIN_PIECE)
    for g0 in range(0, n // m, step_g):
        for h0 in range(0, h, step_h):
            gs, hs = slice(g0, g0 + step_g), slice(h0, h0 + step_h)
            e = groups[:, gs, 0, hs]
            t = ft.mont_mul(groups[:, gs, 1, hs], w[:, :, hs])
            out[:, gs, 0, hs] = ft.add(e, t)
            out[:, gs, 1, hs] = ft.sub(e, t)
    return out.reshape(4, n)


def ntt_stages_plain(x: torch.Tensor, tw: torch.Tensor, s: int, last: int) -> torch.Tensor:
    """Plain version of a multi-stage ntt_stage: stages s..last, one by one."""
    for stage in range(s, last + 1):
        x = ntt_stage_plain(x, tw, stage)
    return x


def ntt_block_plain(x: torch.Tensor, tw: torch.Tensor, log_block: int,
                    scale: int | None = None) -> torch.Tensor:
    """Plain version of ntt_block: bit-reversed gather, the optional scale,
    then DIT stages 1..log_block."""
    x = x.index_select(1, _bit_reverse_indices(_log2(x.shape[1]), x.device))
    if scale is not None:
        x = ft.mont_mul(x, scale)
    return ntt_stages_plain(x, tw, 1, log_block)


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


# -- the passes and the kernels' index maps (pure Python, no torch) -----------


def pass_plan(log_n: int) -> list:
    """The passes [(first stage, last stage), ...] of a 2^log_n-point
    transform: contiguous, covering 1..log_n, as few as the limits allow
    (one up to 2^10, two up to 2^20, three up to 2^30) and as even as can be,
    the longer ones first. ntt_block runs the first, ntt_stage the others."""
    if not 1 <= log_n <= 31:
        raise ValueError(f"log_n must be in [1, 31], got {log_n}")
    count = -(-log_n // min(LOG_BLOCK_MAX, LOG_PASS_MAX))
    plan, first = [], 1
    for p in range(count):
        k = log_n // count + (1 if p < log_n % count else 0)
        plan.append((first, first + k - 1))
        first += k
    return plan


def tile_cols(limit: int) -> int:
    """log2 of the columns of a tile, at most `limit` (what the pass allows)."""
    return min(limit, LOG_COLS)


def tile_threads(k: int, t: int) -> int:
    """log2 of the threads of a block that runs a tile of 2^k rows by 2^t
    columns (the launcher takes fewer where the tile has fewer pairs)."""
    return min(10, max(7, k - 1 + t - LOG_PAIRS_PER_THREAD))


def bit_reverse(v, bits: int):
    """The low `bits` bits of v (an int or an integer array) reversed."""
    out = v * 0
    for b in range(bits):
        out = out | (((v >> b) & 1) << (bits - 1 - b))
    return out


def block_source_index(log_n: int, k: int, t: int, tile, r, c):
    """ntt_block: where element (row r, column c) of `tile` is read."""
    return (r << (log_n - k)) + (tile << t) + c


def block_shared_index(k: int, t: int, r, c):
    """ntt_block: where it is kept: row brev_k(r) of rows padded to 2^t | 1."""
    return bit_reverse(r, k) * ((1 << t) | 1) + c


def block_output_index(log_n: int, k: int, t: int, tile, row, c):
    """ntt_block: where (row, column c) of `tile` is written."""
    return (bit_reverse((tile << t) + c, log_n - k) << k) + row


def stage_global_index(s0: int, k: int, t: int, tile, i, c):
    """ntt_stage over stages s0+1..s0+k: where (row i, column c) of `tile`
    lives, read and written; its shared index is i * 2^t + c."""
    c0 = (tile & ((1 << (s0 - t)) - 1)) << t
    return ((tile >> (s0 - t)) << (s0 + k)) + (i << s0) + c0 + c


def pair_rows(u: int, rp):
    """Stage u of a tile, row pair rp: (low row, high row, i')."""
    h = 1 << (u - 1)
    ip = rp & (h - 1)
    row = ((rp >> (u - 1)) << u) | ip
    return row, row + h, ip


def quad_rows(u: int, rq):
    """Stages u and u+1 of a tile in one step, row quad rq: (the four rows
    row + {0, h, 2h, 3h}, h = 2^(u-1); i'). Stage u pairs rows (0, 1) and
    (2, 3) of the quad with the twiddle of i'; stage u+1 pairs (0, 2) with
    that of i' and (1, 3) with that of i' + h."""
    h = 1 << (u - 1)
    ip = rq & (h - 1)
    row = ((rq >> (u - 1)) << (u + 1)) | ip
    return (row, row + h, row + 2 * h, row + 3 * h), ip


def row_twiddle_index(k: int, u: int, ip):
    """Entry of the row table [w_(2^k)^e] that is w_(2^u)^i'."""
    return ip << (k - u)


def master_index(log_n: int, log_m: int, e):
    """Entry of the master table [w_(2^log_n)^j : j < 2^(log_n-1)] that is
    w_(2^log_m)^e, e < 2^(log_m-1): a tile's row factors (log_m = k) and its
    column factors (log_m = the pass's last stage)."""
    return e << (log_n - log_m)


def column_twiddle_power(k: int, u: int) -> int:
    """The power of the column table's entry w_(2^(s0+k))^c that is stage
    s0+u's column factor w_(2^(s0+u))^c: the kernel squares k - u times."""
    return 1 << (k - u)


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
    t = tile_cols(log_n - log_block)
    out = torch.empty((4, x.shape[1]), dtype=torch.int32, device=x.device)
    c = int_to_words(scale if scale is not None else 0)
    with torch.cuda.device(x.device):
        _build.launch(
            "ntt_block", x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
            tw.data_ptr(), tw.stride(0), log_n, log_block, t, tile_threads(log_block, t),
            int(scale is not None), c[0], c[1], c[2], c[3],
        )
    return out


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, s: int, last: int | None = None) -> torch.Tensor:
    """Radix-2 stages s..last (default: s alone; m = 2^s .. 2^last) of x in
    ONE launch, IN PLACE; returns x. At most LOG_PASS_MAX stages."""
    log_n = _check_transform_args(x, tw)
    last = s if last is None else last
    if not 1 <= s <= last <= log_n or last - s + 1 > LOG_PASS_MAX:
        raise ValueError(f"stages must satisfy 1 <= s <= last <= {log_n} and span at most "
                         f"{LOG_PASS_MAX}, got {s}..{last}")
    if x.device.type != "cuda":
        return x.copy_(ntt_stages_plain(x, tw, s, last))
    k = last - s + 1
    t = tile_cols(s - 1)
    with torch.cuda.device(x.device):
        _build.launch("ntt_stage", x.data_ptr(), x.stride(0), tw.data_ptr(), tw.stride(0),
                      log_n, s, last, t, tile_threads(k, t))
    return x


def transform(x: torch.Tensor, tw: torch.Tensor, scale: int | None = None) -> torch.Tensor:
    """Natural-order NTT of (4, n) planes with master twiddles tw (4, n/2)."""
    _build.check_planes(x, 4, "ntt.x")
    if x.shape[1] == 1:
        return x if scale is None else fk.mont_mul(x, scale)
    log_n = _check_transform_args(x, tw)
    if x.device.type != "cuda":
        return transform_plain(x, tw, scale)
    plan = pass_plan(log_n)
    out = ntt_block(x, tw, plan[0][1], scale)
    for s, last in plan[1:]:
        ntt_stage(out, tw, s, last)
    return out
