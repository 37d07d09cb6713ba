"""NTT over a shard mesh: the four-step algorithm with all-to-all exchanges.

Counterpart of the JAX package's parallel/ntt_sharded.py. Global size-n
transform over S shards, n = S * n2. Three layout-typed variants, each TWO
exchanges of the codeword (the least for a factorised transform whose both
factors need remote points):

natural -> cyclic  (i = i1*n2 + i2 contiguous in; X[k1 + S*k2] at shard k1,
                    slot k2 out):
  1. exchange #1: shard d gets ALL rows i1 for its block of i2: the size-S
     column transforms become local;
  2. size-S column transforms, then the cross twiddles w^(i2*k1);
  3. exchange #2: regroup by k1;
  4. size-n2 row transform: slot k2 = X[k1 + S*k2]: CYCLIC output.

cyclic -> natural  (x[i1 + S*i2] at shard i1 in; X contiguous out):
  1. size-n2 row transform over i2;
  2. cross twiddles w^(i1*k2) (each shard its row of the table);
  3. exchange #1: gather all i1 for each block of k2;
  4. size-S column transforms over i1 -> k1;
  5. exchange #2: scatter k1 -> natural contiguous output.

natural -> natural: natural -> cyclic plus ONE reorder exchange.

The LDE chain iNTT(natural evaluations) -> coefficients -> coset NTT
(-> natural evaluations) costs FOUR exchanges, not six: the iNTT leaves
cyclic coefficients, the offset scale and the zero pad are local in cyclic
layout, and the forward NTT takes cyclic directly.

Every function takes this process's part of the codeword: the ``(4, n/W)``
tensor of its S/W shards (parallel/mesh.py), which in one process is the
whole ``(4, n)`` tensor. Inside, the local shards are dim 1 of a
``(4, S/W, ...)`` tensor. The column transforms are ONE ``grouped_ntt``
call (ops/ntt.py: the ``ntt_grouped`` kernel on a CUDA tensor) for
2 <= S <= 128, whose groups end at 128; for S > 128 every size-S column
goes through ``ntt_kernels.transform`` (``ntt_block`` and its
``ntt_stage`` passes), n/(S*W) transforms a process: slow, and taken only
on meshes that wide. The route is chosen by S alone. The row transforms are
``ntt_kernels.transform``, one call per local shard in a loop (the kernels
take one transform length per launch), joined with one ``stack``. The
cross-twiddle product is ``fk.mont_mul``. Every table is this process's
own entries alone: powers base^e at exponents computed on the device, each
the product of two entries of tables about sqrt(n) long
(``gathered_powers``), cached beside the twiddle tables
(``ntt.clear_twiddle_cache`` drops them). All paths give the bytes of
ops/ntt.py ``ntt`` / ``intt`` for every mesh (exact field math, canonical
representatives).
"""

from __future__ import annotations

import torch

from stark_anatomy_tpu_torch.ops import field_kernels as fk
from stark_anatomy_tpu_torch.ops import ntt as nttmod
from stark_anatomy_tpu_torch.ops import ntt_kernels
from stark_anatomy_tpu_torch.ops.field import PRIME, finv, primitive_root_of_unity
from stark_anatomy_tpu_torch.ops.limbs import mont
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, block_start, gather, shard

NATURAL = "natural"
CYCLIC = "cyclic"

#: the largest S whose column transforms are one grouped_ntt launch
GROUPED_MAX = 128


def _check_divisible(n: int, s: int) -> int:
    if not four_step_fits(n, s):
        raise ValueError(f"shard count {s} must divide n and n/S (n={n})")
    return n // s


def _arange(count: int, mesh: Mesh, first: int = 0) -> torch.Tensor:
    return torch.arange(first, first + count, dtype=torch.int64, device=mesh.device)


def _local_shard_ids(mesh: Mesh) -> torch.Tensor:
    return _arange(mesh.local_shards, mesh, first=mesh.rank * mesh.local_shards)


def four_step_fits(n: int, shards: int) -> bool:
    """True iff the four-step transform takes length n on `shards` shards
    (S | n and S | n/S)."""
    return n % shards == 0 and (n // shards) % shards == 0


def cyclic_indices(n: int, mesh: Mesh) -> torch.Tensor:
    """The global indices of a length-n array that this process holds in
    CYCLIC layout, in stored order: element d + S*j at local slot (d, j)
    for its shards d."""
    s = mesh.shards
    return (_local_shard_ids(mesh)[:, None] + s * _arange(n // s, mesh)).reshape(-1)


def gathered_powers(base: int, n: int, exponents: torch.Tensor) -> torch.Tensor:
    """(4, exponents.numel()) Montgomery powers base^e for exponents in
    [0, n): e = hi*B + lo with B about sqrt(n), base^e = base^lo * (base^B)^hi,
    two gathers from tables of B and n/B entries and one product. No table
    spans the domain; the values are those of ``ntt.powers(base, n)[e]``."""
    e = exponents.reshape(-1)
    log_b = (max(n, 2) - 1).bit_length() // 2
    b = 1 << log_b
    lo = nttmod.powers(base, b, e.device).index_select(1, e & (b - 1))
    hi = nttmod.powers(pow(base, b, PRIME), max(-(-n // b), 1), e.device).index_select(1, e >> log_b)
    return fk.mont_mul(lo, hi, out=lo)


def _cross_twiddles(n2: int, mesh: Mesh, inverse: bool) -> torch.Tensor:
    """(4, S/W * n2) table, flat over (local shard d, j, k1): w^(+-i2*k1) with
    i2 = d * n2/S + j, the block of i2 that shard d transforms (natural in)."""
    s = mesh.shards
    n = n2 * s

    def build() -> torch.Tensor:
        w = primitive_root_of_unity(n)
        i2 = _local_shard_ids(mesh)[:, None] * (n2 // s) + _arange(n2 // s, mesh)
        return gathered_powers(finv(w) if inverse else w, n, i2[:, :, None] * _arange(s, mesh))

    return nttmod.cached_table(
        ("cross", n, s, inverse, NATURAL, str(mesh.device), mesh.rank, mesh.world), build)


def _cross_twiddles_rows(n2: int, mesh: Mesh, inverse: bool) -> torch.Tensor:
    """(4, S/W * n2) table, flat over (local shard i1, k2): w^(+-i1*k2), each
    shard its own row (cyclic in)."""
    s = mesh.shards
    n = n2 * s

    def build() -> torch.Tensor:
        w = primitive_root_of_unity(n)
        return gathered_powers(finv(w) if inverse else w, n,
                                _local_shard_ids(mesh)[:, None] * _arange(n2, mesh))

    return nttmod.cached_table(
        ("cross", n, s, inverse, CYCLIC, str(mesh.device), mesh.rank, mesh.world), build)


def _cyclic_offset_table(offset: int, n: int, mesh: Mesh) -> torch.Tensor:
    """(4, n/W) Montgomery offset powers in CYCLIC stored order: local slot
    (i1, j) holds offset^(i1 + S*j), the table that multiplies a
    cyclic-layout coefficient array elementwise (the same value pairs as in
    natural layout, so the products are the same)."""
    return gathered_powers(offset, n, cyclic_indices(n, mesh))


def _col_transform(y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(4, L, S, c), dim 2 the transform index -> (4, L, c, S), dim 3 the
    output index: every column's size-S transform on the flat array whose
    aligned runs of S are the columns. S <= 128: all in one grouped_ntt
    call. S > 128: one ``transform`` a column (L*c = n/(S*W) of them), the
    1/S of the inverse folded in as grouped_ntt folds it."""
    _, local, s, c = y.shape
    flat = y.permute(0, 1, 3, 2).reshape(4, local * c * s)
    if s <= GROUPED_MAX:
        return nttmod.grouped_ntt(flat, s, inverse).reshape(4, local, c, s)
    tw = nttmod._twiddles(s, inverse, y.device)
    scale = mont(finv(s)) if inverse else None
    cols = [ntt_kernels.transform(flat[:, k * s : (k + 1) * s], tw, scale) for k in range(local * c)]
    return torch.stack(cols, dim=1).reshape(4, local, c, s)


def _row_transform(y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(4, L, n2): the size-n2 transform of every local shard's row."""
    n2 = y.shape[2]
    tw = nttmod._twiddles(n2, inverse, y.device)
    scale = mont(finv(n2)) if inverse else None
    return torch.stack(
        [ntt_kernels.transform(y[:, d], tw, scale) for d in range(y.shape[1])], dim=1)


def _body_nat_in(x: torch.Tensor, mesh: Mesh, inverse: bool, out_layout: str) -> torch.Tensor:
    """Natural input. x: (4, L, n2), L = S/W local shards."""
    s, local, n2 = mesh.shards, x.shape[1], x.shape[2]
    # 1. gather all i1 rows for each shard's i2 block: (4, L, i1, j).
    y = mesh.all_to_all(x.reshape(4, local, s, n2 // s), 2, 2)
    # 2. size-S column transforms + cross twiddles: (4, L, j, k1).
    y = _col_transform(y, inverse)
    y = fk.mont_mul(y.reshape(4, local * n2), _cross_twiddles(n2, mesh, inverse))
    # 3. regroup by k1: shard k1 collects all i2 in natural order.
    y = mesh.all_to_all(y.reshape(4, local, n2 // s, s), 3, 2)[..., 0]
    # 4. size-n2 row transform: slot k2 = X[k1 + S*k2]: CYCLIC output.
    y = _row_transform(y, inverse)
    if out_layout == CYCLIC:
        return y
    # 5. natural contiguous blocks: global k = k1 + S*k2, block e = k2 // (n2/S).
    z = mesh.all_to_all(y.reshape(4, local, s, n2 // s), 2, 2)
    # dim 2 = source k1, dim 3 = j; local position j*S + k1.
    return z.permute(0, 1, 3, 2).reshape(4, local, n2)


def _body_cyc_to_nat(x: torch.Tensor, mesh: Mesh, inverse: bool) -> torch.Tensor:
    """Cyclic input: slot j of shard i1 holds x[i1 + S*j]. x: (4, L, n2)."""
    s, local, n2 = mesh.shards, x.shape[1], x.shape[2]
    # 1. size-n2 row transform over i2: T[i1, k2].
    y = _row_transform(x, inverse)
    # 2. cross twiddle w^(i1*k2): each shard its row of the table.
    y = fk.mont_mul(y.reshape(4, local * n2), _cross_twiddles_rows(n2, mesh, inverse))
    # 3. gather all i1 for each k2 block: (4, L, i1, j).
    y = mesh.all_to_all(y.reshape(4, local, s, n2 // s), 2, 2)
    # 4. size-S transforms over i1 -> k1: (4, L, j, k1).
    y = _col_transform(y, inverse)
    # 5. scatter k1: shard k1 collects its outputs in k2 order (natural).
    return mesh.all_to_all(y, 3, 2)[..., 0]


def sharded_ntt(
    x_mont: torch.Tensor,
    mesh: Mesh,
    inverse: bool = False,
    layout_in: str = NATURAL,
    layout_out: str = NATURAL,
) -> torch.Tensor:
    """Size-n NTT / iNTT of a codeword sharded over `mesh`; x_mont is this
    process's (4, n/W) part, and so is the result.

    The same values as ops/ntt.py ntt / intt. layout_in / layout_out name
    the storage order of the domain axis: "natural" is contiguous blocks,
    "cyclic" stores element k1 + S*k2 at shard k1, slot k2 (stored index
    k1*n/S + k2). At most one end may be cyclic; natural -> natural costs
    one more exchange."""
    if {layout_in, layout_out} - {NATURAL, CYCLIC}:
        raise ValueError(f"unknown layout {layout_in!r} -> {layout_out!r}")
    s = mesh.shards
    if s == 1:
        return nttmod.intt(x_mont) if inverse else nttmod.ntt(x_mont)
    if layout_in == CYCLIC and layout_out != NATURAL:
        raise ValueError("cyclic->cyclic transforms are not defined")
    local = mesh.local_shards
    n2 = _check_divisible(x_mont.shape[-1] * mesh.world, s)
    x = x_mont.reshape(4, local, n2)
    if layout_in == NATURAL:
        y = _body_nat_in(x, mesh, inverse, layout_out)
    else:
        y = _body_cyc_to_nat(x, mesh, inverse)
    return y.reshape(4, local * n2)


def sharded_coset_evaluate(
    coeffs_mont: torch.Tensor,
    domain_len: int,
    offset: int,
    mesh: Mesh,
    layout_in: str = NATURAL,
) -> torch.Tensor:
    """Sharded counterpart of ops/ntt.py coset_evaluate (natural output).

    Scales the coefficients by the offset's powers, zero-pads to
    `domain_len` and runs the sharded NTT. With layout_in="cyclic" (what
    sharded_ntt(..., inverse=True, layout_out="cyclic") leaves) scale and
    pad are LOCAL: slot j of shard d is coefficient d + S*j, so zeros
    appended to each shard's block extend every residue class, and the
    transform takes cyclic directly. With natural input the pad moves block
    boundaries, so several processes gather the (shorter) coefficient array
    and each cuts its block of the padded one: the block-local prover
    (``Stark.prove`` under a mesh) takes the cyclic branch only."""
    n = coeffs_mont.shape[-1] * mesh.world
    if n > domain_len:
        raise ValueError("polynomial longer than the target domain")
    s, local = mesh.shards, mesh.local_shards
    if layout_in == CYCLIC:
        _check_divisible(n, s)
        _check_divisible(domain_len, s)
        scaled = fk.mont_mul(coeffs_mont, _cyclic_offset_table(offset, n, mesh))
        if n < domain_len:
            # pad per residue class: (4, L, n/S) -> (4, L, domain_len/S)
            padded = torch.zeros((4, local, domain_len // s), dtype=torch.int32,
                                 device=scaled.device)
            padded[:, :, : n // s] = scaled.reshape(4, local, n // s)
            scaled = padded.reshape(4, local * (domain_len // s))
        return sharded_ntt(scaled, mesh, layout_in=CYCLIC, layout_out=NATURAL)
    off = nttmod.powers(offset, n // mesh.world, coeffs_mont.device, start=block_start(n, mesh))
    scaled = gather(fk.mont_mul(coeffs_mont, off), mesh)
    if n < domain_len:
        padded = torch.zeros((4, domain_len), dtype=torch.int32, device=scaled.device)
        padded[:, :n] = scaled
        scaled = padded
    return sharded_ntt(shard(scaled, mesh), mesh)


def sharded_lde(evals_mont: torch.Tensor, domain_len: int, offset: int, mesh: Mesh) -> torch.Tensor:
    """Interpolate a natural-sharded evaluation column and evaluate it on the
    length-`domain_len` coset: the mesh LDE chain at FOUR exchanges (iNTT
    natural -> cyclic, local scale and pad, NTT cyclic -> natural)."""
    coeffs = sharded_ntt(evals_mont, mesh, inverse=True, layout_out=CYCLIC)
    return sharded_coset_evaluate(coeffs, domain_len, offset, mesh, layout_in=CYCLIC)
