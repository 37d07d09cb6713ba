"""State carried between this port and the JAX package (numpy only).

The two packages hold the same integers in different layouts: the JAX
package stores an element as 8 radix-2^16 digits in a ``(8, n) uint32``
array, this port as 4 little-endian 32-bit words in a ``(4, n) int32``
tensor (ops/limbs.py). Digests are ``(n, 16)`` uint32 rows there and
``(16, n)`` int32 planes here. The functions below take and return numpy
only, so a test can hand one numpy input to both packages. There are no
learned weights to carry: round constants and twiddles are derived on both
sides from the same integers. The only state either package writes to disk
is a prover snapshot (utils/checkpoint.py); ``snapshot_from_reference``
re-slices one written by the JAX package into this port's layout. A mesh
changes neither: ``natural_to_cyclic`` / ``cyclic_to_natural`` are the one
index map both packages' sharded transforms share, and
``merkle_levels_as_rows`` reads a tree of either package level by level.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_anatomy_tpu_torch.ops.limbs import require_device, to_numpy, to_tensor


def _limbs_to_words(limbs: np.ndarray) -> np.ndarray:
    limbs = np.asarray(limbs, dtype=np.uint32)
    if limbs.ndim != 2 or limbs.shape[0] != 8:
        raise ValueError("expected (8, n) digit limbs")
    return limbs[0::2] | (limbs[1::2] << np.uint32(16))


def from_reference_limbs(limbs: np.ndarray, device="cuda") -> torch.Tensor:
    """(8, n) uint32 16-bit digits -> (4, n) int32 word-plane tensor."""
    return to_tensor(_limbs_to_words(limbs), require_device(device))


def snapshot_from_reference(arrays: dict) -> dict:
    """The arrays of a snapshot the JAX package wrote (``comb``, ``bq{j}``,
    ``zk`` of stage "pre-fri", ``codeword`` of a stage "fri-r{r}"; each
    (8, n) uint32 digits) -> the same names as (4, n) uint32 word planes,
    ready for this port's ``utils.checkpoint.save``."""
    return {name: _limbs_to_words(limbs) for name, limbs in arrays.items()}


def to_reference_limbs(t: torch.Tensor) -> np.ndarray:
    """(4, n) int32 word-plane tensor -> (8, n) uint32 16-bit digits."""
    words = to_numpy(t)
    out = np.empty((8, words.shape[1]), dtype=np.uint32)
    out[0::2] = words & np.uint32(0xFFFF)
    out[1::2] = words >> np.uint32(16)
    return out


def from_reference_digests(rows: np.ndarray, device="cuda") -> torch.Tensor:
    """(n, 16) uint32 digest rows -> (16, n) int32 digest planes."""
    return to_tensor(np.ascontiguousarray(np.asarray(rows, dtype=np.uint32).T), require_device(device))


def to_reference_digests(planes: torch.Tensor) -> np.ndarray:
    """(16, n) int32 digest planes -> (n, 16) uint32 digest rows."""
    return np.ascontiguousarray(to_numpy(planes).T)


def natural_to_cyclic(arr: np.ndarray, shards: int) -> np.ndarray:
    """(k, n) array in natural order -> the cyclic layout of a mesh of
    `shards` shards (both packages'): stored index i1*(n/S) + j holds element
    i1 + S*j."""
    k, n = arr.shape
    return np.ascontiguousarray(np.transpose(arr.reshape(k, n // shards, shards), (0, 2, 1))).reshape(k, n)


def cyclic_to_natural(arr: np.ndarray, shards: int) -> np.ndarray:
    """The inverse of natural_to_cyclic."""
    k, n = arr.shape
    return np.ascontiguousarray(np.transpose(arr.reshape(k, shards, n // shards), (0, 2, 1))).reshape(k, n)


def merkle_levels_as_rows(tree) -> list:
    """Every level of a MerkleTree of either package as (m, 16) uint32 digest
    rows, leaves first: this port keeps device levels as (16, m) int32 plane
    tensors and host levels as rows; the JAX package keeps rows, or planes
    for the levels its ``plane_levels`` names."""
    planes = getattr(tree, "plane_levels", frozenset())
    out = []
    for i, level in enumerate(tree.levels):
        if isinstance(level, torch.Tensor):
            out.append(to_reference_digests(level))
        else:
            rows = np.asarray(level).astype(np.uint32)
            out.append(np.ascontiguousarray(rows.T if i in planes else rows))
    return out


def stark_from_reference(cfg: dict, device="cuda"):
    """A port Stark from plain ints: ``chain_length``, and optionally
    ``expansion_factor``, ``num_colinearity_checks``, ``grinding_bits``,
    ``num_randomizers`` (the JAX Stark's constructor arguments)."""
    from stark_anatomy_tpu_torch.iop.stark import Stark
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, RescuePrimeAir

    air = RescuePrimeAir(RescuePrime(), chain_length=int(cfg["chain_length"]))
    return Stark(
        air,
        expansion_factor=int(cfg.get("expansion_factor", 4)),
        num_colinearity_checks=int(cfg.get("num_colinearity_checks", 16)),
        num_randomizers=cfg.get("num_randomizers"),
        grinding_bits=int(cfg.get("grinding_bits", 0)),
        device=device,
    )
