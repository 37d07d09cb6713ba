"""Prover phase checkpoint/resume (numpy and the standard library only).

The prover is deterministic given (trace, boundary, randomizer_seed), so a
checkpoint only needs the expensive intermediates at a phase boundary:

- stage "pre-fri": the Fiat-Shamir transcript so far, the combination
  codeword (Montgomery form), and the standard-form boundary-quotient and
  zk-randomizer codewords (their Merkle trees are re-committed from them on
  resume: hashing is cheap next to the LDE and quotient arithmetic skipped);
- stage "fri-r{r}": the standard-form codeword FRI committed in round r
  (iop/fri.py).

Format: one .npz (``(4, n) uint32`` word planes, ops/limbs.py) + one .json
(transcript + metadata) per stage, under the JAX package's file names. The
metadata carries ``"layout": "u32x4"``, which that package's metadata never
has: it refuses such a snapshot and recomputes instead of misreading the
arrays as 16-bit digits (and this package refuses one of its snapshots the
same way; reference.py converts the arrays). Resume validates the metadata
and refuses mismatches. Wired into Stark.prove(checkpoint_dir=...).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

STAGE_PRE_FRI = "pre-fri"
#: layout tag of every snapshot this package writes.
LAYOUT = "u32x4"


def _paths(directory: str, stage: str):
    return (
        os.path.join(directory, f"stark-{stage}.npz"),
        os.path.join(directory, f"stark-{stage}.json"),
    )


def save(directory: str, stage: str, items: list, arrays: Dict[str, np.ndarray],
         meta: Dict) -> None:
    """Atomically persist a phase checkpoint."""
    os.makedirs(directory, exist_ok=True)
    npz_path, json_path = _paths(directory, stage)
    tmp = npz_path + ".tmp.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, npz_path)
    tmp = json_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"stage": stage, "meta": meta, "items": items}, fh)
    os.replace(tmp, json_path)


def load(directory: str, stage: str, expect_meta: Dict) -> Optional[Dict]:
    """Load a checkpoint if present AND its metadata matches, else None."""
    npz_path, json_path = _paths(directory, stage)
    if not (os.path.exists(npz_path) and os.path.exists(json_path)):
        return None
    try:
        with open(json_path) as fh:
            doc = json.load(fh)
        if doc.get("stage") != stage or doc.get("meta") != expect_meta:
            return None
        arrays = dict(np.load(npz_path))
        return {"items": doc["items"], "arrays": arrays}
    except (OSError, ValueError, KeyError):
        return None


def clear(directory: str, stage: str) -> None:
    for p in _paths(directory, stage):
        try:
            os.remove(p)
        except OSError:
            pass
