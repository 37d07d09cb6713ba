"""stark_anatomy_tpu_torch: the PyTorch/CUDA port of stark_anatomy_tpu.

A STARK prover/verifier over F_p, p = 1 + 407 * 2^119, with the hot loops
(field arithmetic, NTT, Blake2b) as hand-written CUDA kernels for sm_90a
(csrc/) and a plain PyTorch version of each beside its wrapper.

Layout mirrors the JAX package so a reader finds each counterpart:
ops/ (field, limbs, NTT, Blake2b), iop/ (transcript, Merkle, FRI, STARK),
models/ (AIRs), native/ (host C++ helpers), utils/. The command-line prover
is ``python3 -m stark_anatomy_tpu_torch.prove_rescue``.

Entry points take an explicit ``device`` and default to ``"cuda"``; they
raise when no card is present rather than run on the CPU. Importing this
package imports torch and numpy only, and builds nothing: kernels are
compiled at first launch (ops/_build.py).
"""

__version__ = "0.1.0"

from stark_anatomy_tpu_torch.ops.field import PRIME, FieldElement  # noqa: F401


def clear_table_caches() -> None:
    """Release every module-level twiddle/domain table cache.

    Cache policy: precomputed tables (NTT twiddles, and the mesh's stage and
    block tables that parallel/ntt_sharded.py caches through
    ``ops.ntt.cached_table``) are cached per distinct (size, direction,
    device) key for the life of the process: the right trade for a prover
    that hammers a handful of domain sizes. A long-lived service proving MANY
    distinct sizes should call this between size regimes to drop the
    accumulated device tensors (a 2^24-point domain's two twiddle tables
    hold 256 MiB; tables are rebuilt on demand in milliseconds).
    """
    from stark_anatomy_tpu_torch.ops import ntt as _ntt

    _ntt.clear_twiddle_cache()
