"""Sharding the prover's transforms and commits over a mesh of shards, in
one process or across the processes of a ``torch.distributed`` group."""

from stark_anatomy_tpu_torch.parallel import distributed
from stark_anatomy_tpu_torch.parallel.merkle_sharded import commit_sharded
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, gather, host_gather, make_mesh, shard
from stark_anatomy_tpu_torch.parallel.ntt_sharded import (
    CYCLIC,
    NATURAL,
    sharded_coset_evaluate,
    sharded_lde,
    sharded_ntt,
)

__all__ = [
    "CYCLIC", "NATURAL", "Mesh", "commit_sharded", "distributed", "gather", "host_gather", "make_mesh", "shard",
    "sharded_coset_evaluate", "sharded_lde", "sharded_ntt",
]
