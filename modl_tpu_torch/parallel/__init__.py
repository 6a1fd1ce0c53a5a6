"""SPMD data and feature parallelism of the SOMF fit over
``torch.distributed`` (counterpart of ``modl_tpu.parallel``)."""
from .mesh import (COLLECTIVES, Layout, config_for_mesh, make_mesh,
                   shard_batch, shard_batches, shard_indices, shard_state,
                   unshard, unshard_state)

__all__ = ["COLLECTIVES", "Layout", "config_for_mesh", "make_mesh",
           "shard_batch", "shard_batches", "shard_indices", "shard_state",
           "unshard", "unshard_state"]
