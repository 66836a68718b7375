"""Data parallelism and spatial sharding across processes (the JAX
package's `ganslate_tpu/parallel/`)."""

from ganslate_tpu_torch.parallel.mesh import (all_gather_batch, all_reduce_sum,
                                              average_gradients, batch_spans_ranks,
                                              broadcast_module, broadcast_spatial,
                                              check_local_batch, global_batch, leaf_is_sharded,
                                              spatial_slab)

__all__ = ["all_gather_batch", "all_reduce_sum", "average_gradients", "batch_spans_ranks",
           "broadcast_module", "broadcast_spatial", "check_local_batch", "global_batch",
           "leaf_is_sharded", "spatial_slab"]
