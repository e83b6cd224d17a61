"""Data parallelism over ``torch.distributed`` ranks and the temporal halo
exchange (the JAX package's ``parallel/``)."""

from .mesh import pad_batch_for_mesh, pad_to_multiple
from .multihost import (all_gather_rows, host_batch_indices, initialize_distributed,
                        process_count, process_index)
from .temporal import conv3d_temporal_sharded, halo_exchange_t

__all__ = ["all_gather_rows", "conv3d_temporal_sharded", "halo_exchange_t",
           "host_batch_indices", "initialize_distributed", "pad_batch_for_mesh",
           "pad_to_multiple", "process_count", "process_index"]
