from .sharding import (MeshAxes, PartitionSpec, cache_specs, data_spec, distribute_tree,
                       param_specs, placements)
from .collectives import CompressionState, cross_pod_grad_reduce, init_compression

__all__ = ["MeshAxes", "PartitionSpec", "cache_specs", "data_spec", "distribute_tree",
           "param_specs", "placements", "CompressionState", "cross_pod_grad_reduce",
           "init_compression"]
