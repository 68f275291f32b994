from .mesh import (DataMesh, all_gather_rays, all_reduce_mean, make_mesh,
                   replica_spread, replicate, shard_batch_tree, shard_rays)
