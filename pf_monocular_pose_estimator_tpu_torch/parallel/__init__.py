from .comm import DistMesh, LocalMesh, shard_lanes, unshard_lanes
from .gather_kernel import ring_gather
from .mesh import (
    make_mesh,
    make_sharded_multi_tracker,
    make_sharded_tracker,
    shard_target_state,
    unshard_target_state,
)
from .resample import DistResampleOut, make_distributed_resampler

__all__ = ["DistMesh", "DistResampleOut", "LocalMesh", "make_distributed_resampler", "make_mesh",
           "make_sharded_multi_tracker", "make_sharded_tracker", "ring_gather", "shard_lanes",
           "shard_target_state", "unshard_lanes", "unshard_target_state"]
