"""The multi-device layer of the port over ``torch.distributed``, one
process per shard: the sharded block map (``block_sharded``), its map
axis (``collectives``) and the world launcher (``launch``).  The rest of
the JAX package's ``parallel/`` (the sharded SLAM system, distributed
bundle adjustment, the multi-host helpers, the sharded dense pipeline and
the stream pipeline) is not ported yet."""

from ..models.host_cache import ShardedHostCache
from .block_sharded import ShardedBlockPipeline, dryrun_sharded_block_step
from .collectives import MapAxis, make_mesh
from .launch import spawn_world

__all__ = [
    "MapAxis",
    "make_mesh",
    "spawn_world",
    "ShardedBlockPipeline",
    "ShardedHostCache",
    "dryrun_sharded_block_step",
]
