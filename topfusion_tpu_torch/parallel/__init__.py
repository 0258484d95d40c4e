"""The multi-device layer of the port over ``torch.distributed``, one
process per shard: the sharded block map (``block_sharded``), the sharded
dense pipeline (``sharded_pipeline``), the sharded SLAM system
(``sharded_slam``) with distributed bundle adjustment (``dist_ba``), the
multi-process runtime (``multihost``), the map axis (``collectives``) and
the world launcher (``launch``).  The JAX package's stream pipeline
(``stream_pipeline.py``) is not ported yet."""

from ..models.host_cache import ShardedHostCache
from .block_sharded import ShardedBlockPipeline, dryrun_sharded_block_step
from .collectives import MapAxis, make_mesh
from .dist_ba import optimize_distributed
from .launch import spawn_world
from .multihost import initialize_multihost, measure_scaling
from .sharded_pipeline import dryrun_sharded_step, make_sharded_pipeline
from .sharded_slam import ShardedSlamSystem

__all__ = [
    "make_mesh",
    "make_sharded_pipeline",
    "dryrun_sharded_step",
    "ShardedBlockPipeline",
    "ShardedSlamSystem",
    "optimize_distributed",
    "initialize_multihost",
    "measure_scaling",
    "MapAxis",
    "spawn_world",
    "ShardedHostCache",
    "dryrun_sharded_block_step",
]
