"""topfusion_tpu_torch — the PyTorch/CUDA port of ``topfusion_tpu``.

A second package beside the JAX one, which stays the reference.  It
imports torch and never jax, and nothing from ``topfusion_tpu``.  Ported
so far: the voxel-hashed fusion step (``models.block_pipeline.
BlockPipeline``) with its one hand-written CUDA kernel, the fused TSDF
integrate (``csrc/integrate.cu``, wrapped by ``ops.cuda.integrate``);
RGB fusion (``step_rgb``); the display (``render``, ``render_normals``,
``render_confidence``, ``render_color`` over the hashed-map raycast);
point-cloud export (``ops.pointcloud``); the dense-volume pipeline
(``models.pipeline.DensePipeline`` over ``ops.tsdf_dense``); the
out-of-core block swap (``ops.swap``, ``models.host_cache.HostBlockCache``);
the keyframe pose graph with loop closure (``models.posegraph``); the SLAM
system (``models.slam.SlamSystem``) with its checkpoints, config IO,
metrics and dataset loaders; ICP's onehot gather mode over the band
gather (``ops.gather_mm``); the app
(``python -m topfusion_tpu_torch.apps.run_fusion``) with its GIF outputs
(``io.gif``); and the sharded block map over ``torch.distributed``, one
process per shard (``parallel.ShardedBlockPipeline``, with
``ShardedHostCache`` for its out-of-core swap).
"""

from .config import (
    BlockMapConfig,
    CameraConfig,
    ICPConfig,
    PipelineConfig,
    PoseGraphConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from .models.block_pipeline import BlockPipeline
from .models.pipeline import DensePipeline
from .models.slam import SlamSystem
from .parallel import (
    ShardedBlockPipeline,
    ShardedHostCache,
    dryrun_sharded_block_step,
    make_mesh,
)

__version__ = "0.1.0"

__all__ = [
    "CameraConfig",
    "ICPConfig",
    "PreprocConfig",
    "TSDFConfig",
    "BlockMapConfig",
    "RaycastConfig",
    "PipelineConfig",
    "PoseGraphConfig",
    "DensePipeline",
    "BlockPipeline",
    "SlamSystem",
    "ShardedBlockPipeline",
    "ShardedHostCache",
    "make_mesh",
    "dryrun_sharded_block_step",
]
