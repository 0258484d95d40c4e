"""topfusion_tpu_torch — the PyTorch/CUDA port of ``topfusion_tpu``.

A second package beside the JAX one, which stays the reference.  It
imports torch and never jax, and nothing from ``topfusion_tpu``.  The
ported slice is the voxel-hashed fusion step (``models.block_pipeline.
BlockPipeline``) with its one hand-written CUDA kernel, the fused TSDF
integrate (``csrc/integrate.cu``, wrapped by ``ops.cuda.integrate``).
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
    "BlockPipeline",
]
