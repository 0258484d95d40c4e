"""The bench configuration: the JAX package's ``bench.py:make_cfg``, the
one configuration that ``chip_smoke.py`` and the tools drive."""

from __future__ import annotations

import dataclasses

from ..config import (
    BlockMapConfig,
    CameraConfig,
    ICPConfig,
    PipelineConfig,
    RaycastConfig,
    TSDFConfig,
)


def bench_config(pool_dtype: str = "int16") -> PipelineConfig:
    """640x480 at the reference intrinsics, 5 mm voxels, mu = 2 cm, 2^16
    blocks, 4096 visible blocks, occlusion-culled aged visible sets,
    splat K = 80, ICP (10, 5, 4) with bilinear polish, the integrate
    kernel."""
    return PipelineConfig(
        camera=CameraConfig(),
        icp=ICPConfig(iters=(10, 5, 4)),
        tsdf=TSDFConfig(voxel_size=0.005, trunc_dist=0.02),
        blockmap=BlockMapConfig(
            max_visible_blocks=1 << 12,
            pool_dtype=pool_dtype,
            use_pallas_integrate=True,
            visible_occlusion_cull=True,
        ),
        raycast=RaycastConfig(max_steps=192, surfels_per_block=80),
    )


def with_plain_integrate(cfg: PipelineConfig) -> PipelineConfig:
    """``cfg`` with the plain PyTorch integrate in place of the kernel."""
    return dataclasses.replace(
        cfg, blockmap=dataclasses.replace(cfg.blockmap, use_pallas_integrate=False)
    )
