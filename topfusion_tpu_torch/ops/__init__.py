from .depth import (
    depth_to_meters,
    bilateral_filter,
    truncate_depth,
    downsample_depth,
    build_depth_pyramid,
)
from .normals import (
    compute_points_normals,
    resize_points_normals,
)
from .rendering import (
    phong_shade,
    render_normals_rgb,
)

__all__ = [
    "depth_to_meters",
    "bilateral_filter",
    "truncate_depth",
    "downsample_depth",
    "build_depth_pyramid",
    "compute_points_normals",
    "resize_points_normals",
    "phong_shade",
    "render_normals_rgb",
]
