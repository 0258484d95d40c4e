from .se3 import (
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
    se3_inverse,
    transform_points,
    rotate_vectors,
)
from .camera import (
    intrinsics_matrix,
    project,
    backproject,
    backproject_grid,
)

__all__ = [
    "se3_exp",
    "se3_log",
    "so3_exp",
    "so3_log",
    "se3_inverse",
    "transform_points",
    "rotate_vectors",
    "intrinsics_matrix",
    "project",
    "backproject",
    "backproject_grid",
]
