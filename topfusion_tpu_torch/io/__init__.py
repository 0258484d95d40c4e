from .synthetic import SyntheticScene, orbit_trajectory
from .trajectory import (
    ate_rmse,
    align_umeyama,
    save_tum_trajectory,
    load_tum_trajectory,
)

__all__ = [
    "SyntheticScene",
    "orbit_trajectory",
    "ate_rmse",
    "align_umeyama",
    "save_tum_trajectory",
    "load_tum_trajectory",
]
