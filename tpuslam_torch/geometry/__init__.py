"""Geometry core: SE(3), Pluecker lines, the pinhole camera (torch)."""

from tpuslam_torch.geometry.camera import (  # noqa: F401
    Intrinsics,
    line_projection_matrix,
    project_points,
)
from tpuslam_torch.geometry.plucker import (  # noqa: F401
    plucker_from_points,
    plucker_normalize,
    plucker_retract,
    plucker_transform,
)
from tpuslam_torch.geometry.se3 import (  # noqa: F401
    se3_apply,
    se3_exp,
    se3_inverse,
    se3_orthonormalize,
    se3_retract,
    so3_exp,
    so3_hat,
)
