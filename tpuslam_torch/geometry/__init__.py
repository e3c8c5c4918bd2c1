"""Geometry core: SE(3), Pluecker lines, the pinhole camera and its radtan distortion (torch)."""

from tpuslam_torch.geometry.camera import (  # noqa: F401
    Distortion,
    Intrinsics,
    distort_pixels,
    line_projection_matrix,
    project_points,
    undistort_pixels,
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
    se3_log,
    se3_orthonormalize,
    se3_retract,
    so3_exp,
    so3_hat,
    so3_log,
)
