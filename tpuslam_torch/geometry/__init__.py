"""Geometry core: SE(3), Pluecker lines, the pinhole camera and its radtan distortion (torch)."""

from tpuslam_torch.geometry.camera import (  # noqa: F401
    Distortion,
    Intrinsics,
    backproject_pixels,
    distort_pixels,
    image_line_through,
    line_projection_matrix,
    project_plucker_line,
    project_points,
    undistort_pixels,
)
from tpuslam_torch.geometry.plucker import (  # noqa: F401
    orthonormal_to_plucker,
    plucker_closest_point,
    plucker_distance_to_origin,
    plucker_from_points,
    plucker_normalize,
    plucker_point_at,
    plucker_retract,
    plucker_to_orthonormal,
    plucker_transform,
)
from tpuslam_torch.geometry.se3 import (  # noqa: F401
    se3_apply,
    se3_compose,
    se3_exp,
    se3_identity,
    se3_inverse,
    se3_log,
    se3_orthonormalize,
    se3_retract,
    so3_exp,
    so3_hat,
    so3_log,
    so3_vee,
)
from tpuslam_torch.geometry.triangulate import (  # noqa: F401
    plane_from_image_line,
    stereo_depth_from_disparity,
    triangulate_plucker_two_view,
    triangulate_points,
)
