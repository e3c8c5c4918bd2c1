"""Trajectory evaluation (numpy)."""

from tpuslam_torch.eval.ate import absolute_trajectory_error, align_umeyama
from tpuslam_torch.eval.rpe import relative_pose_error

__all__ = ["absolute_trajectory_error", "align_umeyama", "relative_pose_error"]
