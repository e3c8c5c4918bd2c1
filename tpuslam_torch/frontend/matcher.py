"""Projection-guided matching against the map and the tracking stage (torch).

Counterpart of ``tpuslam.frontend.matcher``: project all landmarks, gate a
dense (landmarks x features) distance matrix by midpoint radius and angle,
match descriptors, then refine the pose with the line LM.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.backend.pose_opt import PoseOptConfig, pose_optimize
from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.geometry.camera import Intrinsics, project_points
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.kernels.match import (
    MatchParams,
    MatchResult,
    angle_penalty,
    match_descriptors,
    midpoint_radius_penalty,
)


class ProjectionSearchParams(NamedTuple):
    radius: float = 40.0  # px midpoint search radius
    angle_tol: float = 0.3
    match: MatchParams = MatchParams(max_dist=110.0, ratio=0.95)
    min_z: float = 0.05
    margin: float = -20.0  # allow midpoints slightly outside the image


def project_map_lines(T_cw: torch.Tensor, ep3d: torch.Tensor, cam: Intrinsics, min_z: float, margin: float):
    """Project (N, 2, 3) world endpoints. Returns (uv (N,2,2), mid (N,2),
    ang (N,), visible (N,) bool)."""
    ep_c = se3_apply(T_cw, ep3d)
    uv = project_points(cam, ep_c)
    in_front = torch.all(ep_c[..., 2] > min_z, dim=-1)
    mid = torch.mean(uv, dim=1)
    d = uv[:, 1] - uv[:, 0]
    ang = torch.atan2(d[..., 1], d[..., 0])
    in_img = (
        (mid[:, 0] >= margin)
        & (mid[:, 0] < cam.width - margin)
        & (mid[:, 1] >= margin)
        & (mid[:, 1] < cam.height - margin)
    )
    return uv, mid, ang, in_front & in_img


def search_by_projection(
    T_cw: torch.Tensor,
    map_ep3d: torch.Tensor,
    map_bits: torch.Tensor,
    map_valid: torch.Tensor,
    feats: FrameFeatures,
    cam: Intrinsics,
    params: ProjectionSearchParams = ProjectionSearchParams(),
) -> MatchResult:
    """Match map lines to frame features near their predicted projection.
    Returns a MatchResult over the landmark axis: idx[i] = frame feature slot."""
    _, mid, ang, visible = project_map_lines(T_cw, map_ep3d, cam, params.min_z, params.margin)
    pen = midpoint_radius_penalty(mid, feats.midpoint, params.radius) + angle_penalty(
        ang, feats.angle, params.angle_tol
    )
    vf = map_valid.to(torch.float32) * visible.to(torch.float32)
    return match_descriptors(map_bits, vf, feats.desc_bits, feats.valid, params.match, pen)


class TrackStepResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) optimized T_cw
    match_idx: torch.Tensor  # (N,) landmark -> frame slot (-1 none)
    inlier: torch.Tensor  # (N,) final inlier mask (f32)
    num_matched: torch.Tensor  # int32
    num_inliers: torch.Tensor  # int32


def tracked_pose_step(
    T_pred: torch.Tensor,
    map_plucker: torch.Tensor,  # (N, 6) world lines
    map_ep3d: torch.Tensor,  # (N, 2, 3)
    map_bits: torch.Tensor,  # (N, W) int64 words
    map_valid: torch.Tensor,  # (N,) f32 {0, 1}
    feats: FrameFeatures,
    cam: Intrinsics,
    search: ProjectionSearchParams = ProjectionSearchParams(),
    opt: PoseOptConfig = PoseOptConfig(),
) -> TrackStepResult:
    """One tracking stage: project + match + pose LM + re-gate."""
    m = search_by_projection(T_pred, map_ep3d, map_bits, map_valid, feats, cam, search)
    slot = torch.clamp(m.idx, min=0)
    res = pose_optimize(
        T_pred, map_plucker, feats.endpoints[slot], m.valid, cam, opt, l_sigma=feats.sigma[slot]
    )
    return TrackStepResult(
        pose=res.pose,
        match_idx=m.idx,
        inlier=res.inlier_lines,
        num_matched=torch.sum(m.valid).to(torch.int32),
        num_inliers=res.num_inliers,
    )


def triangulate_stereo_lines(T_wc, feats: FrameFeatures, cam: Intrinsics):
    """Stereo-depth endpoints -> world Pluecker lines + 3D endpoints.

    Returns (plucker (K, 6), ep3d (K, 2, 3), okf (K,) f32)."""
    dev = feats.endpoints.device
    T_wc = torch.as_tensor(np.asarray(T_wc, np.float32), device=dev)
    x = (feats.endpoints[..., 0] - cam.cx) / cam.fx  # (K, 2)
    y = (feats.endpoints[..., 1] - cam.cy) / cam.fy
    z = feats.depth
    p_w = se3_apply(T_wc, torch.stack([x * z, y * z, z], dim=-1))  # (K, 2, 3)
    v = p_w[:, 1] - p_w[:, 0]
    n = torch.linalg.cross(p_w[:, 0], p_w[:, 1], dim=-1)
    seg_len = torch.linalg.norm(v, dim=-1)
    okf = (
        feats.has_depth
        * feats.valid
        * (seg_len > 0.05).to(torch.float32)
        * (seg_len < 20.0).to(torch.float32)
    )
    return torch.cat([n, v], dim=-1), p_w, okf
