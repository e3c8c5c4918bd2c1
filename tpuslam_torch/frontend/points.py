"""The point front end: corner extraction, stereo depth, the hybrid
tracking stage (torch).

Counterpart of ``tpuslam.frontend.points``. Corners come from
``kernels.fast.detect_corners``; descriptor stereo reuses the binary
matcher with the rectified row-and-disparity gate; the hybrid stage projects
the local map's lines and points, gates and matches each family, and refines
the pose with one LM over both residual families
(``backend.pose_opt.pose_optimize`` with its point terms).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.backend.pose_opt import PoseOptConfig, pose_optimize
from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.frontend.matcher import search_by_projection
from tpuslam_torch.geometry.camera import Intrinsics, project_points
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.kernels.fast import FASTParams, PointFeatures, detect_corners
from tpuslam_torch.kernels.match import MatchParams, match_descriptors, midpoint_radius_penalty, stereo_row_penalty


class PointFrontendParams(NamedTuple):
    """Same fields and defaults as the JAX package's."""

    fast: FASTParams = FASTParams()
    max_points: int = 256
    # stereo association (rectified)
    stereo_max_dy: float = 2.0
    min_disp: float = 0.5
    max_disp: float = 200.0
    stereo_match: MatchParams = MatchParams(max_dist=60.0, ratio=0.9)
    # map-point projection search
    radius: float = 30.0
    match: MatchParams = MatchParams(max_dist=60.0, ratio=0.95)
    min_z: float = 0.05
    min_depth: float = 0.1
    max_depth: float = 40.0


def extract_points(img: torch.Tensor, params: PointFrontendParams) -> PointFeatures:
    """(H, W) float32 image in [0, 1] -> PointFeatures (capacity-padded)."""
    return detect_corners(img, params.max_points, params.fast)


def stereo_point_depths(left: PointFeatures, right: PointFeatures, fx_baseline: float, params: PointFrontendParams) -> PointFeatures:
    """Left-right corner association on rectified pairs -> metric depth."""
    pen = stereo_row_penalty(left.uv, right.uv, params.stereo_max_dy, params.min_disp, params.max_disp)
    m = match_descriptors(left.desc_bits, left.valid, right.desc_bits, right.valid, params.stereo_match, pen)
    disp = left.uv[:, 0] - right.uv[torch.clamp(m.idx, min=0), 0]
    okf = m.valid * (disp > params.min_disp).to(torch.float32) * (disp < params.max_disp).to(torch.float32)
    depth = okf * float(np.float32(fx_baseline)) / torch.clamp(disp, min=1e-6)
    okf = okf * (depth > params.min_depth).to(torch.float32) * (depth < params.max_depth).to(torch.float32)
    return left._replace(depth=depth * okf, has_depth=okf)


def triangulate_stereo_points(T_wc, feats: PointFeatures, cam: Intrinsics):
    """Stereo-depth corners back-projected to world points: (xyz (K, 3),
    okf (K,) float32)."""
    dev = feats.uv.device
    T_wc = torch.as_tensor(np.asarray(T_wc, np.float32), device=dev)
    x = (feats.uv[:, 0] - cam.cx) / cam.fx
    y = (feats.uv[:, 1] - cam.cy) / cam.fy
    z = feats.depth
    p_w = se3_apply(T_wc, torch.stack([x * z, y * z, z], dim=-1))
    return p_w, feats.has_depth * feats.valid


class HybridTrackResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) optimized T_cw
    l_match_idx: torch.Tensor  # (NL,) line landmark -> frame line slot
    l_inlier: torch.Tensor  # (NL,) f32
    p_match_idx: torch.Tensor  # (NP,) point landmark -> frame corner slot
    p_inlier: torch.Tensor  # (NP,) f32
    num_matched: torch.Tensor  # int32 (lines + points)
    num_inliers: torch.Tensor  # int32 (lines + points)


def project_map_points(T: torch.Tensor, xyz: torch.Tensor, validf: torch.Tensor, cam: Intrinsics, min_z: float):
    """Projections (NP, 2) of world points under T and their validity: in
    front of the camera and within 20 px of the image."""
    p_c = se3_apply(T, xyz)
    uv = project_points(cam, p_c)
    vis = (
        (p_c[:, 2] > min_z)
        & (uv[:, 0] >= -20.0) & (uv[:, 0] < cam.width + 20.0)
        & (uv[:, 1] >= -20.0) & (uv[:, 1] < cam.height + 20.0)
    )
    return uv, validf * vis.to(torch.float32)


def tracked_pose_step_hybrid(
    T_pred: torch.Tensor,
    line_local: dict,  # plucker (NL, 6), ep3d (NL, 2, 3), bits, valid
    point_local: dict,  # xyz (NP, 3), bits, valid
    line_feats: FrameFeatures,
    point_feats: PointFeatures,
    cam: Intrinsics,
    search,  # ProjectionSearchParams (the line gate)
    pparams: PointFrontendParams,
    opt: PoseOptConfig = PoseOptConfig(),
) -> HybridTrackResult:
    """One hybrid tracking stage: both landmark families projected, gated
    and matched, then one pose LM over both."""
    ml = search_by_projection(
        T_pred, line_local["ep3d"], line_local["bits"], line_local["valid"], line_feats, cam, search
    )
    uv, vf_p = project_map_points(T_pred, point_local["xyz"], point_local["valid"], cam, pparams.min_z)
    pen_p = midpoint_radius_penalty(uv, point_feats.uv, pparams.radius)
    mp = match_descriptors(point_local["bits"], vf_p, point_feats.desc_bits, point_feats.valid, pparams.match, pen_p)
    l_slot = torch.clamp(ml.idx, min=0)
    p_slot = torch.clamp(mp.idx, min=0)
    res = pose_optimize(
        T_pred, line_local["plucker"], line_feats.endpoints[l_slot], ml.valid, cam, opt,
        l_sigma=line_feats.sigma[l_slot], points=point_local["xyz"], p_uv=point_feats.uv[p_slot], p_valid=mp.valid,
    )
    n_lm = torch.sum(ml.valid).to(torch.int32)
    n_pm = torch.sum(mp.valid).to(torch.int32)
    return HybridTrackResult(
        pose=res.pose,
        l_match_idx=ml.idx,
        l_inlier=res.inlier_lines,
        p_match_idx=mp.idx,
        p_inlier=res.inlier_points,
        num_matched=n_lm + n_pm,
        num_inliers=res.num_inliers,
    )
