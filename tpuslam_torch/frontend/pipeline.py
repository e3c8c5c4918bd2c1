"""The semi-direct chunk program of the pipelined stereo tracker (torch).

Counterpart of the direct-stereo and semi-direct parts of
``tpuslam.frontend.pipeline``. One chunk is C consecutive frames handed to
the device as one u8 tensor ``frames`` (C + 1, H, W) = [L0, R0, L1, ...,
L_{C-1}]:

- the anchor frame (the first) runs the full frame: the detector and LBD on
  the left image, direct epipolar stereo against the right image, coarse and
  fine projection search with the pose LM (:func:`_fused_frame_direct_body`),
  then photometric templates of the local map under its accepted pose;
- each of the C - 1 followers is tracked by template alignment against the
  local line map (``kernels/align_direct.py``), from the motion model.

The pose chain (T_last, T_prevlast) and the per-frame acceptance stay on
the device: each select is arithmetic on a 0-d float mask, every shape is
fixed, and nothing in the chunk reads back to the host; the tracker reads
the chunk's (C, 20) ``packed`` rows once, when it resolves the chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.backend.pose_opt import PoseOptConfig
from tpuslam_torch.frontend.frame import FrameFeatures, FrontendParams, extract_features
from tpuslam_torch.frontend.matcher import ProjectionSearchParams, tracked_pose_step
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.geometry.se3 import se3_inverse, se3_orthonormalize
from tpuslam_torch.kernels.align_direct import DirectAlignParams, align_frame_body, anchor_templates_body
from tpuslam_torch.kernels.stereo_direct import DirectStereoParams, direct_line_disparity_body


class FusedFrameOut(NamedTuple):
    feats: FrameFeatures  # the anchor's stereo-associated left features
    match_idx: torch.Tensor  # (NL,) landmark -> anchor feature slot
    inlier: torch.Tensor  # (NL,) float32
    packed: torch.Tensor  # (C, 20) float32 rows: pose (16), n_matched, n_inliers, n_depth, accept
    T_last: torch.Tensor  # (4, 4) the chain forward: the last frame's accepted (or predicted) pose
    T_prevlast: torch.Tensor  # (4, 4) the chain forward


def _packed_row(T: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, acceptf: torch.Tensor) -> torch.Tensor:
    return torch.cat([T.reshape(-1), torch.stack([a.to(torch.float32), b.to(torch.float32), c, acceptf])])


def _accept(acceptf: torch.Tensor, T_new: torch.Tensor, T_pred: torch.Tensor, T_last: torch.Tensor):
    """In-program acceptance: the accepted pose (projected back onto SO(3):
    the chain feeds back through se3_inverse products frame after frame),
    or the prediction; on reject the velocity resets (T_prevlast' = T_acc)."""
    T_acc = se3_orthonormalize(acceptf * T_new + (1.0 - acceptf) * T_pred)
    return T_acc, acceptf * T_last + (1.0 - acceptf) * T_acc


def _track_core_body(
    fl: FrameFeatures,
    depth: torch.Tensor,
    okf: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    lm_plucker: torch.Tensor,
    lm_ep3d: torch.Tensor,
    lm_bits: torch.Tensor,
    lm_validf: torch.Tensor,
    cam: Intrinsics,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
):
    """Motion-model prediction, coarse and fine projection search with the
    pose LM, and in-program acceptance (stereo depths given). Returns
    (depth, okf, match_idx, inlier, packed (20,), T_acc, T_prev_next)."""
    T_pred = T_last @ se3_inverse(T_prevlast) @ T_last
    coarse = tracked_pose_step(T_pred, lm_plucker, lm_ep3d, lm_bits, lm_validf, fl, cam, sc, po)
    fine = tracked_pose_step(coarse.pose, lm_plucker, lm_ep3d, lm_bits, lm_validf, fl, cam, sf, po)
    acceptf = (fine.num_inliers >= min_inliers).to(torch.float32)
    T_acc, T_prev_next = _accept(acceptf, fine.pose, T_pred, T_last)
    packed = _packed_row(T_acc, fine.num_matched, fine.num_inliers, torch.sum(okf), acceptf)
    return depth, okf, fine.match_idx, fine.inlier, packed, T_acc, T_prev_next


def _fused_frame_direct_body(
    pair: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    lm_plucker: torch.Tensor,
    lm_ep3d: torch.Tensor,
    lm_bits: torch.Tensor,
    lm_validf: torch.Tensor,
    fxb: float,
    cam: Intrinsics,
    fe: FrontendParams,
    sd: DirectStereoParams,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
):
    """One direct-stereo frame: detect and describe the left image only; the
    line depths come from direct epipolar correlation against the right
    image. pair: (2, H, W) float32 in [0, 1]. Returns (feats, depth, okf,
    match_idx, inlier, packed, T_acc, T_prev_next)."""
    fl = extract_features(pair[0], fe)
    disp, okf = direct_line_disparity_body(pair[0], pair[1], fl.endpoints, fl.valid, fl.angle, sd)
    depth = okf[:, None] * fxb / torch.clamp(disp, min=1e-6)
    out = _track_core_body(fl, depth, okf, T_last, T_prevlast, lm_plucker, lm_ep3d, lm_bits, lm_validf, cam, sc, sf, po, min_inliers)
    return (fl,) + out


def _follower_step(img, T_l, T_p, plucker_a, tm, cam: Intrinsics, ap: DirectAlignParams, min_inliers: int):
    """One follower: the motion-model prediction, template alignment and the
    in-program acceptance. Returns (T_i, T_prev_next, packed row)."""
    T_pred = T_l @ se3_inverse(T_p) @ T_l
    T_new, n_samp, n_lines = align_frame_body(img, T_pred, plucker_a, tm, cam, ap)
    acceptf = (n_lines >= float(min_inliers)).to(torch.float32)
    T_i, T_p_next = _accept(acceptf, T_new, T_pred, T_l)
    return T_i, T_p_next, _packed_row(T_i, n_samp, n_lines, torch.zeros_like(n_samp), acceptf)


def _fused_chunk_semidirect(
    frames: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    lm_plucker: torch.Tensor,
    lm_ep3d: torch.Tensor,
    lm_bits: torch.Tensor,
    lm_validf: torch.Tensor,
    fxb: float,
    cam: Intrinsics,
    fe: FrontendParams,
    sd: DirectStereoParams,
    ap: DirectAlignParams,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
):
    """The semi-direct chunk: the full frame and the templates on the
    anchor, template alignment on the followers. frames: (C + 1, H, W) u8
    (or float32 in [0, 1]) = [L0, R0, L1, ..., L_{C-1}]. Follower rows of
    ``packed`` hold (n_samples_good, n_lines_good, 0, accept) in the counter
    slots: an aligned line stands for a tracked inlier line. Returns (feats,
    depth, okf, match_idx, inlier, packed (C, 20), T_last, T_prevlast)."""
    if frames.dtype != torch.float32:
        frames = frames.to(torch.float32) / 255.0
    fl, depth, okf, midx, inlier, packed0, T_l, T_p = _fused_frame_direct_body(
        frames[:2], T_last, T_prevlast, lm_plucker, lm_ep3d, lm_bits, lm_validf,
        fxb, cam, fe, sd, sc, sf, po, min_inliers,
    )
    A = ap.align_cap
    plucker_a = lm_plucker[:A]
    tm = anchor_templates_body(frames[0], T_l, lm_ep3d[:A], lm_validf[:A], cam, ap)
    rows = [packed0]
    for img in frames[2:]:
        T_l, T_p, row = _follower_step(img, T_l, T_p, plucker_a, tm, cam, ap, min_inliers)
        rows.append(row)
    return fl, depth, okf, midx, inlier, torch.stack(rows), T_l, T_p


def fused_stereo_semidirect(
    frames: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    local: dict,
    fxb: float,
    cam: Intrinsics,
    fe: FrontendParams,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
    sd: DirectStereoParams,
    ap: DirectAlignParams,
) -> FusedFrameOut:
    """The semi-direct chunk against the local map arrays ``local``
    (plucker, ep3d, bits, valid). The result carries the anchor's features
    and matches and one ``packed`` row per frame."""
    fl, depth, okf, midx, inlier, packed, T_l, T_p = _fused_chunk_semidirect(
        frames, T_last, T_prevlast, local["plucker"], local["ep3d"], local["bits"], local["valid"],
        float(fxb), cam, fe, sd, ap, sc, sf, po, int(min_inliers),
    )
    return FusedFrameOut(
        feats=fl._replace(depth=depth, has_depth=okf), match_idx=midx, inlier=inlier, packed=packed, T_last=T_l, T_prevlast=T_p
    )
