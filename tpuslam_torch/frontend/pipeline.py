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

The hybrid chunk (``_fused_chunk_semidirect_hybrid``) adds FAST/BRIEF
corners on the anchor (direct epipolar corner depths, both landmark
families in one pose LM per stage) and point templates beside the line
templates on the followers (one joint Gauss-Newton). The single-frame fused
hybrid program of the JAX package is not ported (:func:`fused_stereo_frame_hybrid`
raises).

The pose chain (T_last, T_prevlast) and the per-frame acceptance stay on
the device: each select is arithmetic on a 0-d float mask, every shape is
fixed, and nothing in the chunk reads back to the host; the tracker reads
the chunk's (C, 20) ``packed`` rows once, when it resolves the chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.backend.pose_opt import PoseOptConfig
from tpuslam_torch.frontend.frame import FrameFeatures, FrontendParams, extract_features
from tpuslam_torch.frontend.matcher import ProjectionSearchParams, tracked_pose_step
from tpuslam_torch.frontend.points import PointFrontendParams, tracked_pose_step_hybrid
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.geometry.se3 import se3_inverse, se3_orthonormalize
from tpuslam_torch.kernels.align_direct import (
    DirectAlignParams,
    align_frame_body,
    align_frame_hybrid_body,
    anchor_point_templates_body,
    anchor_templates_body,
)
from tpuslam_torch.kernels.fast import PointFeatures, detect_corners
from tpuslam_torch.kernels.stereo_direct import (
    DirectPointStereoParams,
    DirectStereoParams,
    direct_line_disparity_body,
    direct_point_disparity_body,
)


class FusedFrameOut(NamedTuple):
    feats: FrameFeatures  # the anchor's stereo-associated left features
    match_idx: torch.Tensor  # (NL,) landmark -> anchor feature slot
    inlier: torch.Tensor  # (NL,) float32
    packed: torch.Tensor  # (C, 20) float32 rows: pose (16), n_matched, n_inliers, n_depth, accept
    T_last: torch.Tensor  # (4, 4) the chain forward: the last frame's accepted (or predicted) pose
    T_prevlast: torch.Tensor  # (4, 4) the chain forward
    # hybrid chunks only
    pfeats: PointFeatures | None = None  # the anchor's corners with direct-stereo depths
    p_match_idx: torch.Tensor | None = None  # (NP,) point landmark -> anchor corner slot
    p_inlier: torch.Tensor | None = None  # (NP,) float32


# XLA rewrites a division by a constant inside a jitted program into a
# multiplication by its float32 reciprocal: the JAX package's chunk programs
# scale their u8 frames by this, not by 1/255 exactly (a one-ulp difference on
# about half of the 256 levels, which the FAST and detector thresholds see)
_INV255 = float(np.float32(1.0) / np.float32(255.0))


def _frames01(frames: torch.Tensor) -> torch.Tensor:
    """A chunk's u8 frames -> float32 in [0, 1], as the JAX package's jitted
    chunk programs compute it; float32 frames pass through."""
    if frames.dtype == torch.float32:
        return frames
    return frames.to(torch.float32) * _INV255


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


def _follower_step(img, T_l, T_p, plucker_a, tm, cam: Intrinsics, ap: DirectAlignParams, min_inliers: int, tm_p=None):
    """One follower: the motion-model prediction, template alignment (lines,
    and points with ``tm_p``) and the in-program acceptance. Returns (T_i,
    T_prev_next, packed row)."""
    T_pred = T_l @ se3_inverse(T_p) @ T_l
    if tm_p is None:
        T_new, n_samp, n_lines = align_frame_body(img, T_pred, plucker_a, tm, cam, ap)
    else:
        T_new, n_samp, n_lines = align_frame_hybrid_body(img, T_pred, plucker_a, tm, tm_p, cam, ap)
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
    frames = _frames01(frames)
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


def _track_core_hybrid_body(
    fl: FrameFeatures,
    l_depth: torch.Tensor,
    l_okf: torch.Tensor,
    fp: PointFeatures,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    local: dict,
    plocal: dict,
    cam: Intrinsics,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    pp: PointFrontendParams,
    po: PoseOptConfig,
    min_inliers: int,
):
    """The hybrid :func:`_track_core_body`: coarse and fine stages, each
    matching both landmark families and refining the pose with one LM over
    both. Returns (l_depth, l_okf, l_match_idx, l_inlier, p_match_idx,
    p_inlier, packed (20,), T_acc, T_prev_next); the counts in ``packed``
    are lines and points together."""
    T_pred = T_last @ se3_inverse(T_prevlast) @ T_last
    coarse = tracked_pose_step_hybrid(T_pred, local, plocal, fl, fp, cam, sc, pp, po)
    fine = tracked_pose_step_hybrid(coarse.pose, local, plocal, fl, fp, cam, sf, pp, po)
    acceptf = (fine.num_inliers >= min_inliers).to(torch.float32)
    T_acc, T_prev_next = _accept(acceptf, fine.pose, T_pred, T_last)
    packed = _packed_row(T_acc, fine.num_matched, fine.num_inliers, torch.sum(l_okf), acceptf)
    return l_depth, l_okf, fine.l_match_idx, fine.l_inlier, fine.p_match_idx, fine.p_inlier, packed, T_acc, T_prev_next


def _fused_frame_hybrid_body(
    pair: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    local: dict,
    plocal: dict,
    fxb: float,
    cam: Intrinsics,
    fe: FrontendParams,
    sd: DirectStereoParams,
    sdp: DirectPointStereoParams,
    pp: PointFrontendParams,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
):
    """One hybrid direct-stereo frame: lines and corners detected on the
    left image only, both families' depths from direct epipolar correlation
    against the right image (corner depths outside [min_depth, max_depth]
    dropped), then :func:`_track_core_hybrid_body`. pair: (2, H, W) float32
    in [0, 1]. Returns (fl, fp) + the core's outputs."""
    fl = extract_features(pair[0], fe)
    fp = detect_corners(pair[0], pp.max_points, pp.fast)
    if fe.prescaled and fe.base_scale != 1.0:
        # corners found on the prescaled image: uv in full-resolution pixels,
        # as the line geometry (the corner stereo maps back by its coord_scale)
        fp = fp._replace(uv=fp.uv / fe.base_scale)
    l_disp, l_okf = direct_line_disparity_body(pair[0], pair[1], fl.endpoints, fl.valid, fl.angle, sd)
    l_depth = l_okf[:, None] * fxb / torch.clamp(l_disp, min=1e-6)
    p_disp, p_okf = direct_point_disparity_body(pair[0], pair[1], fp.uv, fp.valid, sdp)
    p_depth = p_okf * fxb / torch.clamp(p_disp, min=1e-6)
    p_okf = p_okf * (p_depth > pp.min_depth).to(torch.float32) * (p_depth < pp.max_depth).to(torch.float32)
    fp = fp._replace(depth=p_depth * p_okf, has_depth=p_okf)
    out = _track_core_hybrid_body(fl, l_depth, l_okf, fp, T_last, T_prevlast, local, plocal, cam, sc, sf, pp, po, min_inliers)
    return (fl, fp) + out


def _fused_chunk_semidirect_hybrid(
    frames: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    local: dict,
    plocal: dict,
    fxb: float,
    cam: Intrinsics,
    fe: FrontendParams,
    sd: DirectStereoParams,
    sdp: DirectPointStereoParams,
    pp: PointFrontendParams,
    ap: DirectAlignParams,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
):
    """The hybrid semi-direct chunk: the hybrid full frame on the anchor,
    line and point templates from it, joint alignment on the followers.
    Same frame layout and packed rows as :func:`_fused_chunk_semidirect`; a
    follower's counters are (samples good, a point counting 2; lines and
    points aligned). Returns (fl, fp, l_depth, l_okf, l_match_idx, l_inlier,
    p_match_idx, p_inlier, packed (C, 20), T_last, T_prevlast)."""
    frames = _frames01(frames)
    fl, fp, l_depth, l_okf, midx, l_inl, p_idx, p_inl, packed0, T_l, T_p = _fused_frame_hybrid_body(
        frames[:2], T_last, T_prevlast, local, plocal, fxb, cam, fe, sd, sdp, pp, sc, sf, po, min_inliers
    )
    A, Ap = ap.align_cap, ap.point_cap
    plucker_a = local["plucker"][:A]
    tm = anchor_templates_body(frames[0], T_l, local["ep3d"][:A], local["valid"][:A], cam, ap)
    tm_p = anchor_point_templates_body(frames[0], T_l, plocal["xyz"][:Ap], plocal["valid"][:Ap], cam, ap)
    rows = [packed0]
    for img in frames[2:]:
        T_l, T_p, row = _follower_step(img, T_l, T_p, plucker_a, tm, cam, ap, min_inliers, tm_p=tm_p)
        rows.append(row)
    return fl, fp, l_depth, l_okf, midx, l_inl, p_idx, p_inl, torch.stack(rows), T_l, T_p


def fused_stereo_semidirect_hybrid(
    frames: torch.Tensor,
    T_last: torch.Tensor,
    T_prevlast: torch.Tensor,
    local: dict,
    plocal: dict,
    fxb: float,
    cam: Intrinsics,
    fe: FrontendParams,
    sc: ProjectionSearchParams,
    sf: ProjectionSearchParams,
    po: PoseOptConfig,
    min_inliers: int,
    sd: DirectStereoParams,
    sdp: DirectPointStereoParams,
    pp: PointFrontendParams,
    ap: DirectAlignParams,
) -> FusedFrameOut:
    """The hybrid semi-direct chunk against the local line map ``local``
    and the local point map ``plocal`` (xyz, bits, valid). The result
    carries the anchor's line and corner features and matches and one
    ``packed`` row per frame."""
    fl, fp, l_depth, l_okf, midx, l_inl, p_idx, p_inl, packed, T_l, T_p = _fused_chunk_semidirect_hybrid(
        frames, T_last, T_prevlast, local, plocal, float(fxb), cam, fe, sd, sdp, pp, ap, sc, sf, po, int(min_inliers)
    )
    return FusedFrameOut(
        feats=fl._replace(depth=l_depth, has_depth=l_okf), match_idx=midx, inlier=l_inl, packed=packed, T_last=T_l,
        T_prevlast=T_p, pfeats=fp, p_match_idx=p_idx, p_inlier=p_inl,
    )


def fused_stereo_frame_hybrid(*args, **kwargs):
    """The JAX package's single-frame fused hybrid program: not ported."""
    raise NotImplementedError(
        "the single-frame fused hybrid program (fused_stereo_frame_hybrid) is not ported: hybrid points run in the "
        "semi-direct chunks or on the synchronous path"
    )
