"""The tracking front end: per-frame pose estimation (torch).

Counterpart of the synchronous stereo path of ``tpuslam.frontend.tracking``:

  extract_features (left, right) + stereo_line_depths
  tracked_pose_step (coarse radius) -> tracked_pose_step (fine radius)
  TrackReferenceKeyFrame fallback when too few inliers remain
  keyframe policy, keyframe creation and stereo landmark triangulation
  relocalization of a LOST frame (keyframe database + DLT-Lines reseed)

State machine: NOT_INITIALIZED -> OK <-> LOST. Device work runs on
``device``; map bookkeeping stays on the host in numpy, and each frame reads
its match counts back once. ``on_new_keyframe`` (the mapper, through
``System``) fires after every keyframe insertion.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from tpuslam_torch.backend.dlt import dlt_lines_pose, image_line_coeffs
from tpuslam_torch.backend.pose_opt import PoseOptConfig
from tpuslam_torch.frontend.frame import (
    FrameFeatures,
    FrontendParams,
    StereoParams,
    extract_features,
    stereo_line_depths,
)
from tpuslam_torch.frontend.matcher import (
    ProjectionSearchParams,
    TrackStepResult,
    tracked_pose_step,
    triangulate_stereo_lines,
)
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.kernels.match import match_descriptors
from tpuslam_torch.slammap.map import KeyFrame, SlamMap


class TrackingState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerConfig:
    """The synchronous stereo path's settings; same names and defaults as
    ``tpuslam.frontend.tracking.TrackerConfig``. Its pipelined, fused,
    chunked, direct-stereo, semi-direct and hybrid-point options belong to
    paths not ported yet and are absent."""

    frontend: FrontendParams = FrontendParams()
    stereo: StereoParams = StereoParams()
    search_coarse: ProjectionSearchParams = ProjectionSearchParams(radius=50.0)
    search_fine: ProjectionSearchParams = ProjectionSearchParams(radius=20.0)
    pose_opt: PoseOptConfig = PoseOptConfig()
    local_capacity: int = 1024  # padded local-map landmark count
    min_init_lines: int = 20
    min_track_matches: int = 10
    min_track_inliers: int = 8
    max_frames_between_kf: int = 20
    min_frames_between_kf: int = 0
    kf_tracked_ratio: float = 0.6  # new KF if inliers < ratio * ref tracked
    min_new_kf_lines: int = 30  # (stereo) close lines needed to defer KF
    local_window_kfs: int = 10


@dataclass
class FrameResult:
    frame_idx: int
    timestamp: float
    T_cw: np.ndarray
    state: TrackingState
    n_matches: int = 0
    n_inliers: int = 0
    made_keyframe: bool = False


class Tracker:
    """Per-frame stereo tracking over a shared SlamMap."""

    def __init__(self, cam: Intrinsics, slam_map: SlamMap, cfg: Optional[TrackerConfig] = None, device="cpu"):
        self.cam = cam
        self.map = slam_map
        self.cfg = cfg if cfg is not None else TrackerConfig()
        self.device = torch.device(device)
        self.state = TrackingState.NOT_INITIALIZED
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)  # T_curr @ inv(T_last)
        self.last_T_cw: Optional[np.ndarray] = None
        self.ref_kf: Optional[int] = None
        self.last_kf_frame = -10**9
        self.frame_idx = -1
        self.ref_tracked = 0
        # local-map device arrays (rebuilt when the window changes)
        self._local_ids = np.zeros(self.cfg.local_capacity, np.int32)
        self._local_valid = np.zeros(self.cfg.local_capacity, bool)
        self._local_dirty = True
        self._local_dev = None
        self.on_new_keyframe = None  # callback(kf), installed by System
        self.kf_db = None  # KeyFrameDatabase for relocalization (System)
        self.n_relocalizations = 0

    # ---- public API ----------------------------------------------------
    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray, timestamp: float) -> FrameResult:
        self.frame_idx += 1
        return self._track(self._stereo_features(img_left, img_right), timestamp)

    def _image(self, img: np.ndarray) -> torch.Tensor:
        """u8 (0..255) or f32 (0..1) host frame -> f32 [0, 1] on the device
        (u8 frames cross to the device as u8, a quarter of the bytes)."""
        img = np.asarray(img)
        t = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        if img.dtype == np.uint8:
            return t.to(torch.float32) / 255.0
        return t.to(torch.float32)

    def _stereo_features(self, img_left: np.ndarray, img_right: np.ndarray) -> FrameFeatures:
        """Left features with descriptor-stereo depths (both cameras detected)."""
        fl = extract_features(self._image(img_left), self.cfg.frontend)
        fr = extract_features(self._image(img_right), self.cfg.frontend)
        return stereo_line_depths(fl, fr, self.cam.fx * self.cam.baseline, self.cfg.stereo)

    def _pose_tensor(self, T: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(T, np.float32)).to(self.device)

    # ---- core ----------------------------------------------------------
    def _track(self, feats: FrameFeatures, timestamp: float) -> FrameResult:
        if self.state == TrackingState.NOT_INITIALIZED:
            ok = self._initialize(feats, timestamp)
            return FrameResult(self.frame_idx, timestamp, self.T_cw.copy(), self.state, made_keyframe=ok)
        return self._track_frame_sync(feats, timestamp)

    def _track_frame_sync(self, feats: FrameFeatures, timestamp: float) -> FrameResult:
        if self.state == TrackingState.LOST:
            reloc = self._relocalize(feats)
            if reloc is None:
                return FrameResult(self.frame_idx, timestamp, self.T_cw.copy(), TrackingState.LOST)
            self.T_cw = reloc
            self.last_T_cw = reloc.copy()
            self.velocity = np.eye(4, dtype=np.float32)

        T_pred = self.velocity @ self.last_T_cw if self.last_T_cw is not None else self.T_cw
        local = self._local_map_arrays()
        coarse = tracked_pose_step(
            self._pose_tensor(T_pred), local["plucker"], local["ep3d"], local["bits"], local["valid"],
            feats, self.cam, self.cfg.search_coarse, self.cfg.pose_opt,
        )
        fine = tracked_pose_step(
            coarse.pose, local["plucker"], local["ep3d"], local["bits"], local["valid"],
            feats, self.cam, self.cfg.search_fine, self.cfg.pose_opt,
        )
        n_matches = int(fine.num_matched)
        n_inliers = int(fine.num_inliers)

        if n_inliers < self.cfg.min_track_inliers:
            alt = self._track_reference_keyframe(feats)
            if alt is not None:
                fine = alt
                n_matches = int(fine.num_matched)
                n_inliers = int(fine.num_inliers)

        if n_inliers >= self.cfg.min_track_inliers:
            self.state = TrackingState.OK
            new_T = fine.pose.cpu().numpy()
            if self.last_T_cw is not None:
                self.velocity = (new_T @ np.linalg.inv(self.last_T_cw)).astype(np.float32)
            self.last_T_cw = new_T
            self.T_cw = new_T
        else:
            # tracking failure: keep the motion-model pose, flag LOST
            self.state = TrackingState.LOST
            self.T_cw = np.asarray(T_pred, np.float32)
            self.last_T_cw = self.T_cw
            self.velocity = np.eye(4, dtype=np.float32)

        made_kf = False
        if self.state == TrackingState.OK and self._need_new_keyframe(n_inliers, feats):
            self._create_keyframe(feats, timestamp, fine)
            made_kf = True
        return FrameResult(
            self.frame_idx, timestamp, self.T_cw.copy(), self.state, n_matches, n_inliers, made_kf
        )

    # ---- initialization -------------------------------------------------
    def _initialize(self, feats: FrameFeatures, timestamp: float) -> bool:
        plucker, ep3d, okf = triangulate_stereo_lines(np.linalg.inv(self.T_cw), feats, self.cam)
        ok = okf.cpu().numpy() > 0.5
        if ok.sum() < self.cfg.min_init_lines:
            return False
        kf = self.map.new_keyframe(self.frame_idx, timestamp, self.T_cw, feats)
        self._bind_new_landmarks(kf, plucker.cpu().numpy(), ep3d.cpu().numpy(), ok)
        self.map.update_connections(kf)
        self.ref_kf = kf.kid
        self.ref_tracked = int(ok.sum())
        self.last_kf_frame = self.frame_idx
        self.last_T_cw = self.T_cw.copy()
        self.state = TrackingState.OK
        self._local_dirty = True
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)
        return True

    # ---- keyframes ------------------------------------------------------
    def _need_new_keyframe(self, n_inliers: int, feats: FrameFeatures) -> bool:
        since = self.frame_idx - self.last_kf_frame
        if since < max(1, self.cfg.min_frames_between_kf):
            return False
        if since >= self.cfg.max_frames_between_kf:
            return True
        weak = n_inliers < self.cfg.kf_tracked_ratio * max(self.ref_tracked, 1)
        n_depth = int(feats.has_depth.sum())
        return weak or (n_inliers < self.cfg.min_new_kf_lines and n_depth > n_inliers + 10)

    def _create_keyframe(self, feats: FrameFeatures, timestamp: float, fine: TrackStepResult):
        """Insert the keyframe, bind tracked landmarks (local slot i -> frame
        slot fine.match_idx[i]) and create landmarks from unmatched
        stereo-depth features."""
        plucker, ep3d, okf = triangulate_stereo_lines(np.linalg.inv(self.T_cw), feats, self.cam)
        self.last_kf_frame = self.frame_idx
        kf = self.map.new_keyframe(self.frame_idx, timestamp, self.T_cw, feats)
        match_idx = fine.match_idx.cpu().numpy()
        inlier = fine.inlier.cpu().numpy() > 0.5
        for i in np.nonzero(inlier & (match_idx >= 0))[0]:
            lid = int(self._local_ids[i])
            if self._local_valid[i] and self.map.lines.alive[lid]:
                slot = int(match_idx[i])
                if kf.line_ids[slot] < 0:
                    self.map.lines.add_observation(lid, kf, slot)
        ok = (okf.cpu().numpy() > 0.5) & (kf.line_ids < 0)
        self._bind_new_landmarks(kf, plucker.cpu().numpy(), ep3d.cpu().numpy(), ok)
        self.map.update_connections(kf)
        self.ref_kf = kf.kid
        self.ref_tracked = max(int(np.sum(kf.line_ids >= 0)), 1)
        self._local_dirty = True
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)

    def _bind_new_landmarks(self, kf: KeyFrame, plucker, ep3d, ok: np.ndarray):
        bits = kf.features.desc_bits
        for slot in np.nonzero(ok)[0]:
            lid = self.map.lines.allocate(plucker[slot], ep3d[slot], bits[slot], kf.kid)
            self.map.lines.add_observation(lid, kf, int(slot))

    # ---- reference-keyframe fallback -------------------------------------
    def _window_arrays(self, lids: List[int]):
        """Padded device arrays of the given landmark ids; returns (arrays,
        ids (NL,) int32, valid (NL,) f32)."""
        NL = self.cfg.local_capacity
        n = len(lids)
        ids = np.zeros(NL, np.int32)
        ids[:n] = lids
        valid = np.zeros(NL, np.float32)
        valid[:n] = 1.0
        st = self.map.lines

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        arrays = dict(
            plucker=dev(st.plucker[ids]),
            ep3d=dev(st.endpoints[ids]),
            bits=dev(st.desc_bits[ids].astype(np.int64)),
            valid=dev(valid),
        )
        return arrays, ids, valid

    def _track_reference_keyframe(self, feats: FrameFeatures) -> Optional[TrackStepResult]:
        """Descriptor matching (no projection gate) against the reference
        keyframe's window, LM seeded from the last pose."""
        if self.ref_kf is None or self.ref_kf not in self.map.keyframes:
            return None
        st = self.map.lines
        _, lids = self.map.local_window(self.ref_kf, 5)
        lids = [l for l in lids if st.alive[l]][: self.cfg.local_capacity]
        if len(lids) < self.cfg.min_track_inliers:
            return None
        arrays, ids, valid = self._window_arrays(lids)
        T0 = self.last_T_cw if self.last_T_cw is not None else self.T_cw
        res = tracked_pose_step(
            self._pose_tensor(T0), arrays["plucker"], arrays["ep3d"], arrays["bits"], arrays["valid"],
            feats, self.cam, self.cfg.search_coarse._replace(radius=1e6), self.cfg.pose_opt,
        )
        if int(res.num_inliers) < self.cfg.min_track_inliers:
            return None
        # keyframe creation binds landmarks through (_local_ids, match_idx):
        # swap the fallback's mapping in; the cache rebuilds next frame
        self._local_ids = ids
        self._local_valid = valid > 0.5
        self._local_dirty = True
        return res

    # ---- relocalization -------------------------------------------------
    def _relocalize(self, feats: FrameFeatures) -> Optional[np.ndarray]:
        """Keyframe-database query, then for each of the 3 best candidates a
        descriptor-only search against its window's landmarks from its pose,
        and a DLT-Lines reseed when that LM does not converge. Returns the
        recovered T_cw or None."""
        if self.kf_db is None:
            return None
        scores = self.kf_db.query_bits(feats.desc_bits, feats.valid)
        cands = sorted((k for k in scores if k in self.map.keyframes), key=lambda k: -scores[k])[:3]
        st = self.map.lines
        for kid in cands:
            if scores[kid] < self.cfg.min_track_matches:
                break
            _, lids = self.map.local_window(kid, 5)
            lids = [l for l in lids if st.alive[l]][: self.cfg.local_capacity]
            if len(lids) < self.cfg.min_track_inliers:
                continue
            arrays, ids, valid = self._window_arrays(lids)
            res = tracked_pose_step(
                self._pose_tensor(self.map.keyframes[kid].T_cw), arrays["plucker"], arrays["ep3d"], arrays["bits"],
                arrays["valid"], feats, self.cam, self.cfg.search_coarse._replace(radius=1e6), self.cfg.pose_opt,
            )
            if int(res.num_inliers) < self.cfg.min_track_inliers:
                # the matches do not depend on the pose, but LM from a distant
                # candidate's pose can diverge: reseed from the matches
                res = self._relocalize_dlt(feats, arrays, valid)
            if res is not None and int(res.num_inliers) >= self.cfg.min_track_inliers:
                self.ref_kf = kid
                self.n_relocalizations += 1
                self.state = TrackingState.OK
                self._local_dirty = True
                return res.pose.cpu().numpy()
        return None

    def _relocalize_dlt(self, feats: FrameFeatures, arrays, valid: np.ndarray) -> Optional[TrackStepResult]:
        """Pose-free descriptor matching, DLT-Lines on the matches, and one
        projection-search stage from the DLT pose."""
        m = match_descriptors(arrays["bits"], arrays["valid"], feats.desc_bits, feats.valid, self.cfg.search_coarse.match)
        midx = m.idx.cpu().numpy()
        mvalid = (m.valid.cpu().numpy() > 0.5) & (midx >= 0) & (valid > 0.5)
        if int(mvalid.sum()) < 8:
            return None
        l2d = image_line_coeffs(feats.endpoints)[torch.clamp(m.idx, min=0)]  # (NL, 3) per map slot
        mask = torch.from_numpy(mvalid.astype(np.float32)).to(self.device)
        T_dlt, ok = dlt_lines_pose(l2d, arrays["ep3d"], mask, self.cam)
        if float(ok) < 0.5:
            return None
        return tracked_pose_step(
            T_dlt, arrays["plucker"], arrays["ep3d"], arrays["bits"], arrays["valid"],
            feats, self.cam, self.cfg.search_coarse, self.cfg.pose_opt,
        )

    # ---- local map ------------------------------------------------------
    def invalidate_local_map(self):
        """Call after mapping or BA changes landmark geometry."""
        self._local_dirty = True

    def _local_map_arrays(self):
        if not self._local_dirty and self._local_dev is not None:
            return self._local_dev
        lids: List[int] = []
        if self.ref_kf is not None and self.ref_kf in self.map.keyframes:
            _, lids = self.map.local_window(self.ref_kf, self.cfg.local_window_kfs)
        lids = [l for l in lids if self.map.lines.alive[l]][: self.cfg.local_capacity]
        self._local_dev, ids, valid = self._window_arrays(lids)
        self._local_ids = ids
        self._local_valid = valid > 0.5
        self._local_dirty = False
        return self._local_dev
