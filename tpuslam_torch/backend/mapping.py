"""Local mapping: the stereo mapper's steps at each keyframe (torch).

Counterpart of ``tpuslam.backend.mapping`` for stereo maps of lines and,
with the hybrid front end, points. At each keyframe event, synchronously:

  MapLine/PointCulling  -> drop recent landmarks not confirmed in time
  SearchInNeighbors     -> fuse duplicate lines and points (projection-gated match)
  UpdateConnections     -> covisibility recount
  LocalBundleAdjustment -> backend.local_ba (LM+Schur on the device)
  KeyFrameCulling       -> drop redundant keyframes

Mono triangulation (of lines and points) is not ported. Neither is the JAX
package's TPU machinery around the solve: the subprocess BA worker and the
deferred fusion apply (both exist to hide the TPU's dispatch and compile
costs). So ``tick`` and ``finish`` have nothing to do; they stay so that
``System`` drives both packages' mappers alike.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from tpuslam_torch.backend.local_ba import LocalBAConfig, LocalBAStats, local_bundle_adjustment
from tpuslam_torch.device import resolve_device
from tpuslam_torch.frontend.matcher import ProjectionSearchParams, search_by_projection
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.kernels.match import MatchParams, match_descriptors, midpoint_radius_penalty
from tpuslam_torch.slammap.map import KeyFrame, SlamMap, features_to_device, point_features_to_device


@dataclass
class MapperConfig:
    """The stereo mapper's settings; same names and defaults as
    ``tpuslam.backend.mapping.MapperConfig``. Its mono triangulation and
    deferred-fusion fields belong to paths not ported and are absent, except
    ``tri_point_match``, which point fusion uses."""

    ba: LocalBAConfig = field(default_factory=LocalBAConfig)
    ba_every: int = 1  # run local BA every N keyframes
    cull_min_obs: int = 2  # landmark must reach this within cull_horizon KFs
    cull_horizon: int = 3
    tri_point_match: MatchParams = field(default_factory=lambda: MatchParams(max_dist=60.0, ratio=0.8))
    fuse_search: ProjectionSearchParams = field(
        default_factory=lambda: ProjectionSearchParams(radius=10.0, angle_tol=0.15)
    )
    kf_cull_redundancy: float = 0.9  # cull KF if this fraction of its
    kf_cull_min_obs: int = 3  # landmarks is seen by >= this many other KFs
    enable_kf_culling: bool = True


class LocalMapper:
    """Synchronous mapping back end; install via tracker.on_new_keyframe."""

    def __init__(
        self,
        slam_map: SlamMap,
        cam: Intrinsics,
        cfg: MapperConfig = MapperConfig(),
        mono: bool = False,
        device="cuda",
    ):
        if mono:
            raise NotImplementedError(
                "mono mapping (two-view line triangulation) is not ported yet: it comes with the mono port "
                "(ROADMAP.md, 'Mono')"
            )
        self.map = slam_map
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self._recent: Dict[int, int] = {}  # line id -> kf id at creation
        self._recent_pts: Dict[int, int] = {}  # point id -> kf id at creation
        self._kf_count = 0
        self.last_ba: LocalBAStats | None = None
        self.on_map_changed = None  # callback (e.g. tracker.invalidate_local_map)
        self.timer = None  # optional StageTimer (System wires its own in)
        # per-solve wall ms (assemble excluded, read back included) by the
        # (P, L, OL) rung of the problem
        self.solve_ms_by_rung: Dict[tuple, List[float]] = {}

    def process(self, kf: KeyFrame):
        _t = time.perf_counter
        marks = [("start", _t())]
        self._kf_count += 1
        self._register_recent(kf)
        self._cull_recent(kf)
        marks.append(("mp.cull", _t()))
        self._fuse_all(kf)
        marks.append(("mp.fuse_dispatch", _t()))
        self.map.update_connections(kf)
        marks.append(("mp.covis", _t()))
        if self._kf_count % self.cfg.ba_every == 0 and len(self.map.keyframes) >= 2:
            self.last_ba = local_bundle_adjustment(
                self.map, kf.kid, self.cam, self.cfg.ba, device=self.device, solve_ms_by_rung=self.solve_ms_by_rung
            )
        marks.append(("mp.ba", _t()))
        if self.cfg.enable_kf_culling:
            self._cull_keyframes(kf)
        if self.on_map_changed:
            self.on_map_changed()
        marks.append(("mp.kf_cull", _t()))
        if self.timer is not None:  # System's StageTimer (KF-event wall split)
            for (_, prev), (name, now) in zip(marks, marks[1:]):
                self.timer.add(name, now - prev)

    def tick(self):
        """Between-keyframe poll: nothing is deferred in this package."""

    def finish(self):
        """Sequence end: nothing is in flight in this package."""

    # ---- landmark culling ----------------------------------------------
    def _register_recent(self, kf: KeyFrame):
        st = self.map.lines
        for lid in kf.line_ids:
            if lid >= 0 and st.first_kf[lid] == kf.kid:
                self._recent[int(lid)] = kf.kid
        if kf.point_ids is not None:
            pst = self.map.points
            for pid in kf.point_ids:
                if pid >= 0 and pst.first_kf[pid] == kf.kid:
                    self._recent_pts[int(pid)] = kf.kid

    def _cull_recent(self, kf: KeyFrame):
        for store, recent in ((self.map.lines, self._recent), (self.map.points, self._recent_pts)):
            for lm, born in list(recent.items()):
                if not store.alive[lm]:
                    del recent[lm]
                    continue
                if kf.kid - born >= self.cfg.cull_horizon:
                    if store.n_obs[lm] < self.cfg.cull_min_obs:
                        store.kill(lm, self.map.keyframes)
                    del recent[lm]

    # ---- duplicate fusion -----------------------------------------------
    def _fuse_all(self, kf: KeyFrame):
        """Match older local-map lines and points into this keyframe (one
        read back of both families' matches); bind missed observations and
        merge duplicates."""
        ld, pd = self._fuse_lines_dispatch(kf), self._fuse_points_dispatch(kf)
        live = [d for d in (ld, pd) if d is not None]
        if not live:
            return
        both = torch.cat([torch.stack([m.valid.to(torch.int64), m.idx]) for m, _ in live], dim=1).cpu().numpy()
        n = 0
        for d, apply in ((ld, self._fuse_lines_apply), (pd, self._fuse_points_apply)):
            if d is not None:
                k = len(d[1])
                apply(kf, d[1], both[0, n : n + k] > 0, both[1, n : n + k])
                n += k

    @staticmethod
    def _padded_ids(old_ids: List[int]):
        """ids padded to a doubling capacity from 128, as the JAX package
        pads them, and their validity."""
        n = len(old_ids)
        cap = 128
        while cap < n:
            cap *= 2
        ids = np.zeros(cap, np.int32)
        ids[:n] = old_ids
        validf = np.zeros(cap, np.float32)
        validf[:n] = 1.0
        return ids, validf

    def _fuse_lines_dispatch(self, kf: KeyFrame):
        st = self.map.lines
        neighbors = self.map.covisible_keyframes(kf.kid, 5)
        old_ids = sorted(
            {
                int(l)
                for nk in neighbors
                for l in self.map.keyframes[nk].line_ids
                if l >= 0 and st.alive[l] and st.first_kf[l] != kf.kid
            }
        )
        if not old_ids:
            return None
        ids, validf = self._padded_ids(old_ids)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        m = search_by_projection(
            dev(kf.T_cw),
            dev(st.endpoints[ids]),
            dev(st.desc_bits[ids].astype(np.int64)),
            dev(validf),
            features_to_device(kf.features, self.device),
            self.cam,
            self.cfg.fuse_search,
        )
        return m, ids

    def _fuse_lines_apply(self, kf: KeyFrame, ids, mv, midx):
        st = self.map.lines
        for i in np.nonzero(mv)[0]:
            slot = int(midx[i])
            old = int(ids[i])
            cur = int(kf.line_ids[slot])
            if cur < 0:
                st.add_observation(old, kf, slot)
            elif cur != old and st.alive[cur] and st.alive[old]:
                # keep the better-observed landmark
                keep, drop = (old, cur) if st.n_obs[old] >= st.n_obs[cur] else (cur, old)
                st.replace(drop, keep, self.map.keyframes)

    def _fuse_points_dispatch(self, kf: KeyFrame):
        """The point analog: older neighbourhood points projected into this
        keyframe on the host (float32 numpy, as the JAX package does), gated
        by the fusion radius and matched by descriptor."""
        if kf.point_features is None or kf.point_ids is None:
            return None
        pst = self.map.points
        old_ids = sorted(
            {
                int(q)
                for nk in self.map.covisible_keyframes(kf.kid, 5)
                for q in (() if self.map.keyframes[nk].point_ids is None else self.map.keyframes[nk].point_ids)
                if q >= 0 and pst.alive[q] and pst.first_kf[q] != kf.kid
            }
        )
        if not old_ids:
            return None
        ids, validf = self._padded_ids(old_ids)
        T = kf.T_cw
        Xc = pst.xyz[ids] @ T[:3, :3].T + T[:3, 3]
        cam = self.cam
        Kmat = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], np.float32)
        pr = Xc @ Kmat.T
        uv = pr[:, :2] / np.maximum(pr[:, 2:3], 1e-9)
        validf *= (Xc[:, 2] > 0.05).astype(np.float32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        pf = point_features_to_device(kf.point_features, self.device)
        pen = midpoint_radius_penalty(dev(uv.astype(np.float32)), pf.uv, self.cfg.fuse_search.radius)
        m = match_descriptors(
            dev(pst.desc_bits[ids].astype(np.int64)), dev(validf), pf.desc_bits, pf.valid, self.cfg.tri_point_match, pen
        )
        return m, ids

    def _fuse_points_apply(self, kf: KeyFrame, ids, mv, midx):
        pst = self.map.points
        for i in np.nonzero(mv)[0]:
            slot = int(midx[i])
            old = int(ids[i])
            cur = int(kf.point_ids[slot])
            if cur < 0:
                pst.add_observation(old, kf, slot)
            elif cur != old and pst.alive[cur] and pst.alive[old]:
                keep, drop = (old, cur) if pst.n_obs[old] >= pst.n_obs[cur] else (cur, old)
                pst.replace(drop, keep, self.map.keyframes)

    # ---- keyframe culling ----------------------------------------------
    def _cull_keyframes(self, kf: KeyFrame):
        st = self.map.lines
        for kid in self.map.covisible_keyframes(kf.kid, 10):
            ckf = self.map.keyframes.get(kid)
            if ckf is None or kid == kf.kid or kid == min(self.map.keyframes):
                continue
            lids = [int(l) for l in ckf.line_ids if l >= 0 and st.alive[l]]
            if len(lids) < 10:
                continue
            redundant = sum(1 for l in lids if st.n_obs[l] >= self.cfg.kf_cull_min_obs + 1)
            if redundant > self.cfg.kf_cull_redundancy * len(lids):
                self.map.erase_keyframe(kid)
