"""Local mapping: the stereo mapper's steps at each keyframe (torch).

Counterpart of ``tpuslam.backend.mapping`` for stereo line maps. At each
keyframe event, synchronously:

  MapLineCulling        -> drop recent landmarks not confirmed in time
  SearchInNeighbors     -> fuse duplicate landmarks (projection-gated match)
  UpdateConnections     -> covisibility recount
  LocalBundleAdjustment -> backend.local_ba (LM+Schur on the device)
  KeyFrameCulling       -> drop redundant keyframes

Mono triangulation and hybrid points are not ported. Neither is the JAX
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
from tpuslam_torch.slammap.map import KeyFrame, SlamMap, features_to_device


@dataclass
class MapperConfig:
    """The stereo mapper's settings; same names and defaults as
    ``tpuslam.backend.mapping.MapperConfig``. Its mono triangulation and
    deferred-fusion fields belong to paths not ported and are absent."""

    ba: LocalBAConfig = field(default_factory=LocalBAConfig)
    ba_every: int = 1  # run local BA every N keyframes
    cull_min_obs: int = 2  # landmark must reach this within cull_horizon KFs
    cull_horizon: int = 3
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

    def _cull_recent(self, kf: KeyFrame):
        st = self.map.lines
        for lid, born in list(self._recent.items()):
            if not st.alive[lid]:
                del self._recent[lid]
                continue
            if kf.kid - born >= self.cfg.cull_horizon:
                if st.n_obs[lid] < self.cfg.cull_min_obs:
                    st.kill(lid, self.map.keyframes)
                del self._recent[lid]

    # ---- duplicate fusion -----------------------------------------------
    def _fuse_all(self, kf: KeyFrame):
        """Match older local-map lines into this keyframe (one read back of
        the matches); bind missed observations and merge duplicates."""
        d = self._fuse_lines_dispatch(kf)
        if d is None:
            return
        m, ids = d
        both = torch.stack([m.valid.to(torch.int64), m.idx]).cpu().numpy()
        self._fuse_lines_apply(kf, ids, both[0] > 0, both[1])

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
        # padded to a doubling capacity from 128, as the JAX package pads
        n = len(old_ids)
        cap = 128
        while cap < n:
            cap *= 2
        ids = np.zeros(cap, np.int32)
        ids[:n] = old_ids
        validf = np.zeros(cap, np.float32)
        validf[:n] = 1.0

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
