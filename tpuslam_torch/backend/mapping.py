"""Local mapping: the mapper's steps at each keyframe (torch).

Counterpart of ``tpuslam.backend.mapping`` for stereo and monocular maps of
lines and, with the hybrid front end, points. At each keyframe event:

  (apply a deferred fusion still pending)
  MapLine/PointCulling  -> drop recent landmarks not confirmed in time
  CreateNewMapLines/Points -> (mono) two-view triangulation against covisible
                           keyframes
  SearchInNeighbors     -> fuse duplicate lines and points (projection-gated match)
  UpdateConnections     -> covisibility recount
  LocalBundleAdjustment -> backend.local_ba (LM+Schur on the device)
  KeyFrameCulling       -> drop redundant keyframes

Local BA runs in this process, or, given a ``solver``
(``backend.ba_worker.BASolverWorker``, which ``System`` starts on the card),
asynchronously in the solver process, as the reference's mapping thread
runs it: at a keyframe the mapper applies the previous solve if it has
finished and submits the new window; while the solver is busy the window
is skipped (``ba_skipped``) and :meth:`LocalMapper.tick` sends the
freshest one once it is free (``ba_resubmitted``); a solve assembled before
a loop correction (``map.generation``) is dropped (``ba_stale``); a failed
or abandoned solve is counted (``ba_failed``) and reported on stderr.

With ``MapperConfig.fuse_defer`` the fusion searches are dispatched at the
keyframe, their matches copied to pinned host memory behind a CUDA event,
and applied by :meth:`LocalMapper.tick` once ``fuse_apply_delay_s`` has
passed (or at the next keyframe event, or at :meth:`LocalMapper.finish`),
unless the keyframe was culled or the map corrected meanwhile.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from tpuslam_torch.backend.local_ba import (
    LocalBAConfig,
    LocalBAStats,
    apply_result,
    assemble_problem,
    local_bundle_adjustment,
    problem_arrays,
)
from tpuslam_torch.device import resolve_device
from tpuslam_torch.frontend.matcher import ProjectionSearchParams, search_by_projection
from tpuslam_torch.geometry.camera import Intrinsics, image_line_through, line_projection_matrix
from tpuslam_torch.geometry.plucker import plucker_transform
from tpuslam_torch.geometry.triangulate import (
    line_ray_endpoints,
    projection_matrix,
    triangulate_plucker_two_view,
    triangulate_points,
)
from tpuslam_torch.kernels.match import (
    MatchParams,
    angle_penalty,
    epipolar_penalty,
    match_descriptors,
    midpoint_radius_penalty,
)
from tpuslam_torch.slammap.map import KeyFrame, SlamMap, features_to_device, point_features_to_device
from tpuslam_torch.spans import span


@dataclass
class MapperConfig:
    """The mapper's settings; same names and defaults as
    ``tpuslam.backend.mapping.MapperConfig``."""

    ba: LocalBAConfig = field(default_factory=LocalBAConfig)
    ba_every: int = 1  # run local BA every N keyframes
    cull_min_obs: int = 2  # landmark must reach this within cull_horizon KFs
    cull_horizon: int = 3
    # mono two-view triangulation
    triangulate_neighbors: int = 3  # covisible keyframes searched for new landmarks
    tri_min_parallax_deg: float = 1.0  # points: least ray angle
    # lines: least angle between the back-projected planes; a tiny floor only
    # (the JAX package's note: a 1-degree floor rejects a whole orientation class)
    tri_line_min_parallax_deg: float = 0.2
    tri_depth_band: tuple = None  # (lo, hi) x the keyframe's median landmark depth, or None
    tri_depth_band_min_ref: int = 10  # bound landmarks needed to define that median
    tri_max_reproj_px: float = 4.0
    tri_min_depth: float = 0.1
    tri_max_depth: float = 60.0
    tri_match: MatchParams = field(default_factory=lambda: MatchParams(max_dist=90.0, ratio=0.8))
    tri_point_match: MatchParams = field(default_factory=lambda: MatchParams(max_dist=60.0, ratio=0.8))
    tri_epipolar_px: float = 3.0  # epipolar gate of two-view point matches
    fuse_search: ProjectionSearchParams = field(
        default_factory=lambda: ProjectionSearchParams(radius=10.0, angle_tol=0.15)
    )
    kf_cull_redundancy: float = 0.9  # cull KF if this fraction of its
    kf_cull_min_obs: int = 3  # landmarks is seen by >= this many other KFs
    enable_kf_culling: bool = True
    # dispatch the fusion searches at the keyframe and apply their matches
    # from tick() once fuse_apply_delay_s has passed (finish() drains it);
    # the JAX bench turns it on (TPUSLAM_BENCH_FUSEDEFER=1, its default)
    fuse_defer: bool = False
    fuse_apply_delay_s: float = field(default_factory=lambda: float(os.environ.get("TPUSLAM_FUSE_DEFER_MS", "40")) / 1e3)


class LocalMapper:
    """Mapping back end; install via tracker.on_new_keyframe. Local BA
    solves in this process, or asynchronously in ``solver`` (a
    ``backend.ba_worker.BASolverWorker``)."""

    def __init__(
        self,
        slam_map: SlamMap,
        cam: Intrinsics,
        cfg: MapperConfig = MapperConfig(),
        mono: bool = False,
        solver=None,
        device="cuda",
    ):
        self.map = slam_map
        self.cam = cam
        self.cfg = cfg
        self.mono = mono
        self.solver = solver
        self.device = resolve_device(device)
        self._ba_ctx = None  # the in-flight solve's write-back context
        self._ba_req = -1  # and its request id
        self._ba_want_resubmit = False  # a window was skipped: tick() sends the freshest
        self._fuse_pending = None  # a deferred fusion's matches on their way to the host
        self._recent: Dict[int, int] = {}  # line id -> kf id at creation
        self._recent_pts: Dict[int, int] = {}  # point id -> kf id at creation
        self._kf_count = 0
        self.last_ba: LocalBAStats | None = None
        self.on_map_changed = None  # callback (e.g. tracker.invalidate_local_map)
        self.timer = None  # StageTimer of the local_mapping and mp.* spans (System wires its own in)
        # the JAX mapper's counters of the asynchronous path, and ba_failed
        self.ba_submitted = 0
        self.ba_skipped = 0  # the solver was busy when a keyframe's window was due
        self.ba_resubmitted = 0  # freshest windows sent by tick() after a skip
        self.ba_stale = 0  # solves dropped: the map was corrected while they ran
        self.ba_failed = 0  # solves that came back with an error or were abandoned at a drain
        # solve wall ms (assembly excluded, read back included): warm solves,
        # and the same by (P, L, OL) rung; the solver's first solve of a rung
        # in cold_solve_ms; the solver's stage split of its last solve
        self.solve_ms: List[float] = []
        self.solve_ms_by_rung: Dict[tuple, List[float]] = {}
        self.cold_solve_ms: List[float] = []
        self.last_stage_ms = None

    def process(self, kf: KeyFrame):
        timer = self.timer
        with span("local_mapping", timer):
            self._kf_count += 1
            with span("mp.fuse_apply", timer):
                self._apply_pending_fuse()
            with span("mp.cull", timer):
                self._register_recent(kf)
                self._cull_recent(kf)
            if self.mono:
                with span("mp.triangulate", timer):
                    self._create_new_maplines(kf)
                    self._create_new_mappoints(kf)
            with span("mp.fuse_dispatch", timer):
                if self.cfg.fuse_defer:
                    self._dispatch_fuse_deferred(kf)
                else:
                    self._fuse_all(kf)
            with span("mp.covis", timer):
                self.map.update_connections(kf)
            with span("mp.ba", timer):
                if self._kf_count % self.cfg.ba_every == 0 and len(self.map.keyframes) >= 2:
                    if self.solver is not None:
                        # apply the previous keyframe's solve if it has finished, then
                        # submit this window; a busy solver skips it (tick() catches up)
                        self._poll_ba(blocking=False)
                        if self._ba_ctx is None:
                            self._submit_ba(kf.kid)
                        else:
                            self.ba_skipped += 1
                            self._ba_want_resubmit = True
                    else:
                        by_rung: Dict[tuple, List[float]] = {}
                        self.last_ba = local_bundle_adjustment(
                            self.map, kf.kid, self.cam, self.cfg.ba, device=self.device, solve_ms_by_rung=by_rung
                        )
                        for rung, ms in by_rung.items():
                            self.solve_ms_by_rung.setdefault(rung, []).extend(ms)
                            self.solve_ms.extend(ms)
            with span("mp.kf_cull", timer):
                if self.cfg.enable_kf_culling:
                    self._cull_keyframes(kf)
                if self.on_map_changed:
                    self.on_map_changed()

    # ---- the asynchronous local BA -----------------------------------------
    def _submit_ba(self, center_kid: int):
        """Assemble the window around ``center_kid`` on the host and submit
        it to the solver (the caller knows it is free)."""
        with span("local_ba.assemble"):
            prob, ctx = assemble_problem(self.map, center_kid, self.cam, self.cfg.ba, device="cpu")
        ctx["generation"] = self.map.generation  # a loop correction before the write-back makes it stale
        ctx["bucket"] = (int(prob.poses.shape[0]), int(prob.lines.shape[0]), int(prob.l_pose.shape[0]))
        ba = self.cfg.ba
        self._ba_req = self.solver.submit(problem_arrays(prob), ba.lm, ba.chi2_line, ba.chi2_point)
        self._ba_ctx = ctx
        self.ba_submitted += 1
        self._ba_want_resubmit = False

    def _poll_ba(self, blocking: bool, timeout: float = 1200.0):
        """Write back the in-flight solve if it has finished (``blocking``:
        once it has, waiting up to ``timeout`` s; past that the solve is
        abandoned, counted in ``ba_failed``, and the solver restarted, so that
        its late result cannot meet the next request)."""
        if self.solver is None or self._ba_ctx is None:
            return
        out = self.solver.poll(self._ba_req, timeout=0.0)
        t0 = time.perf_counter()
        while out is None and blocking and time.perf_counter() - t0 < timeout:
            step = min(30.0, max(0.1, timeout - (time.perf_counter() - t0)))
            out = self.solver.poll(self._ba_req, timeout=step)
        if out is None:
            if blocking:
                print(f"mapper: abandoned the in-flight BA solve after a {timeout:.0f} s drain", file=sys.stderr)
                self.ba_failed += 1
                self._ba_ctx, self._ba_req = None, -1
                self.solver.restart()
            return
        res, err = out
        ctx, self._ba_ctx = self._ba_ctx, None
        self._ba_req = -1
        if res is None:
            print(f"BA solver: the solve failed: {err}", file=sys.stderr)
            self.ba_failed += 1
            return
        if "solve_ms" in res:
            if res.get("warm", True):
                self.solve_ms.append(float(res["solve_ms"]))
                self.solve_ms_by_rung.setdefault(ctx.get("bucket", ()), []).append(float(res["solve_ms"]))
            else:
                self.cold_solve_ms.append(float(res["solve_ms"]))
            self.last_stage_ms = res.get("stage_ms")
        if ctx.get("generation", self.map.generation) != self.map.generation:
            # assembled before a loop correction: writing it back would undo it
            self.ba_stale += 1
            return
        with span("local_ba.apply"):
            self.last_ba = apply_result(self.map, self.cfg.ba, ctx, res)
        if self.on_map_changed:
            self.on_map_changed()

    def tick(self):
        """Between keyframes (once per tracked frame): apply a deferred
        fusion whose delay has passed, write back a finished solve, and
        after a skipped window submit the freshest one once the solver is
        free."""
        pending = self._fuse_pending
        if pending is not None and time.perf_counter() - pending[-1] >= self.cfg.fuse_apply_delay_s:
            self._apply_pending_fuse()
        if self._ba_ctx is not None:
            self._poll_ba(blocking=False)
        if self._ba_ctx is None and self._ba_want_resubmit and self.solver is not None and len(self.map.keyframes) >= 2:
            self._submit_ba(max(self.map.keyframes))
            self.ba_resubmitted += 1

    def finish(self, timeout: float = 1200.0):
        """Sequence end: apply a pending fusion and drain the in-flight
        solve, waiting up to ``timeout`` s for it."""
        self._apply_pending_fuse()
        self._poll_ba(blocking=True, timeout=timeout)

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

    # ---- new landmark triangulation (mono) ------------------------------
    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _K(self) -> np.ndarray:
        cam = self.cam
        return np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], np.float32)

    def _Kinv(self) -> np.ndarray:
        return np.linalg.inv(self._K())

    def _create_new_maplines(self, kf: KeyFrame):
        """Two-view line triangulation against the covisible keyframes: an
        angle-gated descriptor match of the free (unbound) lines, the planes'
        intersection, then the checks of :meth:`_validate_triangulations`,
        the plane-parallax floor and the optional depth band. Device work
        runs at the fixed feature capacity K, one read back per neighbour."""
        cfg = self.cfg
        neighbors = self.map.covisible_keyframes(kf.kid, cfg.triangulate_neighbors)
        f = kf.features
        free = (kf.line_ids < 0) & (f.valid > 0.5)
        if free.sum() == 0:
            return
        T0 = kf.T_cw
        fd = features_to_device(f, self.device)
        P0 = projection_matrix(self.cam, self._dev(T0))
        l0 = image_line_through(fd.endpoints[:, 0], fd.endpoints[:, 1])
        P0n, l0n = P0.cpu().numpy(), l0.cpu().numpy()
        # the median depth of this keyframe's bound landmarks: the depth band's reference
        ref_med_depth = None
        bound = kf.line_ids[kf.line_ids >= 0]
        st = self.map.lines
        if bound.size >= cfg.tri_depth_band_min_ref:
            alive_b = [int(l) for l in bound if st.alive[l]]
            if len(alive_b) >= cfg.tri_depth_band_min_ref:
                z = (st.endpoints[np.asarray(alive_b)] @ T0[:3, :3].T + T0[:3, 3])[..., 2]
                ref_med_depth = float(np.median(np.median(z, axis=-1)))
                if not np.isfinite(ref_med_depth) or ref_med_depth <= 0:
                    ref_med_depth = None
        a0 = f.endpoints
        # view 0's unit endpoint rays (host float32, as the JAX package forms them)
        rays = np.concatenate([a0, np.ones((a0.shape[0], 2, 1), np.float32)], axis=-1) @ self._Kinv().T
        rays = self._dev(rays / np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12))
        for nkid in neighbors:
            nkf = self.map.keyframes[nkid]
            nfree = (nkf.line_ids < 0) & (nkf.features.valid > 0.5)
            if nfree.sum() == 0:
                continue
            nd = features_to_device(nkf.features, self.device)
            pen = angle_penalty(fd.angle, nd.angle, 0.35)
            m = match_descriptors(
                fd.desc_bits, self._dev(free.astype(np.float32)), nd.desc_bits, self._dev(nfree.astype(np.float32)),
                cfg.tri_match, pen,
            )
            a1d = nd.endpoints[torch.clamp(m.idx, min=0)]  # (K, 2, 2)
            T1 = nkf.T_cw
            P1 = projection_matrix(self.cam, self._dev(T1))
            l1 = image_line_through(a1d[:, 0], a1d[:, 1])
            Lw = triangulate_plucker_two_view(P0, P1, l0, l1)
            # the lines in both cameras and their endpoints from view 0's rays
            L0 = plucker_transform(self._dev(T0), Lw)
            pts, s = line_ray_endpoints(L0, rays)
            mv, idx, Lw, L0, L1, pts, s, l1n, P1n = (
                x.cpu().numpy() for x in (m.valid, m.idx, Lw, L0, plucker_transform(self._dev(T1), Lw), pts, s, l1, P1)
            )
            mv = mv > 0.5
            if not mv.any():
                continue
            idx = np.maximum(idx, 0)
            a1 = nkf.features.endpoints[idx]
            # the plane-parallax gate: a low-parallax pair's planes nearly
            # coincide, and its intersection depth is noise (a line reprojects
            # onto itself at any depth, so the residual cannot catch it)
            pi0 = l0n @ P0n
            pi1 = l1n @ P1n
            n0 = pi0[:, :3] / np.maximum(np.linalg.norm(pi0[:, :3], axis=-1, keepdims=True), 1e-12)
            n1 = pi1[:, :3] / np.maximum(np.linalg.norm(pi1[:, :3], axis=-1, keepdims=True), 1e-12)
            cosang = np.abs(np.sum(n0 * n1, axis=-1))
            ok, ep3d = self._validate_triangulations(Lw, L0, L1, pts, s, a0, a1, T0, T1)
            ok &= cosang < np.cos(np.deg2rad(cfg.tri_line_min_parallax_deg))
            if ref_med_depth is not None and cfg.tri_depth_band is not None:
                cand_z = np.maximum((ep3d @ T0[:3, :3].T + T0[:3, 3])[..., 2], 1e-6)  # (K, 2) depths in view 0
                cand_med = np.median(cand_z, axis=-1)
                lo, hi = cfg.tri_depth_band
                ok &= (cand_med >= lo * ref_med_depth) & (cand_med <= hi * ref_med_depth)
            ok &= mv
            bits = f.desc_bits
            for s0 in np.nonzero(ok)[0]:
                s1 = int(idx[s0])
                if kf.line_ids[s0] >= 0 or nkf.line_ids[s1] >= 0:
                    continue
                lid = st.allocate(Lw[s0], ep3d[s0], bits[s0], kf.kid)
                st.add_observation(lid, kf, int(s0))
                st.add_observation(lid, nkf, s1)
                self._recent[lid] = kf.kid
            free = (kf.line_ids < 0) & (f.valid > 0.5)

    def _validate_triangulations(self, Lw, L0, L1, pts, s, a0, a1, T0, T1):
        """Reprojection in both views, cheirality, depth bounds in both views,
        on the host over the capacity K: ``L0`` / ``L1`` the lines in the two
        cameras, ``pts`` / ``s`` view 0's endpoint-ray points and ray
        parameters. Returns (ok (K,), world endpoints (K, 2, 3), 0 where not
        ok)."""
        cfg = self.cfg
        K = Lw.shape[0]
        KL = line_projection_matrix(self.cam).numpy()
        # the parallax floor is implicit here: near-parallel planes give |v| ~ 0
        ok = np.linalg.norm(Lw[:, 3:], axis=-1) > 1e-7
        with np.errstate(divide="ignore", invalid="ignore"):
            for Lc, a in ((L0, a0), (L1, a1)):
                l = Lc[:, :3] @ KL.T  # (K, 3) projected image lines
                den = np.hypot(l[:, 0], l[:, 1])
                ok &= den > 1e-9
                den = np.maximum(den, 1e-9)
                for e in range(2):
                    d = np.abs(l[:, 0] * a[:, e, 0] + l[:, 1] * a[:, e, 1] + l[:, 2]) / den
                    ok &= d <= cfg.tri_max_reproj_px
            z = pts[..., 2]
            ok &= np.all(s > 0, axis=-1)
            ok &= np.all(z >= cfg.tri_min_depth, axis=-1)
            ok &= np.all(z <= cfg.tri_max_depth, axis=-1)
            ok &= np.isfinite(pts).all(axis=(1, 2))
            # cheirality and depth bounds in the second view too
            T10 = (T1 @ np.linalg.inv(T0)).astype(np.float32)
            z1 = (pts @ T10[:3, :3].T + T10[:3, 3])[..., 2]
            ok &= np.all(z1 >= cfg.tri_min_depth, axis=-1)
            ok &= np.all(z1 <= cfg.tri_max_depth, axis=-1)
        Twc = np.linalg.inv(T0)
        ep3d = (pts @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
        return ok, np.where(ok[:, None, None], ep3d, 0.0).astype(np.float32)

    def _create_new_mappoints(self, kf: KeyFrame):
        """Two-view corner triangulation against the covisible keyframes: an
        epipolar-gated BRIEF match, DLT triangulation, then depth,
        reprojection and parallax checks on the host. A match to a corner
        already bound adds an observation of that landmark."""
        pf = kf.point_features
        if pf is None or kf.point_ids is None:
            return
        cfg = self.cfg
        pst = self.map.points
        uv0 = pf.uv
        T0 = kf.T_cw
        pd = point_features_to_device(pf, self.device)
        P0 = projection_matrix(self.cam, self._dev(T0))
        Kmat = self._K()
        Kinv = np.linalg.inv(Kmat)
        C0 = (-T0[:3, :3].T @ T0[:3, 3]).astype(np.float32)
        cos_max = np.cos(np.deg2rad(cfg.tri_min_parallax_deg))
        for nkid in self.map.covisible_keyframes(kf.kid, cfg.triangulate_neighbors):
            free = (kf.point_ids < 0) & (pf.valid > 0.5)
            if free.sum() == 0:
                return
            nkf = self.map.keyframes[nkid]
            npf = nkf.point_features
            if npf is None or nkf.point_ids is None:
                continue
            # corners bound to landmarks stay eligible: they add an observation
            nfree = npf.valid > 0.5
            if nfree.sum() == 0:
                continue
            T1 = nkf.T_cw
            T10 = T1 @ np.linalg.inv(T0)
            tx = np.array(
                [[0.0, -T10[2, 3], T10[1, 3]], [T10[2, 3], 0.0, -T10[0, 3]], [-T10[1, 3], T10[0, 3], 0.0]], np.float32
            )
            F = (Kinv.T @ (tx @ T10[:3, :3]) @ Kinv).astype(np.float32)
            npd = point_features_to_device(npf, self.device)
            pen = epipolar_penalty(pd.uv, npd.uv, self._dev(F), cfg.tri_epipolar_px)
            m = match_descriptors(
                pd.desc_bits, self._dev(free.astype(np.float32)), npd.desc_bits, self._dev(nfree.astype(np.float32)),
                cfg.tri_point_match, pen,
            )
            P1 = projection_matrix(self.cam, self._dev(T1))
            X = triangulate_points(P0, P1, pd.uv, npd.uv[torch.clamp(m.idx, min=0)])  # (K, 3) world
            mv, idx, X = (x.cpu().numpy() for x in (m.valid, m.idx, X))
            mv = mv > 0.5
            if not mv.any():
                continue
            idx = np.maximum(idx, 0)
            uv1 = npf.uv[idx]  # (K, 2)
            Xh = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], -1)
            ok = mv & np.isfinite(X).all(axis=-1)
            with np.errstate(divide="ignore", invalid="ignore"):
                for T, uv in ((T0, uv0), (T1, uv1)):
                    xc = Xh @ T.T[:, :3]  # (K, 3) camera coordinates
                    z = xc[:, 2]
                    ok &= (z > cfg.tri_min_depth) & (z < cfg.tri_max_depth)
                    pr = xc @ Kmat.T
                    pru = pr[:, :2] / np.maximum(pr[:, 2:3], 1e-9)
                    ok &= np.linalg.norm(pru - uv, axis=-1) <= cfg.tri_max_reproj_px
                C1 = (-T1[:3, :3].T @ T1[:3, 3]).astype(np.float32)
                r0 = X - C0
                r1 = X - C1
                cosang = np.sum(r0 * r1, axis=-1) / np.maximum(np.linalg.norm(r0, axis=-1) * np.linalg.norm(r1, axis=-1), 1e-12)
                ok &= cosang < cos_max  # enough parallax
            bits = pf.desc_bits
            for s0 in np.nonzero(ok)[0]:
                s1 = int(idx[s0])
                if kf.point_ids[s0] >= 0:
                    continue
                existing = int(nkf.point_ids[s1])
                if existing >= 0:
                    if pst.alive[existing]:
                        pst.add_observation(existing, kf, int(s0))
                    continue
                pid = pst.allocate(X[s0], bits[s0], kf.kid)
                pst.add_observation(pid, kf, int(s0))
                pst.add_observation(pid, nkf, s1)
                self._recent_pts[pid] = kf.kid

    # ---- duplicate fusion -----------------------------------------------
    def _fuse_dispatch(self, kf: KeyFrame):
        """Both families' fusion searches; (line ids, point ids, matches as
        one device tensor (2, n): valid, then index), or None when neither
        has older landmarks."""
        ld, pd = self._fuse_lines_dispatch(kf), self._fuse_points_dispatch(kf)
        live = [d for d in (ld, pd) if d is not None]
        if not live:
            return None
        both = torch.cat([torch.stack([m.valid.to(torch.int64), m.idx]) for m, _ in live], dim=1)
        return (None if ld is None else ld[1]), (None if pd is None else pd[1]), both

    def _fuse_apply(self, kf: KeyFrame, line_ids, point_ids, both: np.ndarray):
        """Bind missed observations and merge duplicates from the matches."""
        n = 0
        for ids, apply in ((line_ids, self._fuse_lines_apply), (point_ids, self._fuse_points_apply)):
            if ids is not None:
                k = len(ids)
                apply(kf, ids, both[0, n : n + k] > 0, both[1, n : n + k])
                n += k

    def _fuse_all(self, kf: KeyFrame):
        """Match older local-map lines and points into this keyframe (one
        read back of both families' matches); bind missed observations and
        merge duplicates."""
        out = self._fuse_dispatch(kf)
        if out is not None:
            line_ids, point_ids, both = out
            self._fuse_apply(kf, line_ids, point_ids, both.cpu().numpy())

    def _dispatch_fuse_deferred(self, kf: KeyFrame):
        """Dispatch the fusion searches and start their matches' copy to
        pinned host memory behind a CUDA event; the apply runs later."""
        out = self._fuse_dispatch(kf)
        if out is None:
            return
        line_ids, point_ids, both = out
        ready = None
        if both.is_cuda:
            host = torch.empty(both.shape, dtype=both.dtype, pin_memory=True)
            host.copy_(both, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(both.device))
            both = host
        self._fuse_pending = (kf, line_ids, point_ids, both, ready, self.map.generation, time.perf_counter())

    def _apply_pending_fuse(self):
        """Apply the deferred fusion, unless its keyframe was culled or the
        map corrected since the dispatch (its matches are then stale)."""
        pending, self._fuse_pending = self._fuse_pending, None
        if pending is None:
            return
        kf, line_ids, point_ids, both, ready, generation, _ = pending
        if kf.kid not in self.map.keyframes or kf.is_bad or generation != self.map.generation:
            return
        if ready is not None:
            ready.synchronize()  # the copy, not the whole device
        self._fuse_apply(kf, line_ids, point_ids, both.numpy())
        self.map.update_connections(kf)
        if self.on_map_changed:
            self.on_map_changed()

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

        m = search_by_projection(
            self._dev(kf.T_cw),
            self._dev(st.endpoints[ids]),
            self._dev(st.desc_bits[ids].astype(np.int64)),
            self._dev(validf),
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
        pr = Xc @ self._K().T
        uv = pr[:, :2] / np.maximum(pr[:, 2:3], 1e-9)
        validf *= (Xc[:, 2] > 0.05).astype(np.float32)

        pf = point_features_to_device(kf.point_features, self.device)
        pen = midpoint_radius_penalty(self._dev(uv.astype(np.float32)), pf.uv, self.cfg.fuse_search.radius)
        m = match_descriptors(
            self._dev(pst.desc_bits[ids].astype(np.int64)), self._dev(validf), pf.desc_bits, pf.valid, self.cfg.tri_point_match, pen
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
