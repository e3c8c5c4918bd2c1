"""Loop closing: the keyframe database, detection, SE(3) / Sim(3)
correction, the essential graph and global BA (torch).

Counterpart of ``tpuslam.backend.loop_closing``. The keyframe database
scores the current keyframe's binary line descriptors (and, with
``point_slots``, its BRIEF corner descriptors) against every stored
keyframe, vocabulary-free: the JAX package computes the Hamming distances
as a +-1 matmul on the MXU, here they are XOR + popcount on int64 words, as
in ``kernels.match``; both are exact integers, so the scores are equal.

``LoopCloser`` runs at every keyframe, as in the JAX package: detection
against the database with a consistency window; a rigid (stereo) or
similarity (mono) transform from matched line midpoints and points by
numpy RANSAC + Umeyama, refined by the pose LM on the device; then the
essential graph (``backend.pose_graph``) on the device, the keyframe and
landmark correction on the host, and global BA (``backend.global_ba``).
Per event it records its stage times (``timings``) and per closure the
device problems it solved (``closures``). The JAX package's BA worker
subprocess is not carried over.
"""

from __future__ import annotations

import logging
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.backend.global_ba import GlobalBAConfig, global_bundle_adjustment
from tpuslam_torch.backend.pose_graph import (
    PoseGraphConfig,
    PoseGraphProblem,
    Sim3GraphProblem,
    optimize_pose_graph,
    optimize_pose_graph_sim3,
)
from tpuslam_torch.backend.pose_opt import PoseOptConfig, pose_optimize
from tpuslam_torch.device import resolve_device
from tpuslam_torch.eval.ate import align_umeyama
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.geometry.plucker import plucker_transform
from tpuslam_torch.geometry.sim3 import se3_from_sim3
from tpuslam_torch.kernels.match import MatchParams, hamming_distance_matrix, match_descriptors
from tpuslam_torch.slammap.map import KeyFrame, SlamMap

_log = logging.getLogger(__name__)


def _db_scores(
    cur_bits: torch.Tensor,  # (K, W) int64 words
    cur_valid: torch.Tensor,  # (K,)
    db_bits: torch.Tensor,  # (N, K, W) int64 words
    db_valid: torch.Tensor,  # (N, K) f32; all-zero rows are empty slots
    tau: float = 60.0,
    chunk: int = 8,
) -> torch.Tensor:
    """Per-keyframe similarity: the number of valid current descriptors whose
    nearest valid neighbour in that keyframe lies within Hamming distance
    tau - 1. (N,) int32. Keyframes go ``chunk`` at a time, which bounds the
    (K, chunk * K, W) XOR intermediate."""
    N, K, W = db_bits.shape
    cur_on = cur_valid > 0.5
    scores = []
    for s in range(0, N, chunk):
        bits = db_bits[s : s + chunk]
        n = bits.shape[0]
        D = hamming_distance_matrix(cur_bits, bits.reshape(n * K, W))  # (K, n*K)
        D = D + ((db_valid[s : s + chunk].reshape(-1) < 0.5).to(D.dtype) * 10_000)[None, :]
        best = torch.min(D.reshape(K, n, K), dim=-1).values  # (K, n)
        scores.append(torch.sum((best <= tau - 1) & cur_on[:, None], dim=0))
    return torch.cat(scores).to(torch.int32)


def _words(bits) -> np.ndarray:
    """uint32 descriptor words as numpy, from numpy or an int64 tensor."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return np.asarray(bits).astype(np.uint32)


def _flags(valid) -> np.ndarray:
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    return np.asarray(valid, np.float32)


class KeyFrameDatabase:
    """Per-keyframe binary descriptors in a device tensor, scored densely.

    Storage is a fixed-capacity tensor that doubles when full; culled
    keyframes leave tombstone rows, compacted once they outnumber the live
    rows."""

    def __init__(self, capacity_hint: int = 64, point_slots: int = 0, device="cuda"):
        self._cap0 = max(8, int(capacity_hint))
        self.point_slots = int(point_slots)
        self.device = resolve_device(device)
        self.clear()

    def clear(self):
        self.kids: List[Optional[int]] = []  # row -> kid; None = tombstone
        self._bits = None  # (C, K, W) int64 words
        self._valid = None  # (C, K) f32

    def __len__(self):
        return sum(1 for k in self.kids if k is not None)

    def _ensure_capacity(self, K: int, W: int):
        if self._bits is None:
            C = self._cap0
            self._bits = torch.zeros((C, K, W), dtype=torch.int64, device=self.device)
            self._valid = torch.zeros((C, K), dtype=torch.float32, device=self.device)
        elif len(self.kids) >= self._bits.shape[0]:
            self._bits = torch.cat([self._bits, torch.zeros_like(self._bits)])
            self._valid = torch.cat([self._valid, torch.zeros_like(self._valid)])

    def _with_points(self, bits, valid, p_bits, p_valid):
        """Line rows (K, W) uint32 and (K,) -> with ``point_slots`` corner
        rows appended (padded or cut to point_slots), as int64 words."""
        bits, valid = _words(bits), _flags(valid)
        S = self.point_slots
        if S:
            pb = np.zeros((S, bits.shape[1]), np.uint32)
            pv = np.zeros(S, np.float32)
            if p_bits is not None:
                p_bits = _words(p_bits)[:S]
                pb[: p_bits.shape[0]] = p_bits
                pv[: p_bits.shape[0]] = _flags(p_valid)[:S]
            bits, valid = np.concatenate([bits, pb]), np.concatenate([valid, pv])
        return bits.astype(np.int64), valid

    def add(self, kf: KeyFrame):
        pf = getattr(kf, "point_features", None)
        bits, valid = self._with_points(
            kf.features.desc_bits, kf.features.valid, None if pf is None else pf.desc_bits, None if pf is None else pf.valid
        )
        K, W = bits.shape
        self._ensure_capacity(K, W)
        idx = len(self.kids)
        self.kids.append(kf.kid)
        self._bits[idx] = torch.from_numpy(bits).to(self.device)
        self._valid[idx] = torch.from_numpy(valid).to(self.device)

    def remove(self, kid: int):
        if kid in self.kids:
            i = self.kids.index(kid)
            self.kids[i] = None
            self._valid[i] = 0.0
            self._maybe_compact()

    def _maybe_compact(self):
        """Compact tombstoned rows once they outnumber live rows (and the
        dead weight exceeds a bucket's worth): dead rows still cost work in
        every query."""
        dead = sum(1 for k in self.kids if k is None)
        live = len(self.kids) - dead
        if dead <= max(live, self._cap0 - 1):
            return
        keep = [i for i, k in enumerate(self.kids) if k is not None]
        self.kids = [self.kids[i] for i in keep]
        C = self._cap0
        while C < len(keep) + self._cap0:  # headroom: adds must not regrow at once
            C *= 2
        keep_t = torch.tensor(keep, dtype=torch.int64, device=self.device)
        bits = torch.zeros((C,) + self._bits.shape[1:], dtype=self._bits.dtype, device=self.device)
        valid = torch.zeros((C,) + self._valid.shape[1:], dtype=self._valid.dtype, device=self.device)
        bits[: len(keep)] = self._bits[keep_t]
        valid[: len(keep)] = self._valid[keep_t]
        self._bits, self._valid = bits, valid

    def query_bits(self, bits, valid, p_bits=None, p_valid=None) -> Dict[int, int]:
        """Scores of every stored keyframe against line descriptors ``bits``
        (K, W) (uint32 words as numpy, or int64 words as a tensor) and
        ``valid`` (K,), and with point_slots the corner descriptors
        ``p_bits``, ``p_valid``."""
        if len(self) == 0:
            return {}
        bits, valid = self._with_points(bits, valid, p_bits, p_valid)
        cur_bits = torch.from_numpy(bits).to(self.device)
        cur_valid = torch.from_numpy(valid).to(self.device)
        n = len(self.kids)  # rows past the last added one are empty: not scored
        scores = _db_scores(cur_bits, cur_valid, self._bits[:n], self._valid[:n]).cpu().numpy()
        return {k: int(scores[i]) for i, k in enumerate(self.kids) if k is not None}

    def query(self, kf: KeyFrame) -> Dict[int, int]:
        pf = getattr(kf, "point_features", None)
        return self.query_bits(
            kf.features.desc_bits, kf.features.valid, None if pf is None else pf.desc_bits, None if pf is None else pf.valid
        )


@dataclass
class LoopConfig:
    min_kid_gap: int = 25  # a candidate must be this many keyframes old
    min_score: int = 40  # absolute match-count floor
    # a candidate must reach score_ratio x the MINIMUM score among the
    # strongly covisible keyframes (false positives are left to the
    # consistency gate and the geometric RANSAC)
    score_ratio: float = 1.0
    covis_exclude_weight: int = 10  # only strongly covisible keyframes are excluded as candidates
    consistency: int = 2  # supporting detections of the same region required
    # window (in keyframe ids) over which supporting detections accumulate;
    # a miss ages evidence out instead of erasing it
    consistency_window: int = 8
    match: MatchParams = field(default_factory=lambda: MatchParams(max_dist=80.0, ratio=0.8))
    ransac_iters: int = 200
    ransac_inlier_m: float = 0.3
    min_inliers: int = 8
    # mono: a Sim(3) estimate asking for more than this factor of scale
    # change (either way) is taken for a mis-estimate and rejected
    max_scale_correction: float = 2.5
    refine: bool = True  # the pose LM over line / point reprojections after RANSAC
    refine_cap: int = 256  # fixed capacity per landmark family
    covis_edge_weight: int = 50
    pg: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    run_global_ba: bool = True  # full-map BA after the essential graph
    # GlobalBAConfig override (None = defaults): bounds the bucket ladder; a
    # map that overflows it keeps the essential-graph correction (gba_skipped)
    gba_cfg: object = None


class LoopCloser:
    """Loop detection and correction at every keyframe, on ``device``."""

    def __init__(
        self,
        slam_map: SlamMap,
        cam: Intrinsics,
        cfg: LoopConfig | None = None,
        db: KeyFrameDatabase | None = None,
        mono: bool = False,
        device="cuda",
    ):
        self.map = slam_map
        self.cam = cam
        self.cfg = cfg if cfg is not None else LoopConfig()  # its own: callers may edit it
        self.device = resolve_device(device)
        # `is not None`, not `db or ...`: an empty database has len 0 and is
        # falsy, and the System's shared one must not be replaced by a private one
        self.db = db if db is not None else KeyFrameDatabase(device=self.device)
        self.mono = mono  # mono loops carry scale drift: Sim(3) correction
        self._consistent: List[Tuple[int, int]] = []  # (keyframe kid, candidate kid)
        self.closed_loops: List[Tuple[int, int]] = []
        self.gba_skipped: int = 0  # maps too large for the global-BA buckets
        # per process() call: kid, detect_ms, candidate and, where _close ran,
        # its stage times; per successful closure: the device problems solved
        self.timings: List[dict] = []
        self.closures: List[dict] = []

    # ---- per-keyframe entry ----------------------------------------------
    def process(self, kf: KeyFrame) -> bool:
        """True if a loop was closed (the map's poses changed)."""
        t0 = time.perf_counter()
        cand = self._detect(kf)
        ev = dict(kid=kf.kid, detect_ms=(time.perf_counter() - t0) * 1e3, candidate=cand, closed=False)
        self.timings.append(ev)
        self.db.add(kf)
        self._consistent = [(k, c) for (k, c) in self._consistent if kf.kid - k <= self.cfg.consistency_window]
        if cand is None:
            return False
        self._consistent.append((kf.kid, cand))
        support = [c for (_, c) in self._consistent if abs(c - cand) <= 10]
        if len(support) < self.cfg.consistency:
            return False
        ok = self._close(kf, cand, ev)
        self._consistent.clear()
        return ok

    # ---- detection -------------------------------------------------------
    def _detect(self, kf: KeyFrame) -> Optional[int]:
        scores = self.db.query(kf)
        if not scores:
            return None
        covis = set(self.map.covisible_keyframes(kf.kid, min_weight=self.cfg.covis_exclude_weight))
        # the baseline is the MINIMUM similarity among the covisible neighbours
        covis_scores = [s for k, s in scores.items() if k in covis]
        baseline = min(covis_scores) if covis_scores else 0
        best_kid, best_score = None, 0
        for k, s in scores.items():
            if k in covis or kf.kid - k < self.cfg.min_kid_gap:
                continue
            if k not in self.map.keyframes:
                continue
            if s > best_score:
                best_kid, best_score = k, s
        if best_kid is None:
            return None
        if best_score < max(self.cfg.min_score, self.cfg.score_ratio * baseline):
            return None
        return best_kid

    # ---- SE(3) / Sim(3) estimate ---------------------------------------------
    def _match(self, feats_a, valid_a, feats_b, valid_b):
        """(valid, idx) numpy of the mutual-best Hamming matches a -> b."""
        m = match_descriptors(
            torch.from_numpy(_words(feats_a.desc_bits).astype(np.int64)).to(self.device),
            torch.from_numpy(valid_a.astype(np.float32)).to(self.device),
            torch.from_numpy(_words(feats_b.desc_bits).astype(np.int64)).to(self.device),
            torch.from_numpy(valid_b.astype(np.float32)).to(self.device),
            self.cfg.match,
        )
        return m.valid.cpu().numpy(), m.idx.cpu().numpy()

    def _compute_se3(self, kf: KeyFrame, cand: KeyFrame) -> Optional[Tuple[float, np.ndarray]]:
        """(s, T_corr): candidate camera -> current camera.

        RANSAC + Umeyama over matched 3D correspondences (line-landmark
        endpoint midpoints and, with the hybrid front end, point landmarks);
        rigid for stereo (s = 1), a similarity for mono. Then the pose LM of
        the current keyframe's detections against the candidate side's
        landmarks (``_refine_loop_T``)."""
        st = self.map.lines
        va = (np.asarray(kf.features.valid) > 0.5) & (kf.line_ids >= 0)
        vb = (np.asarray(cand.features.valid) > 0.5) & (cand.line_ids >= 0)
        mv, midx = self._match(kf.features, va, cand.features, vb)
        pts_cur, pts_cand = [], []
        line_pairs = []  # (kf feature slot, candidate landmark id)
        for s0 in np.nonzero(mv)[0]:
            l0 = int(kf.line_ids[s0])
            l1 = int(cand.line_ids[midx[s0]])
            if l0 < 0 or l1 < 0 or not (st.alive[l0] and st.alive[l1]):
                continue
            mid0 = st.endpoints[l0].mean(axis=0)
            mid1 = st.endpoints[l1].mean(axis=0)
            pts_cur.append(kf.T_cw[:3, :3] @ mid0 + kf.T_cw[:3, 3])
            pts_cand.append(cand.T_cw[:3, :3] @ mid1 + cand.T_cw[:3, 3])
            line_pairs.append((int(s0), l1))
        point_pairs = []  # (kf corner slot, candidate landmark id)
        if kf.point_features is not None and cand.point_features is not None and kf.point_ids is not None and cand.point_ids is not None:
            pst = self.map.points
            pva = (np.asarray(kf.point_features.valid) > 0.5) & (kf.point_ids >= 0)
            pvb = (np.asarray(cand.point_features.valid) > 0.5) & (cand.point_ids >= 0)
            pmv, pmidx = self._match(kf.point_features, pva, cand.point_features, pvb)
            for s0 in np.nonzero(pmv)[0]:
                p0 = int(kf.point_ids[s0])
                p1 = int(cand.point_ids[pmidx[s0]])
                if p0 < 0 or p1 < 0 or not (pst.alive[p0] and pst.alive[p1]):
                    continue
                pts_cur.append(kf.T_cw[:3, :3] @ pst.xyz[p0] + kf.T_cw[:3, 3])
                pts_cand.append(cand.T_cw[:3, :3] @ pst.xyz[p1] + cand.T_cw[:3, 3])
                point_pairs.append((int(s0), p1))
        if len(pts_cur) < self.cfg.min_inliers:
            return None
        A = np.stack(pts_cand)  # candidate-camera coordinates
        B = np.stack(pts_cur)  # current-camera coordinates
        rng = np.random.default_rng(kf.kid)
        best_inl, best_T = 0, None
        n = len(A)
        for _ in range(self.cfg.ransac_iters):
            idx = rng.choice(n, size=3, replace=False)
            try:
                s, R, t = align_umeyama(A[idx], B[idx], with_scale=self.mono)
            except np.linalg.LinAlgError:
                continue
            err = np.linalg.norm(s * (R @ A.T).T + t - B, axis=1)
            inl = err < self.cfg.ransac_inlier_m
            if inl.sum() > best_inl:
                best_inl = int(inl.sum())
                best_T = inl
        if best_T is None or best_inl < self.cfg.min_inliers:
            return None
        s, R, t = align_umeyama(A[best_T], B[best_T], with_scale=self.mono)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        if self.cfg.refine:
            refined = self._refine_loop_T(kf, cand, float(s), T, line_pairs, point_pairs)
            if refined is not None:
                T = refined
        return float(s), T

    def _refine_loop_T(self, kf: KeyFrame, cand: KeyFrame, s: float, T_seed: np.ndarray, line_pairs, point_pairs):
        """Pose LM of the current keyframe against the candidate side's
        landmarks, in the candidate camera's frame scaled by s, over the
        current keyframe's detected endpoints and corners (``refine_cap``
        rows per family). None if it keeps fewer than ``min_inliers``."""
        st = self.map.lines
        pst = self.map.points
        C = int(self.cfg.refine_cap)
        l_pl = np.zeros((C, 6), np.float32)
        l_ep = np.zeros((C, 2, 2), np.float32)
        l_sig = np.ones(C, np.float32)
        l_val = np.zeros(C, np.float32)
        ep2d = np.asarray(kf.features.endpoints)
        sig = np.asarray(kf.features.sigma)
        Tc = torch.from_numpy(np.asarray(cand.T_cw, np.float32))
        pairs = line_pairs[:C]
        if pairs:
            # world -> candidate camera, then the frame scaled: (n, v) -> (s n, v)
            Lc = plucker_transform(Tc, torch.from_numpy(np.stack([st.plucker[l1] for _, l1 in pairs]))).numpy()
        for i, (s0, _) in enumerate(pairs):
            l_pl[i, :3] = s * Lc[i, :3]
            l_pl[i, 3:] = Lc[i, 3:]
            l_ep[i] = ep2d[s0]
            l_sig[i] = max(float(sig[s0]), 1e-3)
            l_val[i] = 1.0
        p_xyz = np.zeros((C, 3), np.float32)
        p_uv = np.zeros((C, 2), np.float32)
        p_val = np.zeros(C, np.float32)
        if point_pairs and kf.point_features is not None:
            Tcn = np.asarray(cand.T_cw)
            uv2d = np.asarray(kf.point_features.uv)
            for i, (s0, p1) in enumerate(point_pairs[:C]):
                p_xyz[i] = s * (Tcn[:3, :3] @ pst.xyz[p1] + Tcn[:3, 3])
                p_uv[i] = uv2d[s0]
                p_val[i] = 1.0

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

        # the point family is always passed, as the JAX package passes it
        # (its IRLS weights are per family: backend.pose_opt._family_norm)
        res = pose_optimize(
            dev(T_seed), dev(l_pl), dev(l_ep), dev(l_val), self.cam, PoseOptConfig(), l_sigma=dev(l_sig),
            points=dev(p_xyz), p_uv=dev(p_uv), p_valid=dev(p_val),
        )
        out = torch.cat([res.pose.reshape(-1), res.num_inliers.to(res.pose.dtype).reshape(1)]).cpu().numpy()
        if int(out[16]) < self.cfg.min_inliers:
            return None  # the refinement collapsed: keep the RANSAC estimate
        return out[:16].reshape(4, 4).astype(np.float32)

    # ---- correction --------------------------------------------------------
    def _close(self, kf: KeyFrame, cand_kid: int, ev: dict | None = None) -> bool:
        ev = {} if ev is None else ev
        cand = self.map.keyframes.get(cand_kid)
        if cand is None:
            return False
        t0 = time.perf_counter()
        res = self._compute_se3(kf, cand)
        ev["compute_se3_ms"] = (time.perf_counter() - t0) * 1e3
        if res is None:
            return False
        s_corr, T_corr = res
        mx = self.cfg.max_scale_correction
        if not (1.0 / mx <= s_corr <= mx):
            print(f"loop closure rejected: implausible scale correction {s_corr:.3f} (gate {1 / mx:.2f}..{mx:.2f})", file=sys.stderr)
            return False

        t0 = time.perf_counter()
        kids = self.map.all_keyframe_ids()
        pos = {k: i for i, k in enumerate(kids)}
        old_poses = {k: self.map.keyframes[k].T_cw.copy() for k in kids}
        # the current keyframe's corrected pose: S_cw_new = S_corr @ T_cand_cw
        # (rigid for stereo, where s_corr == 1)
        S_corr = np.eye(4, dtype=np.float32)
        S_corr[:3, :3] = np.float32(s_corr) * T_corr[:3, :3]
        S_corr[:3, 3] = T_corr[:3, 3]
        T_kf_new = (S_corr @ cand.T_cw).astype(np.float32)

        # ---- essential graph: spanning tree, loop edges, strong covisibility
        E, meas, weights = [], [], []
        for kid in kids:
            k = self.map.keyframes[kid]
            if k.parent is not None and k.parent in pos:
                E.append((pos[kid], pos[k.parent]))
                meas.append(old_poses[kid] @ np.linalg.inv(old_poses[k.parent]))
                weights.append(100.0)
            for le in k.loop_edges:
                if le in pos and le < kid:
                    E.append((pos[kid], pos[le]))
                    meas.append(old_poses[kid] @ np.linalg.inv(old_poses[le]))
                    weights.append(100.0)
            for other, w in self.map.covis.get(kid, {}).items():
                if other in pos and other < kid and w >= self.cfg.covis_edge_weight:
                    E.append((pos[kid], pos[other]))
                    meas.append(old_poses[kid] @ np.linalg.inv(old_poses[other]))
                    weights.append(float(w) / 10.0)
        # the loop edge: the measured relative pose from T_corr
        E.append((pos[kf.kid], pos[cand_kid]))
        meas.append(T_kf_new @ np.linalg.inv(old_poses[cand_kid]))
        weights.append(200.0)

        P = len(kids)
        poses0 = np.stack([old_poses[k] for k in kids])
        poses0[pos[kf.kid]] = T_kf_new  # seed the current keyframe at its corrected pose
        pose_free = np.ones(P, np.float32)
        pose_free[pos[cand_kid]] = 0.0  # trust the loop side
        pose_free[pos[kids[0]]] = 0.0  # gauge
        # (P, E) padded to powers of two from 16 and 64: pad poses are the
        # identity and fixed, pad edges invalid, both masked exactly
        nE = len(E)
        Pc = 16
        while Pc < P:
            Pc *= 2
        Ec = 64
        while Ec < nE:
            Ec *= 2
        poses_pad = np.tile(np.eye(4, dtype=np.float32), (Pc, 1, 1))
        poses_pad[:P] = poses0
        free_pad = np.zeros(Pc, np.float32)
        free_pad[:P] = pose_free
        e_i = np.zeros(Ec, np.int32)
        e_j = np.zeros(Ec, np.int32)
        e_i[:nE] = [e[0] for e in E]
        e_j[:nE] = [e[1] for e in E]
        e_meas = np.tile(np.eye(4, dtype=np.float32), (Ec, 1, 1))
        e_meas[:nE] = np.stack(meas).astype(np.float32)
        e_valid = np.zeros(Ec, np.float32)
        e_valid[:nE] = 1.0
        e_weight = np.ones(Ec, np.float32)
        e_weight[:nE] = weights

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        args = [dev(a) for a in (poses_pad, free_pad, e_i, e_j, e_meas, e_valid, e_weight)]
        if self.mono:
            # tree and covisibility edges are scale-1 similarities of the old
            # poses; the loop edge carries s_corr
            prob = Sim3GraphProblem(*args)
            out, _ = optimize_pose_graph_sim3(prob, self.cfg.pg)
            both = torch.stack([out[:P], se3_from_sim3(out[:P])]).cpu().numpy()  # one read back
            new_sims, new_se3 = both[0], both[1]
        else:
            prob = PoseGraphProblem(*args)
            out, _ = optimize_pose_graph(prob, self.cfg.pg)
            new_sims = new_se3 = out[:P].cpu().numpy()
        ev["essential_graph_ms"] = (time.perf_counter() - t0) * 1e3
        ev["graph_size"] = (P, nE, Pc, Ec)
        record = dict(kid=kf.kid, candidate=cand_kid, s=s_corr, T_corr=T_corr.copy(), pg=(prob, out))

        # ---- write back and landmark correction (host numpy): per keyframe
        # the world_old -> world_new similarity C_k = S_new_k^-1 @ S_old_k
        t0 = time.perf_counter()
        corrections = {}
        for kid in kids:
            self.map.keyframes[kid].T_cw = new_se3[pos[kid]].astype(np.float32)
            corrections[kid] = (np.linalg.inv(new_sims[pos[kid]]) @ old_poses[kid]).astype(np.float32)

        st = self.map.lines
        lids, refs = [], []
        for lid in st.live_ids():
            ref = int(st.first_kf[lid])
            if ref not in corrections:
                obs_k = next(iter(st.obs.get(int(lid), {})), None)
                if obs_k is None or obs_k not in corrections:
                    continue
                ref = obs_k
            lids.append(int(lid))
            refs.append(ref)
        if lids:
            lids_a = np.asarray(lids)
            C = np.stack([corrections[r] for r in refs])  # (M, 4, 4) similarities
            ep = st.endpoints[lids_a]  # p' = (s R) p + t
            st.endpoints[lids_a] = np.einsum("mij,mkj->mki", C[:, :3, :3], ep) + C[:, None, :3, 3]
            # Pluecker under (s, R, t): v' = R v, n' = s R n + t x R v
            sC = np.cbrt(np.maximum(np.linalg.det(C[:, :3, :3]), 1e-12))
            Rc = C[:, :3, :3] / sC[:, None, None]
            L = st.plucker[lids_a]
            Rv = np.einsum("mij,mj->mi", Rc, L[:, 3:])
            Rn = np.einsum("mij,mj->mi", Rc, L[:, :3])
            n_new = sC[:, None] * Rn + np.cross(C[:, :3, 3], Rv)
            st.plucker[lids_a] = np.concatenate([n_new, Rv], axis=-1)

        # point landmarks get the same correction from their reference keyframe
        pst = self.map.points
        qids, qrefs = [], []
        for qid in pst.live_ids():
            ref = int(pst.first_kf[qid])
            if ref not in corrections:
                obs_k = next(iter(pst.obs.get(int(qid), {})), None)
                if obs_k is None or obs_k not in corrections:
                    continue
                ref = obs_k
            qids.append(int(qid))
            qrefs.append(ref)
        if qids:
            qids_a = np.asarray(qids)
            Cq = np.stack([corrections[r] for r in qrefs])
            xyz = pst.xyz[qids_a]
            pst.xyz[qids_a] = (np.einsum("mij,mj->mi", Cq[:, :3, :3], xyz) + Cq[:, :3, 3]).astype(np.float32)

        kf.loop_edges.add(cand_kid)
        cand.loop_edges.add(kf.kid)
        self.closed_loops.append((kf.kid, cand_kid))
        self.map.generation += 1
        ev["correction_ms"] = (time.perf_counter() - t0) * 1e3
        ev["closed"] = True

        if self.cfg.run_global_ba:
            t0 = time.perf_counter()
            gba = {}
            try:
                record["gba_stats"] = global_bundle_adjustment(
                    self.map, self.cam, cfg=self.cfg.gba_cfg or GlobalBAConfig(), device=self.device, record=gba
                )
            except ValueError as e:
                # the map exceeds the largest BA bucket: the essential graph has
                # already corrected the trajectory
                self.gba_skipped += 1
                _log.warning("global BA skipped after loop closure: %s", e)
            ev["global_ba_ms"] = (time.perf_counter() - t0) * 1e3
            record["gba"] = gba
        self.closures.append(record)
        return True
