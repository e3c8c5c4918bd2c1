"""System facade: the public API (torch).

    sys = System(cam, sensor="stereo", mapping=True, loop_closing=True, device="cuda")
    T_cw = sys.track_stereo(imL, imR, t)     # per-frame pose (numpy 4x4)
    # or System(cam, sensor="mono") and sys.track_monocular(img, t)
    sys.map_lines(); sys.keyframe_graph()
    sys.save_trajectory_tum(path); sys.shutdown()

Same signature as ``tpuslam.system.System`` plus ``device``, the card
unless ``device="cpu"`` is passed (without a card the default raises). This port runs
stereo tracking with relocalization (synchronous, or in pipelined
semi-direct chunks: the JAX package's bench configuration), lines only or
with hybrid points (``TrackerConfig.points``), and, with
``mapping=True``, synchronous local mapping after each keyframe (culling,
fusion, LM+Schur local BA on ``device``) followed, with
``loop_closing=True`` (the default), by the loop closer (detection, the
SE(3) essential graph, landmark correction and global BA on ``device``).
With ``sensor="mono"`` the tracker bootstraps from two views, the mapper
triangulates new lines and points from two keyframes, and the loop closer
takes its Sim(3) branch (the scale drifts in mono).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpuslam_torch.backend.loop_closing import KeyFrameDatabase, LoopCloser
from tpuslam_torch.backend.mapping import LocalMapper, MapperConfig
from tpuslam_torch.device import resolve_device
from tpuslam_torch.frontend.tracking import FrameResult, Tracker, TrackerConfig, TrackingState
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.io.trajectory import save_trajectory_kitti, save_trajectory_tum
from tpuslam_torch.slammap.map import SlamMap


@dataclass
class StageTimer:
    """Warmup-aware per-stage wall timing."""

    warmup: int = 2
    times: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def add(self, stage: str, dt: float):
        c = self.counts.get(stage, 0)
        self.counts[stage] = c + 1
        if c >= self.warmup:
            self.times.setdefault(stage, []).append(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.times.items():
            arr = np.asarray(v)
            out[k] = dict(
                mean_ms=float(arr.mean() * 1e3),
                median_ms=float(np.median(arr) * 1e3),
                p90_ms=float(np.percentile(arr, 90) * 1e3),
                n=len(arr),
            )
        return out


def bench_configs(chunk: int = 6, points: bool = False):
    """The configuration the JAX package benchmarks (``tpuslam/bench.py``):
    pipelined semi-direct chunks of ``chunk`` frames with direct stereo on
    host-halved frames, and local BA on the two-rung bucket ladder (8, 128,
    512) / (16, 256, 1024) (points on the default point buckets). With
    ``points`` the hybrid variant (``TPUSLAM_BENCH_POINTS=1`` there):
    ``PointFrontendParams()`` corners beside the lines. Fusion applies at the
    keyframe (the JAX bench's deferred fusion is not ported). Returns
    (TrackerConfig, MapperConfig)."""
    from tpuslam_torch.backend.local_ba import LocalBAConfig
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.kernels.align_direct import DirectAlignParams
    from tpuslam_torch.kernels.stereo_direct import DirectStereoParams

    tcfg = TrackerConfig(
        pipelined=True, chunk=chunk, direct_stereo=DirectStereoParams(),
        frontend=FrontendParams(base_scale=0.5, prescaled=True), semidirect=DirectAlignParams(),
        points=PointFrontendParams() if points else None,
    )
    mcfg = MapperConfig(ba=LocalBAConfig(pose_buckets=(8, 16), line_buckets=(128, 256), obs_buckets=(512, 1024)))
    return tcfg, mcfg


class System:
    """Top-level SLAM system: stereo or monocular line tracking, local
    mapping and loop closing on ``device``."""

    def __init__(
        self,
        settings: Intrinsics,
        sensor: str = "stereo",
        mapping: bool = True,
        loop_closing: bool = True,
        log_path: Optional[str] = None,
        tracker_cfg: Optional[TrackerConfig] = None,
        mapper_cfg: Optional[MapperConfig] = None,
        device="cuda",
    ):
        if not isinstance(settings, Intrinsics):
            raise TypeError("settings: pass tpuslam_torch.Intrinsics (settings files are not ported yet)")
        if sensor not in ("stereo", "mono"):
            raise ValueError(f"unknown sensor mode {sensor!r}")
        device = resolve_device(device)
        self.sensor = sensor
        self.cam = settings
        self.map = SlamMap()
        tcfg = tracker_cfg or TrackerConfig()
        self.tracker = Tracker(settings, self.map, tcfg, device=device)
        self.mapper: Optional[LocalMapper] = None
        self.timer = StageTimer()
        if mapping:
            # synchronous, in this process: the JAX package's subprocess BA
            # worker exists for the TPU's compile costs and is not carried over
            self.mapper = LocalMapper(
                self.map, settings, mapper_cfg or MapperConfig(), mono=(sensor == "mono"), device=device
            )
            self.mapper.timer = self.timer  # KF-event wall split (mp.* stages)
            self.tracker.on_new_keyframe = self._on_new_keyframe
            self.mapper.on_map_changed = self.tracker.invalidate_local_map
        # with hybrid points a database row carries the corners' BRIEF words too
        self.kf_db = KeyFrameDatabase(point_slots=tcfg.points.max_points if tcfg.points is not None else 0, device=device)
        self.tracker.kf_db = self.kf_db  # relocalization
        self.map.on_keyframe_erased = self.kf_db.remove  # culled KFs leave the DB
        self.loop_closer: Optional[LoopCloser] = None
        if loop_closing:
            # on the System's own database, which relocalization queries too
            self.loop_closer = LoopCloser(self.map, settings, db=self.kf_db, mono=(sensor == "mono"), device=device)
        self.trajectory: List[FrameResult] = []
        self._log_f = open(log_path, "w") if log_path else None

    def _on_new_keyframe(self, kf):
        t0 = time.perf_counter()
        self.mapper.process(kf)
        self.timer.add("local_mapping", time.perf_counter() - t0)
        if self.loop_closer is None:
            self.kf_db.add(kf)  # no loop closer: the database serves relocalization
            return
        t0 = time.perf_counter()
        corrected = self.loop_closer.process(kf)  # adds kf to the database
        self.timer.add("loop_closing", time.perf_counter() - t0)
        if corrected:
            self.tracker.invalidate_local_map()
            # track on from the corrected pose, not the pre-correction chain
            self.tracker.adopt_pose(kf.T_cw)

    def _log(self, r: FrameResult, dt: float):
        if self._log_f is None:
            return
        self._log_f.write(
            json.dumps(
                dict(
                    frame=r.frame_idx,
                    t=r.timestamp,
                    state=r.state.name,
                    n_matches=r.n_matches,
                    n_inliers=r.n_inliers,
                    kf=r.made_keyframe,
                    track_ms=dt * 1e3,
                    pose=np.asarray(r.T_cw).reshape(-1).round(6).tolist(),
                )
            )
            + "\n"
        )

    # ---- public API -----------------------------------------------------
    def track_stereo(self, img_left, img_right, timestamp: float) -> np.ndarray:
        """Track one frame; returns the tracker's newest resolved pose (in
        pipelined mode that of a frame one chunk back)."""
        t0 = time.perf_counter()
        r = self.tracker.track_stereo(img_left, img_right, timestamp)
        dt = time.perf_counter() - t0
        self.timer.add("track", dt)
        if self.mapper is not None:  # between-KF poll, as the JAX System does
            self.mapper.tick()
        if r is not None:  # pipelined mode resolves a chunk later
            self.trajectory.append(r)
            self._log(r, dt)
        for extra in self.tracker.pop_results():  # a resolve can complete several frames
            self.trajectory.append(extra)
            self._log(extra, 0.0)
        return np.asarray(self.tracker.T_cw)

    def track_monocular(self, img, timestamp: float) -> np.ndarray:
        """Track one monocular frame; returns the tracker's pose."""
        t0 = time.perf_counter()
        r = self.tracker.track_monocular(img, timestamp)
        dt = time.perf_counter() - t0
        self.timer.add("track", dt)
        if self.mapper is not None:
            self.mapper.tick()
        self.trajectory.append(r)
        self._log(r, dt)
        return np.asarray(self.tracker.T_cw)

    def track_frame(self, images, timestamp: float) -> np.ndarray:
        """Generic TrackFrame entry: (left, right) images in stereo, an image
        (or a sequence whose first item is the image) in mono."""
        if self.sensor == "stereo":
            return self.track_stereo(images[0], images[1], timestamp)
        img = images[0] if isinstance(images, (list, tuple)) else images
        return self.track_monocular(img, timestamp)

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    def map_lines(self) -> Dict[str, np.ndarray]:
        """Live 3D line landmarks: Pluecker coords + endpoints (world)."""
        ids = self.map.lines.live_ids()
        return dict(
            ids=ids,
            plucker=self.map.lines.plucker[ids].copy(),
            endpoints=self.map.lines.endpoints[ids].copy(),
            n_obs=self.map.lines.n_obs[ids].copy(),
        )

    def map_points(self) -> Dict[str, np.ndarray]:
        """Live 3D point landmarks (hybrid mode; empty arrays otherwise)."""
        ids = self.map.points.live_ids()
        return dict(ids=ids, xyz=self.map.points.xyz[ids].copy(), n_obs=self.map.points.n_obs[ids].copy())

    def keyframe_graph(self):
        """Keyframe poses + covisibility edges (kid_a, kid_b, weight)."""
        kfs = {k: kf.T_cw.copy() for k, kf in self.map.keyframes.items()}
        edges = []
        for a, row in self.map.covis.items():
            for b, w in row.items():
                if a < b and a in kfs and b in kfs:
                    edges.append((a, b, int(w)))
        return kfs, edges

    def save_trajectory_tum(self, path: str):
        save_trajectory_tum(path, [r.timestamp for r in self.trajectory], [r.T_cw for r in self.trajectory])

    def save_trajectory_kitti(self, path: str):
        save_trajectory_kitti(path, [r.T_cw for r in self.trajectory])

    def save_map(self, path: str):
        raise NotImplementedError("map serialization (lines and points) is not ported yet (ROADMAP.md, item 6)")

    def load_map(self, path: str):
        raise NotImplementedError("map serialization (lines and points) is not ported yet (ROADMAP.md, item 6)")

    def timing_summary(self):
        return self.timer.summary()

    def shutdown(self):
        """Track the frames still buffered or in flight (the trajectory then
        holds one entry per input frame), finish mapping and close the log."""
        for r in self.tracker.flush_all():
            self.trajectory.append(r)
            self._log(r, 0.0)
        if self.mapper is not None:
            self.mapper.finish()
        if self._log_f is not None:
            self._log_f.write(json.dumps(dict(timing=self.timing_summary())) + "\n")
            self._log_f.close()
            self._log_f = None
