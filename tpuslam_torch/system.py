"""System facade: the public API (torch).

    sys = System(cam, sensor="stereo", mapping=True, loop_closing=False, device="cuda")
    T_cw = sys.track_stereo(imL, imR, t)     # per-frame pose (numpy 4x4)
    sys.map_lines(); sys.keyframe_graph()
    sys.save_trajectory_tum(path); sys.shutdown()

Same signature as ``tpuslam.system.System`` plus ``device``, the card
unless ``device="cpu"`` is passed (without a card the default raises). This port runs
stereo tracking with relocalization and, with ``mapping=True``, synchronous
local mapping after each keyframe (culling, fusion, LM+Schur local BA on
``device``). ``loop_closing=True`` and ``sensor="mono"`` raise
NotImplementedError.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpuslam_torch.backend.loop_closing import KeyFrameDatabase
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


class System:
    """Top-level SLAM system: stereo line tracking and local mapping on ``device``."""

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
        if sensor == "mono":
            raise NotImplementedError("sensor='mono' is not ported yet (later work after loop closing)")
        if sensor != "stereo":
            raise ValueError(f"unknown sensor mode {sensor!r}")
        if loop_closing:
            raise NotImplementedError("loop_closing=True is not ported yet")
        device = resolve_device(device)
        self.sensor = sensor
        self.cam = settings
        self.map = SlamMap()
        self.tracker = Tracker(settings, self.map, tracker_cfg or TrackerConfig(), device=device)
        self.mapper: Optional[LocalMapper] = None
        self.timer = StageTimer()
        if mapping:
            # synchronous, in this process: the JAX package's subprocess BA
            # worker exists for the TPU's compile costs and is not carried over
            self.mapper = LocalMapper(self.map, settings, mapper_cfg or MapperConfig(), device=device)
            self.mapper.timer = self.timer  # KF-event wall split (mp.* stages)
            self.tracker.on_new_keyframe = self._on_new_keyframe
            self.mapper.on_map_changed = self.tracker.invalidate_local_map
        self.kf_db = KeyFrameDatabase(device=device)
        self.tracker.kf_db = self.kf_db  # relocalization
        self.map.on_keyframe_erased = self.kf_db.remove  # culled KFs leave the DB
        self.trajectory: List[FrameResult] = []
        self._log_f = open(log_path, "w") if log_path else None

    def _on_new_keyframe(self, kf):
        t0 = time.perf_counter()
        self.mapper.process(kf)
        self.timer.add("local_mapping", time.perf_counter() - t0)
        self.kf_db.add(kf)  # no loop closer: the database serves relocalization

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
        t0 = time.perf_counter()
        r = self.tracker.track_stereo(img_left, img_right, timestamp)
        dt = time.perf_counter() - t0
        self.timer.add("track", dt)
        if self.mapper is not None:  # between-KF poll, as the JAX System does
            self.mapper.tick()
        self.trajectory.append(r)
        self._log(r, dt)
        return np.asarray(self.tracker.T_cw)

    def track_frame(self, images, timestamp: float) -> np.ndarray:
        """Generic TrackFrame entry: (left, right) images."""
        return self.track_stereo(images[0], images[1], timestamp)

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

    def timing_summary(self):
        return self.timer.summary()

    def shutdown(self):
        """Finish mapping and close the log. Tracking and mapping are
        synchronous, so no frame or solve is in flight."""
        if self.mapper is not None:
            self.mapper.finish()
        if self._log_f is not None:
            self._log_f.write(json.dumps(dict(timing=self.timing_summary())) + "\n")
            self._log_f.close()
            self._log_f = None
