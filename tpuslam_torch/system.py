"""System facade: the public API (torch).

    sys = System(settings, sensor="stereo", mapping=True, loop_closing=True, device="cuda")
    T_cw = sys.track_stereo(imL, imR, t)     # per-frame pose (numpy 4x4)
    # or System(cam, sensor="mono") and sys.track_monocular(img, t)
    sys.map_lines(); sys.keyframe_graph()
    sys.save_trajectory_tum(path); sys.save_map(path); sys.shutdown()
    # later: System(settings).load_map(path) relocalizes against that map

``settings`` is a ``Settings`` (``io.config.load_settings`` of a
reference-style YAML) or an ``Intrinsics``.

Same signature as ``tpuslam.system.System`` plus ``device``, the card
unless ``device="cpu"`` is passed (without a card the default raises). This port runs
stereo tracking with relocalization (synchronous, or pipelined: the fused
single-frame programs, full-detection or semi-direct chunks, the classic
one-frame-lagged pipeline), lines only or with hybrid points
(``TrackerConfig.points``), and, with
``mapping=True``, local mapping after each keyframe (culling, fusion,
LM+Schur local BA) followed, with ``loop_closing=True`` (the default), by
the loop closer (detection, the SE(3) essential graph, landmark correction
and global BA). On the card local BA and global BA solve in a persistent
solver process on the same card (``backend.ba_worker``), local BA
asynchronously, as the JAX package runs them on its chip; on the CPU they
solve in this process. TPUSLAM_BA_SUBPROCESS=1 / 0 (the JAX package's
switch) chooses either way. With loop closing the System runs
``warmup.warm_loop_programs`` at start on the card (TPUSLAM_WARM_LOOP, the
JAX package's switch; off on the CPU), so that the first closure does not
pay the solvers' one-time set-up.
With ``sensor="mono"`` the tracker bootstraps from two views, the mapper
triangulates new lines and points from two keyframes, and the loop closer
takes its Sim(3) branch (the scale drifts in mono).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpuslam_torch.backend.loop_closing import KeyFrameDatabase, LoopCloser
from tpuslam_torch.backend.mapping import LocalMapper, MapperConfig
from tpuslam_torch.device import resolve_device
from tpuslam_torch.frontend.tracking import FrameResult, Tracker, TrackerConfig, TrackingState
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.io.config import Settings
from tpuslam_torch.io.trajectory import save_trajectory_kitti, save_trajectory_tum
from tpuslam_torch.slammap.map import SlamMap
from tpuslam_torch.slammap.serialize import load_map, save_map
from tpuslam_torch.spans import span


@dataclass
class StageTimer:
    """Warmup-aware per-stage wall timing: the in-memory record of the
    spans (``spans.span``) given it as their timer."""

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


def bench_configs(
    chunk: int = 6,
    points: bool = False,
    pipelined: bool = True,
    direct: bool = True,
    halfres: bool = True,
    hostscale: bool = True,
    semidirect: bool = True,
    fuse_defer: bool = False,
):
    """The configuration the JAX package benchmarks (``tpuslam/bench.py``),
    under its switches (TPUSLAM_BENCH_CHUNK, _POINTS, _PIPELINED, _DIRECT,
    _HALFRES, _HOSTSCALE, _SEMIDIRECT), with their defaults: pipelined
    semi-direct chunks of ``chunk`` frames with direct stereo on host-halved
    frames, and local BA on the two-rung bucket ladder (8, 128, 512) / (16,
    256, 1024) (points on the default point buckets). The same rules:
    ``halfres`` detects at half resolution, halved on the host with
    ``hostscale`` or on the device without; ``semidirect`` needs ``chunk``
    > 1 and ``direct`` stereo; ``points`` adds ``PointFrontendParams()``
    corners beside the lines; ``fuse_defer`` defers the fusion's apply to
    the mapper's tick (the JAX bench's TPUSLAM_BENCH_FUSEDEFER, on by
    default in both benches; off here, so that a System built from these
    configs applies fusion at the keyframe unless asked). Returns
    (TrackerConfig, MapperConfig)."""
    from tpuslam_torch.backend.local_ba import LocalBAConfig
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.kernels.align_direct import DirectAlignParams
    from tpuslam_torch.kernels.stereo_direct import DirectStereoParams

    tcfg = TrackerConfig(pipelined=pipelined, chunk=chunk)
    if direct:
        tcfg.direct_stereo = DirectStereoParams()
    if halfres:
        tcfg.frontend = FrontendParams(base_scale=0.5, prescaled=hostscale)
    if chunk > 1 and direct and semidirect:
        tcfg.semidirect = DirectAlignParams()
    if points:
        tcfg.points = PointFrontendParams()
    mcfg = MapperConfig(
        ba=LocalBAConfig(pose_buckets=(8, 16), line_buckets=(128, 256), obs_buckets=(512, 1024)), fuse_defer=fuse_defer
    )
    return tcfg, mcfg


class System:
    """Top-level SLAM system: stereo or monocular line tracking, local
    mapping and loop closing on ``device``."""

    def __init__(
        self,
        settings: Settings | Intrinsics,
        sensor: str = "stereo",
        mapping: bool = True,
        loop_closing: bool = True,
        log_path: Optional[str] = None,
        tracker_cfg: Optional[TrackerConfig] = None,
        mapper_cfg: Optional[MapperConfig] = None,
        device="cuda",
    ):
        if isinstance(settings, Intrinsics):
            cam = settings
            tcfg = tracker_cfg or TrackerConfig()
        else:
            cam = settings.cam
            tcfg = tracker_cfg or settings.tracker or TrackerConfig()
        if sensor not in ("stereo", "mono"):
            raise ValueError(f"unknown sensor mode {sensor!r}")
        device = resolve_device(device)
        self.sensor = sensor
        self.cam = cam
        self.map = SlamMap()
        self.tracker = Tracker(cam, self.map, tcfg, device=device)
        self.mapper: Optional[LocalMapper] = None
        self.timer = StageTimer()
        self._ba_worker = None
        if mapping:
            # the solver process on the System's card (the JAX package's
            # policy: on its chip by default, in process on the CPU)
            use_worker = os.environ.get("TPUSLAM_BA_SUBPROCESS", "1" if device.type == "cuda" else "0")
            if use_worker == "1":
                from tpuslam_torch.backend.ba_worker import BASolverWorker

                self._ba_worker = BASolverWorker(cam, device=device)
            self.mapper = LocalMapper(
                self.map, cam, mapper_cfg or MapperConfig(), mono=(sensor == "mono"), solver=self._ba_worker, device=device
            )
            self.mapper.timer = self.timer  # local_mapping and its mp.* stages
            self.tracker.on_new_keyframe = self._on_new_keyframe
            self.mapper.on_map_changed = self.tracker.invalidate_local_map
        # with hybrid points a database row carries the corners' BRIEF words too
        self.kf_db = KeyFrameDatabase(point_slots=tcfg.points.max_points if tcfg.points is not None else 0, device=device)
        self.tracker.kf_db = self.kf_db  # relocalization
        self.map.on_keyframe_erased = self.kf_db.remove  # culled KFs leave the DB
        self.loop_closer: Optional[LoopCloser] = None
        self.warm_loop_s: Optional[dict] = None  # warm_loop_programs' seconds, where it ran
        if loop_closing:
            # on the System's own database, which relocalization queries too
            self.loop_closer = LoopCloser(
                self.map, cam, db=self.kf_db, mono=(sensor == "mono"), solver=self._ba_worker, device=device
            )
            # the first closure's one-time set-up paid here, at toy size (the
            # JAX package's policy: on its chip by default, off on the CPU)
            if os.environ.get("TPUSLAM_WARM_LOOP", "1" if device.type == "cuda" else "0") == "1":
                from tpuslam_torch.warmup import warm_loop_programs

                self.warm_loop_s = warm_loop_programs(
                    cam, mono=(sensor == "mono"), refine_cap=self.loop_closer.cfg.refine_cap, device=device
                )
        self.trajectory: List[FrameResult] = []
        self._log_f = open(log_path, "w") if log_path else None

    def _on_new_keyframe(self, kf):
        self.mapper.process(kf)
        if self.loop_closer is None:
            self.kf_db.add(kf)  # no loop closer: the database serves relocalization
            return
        with span("loop_closing", self.timer):
            corrected = self.loop_closer.process(kf)  # adds kf to the database
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
        pipelined mode that of an earlier frame)."""
        with span("track", self.timer) as s:
            r = self.tracker.track_stereo(img_left, img_right, timestamp)
        if self.mapper is not None:  # between-KF poll, as the JAX System does
            with span("tick", self.timer):
                self.mapper.tick()
        if r is not None:  # pipelined mode resolves a chunk later
            self.trajectory.append(r)
            self._log(r, s.seconds)
        for extra in self.tracker.pop_results():  # a resolve can complete several frames
            self.trajectory.append(extra)
            self._log(extra, 0.0)
        return np.asarray(self.tracker.T_cw)

    def track_monocular(self, img, timestamp: float) -> np.ndarray:
        """Track one monocular frame; returns the tracker's pose (pipelined,
        that of the frame before)."""
        with span("track", self.timer) as s:
            r = self.tracker.track_monocular(img, timestamp)
        if self.mapper is not None:
            with span("tick", self.timer):
                self.mapper.tick()
        if r is not None:  # the classic pipeline resolves a frame later
            self.trajectory.append(r)
            self._log(r, s.seconds)
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
        save_map(self.map, path)

    def load_map(self, path: str):
        """Replace the map with the one saved at ``path`` (by either
        package), for localization-only reuse or continued mapping."""
        self.map = load_map(path)
        self.tracker.map = self.map
        if self.mapper is not None:
            self.mapper.map = self.map
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
        # relocalization (and loop detection) query the loaded keyframes
        self.kf_db.clear()
        for kid in sorted(self.map.keyframes):
            self.kf_db.add(self.map.keyframes[kid])
        self.map.on_keyframe_erased = self.kf_db.remove
        self.tracker.invalidate_local_map()

    def timing_summary(self):
        return self.timer.summary()

    def shutdown(self, drain_timeout: float = 1200.0):
        """Track the frames still buffered or in flight (the trajectory then
        holds one entry per input frame), finish mapping (waiting up to
        ``drain_timeout`` s for an in-flight solve; past that it is abandoned
        and counted in ``mapper.ba_failed``), close the log and stop the
        solver process."""
        for r in self.tracker.flush_all():
            self.trajectory.append(r)
            self._log(r, 0.0)
        if self.mapper is not None:
            self.mapper.finish(timeout=drain_timeout)
        if self._log_f is not None:
            self._log_f.write(json.dumps(dict(timing=self.timing_summary())) + "\n")
            self._log_f.close()
            self._log_f = None
        if self._ba_worker is not None:
            self._ba_worker.close()
            self._ba_worker = None
