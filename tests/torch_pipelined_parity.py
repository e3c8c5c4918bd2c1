"""Shared pieces of the tests that hold tpuslam_torch's pipelined tracker
forms to tpuslam's: the two trackers over the same uint8 frames, with the
order in which each dispatches its fused programs and resolves its frames
recorded.

``SnapshotOrder`` wraps a tracker of either package: for every dispatch of a
fused program it records (the frames dispatched, the last frame resolved
before the dispatch, the keyframes in the map when the program took its
local-map snapshot). Frame k of the single-frame forms must match against
the map exactly as the JAX package's frame k does.
"""

import numpy as np

from torch_parity import JaxAsOnTheCard

PROGRAMS = ("fused_stereo_frame", "fused_stereo_frame_hybrid", "fused_stereo_chunk", "fused_stereo_semidirect")


class SnapshotOrder:
    """Records each fused dispatch of ``tracker`` as (frames, last frame
    resolved before it, keyframes in the map at its snapshot); ``module``
    is the namespace the tracker looks its programs up in, patched until
    :meth:`restore`."""

    def __init__(self, tracker, module):
        self.log, self._last, self._frames = [], -1, None
        self._module = module
        self._saved = {n: getattr(module, n) for n in PROGRAMS}
        resolve = tracker._resolve_fused_one

        def resolve_one(*a, **k):
            if tracker._fuse_queue:
                self._last = tracker._fuse_queue[0][0]
            return resolve(*a, **k)

        tracker._resolve_fused_one = resolve_one
        for attr in ("_fuse_compute", "_chunk_compute"):
            inner = getattr(tracker, attr)

            def compute(up, *a, _inner=inner, **k):
                # the JAX package passes (frame or frame list, ts, upload...),
                # the port (frame, ts, left, right) or a list of such entries
                f = up[0]
                self._frames = [b[0] for b in up] if isinstance(f, tuple) else f
                return _inner(up, *a, **k)

            setattr(tracker, attr, compute)
        for name, fn in self._saved.items():

            def program(*a, _fn=fn, **k):
                self.log.append((self._frames, self._last, len(tracker.map.keyframes)))
                return _fn(*a, **k)

            setattr(module, name, program)

    def restore(self):
        for name, fn in self._saved.items():
            setattr(self._module, name, fn)


def _drive(tracker, frames, mono: bool):
    results = []
    for f, fr in enumerate(frames):
        r = tracker.track_monocular(fr, f * 0.05) if mono else tracker.track_stereo(fr[0], fr[1], f * 0.05)
        if r is not None:
            results.append(r)
        results += tracker.pop_results()
    results += tracker.flush_all()
    return results


def run_jax_tracker(cam, frames, jcfg, mono: bool = False):
    """The JAX Tracker (no mapper) over the frames: (results in frame order,
    the dispatch log)."""
    from tpuslam.frontend import pipeline as jpipe
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.slammap.map import SlamMap as JSlamMap

    with JaxAsOnTheCard():
        tr = JTracker(JIntrinsics(*cam), JSlamMap(), jcfg)
        order = SnapshotOrder(tr, jpipe)
        try:
            results = _drive(tr, frames, mono)
        finally:
            order.restore()
            tr.close()
    return sorted(results, key=lambda r: r.frame_idx), order.log


def run_port_tracker(cam, frames, jcfg, mono: bool = False):
    """The port's Tracker (no mapper, on the CPU) in the JAX configuration
    ``jcfg``: (results in frame order, the dispatch log, the tracker)."""
    from tpuslam_torch.convert import tracker_config_from
    from tpuslam_torch.frontend import tracking as ttracking
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    tr = Tracker(cam, SlamMap(), tracker_config_from(jcfg), device="cpu")
    order = SnapshotOrder(tr, ttracking)
    try:
        results = _drive(tr, frames, mono)
    finally:
        order.restore()
    return sorted(results, key=lambda r: r.frame_idx), order.log, tr


def effective_dispatches(log):
    """The dispatch log without the dispatches that a later one of the same
    frames replaced (the port's final flush dispatches the last full chunk
    again where the map it matched changed: its frames' results come from
    the later dispatch)."""
    out = []
    for i, e in enumerate(log):
        if not any(later[0] == e[0] for later in log[i + 1:]):
            out.append(e)
    return out


def pose_gap(T, T_ref):
    """(rotation angle rad, camera centre distance m) between two T_cw."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    dR = T[:3, :3] @ T_ref[:3, :3].T
    w = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    ang = float(np.arctan2(np.linalg.norm(w), 0.5 * (np.trace(dR) - 1.0)))
    c, c_ref = -T[:3, :3].T @ T[:3, 3], -T_ref[:3, :3].T @ T_ref[:3, 3]
    return ang, float(np.linalg.norm(c - c_ref))


def keyframe_split(jres, tres) -> int:
    """The first frame whose keyframe decision differs between the two runs
    (the run's length if none): keyframe decisions are chaotic at the
    threshold (ROADMAP.md section 3), and the maps differ from there on."""
    return next((a.frame_idx for a, b in zip(jres, tres) if a.made_keyframe != b.made_keyframe), len(jres))


def ate(results, scene) -> float:
    from tpuslam_torch.eval.ate import absolute_trajectory_error

    est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in results])
    gt = np.stack([np.linalg.inv(scene.poses[r.frame_idx])[:3, 3] for r in results])
    return float(absolute_trajectory_error(est, gt).rmse)
