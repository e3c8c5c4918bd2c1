"""The whole stereo SLAM system with local mapping, tpuslam_torch against
tpuslam: both Systems see the same exact synthetic features (through
``convert.features_from``), so what differs is the two packages' tracking,
mapping and relocalization alone. The JAX map's native graph mirror is off
(see test_torch_mapping.py)."""

import numpy as np
import pytest

from tpuslam.eval.ate import absolute_trajectory_error as j_ate
from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
from tpuslam.frontend.tracking import TrackingState as JTrackingState
from tpuslam.geometry import Intrinsics as JIntrinsics
from tpuslam.io.synthetic import make_wireframe_scene, synthetic_frame_features
from tpuslam.system import System as JSystem
from tpuslam_torch import Intrinsics
from tpuslam_torch.convert import features_from
from tpuslam_torch.eval.ate import absolute_trajectory_error
from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState
from tpuslam_torch.system import System

J_CAM = JIntrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
T_CAM = Intrinsics(*J_CAM)


def _center(T):
    return np.linalg.inv(np.asarray(T, np.float64))[:3, 3]


def _pair(n_frames, n_segments=140, seed=0):
    """Both Systems (stereo, mapping on, a keyframe at least every 4 frames)
    over the same synthetic features of ``n_frames`` frames."""
    rng = np.random.default_rng(seed)
    scene = make_wireframe_scene(rng, n_segments=n_segments, n_frames=n_frames, cam=J_CAM, motion_scale=0.02)
    js = JSystem(J_CAM, sensor="stereo", loop_closing=False, tracker_cfg=JTrackerConfig(max_frames_between_kf=4))
    ts = System(
        T_CAM, sensor="stereo", loop_closing=False, tracker_cfg=TrackerConfig(max_frames_between_kf=4), device="cpu"
    )
    for f in range(n_frames):
        feats, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng, with_depth=True)
        _feed(js, ts, feats, f, f * 0.05)
    return scene, js, ts, rng


def _feed(js, ts, feats, frame_idx, t):
    js.tracker.frame_idx = ts.tracker.frame_idx = frame_idx
    js.trajectory.append(js.tracker._track(feats, t, stereo=True))
    ts.trajectory.append(ts.tracker._track(features_from(feats), t))


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_NATIVE_MAP", "0")
        scene, js, ts, _ = _pair(20)
    js.shutdown()
    ts.shutdown()
    return scene, js, ts


def test_mapping_system_tracks_like_jax(runs):
    """Same states, keyframes within one, camera centres within 5 cm of the
    JAX package's every frame and ATE within 1 cm of it; local BA ran."""
    scene, js, ts = runs
    assert [r.state.name for r in ts.trajectory] == [r.state.name for r in js.trajectory]
    assert all(r.state == TrackingState.OK for r in ts.trajectory)
    assert abs(len(ts.map.keyframes) - len(js.map.keyframes)) <= 1 and len(ts.map.keyframes) >= 4
    ct = np.stack([_center(r.T_cw) for r in ts.trajectory])
    cj = np.stack([_center(r.T_cw) for r in js.trajectory])
    assert np.linalg.norm(ct - cj, axis=1).max() < 0.05
    gt = np.stack([_center(T) for T in scene.poses])
    assert absolute_trajectory_error(ct, gt).rmse < j_ate(cj, gt).rmse + 0.01
    assert ts.mapper.last_ba is not None and ts.mapper.last_ba.n_poses >= 4
    # the same window; the trackers' inlier gates can bind an observation
    # differently (borderline chi2 values), so lines and observations within
    # 2%, and the final robust cost (a sum dominated by its largest terms)
    # within 2x per observation
    tb, jb = ts.mapper.last_ba, js.mapper.last_ba
    assert tb[:2] == jb[:2]
    np.testing.assert_allclose(tb[2:4], jb[2:4], rtol=0.02)
    assert 0.5 < (tb.cost / tb.n_obs) / (jb.cost / jb.n_obs) < 2.0
    assert sorted(ts.map.keyframes) == sorted(js.map.keyframes)
    for kid, kf in ts.map.keyframes.items():
        np.testing.assert_allclose(kf.T_cw, js.map.keyframes[kid].T_cw, atol=2e-3)


def test_mapping_system_bookkeeping(runs):
    """Every live keyframe is in the relocalization database; the mapper's
    stages and local mapping are timed; solves are recorded by rung."""
    _, js, ts = runs
    assert sorted(k for k in ts.kf_db.kids if k is not None) == sorted(ts.map.keyframes)
    assert len(ts.kf_db) == len(js.kf_db)
    stages = ts.timing_summary()
    for name in ("local_mapping", "mp.cull", "mp.fuse_dispatch", "mp.covis", "mp.ba", "mp.kf_cull"):
        assert name in stages, name
    rungs = ts.mapper.solve_ms_by_rung
    assert sum(len(v) for v in rungs.values()) == len(ts.map.keyframes) - 1
    assert all(len(r) == 3 and r[0] in (8, 16, 24) for r in rungs)
    lines = ts.map_lines()
    assert abs(len(lines["ids"]) - len(js.map_lines()["ids"])) <= 0.05 * len(lines["ids"])


@pytest.mark.parametrize("keyframe_poses", ["kept", "moved_far"])
def test_relocalization_like_jax(keyframe_poses):
    """A LOST tracker fed frame 5 again relocalizes in both packages: from
    the database's best keyframe ("kept"), or, with every keyframe pose moved
    50 m away so that LM from the candidate cannot converge, through the
    DLT-Lines reseed ("moved_far", the JAX package's test_dlt protocol)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_NATIVE_MAP", "0")
        scene, js, ts, rng = _pair(10, n_segments=160)
    if keyframe_poses == "moved_far":
        far = np.eye(4, dtype=np.float32)
        far[:3, 3] = 50.0
        for s in (js, ts):
            for kf in s.map.keyframes.values():
                kf.T_cw = (far @ kf.T_cw).astype(np.float32)
    js.tracker.state, ts.tracker.state = JTrackingState.LOST, TrackingState.LOST
    feats, _ = synthetic_frame_features(scene, 5, noise_px=0.3, rng=rng, with_depth=True)
    _feed(js, ts, feats, 50, 5.0)
    rj, rt = js.trajectory[-1], ts.trajectory[-1]
    assert rj.state.name == rt.state.name == "OK"
    assert ts.tracker.n_relocalizations == js.tracker.n_relocalizations == 1
    assert np.linalg.norm(_center(rt.T_cw) - _center(scene.poses[5])) < 0.05
    assert np.linalg.norm(_center(rt.T_cw) - _center(rj.T_cw)) < 0.01
