"""The classic one-frame-lagged pipeline of tpuslam_torch against tpuslam's,
stereo and mono.

The classic pipeline (``TrackerConfig(pipelined=True, fused=False)``, and
every pipelined mono configuration without points) dispatches frame k's
pose stages after resolving frame k - 1 on the host, so apart from the lag
it computes what the synchronous path computes; it declares LOST where the
synchronous path would fall back to TrackReferenceKeyFrame. The mapper runs
inside the resolve's keyframe insertion (``on_new_keyframe``), before the
next dispatch, so with mapping on too the two agree until a fallback.

- Stereo, 12 QVGA frames of the bench scene, no mapper: the classic
  pipeline bit-equal to the synchronous tracker in both packages (no frame
  falls back there), and the port's classic run against the JAX package's:
  the same keyframes and poses within 2e-3 (rad and m) before the first
  frame whose inlier count differs (the synchronous stereo pose LM keeps one
  Huber weight per observation, ROADMAP.md section 3).
- Stereo with mapping (System, 12 frames): the port's classic run bit-equal
  to its synchronous run, and against the JAX package's: the same keyframes
  before the first inlier difference, camera centres within 5 cm, the ATE
  within the JAX package's + 0.01 m.
- Mono (tests/test_mono.py's 12-frame synthetic-feature sequence, seed 8,
  lines only, the mono mapper; the JAX package's RANSAC draws and its
  8-point on the port's float64 solve, ``mono_parity``): the same
  initialization frame and keyframes, poses within 1e-3 (PR 9's lines-only
  mono tolerance), and the port's pipelined run bit-equal to its
  synchronous one.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import QVGA, python_graph, stereo_scene
from torch_pipelined_parity import ate, pose_gap, run_jax_tracker, run_port_tracker

N_FRAMES = 12
POSE_TOL = 2e-3


def _same_results(a, b):
    """Frame for frame: the same states, counts, keyframes and bit-equal poses."""
    assert [r.frame_idx for r in a] == [r.frame_idx for r in b]
    for x, y in zip(a, b):
        assert (x.state, x.n_matches, x.n_inliers, x.made_keyframe) == (y.state, y.n_matches, y.n_inliers, y.made_keyframe), x.frame_idx
        np.testing.assert_array_equal(x.T_cw, y.T_cw)


def _inlier_split(jres, tres) -> int:
    """The first frame whose inlier count differs between the runs."""
    return next((a.frame_idx for a, b in zip(jres, tres) if a.n_inliers != b.n_inliers), len(jres))


@pytest.fixture(scope="module")
def stereo_runs():
    from tpuslam.frontend.tracking import TrackerConfig

    scene, frames = stereo_scene(N_FRAMES)
    classic = TrackerConfig(pipelined=True, fused=False)
    out = dict(scene=scene)
    for name, cfg in (("sync", TrackerConfig()), ("classic", classic)):
        out[name] = (run_jax_tracker(QVGA, frames, cfg)[0], run_port_tracker(QVGA, frames, cfg))
    return out


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_classic_stereo_equals_sync(stereo_runs, package):
    """Without a mapper the classic pipeline's results are the synchronous
    tracker's, bit for bit, in each package; the port's classic frames after
    the initialization all went through the pipeline."""
    i = 0 if package == "jax" else 1
    sync, classic = stereo_runs["sync"][i], stereo_runs["classic"][i]
    if package == "torch":
        tr = classic[2]
        assert tr.sync_frames == [0] and tr.lagged_frames == list(range(1, N_FRAMES))
        sync, classic = sync[0], classic[0]
    assert all(r.state.name == "OK" for r in classic)
    _same_results(sync, classic)


def test_classic_stereo_matches_jax(stereo_runs):
    """The same keyframes and poses within POSE_TOL before the first frame
    whose inlier count differs (after frame 4), the ATE within the JAX
    package's + 0.01 m."""
    jres, (tres, _, _) = stereo_runs["classic"]
    split = _inlier_split(jres, tres)
    assert split > 4, split
    assert [r.made_keyframe for r in tres[:split]] == [r.made_keyframe for r in jres[:split]]
    for a, b in zip(jres[:split], tres[:split]):
        ang, dc = pose_gap(b.T_cw, a.T_cw)
        assert ang <= POSE_TOL and dc <= POSE_TOL, (a.frame_idx, ang, dc)
    assert ate(tres, stereo_runs["scene"]) <= ate(jres, stereo_runs["scene"]) + 0.01


def _system_run(tcfg, frames, jax: bool):
    from test_torch_pipelined import run_jax_system

    if jax:
        return run_jax_system(QVGA, frames, tcfg, mapping=True)[1]
    from tpuslam_torch.convert import tracker_config_from
    from tpuslam_torch.system import System

    with python_graph():  # held to the JAX System run with its mirror off
        s = System(QVGA, mapping=True, loop_closing=False, tracker_cfg=tracker_config_from(tcfg), device="cpu")
    for f, (il, ir) in enumerate(frames):
        s.track_stereo(il, ir, f * 0.05)
    s.shutdown()
    return s.trajectory


def test_classic_mapping_matches_jax():
    """With mapping: the port's classic run bit-equal to its synchronous run;
    against the JAX package's classic run the same keyframes before the
    first inlier difference, camera centres within 5 cm, the ATE within the
    JAX package's + 0.01 m."""
    from tpuslam.frontend.tracking import TrackerConfig

    scene, frames = stereo_scene(N_FRAMES)
    classic = TrackerConfig(pipelined=True, fused=False)
    tres = _system_run(classic, frames, jax=False)
    assert len([r for r in tres if r.made_keyframe]) >= 2
    _same_results(_system_run(TrackerConfig(), frames, jax=False), tres)
    jres = _system_run(classic, frames, jax=True)
    split = _inlier_split(jres, tres)
    assert [r.made_keyframe for r in tres[:split]] == [r.made_keyframe for r in jres[:split]]
    for a, b in zip(jres, tres):
        assert pose_gap(b.T_cw, a.T_cw)[1] < 0.05, a.frame_idx
    assert ate(tres, scene) <= ate(jres, scene) + 0.01


# ---- pipelined mono ---------------------------------------------------------


def _mono_runs():
    """Both packages' mono trackers and mappers over the synthetic sequence
    with pipelined=True, and the port's synchronous run: (scene, JAX
    results, port results, port synchronous results, port tracker)."""
    from mono_parity import jax_e8_float64, jax_samples
    from test_mono import CAM
    from test_torch_mono import JaxMono, _synthetic_cfgs, _synthetic_sequence
    from tpuslam.backend.mapping import LocalMapper as JLocalMapper
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.slammap.map import SlamMap as JSlamMap
    from tpuslam_torch.backend.mapping import LocalMapper
    from tpuslam_torch.convert import features_from, mapper_config_from, tracker_config_from
    from tpuslam_torch.frontend.initializer import MonoInitializer
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.geometry.camera import Intrinsics
    from tpuslam_torch.slammap.map import SlamMap

    scene, feats = _synthetic_sequence(False, n_frames=N_FRAMES)
    tcfg, mcfg = _synthetic_cfgs(False)
    tcfg = dataclasses.replace(tcfg, pipelined=True)

    def drive(tracker, wrap):
        out = []
        for f, (lf, _) in enumerate(feats):
            tracker.frame_idx = f
            r = tracker._track(wrap(lf), timestamp=f * 0.05, stereo=False)
            if r is not None:
                out.append(r)
        return out + tracker.flush_all()

    with JaxMono(), jax_e8_float64():
        jt = JTracker(CAM, JSlamMap(), tcfg)
        jm = JLocalMapper(jt.map, CAM, mcfg, mono=True)
        jt.on_new_keyframe, jm.on_map_changed = jm.process, jt.invalidate_local_map
        jres = drive(jt, lambda x: x)
    cam = Intrinsics(*CAM)
    runs = []
    for pipelined in (True, False):
        with python_graph():
            tt = Tracker(cam, SlamMap(), tracker_config_from(dataclasses.replace(tcfg, pipelined=pipelined)), device="cpu")
        tt.mono_init = MonoInitializer(cam, sampler=jax_samples)
        tm = LocalMapper(tt.map, cam, mapper_config_from(mcfg), mono=True, device="cpu")
        tt.on_new_keyframe, tm.on_map_changed = tm.process, tt.invalidate_local_map
        runs.append((drive(tt, features_from), tt))
    return scene, jres, runs[0][0], runs[1][0], runs[0][1]


@pytest.fixture(scope="module")
def mono_runs():
    return _mono_runs()


def test_pipelined_mono_matches_jax(mono_runs):
    """One result per frame in order; the same first OK frame and keyframes;
    poses within 1e-3 (rad and m) over the OK frames."""
    _, jres, tres, _, tr = mono_runs
    assert [r.frame_idx for r in tres] == [r.frame_idx for r in jres] == list(range(N_FRAMES))
    js, ts = [r.state.name for r in jres], [r.state.name for r in tres]
    first = js.index("OK")
    assert ts.index("OK") == first < N_FRAMES // 2 and all(s == "OK" for s in ts[first:])
    assert [r.made_keyframe for r in tres] == [r.made_keyframe for r in jres]
    assert tr.lagged_frames == list(range(first + 1, N_FRAMES))  # the frames after the bootstrap
    for a, b in zip(jres[first:], tres[first:]):
        ang, dc = pose_gap(b.T_cw, a.T_cw)
        assert ang <= 1e-3 and np.abs(a.T_cw[:3, 3] - b.T_cw[:3, 3]).max() <= 1e-3, (a.frame_idx, ang)


def test_pipelined_mono_equals_sync(mono_runs):
    """The port's pipelined mono run is its synchronous run, bit for bit (the
    mapper runs before each next dispatch; no frame is rejected)."""
    _, _, tres, sres, _ = mono_runs
    _same_results(sres, tres)
