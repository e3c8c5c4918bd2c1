"""Hybrid points on the synchronous path and in the map: tpuslam_torch's
System with `TrackerConfig(points=PointFrontendParams())` (descriptor
stereo, mapping on) against tpuslam's on the same dot frames, the local BA
window with its point rows, and each keyframe event of the JAX mapper
replayed by this package's mapper (point culling, point fusion, the point
chi2 prune). The JAX map's native mirror is off (its covisibility ties
differ), keyframes are finished at once and cv2 is hidden."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_semidirect import _ate, _pose_gap
from torch_parity import DOTS, JaxAsOnTheCard, dot_scene, np_of, python_graph
from tpuslam_torch.backend import local_ba as tlba
from tpuslam_torch.backend.mapping import LocalMapper
from tpuslam_torch.convert import map_state, mapper_config_from, slam_map_from, tracker_config_from
from tpuslam_torch.frontend.frame import host_prescale
from tpuslam_torch.frontend.points import PointFrontendParams
from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState
from tpuslam_torch.system import System, bench_configs

N_FRAMES = 7  # keyframes at frames 0, 3 and 6


def _jax_config():
    from tpuslam.frontend.points import PointFrontendParams as JPoints
    from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig

    # tests/test_hybrid.py's configuration, a keyframe every 3 frames
    return JTrackerConfig(min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=3, points=JPoints())


@pytest.fixture(scope="module")
def runs():
    """The JAX System over the dot frames (the map and the mapper's state
    recorded before and after every keyframe event) and this package's."""
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.system import System as JSystem

    scene, frames = dot_scene(N_FRAMES)
    events = []
    with JaxAsOnTheCard():
        js = JSystem(JIntrinsics(*DOTS), sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=_jax_config())
        process = js.mapper.process

        def recorded(kf):
            m = js.mapper
            before = copy.deepcopy((map_state(js.map), dict(m._recent), dict(m._recent_pts), m._kf_count))
            process(kf)
            events.append(dict(kid=kf.kid, before=before, after=copy.deepcopy(map_state(js.map)), last_ba=m.last_ba))

        js.mapper.process = recorded
        for f, (il, ir) in enumerate(frames):
            js.track_stereo(il, ir, f * 0.05)
        js.shutdown()
    with python_graph():
        ts = System(DOTS, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tracker_config_from(_jax_config()), device="cpu")
    for f, (il, ir) in enumerate(frames):
        ts.track_stereo(il, ir, f * 0.05)
    ts.shutdown()
    return scene, js, events, ts


def test_sync_system_matches_jax(runs):
    """Every frame OK, each camera within 5 cm of the JAX package's, ATE
    within its ATE + 0.01 m, the same keyframe frames, and live point
    landmarks seen from two keyframes or more."""
    scene, js, _, ts = runs
    traj = ts.trajectory
    assert [r.frame_idx for r in traj] == list(range(N_FRAMES)) and all(r.state == TrackingState.OK for r in traj)
    for r, rj in zip(traj, js.trajectory):
        assert _pose_gap(r.T_cw, rj.T_cw)[1] <= 0.05, r.frame_idx
    assert _ate(traj, scene) <= _ate(js.trajectory, scene) + 0.01
    assert [r.frame_idx for r in traj if r.made_keyframe] == [r.frame_idx for r in js.trajectory if r.made_keyframe]
    pts = ts.map_points()
    assert (pts["n_obs"] >= 2).sum() >= 50 and len(pts["ids"]) >= 100
    assert ts.kf_db.point_slots == 256


def test_map_state_round_trip_with_points(runs):
    """The JAX map, point store and keyframe corners included, carried into
    this package's map and back, unchanged."""
    _, js, _, _ = runs
    a, b = map_state(js.map), map_state(slam_map_from(map_state(js.map)))
    for k in ("xyz", "alive", "desc_bits", "n_obs", "first_kf"):
        np.testing.assert_array_equal(a["points"][k], b["points"][k])
    assert a["points"]["obs"] == b["points"]["obs"] and a["points"]["free"] == b["points"]["free"]
    for ka, kb in zip(a["keyframes"], b["keyframes"]):
        np.testing.assert_array_equal(ka["point_ids"], kb["point_ids"])
        for f in ka["point_features"]:
            np.testing.assert_array_equal(ka["point_features"][f], kb["point_features"][f])


def test_ba_point_rows_match_jax(runs):
    """The last keyframe's window on the final map: the problem equal field
    by field, point blocks and observation rows included (exact); the
    solves' poses within 2e-4; written back with the chi2 prune, the same
    observations kept."""
    from tpuslam.backend import local_ba as jlba
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    _, js, _, _ = runs
    jmap = copy.deepcopy(js.map)
    tmap = slam_map_from(map_state(jmap))
    center = max(jmap.keyframes)
    jprob, jctx = jlba.assemble_problem(jmap, center, JIntrinsics(*DOTS), jlba.LocalBAConfig())
    tprob, tctx = tlba.assemble_problem(tmap, center, DOTS, tlba.LocalBAConfig(), device="cpu")
    assert len(jctx["point_ids"]) >= 100 and jctx["p_obs_table"].shape[0] >= 200
    for name in jprob._fields:
        a, b = np.asarray(getattr(jprob, name)), np_of(getattr(tprob, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for k in jctx:
        np.testing.assert_array_equal(np.asarray(jctx[k]), np.asarray(tctx[k]), err_msg=k)
    jres = jlba.solve_in_process(jprob, JIntrinsics(*DOTS), jlba.LocalBAConfig())
    tres = tlba.solve_in_process(tprob, DOTS, tlba.LocalBAConfig())
    np.testing.assert_allclose(tres["poses"], jres["poses"], atol=2e-4)
    jstats = jlba.apply_result(jmap, jlba.LocalBAConfig(), jctx, copy.deepcopy(jres))
    tstats = tlba.apply_result(tmap, tlba.LocalBAConfig(), tctx, copy.deepcopy(jres))  # one result through both write-backs
    assert tuple(jstats) == tuple(tstats)
    got, want = map_state(tmap), map_state(jmap)
    assert got["points"]["obs"] == want["points"]["obs"]
    np.testing.assert_array_equal(got["points"]["xyz"], want["points"]["xyz"])


@pytest.mark.parametrize("which", [0, 1])
def test_mapper_event_matches_jax(runs, which):
    """A keyframe event of the JAX run replayed by this package's mapper from
    the map the JAX mapper started from: the same point and line landmarks
    culled, fused and pruned (observations, liveness, free lists, keyframe
    slots exact), poses within 2e-4, points seen from 3 keyframes or more
    within 1e-2 m."""
    _, js, events, _ = runs
    ev = [e for e in events if e["kid"] > 0][which]
    before, recent, recent_pts, kf_count = ev["before"]
    tmap = slam_map_from(before)
    mapper = LocalMapper(tmap, DOTS, mapper_config_from(js.mapper.cfg), device="cpu")
    mapper._recent, mapper._recent_pts, mapper._kf_count = dict(recent), dict(recent_pts), kf_count
    mapper.process(tmap.keyframes[ev["kid"]])
    got, want = map_state(tmap), ev["after"]
    assert before["lines"]["obs"] != want["lines"]["obs"]  # the event changes the map
    if which == 1:  # and the second one its points (fusion, the recent-point cull, the prune)
        assert before["points"]["obs"] != want["points"]["obs"]
    for fam in ("lines", "points"):
        assert got[fam]["obs"] == want[fam]["obs"], fam
        np.testing.assert_array_equal(got[fam]["alive"], want[fam]["alive"])
        assert got[fam]["free"] == want[fam]["free"]
    assert got["covis"] == want["covis"]
    for a, b in zip(got["keyframes"], want["keyframes"]):
        np.testing.assert_array_equal(a["point_ids"], b["point_ids"])
        np.testing.assert_array_equal(a["line_ids"], b["line_ids"])
        np.testing.assert_allclose(a["T_cw"], b["T_cw"], atol=2e-4)
    firm = want["points"]["alive"] & (want["points"]["n_obs"] >= 3)
    if firm.any():
        np.testing.assert_allclose(got["points"]["xyz"][firm], want["points"]["xyz"][firm], atol=1e-2)
    stats, jstats = mapper.last_ba, ev["last_ba"]
    assert stats[:4] == jstats[:4] and stats.n_pruned == jstats.n_pruned


def _track_two(tracker, frames, mono=False):
    """Two frames through ``tracker`` and its flush: the results in order."""
    out = []
    for f, fr in enumerate(frames):
        r = tracker.track_monocular(fr[0], f * 0.05) if mono else tracker.track_stereo(fr[0], fr[1], f * 0.05)
        out += ([] if r is None else [r]) + tracker.pop_results()
    return out + tracker.flush_all()


def _fused_hybrid_program():
    """The single-frame hybrid program on frame 1 against the local maps of
    a tracker initialized on frame 0: accepted, with corner matches."""
    from tpuslam_torch.frontend import pipeline
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    _, frames = dot_scene(2)
    tr = Tracker(DOTS, SlamMap(), dataclasses.replace(bench_configs(points=True)[0], chunk=1, semidirect=None), device="cpu")
    tr.track_stereo(*frames[0], 0.0)
    c = tr.cfg
    pair = torch.from_numpy(np.stack([host_prescale(x, c.frontend) for x in frames[1]]))
    T0, T1 = tr._seed_chain()
    out = pipeline.fused_stereo_frame_hybrid(
        pair, T0, T1, tr._local_map_arrays(), tr._point_local_arrays(), tr._fxb, DOTS, c.frontend, tr._direct_lines(),
        tr._direct_points(), c.points, c.search_coarse, c.search_fine, c.pose_opt, c.min_track_inliers,
    )
    assert out.packed.shape == (20,) and float(out.packed[19]) == 1.0 and int((out.p_match_idx >= 0).sum()) > 10


def _single_frame_hybrid_pipeline():
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    _, frames = dot_scene(2)
    tr = Tracker(DOTS, SlamMap(), dataclasses.replace(bench_configs(points=True)[0], chunk=1, semidirect=None), device="cpu")
    out = _track_two(tr, frames)
    assert [r.frame_idx for r in out] == [0, 1] and all(r.state.name == "OK" for r in out)
    assert tr.anchor_frames == [1] and tr.sync_frames == [0]


def _pipelined_hybrid_mono():
    """Pipelined mono with points tracks synchronously, as in the JAX package."""
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    _, frames = dot_scene(2)
    tr = Tracker(DOTS, SlamMap(), bench_configs(points=True)[0], device="cpu")
    out = _track_two(tr, frames, mono=True)
    assert [r.frame_idx for r in out] == [0, 1] and tr.sync_frames == [0, 1] and tr.lagged_frames == []


def _hybrid_map_round_trip(runs, tmp_path):
    """The hybrid System's map saved and loaded into a fresh hybrid System:
    the same map state, corners and point landmarks included, the
    relocalization database rebuilt with the corners' words; the JAX
    load_map reads the same file to the same state."""
    from test_torch_serialize import assert_same_state
    from tpuslam.slammap.serialize import load_map as j_load_map

    _, _, _, ts = runs
    assert len(ts.map_points()["ids"]) >= 100
    p = str(tmp_path / "map.npz")
    ts.save_map(p)
    fresh = System(DOTS, loop_closing=False, tracker_cfg=TrackerConfig(points=PointFrontendParams()), device="cpu")
    fresh.load_map(p)
    assert_same_state(map_state(fresh.map), map_state(ts.map))
    assert_same_state(map_state(j_load_map(p)), map_state(ts.map))
    assert len(fresh.kf_db) == len(fresh.map.keyframes) and fresh.kf_db.point_slots == 256


def _unported():
    """name -> run(request): the hybrid paths that raised until they were
    ported (the single-frame fused programs, the classic pipeline, map
    serialization)."""
    return {
        "single-frame fused hybrid program": lambda request: _fused_hybrid_program(),
        "single-frame hybrid pipeline": lambda request: _single_frame_hybrid_pipeline(),
        "map serialization": lambda request: _hybrid_map_round_trip(
            request.getfixturevalue("runs"), request.getfixturevalue("tmp_path")
        ),
        "pipelined mono tracking": lambda request: _pipelined_hybrid_mono(),
    }


@pytest.mark.parametrize("name", list(_unported()))
def test_unported_hybrid_paths_raise(name, request):
    """The hybrid paths that used to raise: each builds and tracks two QVGA
    frames on the CPU, and the hybrid map saves and loads."""
    _unported()[name](request)
