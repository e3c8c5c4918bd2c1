"""The loop configuration with the solver process against the JAX package,
call by call, through real loop closures (tests/torch_loop_lockstep.py).

The JAX System (stereo, mapping, loop closing) runs over exact synthetic
features of ``io/synthetic.py``'s ``make_loop_scene`` (a circle of
N_CIRCLE frames, a keyframe at least every 2, the circle's start seen
again in its last EXTRA frames), its mapper and loop closer on a
ScheduledSolver: local BA asynchronous on the LAGS schedule, global BA
through the solver's blocking solve. Every mapper call and loop-closer call
is replayed by this package's mapper and loop closer from the JAX map
before it, with the JAX answers of the same requests (local BA) and
rounds (global BA, float32). The closures meet a local-BA solve in flight
(dropped as stale at its write-back) and, with fuse_defer, a pending
deferred fusion (dropped by its generation check). Bounds: those of
tests/test_torch_ba_worker.py's lockstep after a mapper call, those of
tests/test_torch_loop_closing.py's closure after a closer call
(torch_loop_lockstep.compare)."""

import numpy as np
import pytest

from torch_loop_lockstep import (
    CLOSE_POSE_TOL,
    POSE_TOL,
    ScheduledSolver,
    compare_problems,
    jax_solve,
    kf_map_ate,
    record_calls,
    replay,
)
from torch_parity import JaxAsOnTheCard
from tpuslam_torch import Intrinsics
from tpuslam_torch.convert import loop_config_from, mapper_config_from, slam_map_from

CAM = (458.0, 457.0, 320.0, 240.0, 640, 480, 0.11)  # tests/test_loopclosure.py's VGA rig
N_CIRCLE, EXTRA = 56, 8  # the circle's frames; frames of the second lap (three closures in them)
N_SEGMENTS = 450  # enough shared lines that the start region scores over LoopConfig.min_score
CAPACITY = 128  # line slots per frame: 53-95 segments are in view
LAGS = (5, 1, 2, 1, 4, 1)  # frames a request waits, by request id (cycled)
# (fuse_defer, fuse_apply_delay_s): fusion at the keyframe; deferred to the next keyframe event
FORMS = {"sync_fuse": (False, 0.0), "defer_keyframe": (True, 1e9)}


def gt_pose(scene):
    return lambda f: scene.poses[f % N_CIRCLE]


def kf_map_ate_of(state, scene):
    return kf_map_ate(slam_map_from(state), gt_pose(scene))


def jax_run(fuse_defer: bool, delay_s: float):
    """The JAX System over the synthetic loop, recorded call by call:
    (calls, its ScheduledSolver, its WritebackTrace, the JAX System, the
    scene)."""
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
    from tpuslam.geometry import Intrinsics as JIntrinsics
    from tpuslam.io.synthetic import make_loop_scene, synthetic_frame_features
    from tpuslam.system import System as JSystem

    jcam = JIntrinsics(*CAM)
    rng = np.random.default_rng(0)
    scene = make_loop_scene(rng, n_segments=N_SEGMENTS, n_frames=N_CIRCLE, radius=6.0, room=10.0, cam=jcam)
    with JaxAsOnTheCard(), pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_BA_SUBPROCESS", "0")
        mp.setenv("TPUSLAM_WARM_LOOP", "0")
        tcfg = JTrackerConfig(max_frames_between_kf=2, frontend=JFrontendParams(max_lines=CAPACITY))
        js = JSystem(jcam, sensor="stereo", loop_closing=True, tracker_cfg=tcfg,
                     mapper_cfg=JMapperConfig(fuse_defer=fuse_defer, fuse_apply_delay_s=delay_s))
        stub = ScheduledSolver(LAGS, jax_solve(jcam), n_obs=lambda: np.array(js.map.lines.n_obs),
                               closures=lambda: len(js.loop_closer.closed_loops))
        js.mapper.solver = js.loop_closer.solver = stub
        calls, trace = record_calls(js, stub, gt_pose(scene))
        for f in range(N_CIRCLE + EXTRA):
            feats, _ = synthetic_frame_features(scene, f % N_CIRCLE, CAPACITY, noise_px=0.3, rng=rng, with_depth=True)
            stub.frame = js.tracker.frame_idx = f
            js.trajectory.append(js.tracker._track(feats, f * 0.05, stereo=True))
            js.mapper.tick()
        js.mapper.finish()
        trace.uninstall()
    return calls, stub, trace, js, scene


@pytest.fixture(scope="module", params=list(FORMS))
def run(request):
    """One form's JAX run and its replay by this package: the JAX calls and
    solver, the replay's per-call parts, its solver, and its write-back
    ATEs."""
    fuse_defer, delay_s = FORMS[request.param]
    calls, jstub, jtrace, js, scene = jax_run(fuse_defer, delay_s)
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig

    parts, tstub, traces, ttrace = replay(
        calls, jstub, LAGS, Intrinsics(*CAM), mapper_config_from(JMapperConfig(fuse_defer=fuse_defer, fuse_apply_delay_s=delay_s)),
        loop_config_from(js.loop_closer.cfg), n_obs_at=jstub.n_obs_at, gt_pose=gt_pose(scene),
    )
    return dict(form=request.param, calls=calls, jstub=jstub, jtrace=jtrace, js=js, scene=scene, parts=parts, tstub=tstub,
                traces=traces, ttrace=ttrace)


def test_run_closes_a_loop_on_a_solve_in_flight(run):
    """The JAX run closes a real loop (a detected candidate, RANSAC, the
    essential graph and global BA through the solver) while a local-BA
    solve is in flight, drops that solve as stale at its write-back, and
    with fuse_defer meets a pending deferred fusion at the closure."""
    calls = run["calls"]
    closes = [i for i, c in enumerate(calls) if c["name"] == "close" and c["closed"]]
    assert closes, "no loop was closed"
    first = calls[closes[0]]
    assert first["candidate"] is not None and first["after"]["generation"] == first["before"]["generation"] + 1
    assert run["jstub"].global_submitted, "global BA did not go through the solver"
    # the closure happened with the keyframe's window in flight, and that window was dropped afterwards
    assert first["mapper"]["in_flight"]
    assert calls[-1]["mapper"]["ba_stale"] >= 1
    assert calls[-1]["mapper"]["ba_skipped"] >= 1 and calls[-1]["mapper"]["ba_resubmitted"] >= 1
    if run["form"] == "defer_keyframe":
        assert first["mapper"]["pending_fuse"]
    # the closure pulled the keyframe map toward the truth
    assert kf_map_ate_of(first["after"], run["scene"]) <= kf_map_ate_of(first["before"], run["scene"]) + 1e-6


def test_every_call_matches_jax(run):
    """Each mapper and loop-closer call of this package against the JAX
    call from the same map: nothing parts beyond the bounds."""
    parted = [(i, c["name"], c["frame"], p) for i, (c, p) in enumerate(zip(run["calls"], run["parts"])) if p]
    assert not parted, parted[:3]
    n_close = sum(1 for c in run["calls"] if c["name"] == "close" and c["closed"])
    assert len(run["calls"]) >= 100 and n_close >= 1


def test_submitted_problems_match_jax(run):
    """The local-BA problems this package submitted, by request id, and its
    global-BA rounds, against the JAX package's: the same shapes, indices
    and masks; poses within the mapper bound (local BA) and the closure's
    bound (global BA: the essential graph's result)."""
    jstub, tstub = run["jstub"], run["tstub"]
    assert sorted(tstub.submitted) == sorted(jstub.submitted)
    for rid, mine in tstub.submitted.items():
        assert not compare_problems(mine, jstub.submitted[rid], POSE_TOL), rid
    assert len(tstub.global_submitted) == len(jstub.global_submitted) >= 2
    for i, (mine, theirs) in enumerate(zip(tstub.global_submitted, jstub.global_submitted)):
        assert mine["l_endpoints"].dtype == np.float64  # the port's global BA sends float64
        assert not compare_problems(mine, theirs, CLOSE_POSE_TOL), i


def test_no_stale_writeback(run):
    """No local-BA result whose window was assembled before a closure is
    written back after it, in either package; solves submitted after the
    closure are written back."""
    for stub, trace in ((run["jstub"], run["jtrace"]), (run["tstub"], run["ttrace"])):
        assert trace.writes and not trace.stale_writes(stub)
        assert any(stub.closures_at[rid] >= 1 for rid, _ in trace.writes)
    assert run["ttrace"].writes == run["jtrace"].writes


def test_writeback_trace(run):
    """The keyframe-map ATE after each write-back, in both packages, on the
    same input: the same write-backs in the same order, each ATE within
    1e-3 m."""
    for c, mine in zip(run["calls"], run["traces"]):
        theirs = c["writebacks"]
        assert [label for label, _ in mine] == [label for label, _ in theirs], (c["name"], c["frame"])
        for (label, a), (_, b) in zip(mine, theirs):
            assert abs(a - b) <= 1e-3, (c["name"], c["frame"], label, a, b)
