"""The solver process (tpuslam_torch.backend.ba_worker) and the mapper's
asynchronous path against the JAX package's (tests/test_ba_worker.py), on
the CPU at toy size.

One solver process serves the module: its solves against this process's
and against the JAX package's ``solve_in_process`` on the same numpy
problem, a blocking solve while a submit is in flight, global BA through
it. The mapper: a stale generation dropped, the freshest window sent by
``tick()`` after a skip, a System with TPUSLAM_BA_SUBPROCESS=1. And the
lockstep: the JAX System's mapper with a stub solver (its own package's
solve, released on a schedule the test fixes) replayed call by call
(process, tick, finish) by this package's mapper with its own stub, from
the same map before each call, fusion deferred or not."""

import numpy as np
import pytest
import torch

from torch_loop_lockstep import jax_solve, rebind_pending_fuse
from torch_parity import QVGA, np_of, stereo_scene
from tpuslam_torch import Intrinsics
from tpuslam_torch.backend import local_ba as tlba
from tpuslam_torch.backend.ba_worker import BASolverWorker
from tpuslam_torch.backend.lm import BAProblem, LMConfig, run_lm
from tpuslam_torch.backend.mapping import LocalMapper, MapperConfig
from tpuslam_torch.convert import map_state, mapper_config_from, slam_map_from
from tpuslam_torch.parallel.sharded_ba import _toy_problem
from tpuslam_torch.slammap.map import SlamMap

CAM = QVGA  # the solver's camera: the toy problems' and the System's


@pytest.fixture(scope="module")
def worker():
    """One solver process on the CPU, no warm rungs, at QVGA."""
    w = BASolverWorker(CAM, warm_caps=(), device="cpu")
    w.wait_ready(120.0)
    yield w
    w.close()


def _toy(seed, P_, L, OL):
    return _toy_problem(np.random.default_rng(seed), P_=P_, L=L, OL=OL, cam=CAM, device="cpu")


def _solve_args(cfg):
    return cfg.lm, cfg.chi2_line, cfg.chi2_point


def test_worker_solve_matches_in_process_and_jax(worker):
    """The child's solve of a toy problem against this process's (1e-5, it
    is in fact bit-equal on one CPU) and against the JAX package's
    solve_in_process on the same numpy problem: rotations within
    test_torch_mapping's 2e-4 (5.6e-7 here), the chi2 masks equal, both
    final costs at the float32 floor (at most 1e-8 of the initial cost, as
    test_torch_bench holds the toy solves). The translations are not
    compared: this line-only problem's scale is free, and the two packages'
    solutions part along it by 3.7e-3 (test_torch_bench.py). A second solve
    of the same bucket is warm."""
    from tpuslam.backend import local_ba as jlba
    from tpuslam.backend.lm import BAProblem as JBAProblem
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    cfg = tlba.LocalBAConfig()
    prob = _toy(0, 4, 32, 128)
    arrays = tlba.problem_arrays(prob)
    assert {k: v.dtype for k, v in arrays.items()} == {k: np_of(v).dtype for k, v in prob._asdict().items()}
    ref = tlba.solve_in_process(prob, CAM, cfg)
    res, err = worker.solve(arrays, *_solve_args(cfg), timeout=120.0)
    assert err is None, err
    for k in ("poses", "lines", "points", "inl_l", "inl_p", "inl_l0", "inl_p0"):
        np.testing.assert_allclose(res[k], ref[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(res["cost"], ref["cost"], rtol=1e-4, atol=1e-6)
    assert res["solve_ms"] > 0 and set(res["stage_ms"]) == {"lm_enqueue", "chi2_enqueue", "exec_d2h"}
    assert res["warm"] is False and worker.solve(arrays, *_solve_args(cfg), timeout=120.0)[0]["warm"] is True

    jref = jlba.solve_in_process(JBAProblem(**arrays), JIntrinsics(*CAM), jlba.LocalBAConfig())
    np.testing.assert_allclose(res["poses"][:, :3, :3], np.asarray(jref["poses"])[:, :3, :3], atol=2e-4)
    for k in ("inl_l", "inl_p", "inl_l0", "inl_p0"):
        np.testing.assert_array_equal(res[k], np.asarray(jref[k]), err_msg=k)
    cost0 = float(run_lm(prob, CAM, LMConfig(max_iters=0)).cost)
    assert res["cost"] <= 1e-8 * cost0 and float(jref["cost"]) <= 1e-8 * cost0, (res["cost"], jref["cost"], cost0)


def test_blocking_solve_during_inflight_submit(worker):
    """A blocking solve (global BA) issued while a submit (local BA) is in
    flight gets its own result, and the submit's is stashed for its poll."""
    cfg = tlba.LocalBAConfig()
    prob_a, prob_b = _toy(1, 4, 32, 128), _toy(7, 8, 64, 256)
    ref_a, ref_b = (tlba.solve_in_process(p, CAM, cfg) for p in (prob_a, prob_b))
    req_a = worker.submit(tlba.problem_arrays(prob_a), *_solve_args(cfg))
    res_b, err = worker.solve(tlba.problem_arrays(prob_b), *_solve_args(cfg), timeout=120.0)
    assert err is None, err
    assert res_b["poses"].shape == ref_b["poses"].shape
    np.testing.assert_allclose(res_b["poses"], ref_b["poses"], atol=1e-5)
    out = worker.poll(req_a, timeout=120.0)
    assert out is not None, "the submit's response was lost"
    res_a, err = out
    assert err is None, err
    np.testing.assert_allclose(res_a["poses"], ref_a["poses"], atol=1e-5)


def test_pretouch_and_error(worker):
    """A pretouch answers two toy solves' ms; a malformed problem comes back
    as an error, not a result."""
    cfg = tlba.LocalBAConfig()
    first, steady = worker.pretouch_wait(worker.pretouch_async((8, 128, 512), *_solve_args(cfg)), 120.0)
    assert first > 0 and steady > 0
    bad = tlba.problem_arrays(_toy(2, 4, 32, 128))
    del bad["l_sigma"]
    res, err = worker.solve(bad, *_solve_args(cfg), timeout=120.0)
    assert res is None and "l_sigma" in err


@pytest.fixture(scope="module")
def system_run():
    """A System with TPUSLAM_BA_SUBPROCESS=1 on the CPU over 12 QVGA
    stereo frames, a keyframe at least every 3: (scene, System, its solver
    handle)."""
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.system import System

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_BA_SUBPROCESS", "1")
        mp.setenv("TPUSLAM_BA_WORKER_WARMUP", "0")
        mp.setenv("TPUSLAM_NATIVE_MAP", "0")
        scene, frames = stereo_scene(12, QVGA)
        s = System(QVGA, sensor="stereo", loop_closing=False, tracker_cfg=TrackerConfig(max_frames_between_kf=3), device="cpu")
        worker = s._ba_worker
        for f, (il, ir) in enumerate(frames):
            s.track_stereo(il, ir, f * 0.05)
        s.shutdown()
    return scene, s, worker


def test_global_ba_through_the_worker(worker, system_run):
    """Global BA of a System's map: its rounds through the solver (float64
    arrays in, float64 back) write back what the rounds on the device write
    (poses and lines within 1e-6: CPU BLAS rounds by alignment) with the
    same stats; a solver error raises instead of solving here."""
    from tpuslam_torch.backend.global_ba import GlobalBAConfig, global_bundle_adjustment

    cfg = GlobalBAConfig()
    state = map_state(system_run[1].map)
    a, b = slam_map_from(state), slam_map_from(state)
    rec_a, rec_b = {}, {}
    sa = global_bundle_adjustment(a, QVGA, cfg, device="cpu", record=rec_a)
    sb = global_bundle_adjustment(b, QVGA, cfg, device="cpu", record=rec_b, solver=worker)
    assert tuple(sa)[:3] == tuple(sb)[:3] and sa.applied and sb.applied and sa.n_poses >= 3
    np.testing.assert_allclose(sa.cost, sb.cost, rtol=1e-5)
    assert len(rec_b["solves"]) == 1 + cfg.outlier_rounds and rec_a["rung"] == rec_b["rung"]
    for arrays, res, ms in rec_b["solves"]:
        assert arrays["poses"].dtype == np.float64 and res["poses"].dtype == np.float64 and ms > 0
    sa_, sb_ = map_state(a), map_state(b)
    moved = 0.0
    for x, y, k0 in zip(sa_["keyframes"], sb_["keyframes"], state["keyframes"]):
        np.testing.assert_allclose(x["T_cw"], y["T_cw"], atol=1e-6)
        moved = max(moved, float(np.abs(x["T_cw"] - k0["T_cw"]).max()))
    assert moved > 0.0  # global BA moved the keyframes
    np.testing.assert_allclose(sa_["lines"]["plucker"], sb_["lines"]["plucker"], atol=1e-6)

    class Failing:
        def solve(self, *a, **kw):
            return None, "boom"

    with pytest.raises(RuntimeError, match="boom"):
        global_bundle_adjustment(slam_map_from(state), QVGA, cfg, device="cpu", solver=Failing())


def test_worker_defaults_to_the_card(monkeypatch):
    """Without device=..., the solver process asks for the card; without
    one it raises before starting anything."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        BASolverWorker(CAM, warm_caps=())


def test_dead_worker_raises():
    """A child that exits mid-run raises at the next poll (a failed run,
    not a silent synchronous fallback); warm rungs are solved at start-up."""
    w = BASolverWorker(CAM, warm_caps=((8, 128, 512),), device="cpu")
    try:
        w.wait_ready(120.0)
        req = w.submit(tlba.problem_arrays(_toy(4, 4, 32, 128)), *_solve_args(tlba.LocalBAConfig()))
        assert w.poll(req, timeout=120.0)[1] is None and w.n_warmed == 1
        w._proc.terminate()
        w._proc.join(10.0)
        with pytest.raises(RuntimeError, match="exited"):
            w.poll(req + 1, timeout=5.0)
    finally:
        w.close()
    assert not w.alive


class FakeSolver:
    def poll(self, req_id, timeout=0.0):
        return {"poses": np.zeros((1, 4, 4)), "lines": np.zeros((1, 6)), "points": np.zeros((1, 3)), "cost": 0.0,
                "solve_ms": 1.0}, None


def _empty_ctx(m):
    return {"generation": m.generation, "window": [], "fixed": [], "kf_order": [], "line_order": [], "point_ids": [],
            "obs_table": np.zeros((0, 3), np.int32), "p_obs_table": np.zeros((0, 3), np.int32),
            "pose_free": np.zeros(1, np.float32)}


def test_stale_generation_discard():
    """A solve assembled before a loop correction is dropped at its write
    back, its time still recorded and the slot freed."""
    m = SlamMap()
    mapper = LocalMapper(m, CAM, MapperConfig(), solver=FakeSolver(), device="cpu")
    mapper._ba_ctx = _empty_ctx(m)
    mapper._ba_req = 1
    m.generation += 1  # a loop closure corrected the map meanwhile
    mapper._poll_ba(blocking=False)
    assert mapper.ba_stale == 1 and mapper.ba_failed == 0
    assert mapper.last_ba is None
    assert mapper._ba_ctx is None
    assert mapper.solve_ms == [1.0]


def test_failed_solve_is_counted():
    """A solve that comes back with an error is counted, not applied."""

    class Erring:
        def poll(self, req_id, timeout=0.0):
            return None, "RuntimeError('x')"

    m = SlamMap()
    mapper = LocalMapper(m, CAM, MapperConfig(), solver=Erring(), device="cpu")
    mapper._ba_ctx, mapper._ba_req = _empty_ctx(m), 1
    mapper._poll_ba(blocking=False)
    assert mapper.ba_failed == 1 and mapper._ba_ctx is None and mapper.last_ba is None


def test_ba_resubmit_freshest_window_after_skip():
    """A window skipped while the solver was busy is made good by tick():
    the freshest window, once the solver is free."""
    m = SlamMap()
    mapper = LocalMapper(m, CAM, MapperConfig(), solver=object(), device="cpu")
    m.keyframes = {0: object(), 3: object()}
    submitted = []
    mapper._submit_ba = lambda kid: submitted.append(kid)
    mapper._ba_want_resubmit = True
    mapper._ba_ctx = {"generation": 0}
    mapper._poll_ba = lambda blocking: None
    mapper.tick()  # still busy
    assert submitted == []
    mapper._ba_ctx = None
    mapper.tick()
    assert submitted == [3]
    assert mapper.ba_resubmitted == 1


def test_system_with_worker_mapping(system_run):
    """The System with TPUSLAM_BA_SUBPROCESS=1: every frame OK, solves
    submitted and written back, the last drained at shutdown, the child
    gone after it, ATE within the JAX test's 0.05 m."""
    from tpuslam_torch.eval.ate import absolute_trajectory_error
    from tpuslam_torch.frontend.tracking import TrackingState

    scene, s, worker = system_run
    mp_ = s.mapper
    assert worker is not None and mp_.solver is worker
    assert len(s.trajectory) == 12 and all(r.state == TrackingState.OK for r in s.trajectory)
    assert mp_.ba_submitted >= 1 and mp_.ba_failed == 0 and mp_.ba_stale == 0
    assert mp_.last_ba is not None, "no solve was written back"
    assert mp_._ba_ctx is None, "the in-flight solve was not drained"
    assert len(mp_.solve_ms) + len(mp_.cold_solve_ms) == mp_.ba_submitted
    assert s._ba_worker is None and not worker.alive
    est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in s.trajectory])
    gt = np.stack([np.linalg.inv(scene.poses[r.frame_idx])[:3, 3] for r in s.trajectory])
    assert absolute_trajectory_error(est, gt).rmse < 0.05


def test_system_worker_policy(monkeypatch):
    """TPUSLAM_BA_SUBPROCESS defaults to 0 on the CPU (no child) and to 1
    on the card; the JAX bench's FUSEDEFER reaches the mapper through
    bench_configs."""
    from tpuslam_torch.system import System, bench_configs

    monkeypatch.delenv("TPUSLAM_BA_SUBPROCESS", raising=False)
    s = System(QVGA, sensor="stereo", loop_closing=False, device="cpu")
    assert s._ba_worker is None and s.mapper.solver is None
    s.shutdown()
    assert bench_configs()[1].fuse_defer is False and bench_configs(fuse_defer=True)[1].fuse_defer is True


# ---- lockstep: the JAX mapper and this package's under one schedule -----
N_FRAMES = 24
# the frames a request waits before its poll answers, by request id (cycled):
# the first outlasts the next keyframe (a skip, then a resubmit from tick)
LAGS = (5, 1, 2, 1, 4, 1)
BUMP_FRAME = 16  # a stand-in loop correction: map.generation += 1 before this frame's tick


class Stub:
    """A solver that answers submit/poll with ``solve`` (its package's
    solve_in_process); a request's poll answers once LAGS frames have
    passed since its submit, or when the poll waits (a drain). With
    ``problems`` (request id -> arrays) it solves those, the other
    package's, instead of the arrays submitted (kept in ``submitted``)."""

    def __init__(self, solve, problems=None, n_obs=None):
        self.solve, self.problems, self.frame, self.next_id, self.pending, self.submitted = solve, problems, 0, 0, {}, {}
        self.n_obs, self.n_obs_at, self.answered = n_obs, {}, []  # the map's n_obs at each submit; ids answered

    def submit(self, arrays, lm, chi2_line, chi2_point):
        self.next_id += 1
        self.submitted[self.next_id] = arrays
        if self.n_obs is not None:
            self.n_obs_at[self.next_id] = self.n_obs()
        if self.problems is not None:
            arrays = self.problems[self.next_id]
        self.pending[self.next_id] = (self.frame, (arrays, lm, chi2_line, chi2_point))
        return self.next_id

    def poll(self, req_id, timeout=0.0):
        at, args = self.pending[req_id]
        if timeout <= 0 and self.frame - at < LAGS[(req_id - 1) % len(LAGS)]:
            return None
        del self.pending[req_id]
        self.answered.append(req_id)
        return dict(self.solve(*args), solve_ms=1.0, warm=True), None


def _port_solve(arrays, lm, chi2_line, chi2_point):
    prob = BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return tlba.solve_in_process(prob, Intrinsics(*LOCK_CAM), tlba.LocalBAConfig(lm=lm, chi2_line=chi2_line, chi2_point=chi2_point))


LOCK_CAM = (458.0, 457.0, 320.0, 240.0, 640, 480, 0.11)  # test_torch_mapping's VGA rig
COUNTERS = ("ba_submitted", "ba_skipped", "ba_resubmitted", "ba_stale", "_kf_count")


def _mapper_state(mp_):
    return dict({k: getattr(mp_, k) for k in COUNTERS}, recent=dict(mp_._recent), in_flight=mp_._ba_ctx is not None,
                pending_fuse=getattr(mp_, "_fuse_pending", None) is not None, n_solves=len(mp_.solve_ms))


def jax_lockstep(fuse_defer: bool, delay_s: float):
    """The JAX System over test_torch_mapping's 24 frames of exact synthetic
    features (a keyframe at least every 3 frames), its mapper asynchronous
    on a Stub; every mapper call (process, tick, finish) recorded with the
    map before and after it and the mapper's state after it. Returns (the
    calls, the problems submitted by request id)."""
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig
    from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
    from tpuslam.geometry import Intrinsics as JIntrinsics
    from tpuslam.io.synthetic import make_wireframe_scene, synthetic_frame_features
    from tpuslam.system import System as JSystem

    jcam = JIntrinsics(*LOCK_CAM)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSLAM_NATIVE_MAP", "0")
        mp.setenv("TPUSLAM_BA_SUBPROCESS", "0")
        rng = np.random.default_rng(0)
        scene = make_wireframe_scene(rng, n_segments=140, n_frames=N_FRAMES, cam=jcam, motion_scale=0.02)
        js = JSystem(jcam, sensor="stereo", loop_closing=False, tracker_cfg=JTrackerConfig(max_frames_between_kf=3),
                     mapper_cfg=JMapperConfig(fuse_defer=fuse_defer, fuse_apply_delay_s=delay_s))
        stub = Stub(jax_solve(jcam), n_obs=lambda: np.array(js.map.lines.n_obs))
        jm = js.mapper
        jm.solver = stub

        def recorded(name):
            inner = getattr(jm, name)

            def call(*args, **kw):
                before = map_state(js.map)
                n0 = len(stub.answered)
                inner(*args, **kw)
                calls.append(dict(name=name, kid=args[0].kid if name == "process" else None, frame=stub.frame,
                                  before=before, after=map_state(js.map), state=_mapper_state(jm),
                                  answered=stub.answered[n0:]))

            setattr(jm, name, call)

        for name in ("process", "tick", "finish"):
            recorded(name)
        for f in range(N_FRAMES):
            feats, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng, with_depth=True)
            stub.frame = js.tracker.frame_idx = f
            js.trajectory.append(js.tracker._track(feats, f * 0.05, stereo=True))
            if f == BUMP_FRAME:
                js.map.generation += 1
            jm.tick()
        jm.finish()
    return calls, stub.submitted, stub.n_obs_at


def _line_residuals_px(got, want):
    """The event test's image check: each live line's JAX endpoints, in
    front of each keyframe that observes it (JAX pose), against this
    package's line in that image; the largest distance in px."""
    from tpuslam_torch.backend.residuals import line_residuals
    from tpuslam_torch.geometry import project_points, se3_apply

    poses = {k["kid"]: k["T_cw"] for k in want["keyframes"]}
    alive = want["lines"]["alive"]
    rows = [(l, k) for l in np.nonzero(alive)[0] for k in want["lines"]["obs"][int(l)]]
    if not rows:
        return 0.0
    T = torch.from_numpy(np.stack([poses[k] for _, k in rows]))
    X = se3_apply(T[:, None], torch.from_numpy(np.stack([want["lines"]["endpoints"][l] for l, _ in rows])))
    front = (X[..., 2] > 0.1).all(dim=-1)
    L = torch.from_numpy(np.stack([got["lines"]["plucker"][l] for l, _ in rows]))
    cam = Intrinsics(*LOCK_CAM)
    return float(line_residuals(T[front], L[front], project_points(cam, X[front]), cam).abs().max())


@pytest.mark.parametrize("fuse_defer,delay_s", [(False, 0.0), (True, 0.0), (True, 1e9)], ids=["sync_fuse", "defer_tick", "defer_keyframe"])
def test_lockstep_matches_jax(fuse_defer, delay_s):
    """Each of the JAX mapper's calls replayed by this package's mapper
    (its own Stub, the same schedule) from the same map. After every call:
    the same counters, recent landmarks, in-flight solve and pending fusion;
    the same observations, live landmarks, free list, keyframes, line ids
    and covisibility; poses within test_mapper_event_matches_jax's 2e-4,
    firm lines' endpoints within its 1e-2 and every observed line within
    its 1 px in the JAX images. Firm here is seen from 4+ keyframes, now
    and when the window written back was assembled: these early windows'
    keyframes are 3 frames apart, and a line seen from three of them slides
    along its viewing rays between the two packages' float32 solutions by
    up to 0.52 m (call 27 of defer_tick) while its images agree within
    0.002 px; lines seen from four or more agree within 6.3e-4 m, poses
    within 1e-6. The schedule
    covers skips, resubmits, a stale solve, and with fuse_defer fusions
    applied at a tick (delay 0) or at the next keyframe event (delay 1e9).

    A call that writes a solve back and then submits (a keyframe event, a
    resubmitting tick) assembles the next window from its own package's
    solution, and weakly observed lines (seen from two nearby keyframes)
    differ between the packages' float32 solutions along their viewing
    rays by up to ~1 (Pluecker units); a window assembled from them would
    carry that into the next solve. So this package's stub solves the
    problem the JAX mapper submitted under the same request id, and the
    problem this package's mapper submitted is held to it: the same
    shapes, dtypes, observation indices and validity, and poses within
    2e-4."""
    calls, jax_problems, n_obs_at = jax_lockstep(fuse_defer, delay_s)
    last = calls[-1]["state"]
    assert last["ba_skipped"] >= 1 and last["ba_resubmitted"] >= 1 and last["ba_stale"] >= 1
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig

    stub = Stub(_port_solve, problems=jax_problems)
    cfg = mapper_config_from(JMapperConfig(fuse_defer=fuse_defer, fuse_apply_delay_s=delay_s))
    mapper = LocalMapper(SlamMap(), Intrinsics(*LOCK_CAM), cfg, solver=stub, device="cpu")
    fuse_applied = {"tick": 0, "process": 0, "finish": 0}
    inner_apply = mapper._fuse_apply
    applies = []

    def counted_apply(*args):
        applies.append(1)
        return inner_apply(*args)

    mapper._fuse_apply = counted_apply
    for i, c in enumerate(calls):
        m = slam_map_from(c["before"])
        mapper.map = m
        rebind_pending_fuse(mapper, m)
        stub.frame = c["frame"]
        n_applies = len(applies)
        if c["name"] == "process":
            mapper.process(m.keyframes[c["kid"]])
        else:
            getattr(mapper, c["name"])()
        if fuse_defer:
            fuse_applied[c["name"]] += len(applies) > n_applies
        where = f"call {i} ({c['name']} at frame {c['frame']})"
        assert _mapper_state(mapper) == c["state"], where
        got, want = map_state(m), c["after"]
        assert got["lines"]["obs"] == want["lines"]["obs"], where
        np.testing.assert_array_equal(got["lines"]["alive"], want["lines"]["alive"], err_msg=where)
        assert got["lines"]["free"] == want["lines"]["free"], where
        assert [k["kid"] for k in got["keyframes"]] == [k["kid"] for k in want["keyframes"]], where
        assert got["covis"] == want["covis"], where
        for a, b in zip(got["keyframes"], want["keyframes"]):
            np.testing.assert_array_equal(a["line_ids"], b["line_ids"], err_msg=where)
            np.testing.assert_allclose(a["T_cw"], b["T_cw"], atol=2e-4, err_msg=where)
        assert stub.answered[len(stub.answered) - len(c["answered"]):] == c["answered"], where
        # firm: seen from 4+ keyframes now and when each solve written back
        # here was assembled (a window solved late may hold fewer)
        firm = want["lines"]["alive"] & (want["lines"]["n_obs"] >= 4)
        for rid in c["answered"]:
            firm &= n_obs_at[rid] >= 4
        np.testing.assert_allclose(got["lines"]["endpoints"][firm], want["lines"]["endpoints"][firm], atol=1e-2, err_msg=where)
        assert _line_residuals_px(got, want) < 1.0, where
    assert sorted(stub.submitted) == sorted(jax_problems)
    for rid, mine in stub.submitted.items():
        theirs = jax_problems[rid]
        assert mine.keys() == theirs.keys()
        for k, a in mine.items():
            b = np.asarray(theirs[k])
            assert a.shape == b.shape and a.dtype == b.dtype, (rid, k)
            if a.dtype.kind == "i" or k.endswith("valid") or k == "pose_free":
                np.testing.assert_array_equal(a, b, err_msg=f"request {rid}: {k}")
        np.testing.assert_allclose(mine["poses"], theirs["poses"], atol=2e-4, err_msg=f"request {rid}")
    if fuse_defer:  # where the deferred fusions were applied
        assert fuse_applied["tick" if delay_s == 0 else "process"] >= 1, fuse_applied
        assert fuse_applied["process" if delay_s == 0 else "tick"] == 0, fuse_applied
