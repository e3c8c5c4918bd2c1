"""Loop closing of tpuslam_torch against tpuslam: the LoopCloser on hand-built
drifted maps, global BA, and the System wiring.

The maps are the JAX package's own loop fixtures (tests/test_loopclosure.py
``_build_drifted_loop``, plain and with truncated endpoints; tests/test_sim3.py
``_build_scale_drifted_loop``, the mono Sim(3) case), built in the JAX
package and carried into the port's map by ``convert.map_state`` /
``slam_map_from``; a hybrid variant adds point landmarks, and a multi-view
variant fuses the start region's duplicate landmarks so that global BA has
lines seen from three keyframes. Tolerances: the RANSAC draws and Hamming
matches are exact (same candidate, same inlier count, same scale); the
refined loop transform within 1e-4 rad / 3e-4 m (the port's float32 pose LM
lands ~1e-4 from XLA's); after a closure, keyframe poses within 1e-3 (rad
and m: the loop edge carries the refinement's difference through the
essential graph), landmark endpoints and points within 2e-3 m and unit
Pluecker lines within 1e-3; after global BA, poses within 1e-3 and lines
seen from 3+ keyframes within 1e-2 (the float32 LM).

Run as a script, it prints the JAX package's numbers on the loop sequence
of chip_smoke.py (``make_loop_frames``: benchmarks/ladder.py's stereo_loop
scene with a 48-frame dwell), rendered by the port's renderer, on the CPU,
with cv2 hidden, TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0,
TPUSLAM_WARM_LOOP=0 and TPUSLAM_BA_SUBPROCESS=0 (the JAX_LOOP_* constants
there; ~6 min):

    python tests/test_torch_loop_closing.py

With ``--solver`` both packages keep their solver process on
(TPUSLAM_BA_SUBPROCESS=1: local BA asynchronous, global BA through the
solver), and with ``--port`` the port runs instead of the JAX package
(``System(cam, device="cpu")``, the native map mirror off, ~11 min):

    python tests/test_torch_loop_closing.py --solver
    python tests/test_torch_loop_closing.py --solver --port

The solver's schedule depends on timing, so run each a few times; each
run with the solver on prints its local-BA requests' lags, in frames from
the submit to the poll that got the answer (``LagProbe``). With
``--lag L`` (and ``--solver``) neither package starts a solver process: a
stand-in (``FixedLagSolver``) answers each local-BA request at the first
poll L or more frames after its submit, by the package's own child-side
solve in this process, and a global-BA solve at once, so that both
packages run the same schedule.

With ``--replay`` it runs the port on the CPU up to its first closure and
replays that closure in both packages from the same map (~10 min):
``replay_first_closure``.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from torch_parity import QVGA, JaxAsOnTheCard, python_graph, stereo_scene
from tpuslam_torch import Intrinsics
from tpuslam_torch.backend import loop_closing as tlc
from tpuslam_torch.backend.global_ba import global_bundle_adjustment
from tpuslam_torch.convert import global_ba_config_from, loop_config_from, map_state, slam_map_from

KINDS = ["plain", "truncated", "scale", "hybrid"]
ROT_TOL, TRANS_TOL = 1e-4, 3e-4  # the refined loop transform
POSE_TOL = 1e-3  # keyframe poses after a closure or global BA
LANDMARK_TOL = 2e-3  # endpoints and points (m)
PLUCKER_TOL = 1e-3  # unit Pluecker lines
GBA_LINE_TOL = 1e-2  # unit Pluecker lines seen from 3+ keyframes after global BA
LOOP_ENV = {**JaxAsOnTheCard.ENV, "TPUSLAM_WARM_LOOP": "0", "TPUSLAM_BA_SUBPROCESS": "0"}


# ---- the fixtures --------------------------------------------------------


def _add_points(smap, kfs, scene, true_poses):
    """Hybrid variant: corners at the visible segments' midpoints (identity
    stable BRIEF words per segment); point landmarks from keyframes 0-2 at
    their true positions and from the last keyframe at positions consistent
    with its drifted pose, as the fixture binds the lines."""
    from tpuslam.kernels.fast import PointFeatures as JPointFeatures

    words = np.random.RandomState(4321).randint(0, 2**32, size=(scene.segments.shape[0], 8), dtype=np.uint64).astype(np.uint32)
    mids = scene.segments.mean(axis=1)
    cam = scene.cam
    K = 128
    pst = smap.points
    for idx, (kf, vis, _) in enumerate(kfs):
        T = true_poses[kf.frame_idx]
        n = min(K, len(vis))
        Xc = mids[vis[:n]] @ T[:3, :3].T + T[:3, 3]  # camera frame, true pose
        pf = JPointFeatures(
            uv=np.zeros((K, 2), np.float32), valid=np.zeros(K, np.float32), response=np.zeros(K, np.float32),
            desc_bits=np.zeros((K, 8), np.uint32), depth=np.zeros(K, np.float32), has_depth=np.zeros(K, np.float32),
        )
        pf.uv[:n, 0] = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
        pf.uv[:n, 1] = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy
        pf.valid[:n] = 1.0
        pf.desc_bits[:n] = words[vis[:n]]
        pf.depth[:n] = Xc[:, 2]
        pf.has_depth[:n] = 1.0
        kf.point_features = pf
        kf.point_ids = np.full(K, -1, np.int32)
        if idx < 3 or idx == len(kfs) - 1:
            Twc = np.linalg.inv(kf.T_cw if idx == len(kfs) - 1 else T)
            for slot in range(n):
                pid = pst.allocate((Xc[slot] @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32), pf.desc_bits[slot], kf.kid)
                pst.add_observation(pid, kf, slot)


def _fuse_start_region(smap, kfs):
    """Multi-view variant: keyframes 1 and 2's landmarks of a segment keyframe
    0 also sees are fused into keyframe 0's (lines seen from two or three
    keyframes)."""
    st = smap.lines
    seg_of = {}
    for kf, vis, _ in kfs[:1]:
        for slot, seg in enumerate(vis[: int(kf.features.valid.sum())]):
            seg_of[int(seg)] = int(kf.line_ids[slot])
    for kf, vis, _ in kfs[1:3]:
        for slot, seg in enumerate(vis[: int(kf.features.valid.sum())]):
            lid = int(kf.line_ids[slot])
            if int(seg) in seg_of and lid >= 0 and lid != seg_of[int(seg)]:
                st.replace(lid, seg_of[int(seg)], smap.keyframes)


def _jax_fixture(kind: str):
    """(JAX map, JAX closer, keyframe kids, true poses, scene) of one fixture,
    its map without the native graph mirror (which also leaves the mirror's
    library unbuilt here)."""
    with JaxAsOnTheCard():
        return _jax_fixture_maps(kind)


def _jax_fixture_maps(kind: str):
    if kind == "scale":
        from test_sim3 import _build_scale_drifted_loop

        scene, smap, closer, kfs, true_poses, _ = _build_scale_drifted_loop()
        kfs = [(kf, vis, None) for kf, vis in kfs]
    else:
        from test_loopclosure import _build_drifted_loop

        # the multi-view variant's 24 keyframes overlap enough for lines seen from keyframes 0-2
        n_kf = 24 if kind == "multiview" else 10
        scene, smap, closer, kfs, true_poses = _build_drifted_loop(n_kf=n_kf, truncate_seed=11 if kind == "truncated" else None)
        if kind == "hybrid":
            _add_points(smap, kfs, scene, true_poses)
        if kind == "multiview":
            _fuse_start_region(smap, kfs)
    # the 10-keyframe circle's last keyframe shares 12 of its segments with
    # keyframe 0: below the default floor of 40 matches
    closer.cfg.min_score = 10
    return smap, closer, [kf.kid for kf, _, _ in kfs], true_poses, scene


def _port_closer(jmap, jcloser, **cfg_changes):
    """The port's map and closer from the JAX ones (same state, same config)."""
    tmap = slam_map_from(map_state(jmap))
    cfg = loop_config_from(jcloser.cfg)
    for k, v in cfg_changes.items():
        setattr(cfg, k, v)
    return tmap, tlc.LoopCloser(tmap, Intrinsics(*jcloser.cam), cfg, mono=jcloser.mono, device="cpu")


def _final_umeyama_sizes(monkeypatch, module):
    """Record the size of each Umeyama fit over more than 3 points (the final
    fit on RANSAC's inlier set) in ``module``."""
    sizes = []
    inner = module.align_umeyama

    def spy(a, b, with_scale=False):
        if len(a) > 3:
            sizes.append(len(a))
        return inner(a, b, with_scale=with_scale)

    monkeypatch.setattr(module, "align_umeyama", spy)
    return sizes


@pytest.fixture(scope="module")
def closed():
    """Per fixture kind: the detection, the loop transform and the closure
    in both packages (JAX first; the maps start equal)."""
    import tpuslam.backend.loop_closing as jlc

    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for kind in KINDS:
            jmap, jcl, kids, true_poses, _ = _jax_fixture(kind)
            tmap, tcl = _port_closer(jmap, jcl)
            last = kids[-1]
            for cl, m in ((jcl, jmap), (tcl, tmap)):
                for k in kids[:-1]:
                    cl.db.add(m.keyframes[k])
            cand = (jcl._detect(jmap.keyframes[last]), tcl._detect(tmap.keyframes[last]))
            jsizes, tsizes = _final_umeyama_sizes(mp, jlc), _final_umeyama_sizes(mp, tlc)
            se3 = (jcl._compute_se3(jmap.keyframes[last], jmap.keyframes[0]), tcl._compute_se3(tmap.keyframes[last], tmap.keyframes[0]))
            mp.undo()
            before = map_state(tmap)
            ok = (jcl._close(jmap.keyframes[last], 0), tcl._close(tmap.keyframes[last], 0))
            out[kind] = dict(
                cand=cand, se3=se3, inliers=(jsizes, tsizes), ok=ok, before=before, maps=(map_state(jmap), map_state(tmap)),
                closers=(jcl, tcl), true_poses=true_poses, last=last,
            )
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", ["plain", "multiview"])
def test_jax_free_fixture_matches_jax(kind):
    """tests/torch_loop_fixture.py (the card tests' map, built without JAX)
    gives the JAX fixture's map."""
    from torch_loop_fixture import drifted_loop

    jmap, _, kids, _, _ = _jax_fixture(kind)
    _, tmap, tkids, _ = drifted_loop(n_kf=24 if kind == "multiview" else 10, fuse=kind == "multiview")
    want, got = map_state(jmap), map_state(tmap)
    assert tkids == kids and got["covis"] == want["covis"]
    for a, b in zip(got["keyframes"], want["keyframes"]):
        np.testing.assert_allclose(a["T_cw"], b["T_cw"], atol=1e-6)
        np.testing.assert_array_equal(a["line_ids"], b["line_ids"])
        assert (a["parent"], a["children"]) == (b["parent"], b["children"])
        for name, x in b["features"].items():
            np.testing.assert_array_equal(a["features"][name], x, err_msg=name)
    for name in ("alive", "n_obs", "first_kf", "desc_bits"):
        np.testing.assert_array_equal(got["lines"][name], want["lines"][name], err_msg=name)
    assert got["lines"]["obs"] == want["lines"]["obs"]
    np.testing.assert_allclose(got["lines"]["endpoints"], want["lines"]["endpoints"], atol=1e-5)
    np.testing.assert_allclose(got["lines"]["plucker"], want["lines"]["plucker"], atol=1e-4)


# ---- detection, the loop transform, the closure ------------------------------


@pytest.mark.parametrize("kind", ["plain", "truncated", "scale"])
def test_detect_gives_the_same_candidate(closed, kind):
    jc, tc = closed[kind]["cand"]
    assert tc == jc and tc is not None


def _rot_angle(Ra, Rb):
    """Angle of Ra^T Rb from the chord: |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


@pytest.mark.parametrize("kind", KINDS)
def test_compute_se3_matches_jax(closed, kind):
    (js, jT), (ts, tT) = closed[kind]["se3"]
    jsizes, tsizes = closed[kind]["inliers"]
    assert tsizes == jsizes and len(tsizes) == 1  # RANSAC's inlier set: exact
    if kind == "scale":
        assert ts == pytest.approx(js, rel=1e-5) and abs(ts - 1.0) > 0.3
    else:
        assert ts == 1.0 and js == 1.0
    assert _rot_angle(jT[:3, :3], tT[:3, :3]) < ROT_TOL
    np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=TRANS_TOL)


def _unit(L):
    return L / np.linalg.norm(L, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", KINDS)
def test_close_matches_jax(closed, kind):
    c = closed[kind]
    assert c["ok"] == (True, True)
    want, got = c["maps"]
    for a, b in zip(got["keyframes"], want["keyframes"]):
        assert a["kid"] == b["kid"] and a["loop_edges"] == b["loop_edges"]
        np.testing.assert_allclose(a["T_cw"], b["T_cw"], atol=POSE_TOL)
    alive = want["lines"]["alive"]
    np.testing.assert_array_equal(got["lines"]["alive"], alive)
    np.testing.assert_allclose(got["lines"]["endpoints"][alive], want["lines"]["endpoints"][alive], atol=LANDMARK_TOL)
    np.testing.assert_allclose(_unit(got["lines"]["plucker"][alive]), _unit(want["lines"]["plucker"][alive]), atol=PLUCKER_TOL)
    palive = want["points"]["alive"]
    assert (kind == "hybrid") == bool(palive.any())
    np.testing.assert_allclose(got["points"]["xyz"][palive], want["points"]["xyz"][palive], atol=LANDMARK_TOL)
    assert got["generation"] == want["generation"] == 1
    jcl, tcl = c["closers"]
    assert tcl.closed_loops == jcl.closed_loops == [(c["last"], 0)]
    assert [k["loop_edges"] for k in got["keyframes"] if k["loop_edges"]] == [[c["last"]], [0]]
    # the closure pulled the returning keyframe toward the truth
    true_last = c["true_poses"][-1]
    T_last = got["keyframes"][-1]["T_cw"]
    err_before = np.linalg.norm(c["before"]["keyframes"][-1]["T_cw"][:3, 3] - true_last[:3, 3])
    assert np.linalg.norm(T_last[:3, 3] - true_last[:3, 3]) < 0.35 * err_before + 1e-3


def test_close_records_its_stages(closed):
    tcl = closed["plain"]["closers"][1]
    rec = tcl.closures[-1]
    prob, out = rec["pg"]
    assert prob.poses.shape == (16, 4, 4) and prob.e_i.shape == (64,) and out.shape == (16, 4, 4)
    assert "gba" not in rec  # the fixture runs no global BA


@pytest.mark.parametrize("consistency", [1, 2])
def test_process_decisions_match_jax(consistency):
    """process() over every keyframe of the plain fixture: the same
    candidates, consistency evidence and closure decisions per keyframe."""
    jmap, jcl, kids, _, _ = _jax_fixture("plain")
    jcl.cfg.consistency = consistency
    tmap, tcl = _port_closer(jmap, jcl)
    trace = []
    for cl, m in ((jcl, jmap), (tcl, tmap)):
        steps = []
        for k in kids:
            ok = cl.process(m.keyframes[k])
            steps.append((k, ok, list(cl._consistent), list(cl.closed_loops)))
        trace.append(steps)
    assert trace[1] == trace[0]
    assert [s[1] for s in trace[1]].count(True) == (1 if consistency == 1 else 0)
    assert [t["candidate"] for t in tcl.timings][-1] is not None


def test_scale_gate_rejects():
    """A mono closure asking for more scale change than the gate allows is
    refused by both packages, and the map is left as it was."""
    jmap, jcl, kids, _, _ = _jax_fixture("scale")
    jcl.cfg.max_scale_correction = 1.2  # the fixture's drift is ~1.55
    tmap, tcl = _port_closer(jmap, jcl)
    before = map_state(tmap)
    assert jcl._close(jmap.keyframes[kids[-1]], 0) is False
    assert tcl._close(tmap.keyframes[kids[-1]], 0) is False
    assert tcl.closed_loops == jcl.closed_loops == [] and tmap.generation == 0
    after = map_state(tmap)
    for a, b in zip(after["keyframes"], before["keyframes"]):
        np.testing.assert_array_equal(a["T_cw"], b["T_cw"])
    np.testing.assert_array_equal(after["lines"]["plucker"], before["lines"]["plucker"])


# ---- global BA ---------------------------------------------------------------


def test_global_ba_matches_jax():
    """Global BA on the multi-view fixture (24 keyframes, the start region's
    lines seen from keyframes 0-2): poses and 3+-view lines within tolerance
    of the JAX package's, the same stats and rung."""
    from tpuslam.backend.global_ba import global_bundle_adjustment as j_gba

    jmap, jcl, kids, true_poses, _ = _jax_fixture("multiview")
    tmap = slam_map_from(map_state(jmap))
    before = map_state(tmap)
    cam = Intrinsics(*jcl.cam)
    with JaxAsOnTheCard():
        jstats = j_gba(jmap, jcl.cam)
    record = {}
    tstats = global_bundle_adjustment(tmap, cam, device="cpu", record=record)
    assert tstats[:3] == jstats[:3] and tstats.applied == jstats.applied is True
    assert tstats.n_poses == 24 and tstats.n_lines >= 30
    assert tstats.cost == pytest.approx(jstats.cost, abs=1e-6)  # both converge to ~2e-7
    assert record["rung"] == (32, 512, 2048) and record["point_rung"] == (1, 1) and len(record["solves"]) == 2
    want, got = map_state(jmap), map_state(tmap)
    moved = 0.0
    for a, b, c in zip(got["keyframes"], want["keyframes"], before["keyframes"]):
        np.testing.assert_allclose(a["T_cw"], b["T_cw"], atol=POSE_TOL)
        moved = max(moved, float(np.abs(a["T_cw"] - c["T_cw"]).max()))
    assert moved > 1e-3  # the solve was written back
    firm = want["lines"]["alive"] & (want["lines"]["n_obs"] >= 3)
    assert firm.sum() >= 25
    np.testing.assert_allclose(_unit(got["lines"]["plucker"][firm]), _unit(want["lines"]["plucker"][firm]), atol=GBA_LINE_TOL)


def test_global_ba_overflow_keeps_the_essential_graph():
    """A map with more keyframes than the top pose rung: the closure succeeds,
    gba_skipped counts it, and the poses are the essential graph's alone."""
    from tpuslam.backend.global_ba import GlobalBAConfig as JGlobalBAConfig
    from tpuslam.backend.lm import LMConfig as JLMConfig

    jmap, jcl, kids, _, _ = _jax_fixture("plain")
    jcl.cfg.run_global_ba = True
    jcl.cfg.gba_cfg = JGlobalBAConfig(pose_buckets=(8,), line_buckets=(256,), obs_buckets=(1024,), lm=JLMConfig(max_iters=2))
    tmap, tcl = _port_closer(jmap, jcl)
    ref_map, ref = _port_closer(jmap, jcl, run_global_ba=False)
    assert tcl.cfg.gba_cfg == global_ba_config_from(jcl.cfg.gba_cfg)
    with JaxAsOnTheCard():
        assert jcl._close(jmap.keyframes[kids[-1]], 0)
    assert tcl._close(tmap.keyframes[kids[-1]], 0) and ref._close(ref_map.keyframes[kids[-1]], 0)
    assert tcl.gba_skipped == jcl.gba_skipped == 1 and ref.gba_skipped == 0
    for k in kids:
        np.testing.assert_array_equal(tmap.keyframes[k].T_cw, ref_map.keyframes[k].T_cw)
        np.testing.assert_allclose(tmap.keyframes[k].T_cw, jmap.keyframes[k].T_cw, atol=POSE_TOL)
    assert tcl.closures[-1]["gba"] == {}


# ---- the System --------------------------------------------------------------


def test_loop_scene_generator_matches_jax():
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.io.synthetic import make_loop_scene as j_make_loop_scene
    from tpuslam_torch.io.synthetic import make_loop_scene

    cam = Intrinsics(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240, baseline=0.1)
    a = make_loop_scene(np.random.default_rng(7), n_segments=260, n_frames=100, radius=5.0, room=14.0, cam=cam)
    b = j_make_loop_scene(np.random.default_rng(7), n_segments=260, n_frames=100, radius=5.0, room=14.0, cam=JIntrinsics(*cam))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)


def test_system_defaults_build_a_loop_closer():
    from tpuslam_torch.system import System

    s = System(QVGA, device="cpu")
    assert s.mapper is not None and s.loop_closer is not None
    assert s.loop_closer.db is s.kf_db and s.tracker.kf_db is s.kf_db and s.loop_closer.device.type == "cpu"
    assert s.loop_closer.cfg == tlc.LoopConfig() and not s.loop_closer.mono
    m = System(QVGA, sensor="mono", device="cpu")  # mono closes loops through the Sim(3) branch
    assert m.loop_closer is not None and m.loop_closer.mono and m.loop_closer.db is m.kf_db
    # the closer's own database, when none is shared, is still its own object
    db = tlc.KeyFrameDatabase(device="cpu")
    assert tlc.LoopCloser(s.map, QVGA, db=db, device="cpu").db is db


N_SHORT = 6


def test_short_run_with_loop_closing():
    """6 QVGA frames, a keyframe at least every 2 (no loop can fire): the
    trajectory with loop_closing=True
    is bit-equal to loop_closing=False, and tracks like the JAX System with
    loop closing (same states, keyframe count within one, camera centres
    within 5 cm, no closure in either)."""
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.kernels.lsd import LSDParams as JLSDParams
    from tpuslam.system import System as JSystem
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.kernels.lsd import LSDParams
    from tpuslam_torch.system import System

    _, frames = stereo_scene(N_SHORT)
    runs = []
    for loop in (True, False):
        tcfg = TrackerConfig(frontend=FrontendParams(max_lines=128, lsd=LSDParams(ccl_rounds=32)), max_frames_between_kf=2)
        with python_graph():
            s = System(QVGA, tracker_cfg=tcfg, loop_closing=loop, device="cpu")
        for f, (il, ir) in enumerate(frames):
            s.track_stereo(il, ir, 0.05 * f)
        s.shutdown()
        runs.append(s)
    with_lc, without = runs
    assert len(with_lc.trajectory) == N_SHORT
    for a, b in zip(with_lc.trajectory, without.trajectory):
        np.testing.assert_array_equal(a.T_cw, b.T_cw)
        assert a.state == b.state and a.made_keyframe == b.made_keyframe
    n_kf = sum(r.made_keyframe for r in with_lc.trajectory)
    assert len(with_lc.loop_closer.timings) == n_kf >= 2 and with_lc.loop_closer.closed_loops == []
    assert len(with_lc.kf_db) == len(without.kf_db) == len(with_lc.map.keyframes)

    with JaxAsOnTheCard():
        os.environ.update({"TPUSLAM_WARM_LOOP": "0", "TPUSLAM_BA_SUBPROCESS": "0"})
        try:
            jcfg = JTrackerConfig(frontend=JFrontendParams(max_lines=128, lsd=JLSDParams(ccl_rounds=32)), max_frames_between_kf=2)
            js = JSystem(JIntrinsics(*QVGA), tracker_cfg=jcfg)
            for f, (il, ir) in enumerate(frames):
                js.track_stereo(il, ir, 0.05 * f)
            js.shutdown()
        finally:
            for k in ("TPUSLAM_WARM_LOOP", "TPUSLAM_BA_SUBPROCESS"):
                os.environ.pop(k, None)
    assert [r.state.name for r in js.trajectory] == [r.state.name for r in with_lc.trajectory]
    assert abs(len(js.map.keyframes) - len(with_lc.map.keyframes)) <= 1
    assert js.loop_closer.closed_loops == []
    centres = lambda t: np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in t])  # noqa: E731
    assert np.linalg.norm(centres(js.trajectory) - centres(with_lc.trajectory), axis=1).max() < 0.05


@pytest.mark.parametrize("pipelined", [False, True])
def test_adopt_pose_resets_like_jax(pipelined):
    """adopt_pose resets the pose, the last pose, the velocity and the device
    pose chain as the JAX tracker's does, on the synchronous and the chunked
    tracker."""
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.slammap.map import SlamMap as JSlamMap
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap
    from tpuslam_torch.system import bench_configs

    tcfg = bench_configs()[0] if pipelined else None
    jcfg = JTrackerConfig()
    if pipelined:
        from test_torch_semidirect import jax_bench_config

        jcfg = jax_bench_config()[0]
    rng = np.random.default_rng(0)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(size=3)
    trackers = [JTracker(JIntrinsics(*QVGA), JSlamMap(), jcfg), Tracker(QVGA, SlamMap(), tcfg, device="cpu")]
    for tr in trackers:
        tr.velocity = np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32) * 2
        tr.last_T_cw = np.full((4, 4), 3.0, np.float32)
        tr._dev_chain = ("stale", "stale")
        tr.adopt_pose(T)
    j, t = trackers
    assert t.cfg.pipelined == pipelined
    for name in ("T_cw", "last_T_cw", "velocity"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        assert getattr(t, name).dtype == np.float32
    assert t._dev_chain is None and j._dev_chain is None
    assert t.T_cw is not T and t.last_T_cw is not t.T_cw


# ---- the reference numbers on the loop sequence ------------------------------


def kf_map_ate(slam_map, scene, ate_fn) -> float:
    """Rigid ATE of the keyframes' camera centres against the ground truth."""
    kfs = [slam_map.keyframes[k] for k in sorted(slam_map.keyframes)]
    est = np.stack([np.linalg.inv(k.T_cw)[:3, 3] for k in kfs])
    gt = np.stack([np.linalg.inv(scene.poses[k.frame_idx])[:3, 3] for k in kfs])
    return float(ate_fn(est, gt, with_scale=False).rmse)


def run_jax_loop(frames, scene, solver: bool = False, lag=None):
    """The JAX System over the loop sequence, as chip_smoke's loop phase runs
    the port; with ``solver`` its solver process on, or with ``lag`` a
    :class:`FixedLagSolver` in its place. Returns (system, [(kid, frame,
    candidate, pre ATE, post ATE)])."""
    from tpuslam.eval.ate import absolute_trajectory_error
    from tpuslam.frontend.points import PointFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.kernels.stereo_direct import DirectStereoParams
    from tpuslam.system import System

    cfg = TrackerConfig(
        min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=4,
        points=PointFrontendParams(), direct_stereo=DirectStereoParams(max_disp=64.0),
    )
    loop_env = {**LOOP_ENV, "TPUSLAM_BA_SUBPROCESS": "1" if solver and lag is None else "0"}
    with JaxAsOnTheCard():
        env = {k: os.environ.get(k) for k in loop_env}
        os.environ.update(loop_env)
        try:
            s = System(JIntrinsics(*scene.cam), sensor="stereo", mapping=True, loop_closing=True, tracker_cfg=cfg)
            stub = (_attach(s, LagProbe(s.mapper.solver)) if solver else None) if lag is None else _attach(
                s, FixedLagSolver(_jax_child_solve(JIntrinsics(*scene.cam)), lag))
            lc, closures = s.loop_closer, []
            inner = lc._close

            def close(kf, cand):
                pre = kf_map_ate(s.map, scene, absolute_trajectory_error)
                ok = inner(kf, cand)
                if ok:
                    closures.append((kf.kid, kf.frame_idx, cand, pre, kf_map_ate(s.map, scene, absolute_trajectory_error)))
                return ok

            lc._close = close
            for f, (il, ir) in enumerate(frames):
                if stub is not None:
                    stub.frame = f
                s.track_stereo(il, ir, f * 0.05)
                _trace_keyframe(s, scene, f, s.trajectory[-1], absolute_trajectory_error)
            s.shutdown()
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return s, closures


class LagProbe:
    """Passes every call on to the solver process's handle and records, for
    each local-BA request, the frame of its submit and of the poll that got
    its answer (``frame`` is set by the caller before each frame)."""

    def __init__(self, inner):
        self.inner, self.frame, self.at, self.lags = inner, 0, {}, []

    def submit(self, *args, **kwargs):
        req_id = self.inner.submit(*args, **kwargs)
        self.at[req_id] = self.frame
        return req_id

    def poll(self, req_id, timeout=0.0):
        out = self.inner.poll(req_id, timeout=timeout)
        if out is not None and req_id in self.at:
            self.lags.append(self.frame - self.at.pop(req_id))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FixedLagSolver:
    """The solver process's submit / poll / solve in this process on a fixed
    schedule: a local-BA request answers at the first poll ``lag`` or more
    frames after its submit (``frame`` is set by the caller before each
    frame), or at once when the poll waits (a drain); a blocking solve
    (global BA) answers at once. ``solve(arrays, lm, chi2_line,
    chi2_point)`` is the package's own child-side solve."""

    def __init__(self, solve, lag: int):
        self.solve_fn, self.lag, self.frame, self.next_id, self.pending = solve, lag, 0, 0, {}

    def submit(self, arrays, lm, chi2_line, chi2_point):
        self.next_id += 1
        self.pending[self.next_id] = (self.frame, (arrays, lm, chi2_line, chi2_point))
        return self.next_id

    def poll(self, req_id, timeout=0.0):
        at, args = self.pending[req_id]
        if timeout <= 0 and self.frame - at < self.lag:
            return None
        del self.pending[req_id]
        return dict(self.solve_fn(*args), solve_ms=1.0, warm=True), None

    def solve(self, arrays, lm, chi2_line, chi2_point, timeout=None):
        return self.solve_fn(arrays, lm, chi2_line, chi2_point), None

    def restart(self):
        self.pending.clear()


def _attach(s, stub: FixedLagSolver) -> FixedLagSolver:
    """The System's mapper and loop closer use ``stub`` as their solver."""
    s.mapper.solver = s.loop_closer.solver = stub
    return stub


def _jax_child_solve(cam):
    """The JAX solver process's solve (``tpuslam/backend/ba_worker.py``: the
    arrays as they arrive, float64 ones included, with the masks)."""
    from tpuslam.backend import local_ba as jlba
    from tpuslam.backend.lm import BAProblem as JBAProblem

    def solve(arrays, lm, chi2_line, chi2_point):
        return jlba.solve_in_process(JBAProblem(**arrays), cam, jlba.LocalBAConfig(lm=lm, chi2_line=chi2_line, chi2_point=chi2_point))

    return solve


def _trace_keyframe(s, scene, f, r, ate_fn) -> None:
    """With TPUSLAM_LOOP_TRACE=1, one line per keyframe frame: the map's
    keyframes, its keyframe-map ATE, loops closed and the mapper's solves."""
    if os.environ.get("TPUSLAM_LOOP_TRACE") != "1" or not getattr(r, "made_keyframe", False):
        return
    mp_ = s.mapper
    print(f"trace: frame {f} keyframes {len(s.map.keyframes)} KF-map ATE {kf_map_ate(s.map, scene, ate_fn):.5f} m, loops "
          f"{len(s.loop_closer.closed_loops)}, local BA submitted {getattr(mp_, 'ba_submitted', None)} stale "
          f"{getattr(mp_, 'ba_stale', None)}", flush=True)


def run_port_loop(frames, scene, solver: bool = False, lag=None):
    """The port's System on the CPU over the loop sequence, as chip_smoke's
    loop phase builds it (``loop_system``), the native map mirror off; with
    ``solver`` its solver process on, or with ``lag`` a
    :class:`FixedLagSolver` in its place. Returns what :func:`run_jax_loop`
    returns."""
    from chip_smoke import loop_system
    from tpuslam_torch import system as tsystem
    from tpuslam_torch.backend.local_ba import solve_arrays
    from tpuslam_torch.eval.ate import absolute_trajectory_error

    loop_env = {"TPUSLAM_WARM_LOOP": "0", "TPUSLAM_BA_SUBPROCESS": "1" if solver and lag is None else "0"}
    env = {k: os.environ.get(k) for k in loop_env}
    os.environ.update(loop_env)
    build = tsystem.System
    try:
        tsystem.System = lambda *a, **kw: build(*a, **{**kw, "device": "cpu"})
        with python_graph():
            s = loop_system(Intrinsics(*scene.cam))
            cam = Intrinsics(*scene.cam)
            stub = (_attach(s, LagProbe(s.mapper.solver)) if solver else None) if lag is None else _attach(
                s, FixedLagSolver(lambda *a: solve_arrays(*a[:1], cam, *a[1:], "cpu"), lag))
            lc, closures = s.loop_closer, []
            inner = lc._close

            def close(kf, cand, ev=None):
                pre = kf_map_ate(s.map, scene, absolute_trajectory_error)
                ok = inner(kf, cand, ev)
                if ok:
                    closures.append((kf.kid, kf.frame_idx, cand, pre, kf_map_ate(s.map, scene, absolute_trajectory_error)))
                return ok

            lc._close = close
            for f, (il, ir) in enumerate(frames):
                if stub is not None:
                    stub.frame = f
                s.track_stereo(il, ir, f * 0.05)
                _trace_keyframe(s, scene, f, s.trajectory[-1], absolute_trajectory_error)
            s.shutdown()
    finally:
        tsystem.System = build
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return s, closures


class _Closed(Exception):
    """Stops the port's loop run at its first successful closure."""


def _jax_map_from(state):
    """The JAX package's SlamMap from a :func:`map_state` snapshot (no
    native mirror)."""
    from tpuslam.frontend.frame import FrameFeatures as JFrameFeatures
    from tpuslam.kernels.fast import PointFeatures as JPointFeatures
    from tpuslam.slammap.map import KeyFrame as JKeyFrame
    from tpuslam.slammap.map import SlamMap as JSlamMap

    ls, ps = state["lines"], state["points"]
    m = JSlamMap(line_capacity=len(ls["alive"]), point_capacity=len(ps["alive"]), native=False)
    for store, st, arrays in ((m.lines, ls, ("plucker", "endpoints")), (m.points, ps, ("xyz",))):
        for name in (*arrays, "alive", "desc_bits", "n_obs", "first_kf"):
            getattr(store, name)[:] = st[name]
        store.obs = {l: dict(o) for l, o in st["obs"].items()}
        store._next, store._free = st["next"], list(st["free"])
    for k in state["keyframes"]:
        pf = k["point_features"]
        m.keyframes[k["kid"]] = JKeyFrame(
            kid=k["kid"], frame_idx=k["frame_idx"], timestamp=k["timestamp"], T_cw=k["T_cw"].copy(),
            features=JFrameFeatures(**{n: np.asarray(k["features"][n]) for n in JFrameFeatures._fields}),
            line_ids=k["line_ids"].copy(), is_bad=k["is_bad"], parent=k["parent"], children=set(k["children"]),
            loop_edges=set(k["loop_edges"]),
            point_features=None if pf is None else JPointFeatures(**{n: np.asarray(pf[n]) for n in JPointFeatures._fields}),
            point_ids=None if k["point_ids"] is None else k["point_ids"].copy(),
        )
    m.covis = {a: dict(r) for a, r in state["covis"].items()}
    m._next_kid, m.generation = state["next_kid"], state["generation"]
    return m


def replay_first_closure(frames, scene):
    """The port on the CPU over the loop sequence up to its first successful
    closure; that closure replayed from the map as it stood before it, in
    both packages: the essential graph alone, then global BA (the JAX
    package's float32, the port's float32 and its float64). Prints the
    keyframe-map ATE of each, whether the two global-BA problems are
    bit-identical (both from the JAX package's essential-graph map) and the
    pose gap after one float32 LM iteration of each."""
    import torch

    import tpuslam.backend.global_ba as jgba
    from tpuslam.backend.lm import LMConfig as JLMConfig
    from tpuslam.backend.local_ba import _run_lm_jit
    from tpuslam.backend.loop_closing import LoopCloser as JLoopCloser
    from tpuslam.backend.loop_closing import LoopConfig as JLoopConfig
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam_torch.backend import global_ba as tgba
    from tpuslam_torch.backend import lm as tlm
    from tpuslam_torch.eval.ate import absolute_trajectory_error
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.kernels.stereo_direct import DirectStereoParams
    from tpuslam_torch.system import System

    cfg = TrackerConfig(
        min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=4,
        points=PointFrontendParams(), direct_stereo=DirectStereoParams(max_disp=64.0),
    )
    s = System(scene.cam, tracker_cfg=cfg, device="cpu")
    inner, seen = s.loop_closer._close, {}

    def close(kf, cand, ev=None):
        snap = map_state(s.map)
        if inner(kf, cand, ev):
            seen.update(state=snap, kid=kf.kid, cand=cand, frame=kf.frame_idx)
            raise _Closed
        return False

    s.loop_closer._close = close
    try:
        for f, (il, ir) in enumerate(frames):
            s.track_stereo(il, ir, f * 0.05)
    except _Closed:
        pass
    if not seen:
        print("the port closed no loop", flush=True)
        return
    state, kid, cand = seen["state"], seen["kid"], seen["cand"]
    print(f"the port's first closure: keyframe {kid} (frame {seen['frame']}) to keyframe {cand}", flush=True)
    cam = scene.cam
    gcfg = tgba.GlobalBAConfig()

    def ate(m):
        return kf_map_ate(m, scene, absolute_trajectory_error)

    jm = _jax_map_from(state)
    print(f"before the closure: {ate(jm)!r} m", flush=True)
    JLoopCloser(jm, JIntrinsics(*cam), JLoopConfig(run_global_ba=False))._close(jm.keyframes[kid], cand)
    tm = slam_map_from(state)
    tlc.LoopCloser(tm, cam, tlc.LoopConfig(run_global_ba=False), device="cpu")._close(tm.keyframes[kid], cand)
    print(f"essential graph: JAX {ate(jm)!r} m, port {ate(tm)!r} m", flush=True)
    after_eg = map_state(jm)  # global BA from here on starts from the JAX package's map in both packages
    tm = slam_map_from(after_eg)

    problems = []
    inner_lm = jgba._run_lm_jit
    jgba._run_lm_jit = lambda pb, c, lm: problems.append(pb) or inner_lm(pb, c, lm)
    try:
        jgba.global_bundle_adjustment(jm, JIntrinsics(*cam))
    finally:
        jgba._run_lm_jit = inner_lm
    print(f"global BA, JAX float32: {ate(jm)!r} m", flush=True)
    tgba.global_bundle_adjustment(tm, cam, device="cpu")
    print(f"global BA, port float64: {ate(tm)!r} m", flush=True)

    # the port's float32 solve, as the JAX package solves it, with 4 CPU threads and with 1 (another summation
    # order in the CPU's matrix products)
    for threads in (4, 1):
        torch.set_num_threads(threads)
        m32 = slam_map_from(after_eg)
        prob, ctx = tgba.build_global_problem(m32, gcfg, device="cpu")
        st = tlm.run_lm(prob, cam, gcfg.lm)
        inl_l, inl_p = tlm.chi2_outlier_mask(st, prob, cam, gcfg.chi2_line, gcfg.chi2_point)
        st = tlm.run_lm(prob._replace(poses=st.poses, lines=st.lines, points=st.points, l_valid=prob.l_valid * inl_l,
                                      p_valid=prob.p_valid * inl_p), cam, gcfg.lm)
        for k, i in ctx["kf_pos"].items():
            if ctx["pose_free"][i] > 0.5:
                m32.keyframes[k].T_cw = st.poses[i].numpy()
        print(f"global BA, port float32, {threads} CPU threads: {ate(m32)!r} m", flush=True)
    torch.set_num_threads(4)
    same = all(np.array_equal(np.asarray(getattr(problems[0], n)), getattr(prob, n).numpy()) for n in prob._fields)
    print(f"the two packages' global-BA problems bit-identical: {same}", flush=True)
    one = JLMConfig(max_iters=1)
    jst = _run_lm_jit(problems[0], JIntrinsics(*cam), one)
    tst = tlm.run_lm(prob, cam, tlm.LMConfig(max_iters=1))
    print(f"after one float32 LM iteration the poses are {float(np.abs(np.asarray(jst.poses) - tst.poses.numpy()).max())!r} apart", flush=True)


if __name__ == "__main__":
    import time

    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import make_loop_frames

    cam, scene, frames = make_loop_frames()
    if "--replay" in sys.argv:
        torch.set_num_threads(4)
        with JaxAsOnTheCard():
            replay_first_closure(frames, scene)
        sys.exit(0)

    from tpuslam.eval.ate import absolute_trajectory_error

    solver, port = "--solver" in sys.argv, "--port" in sys.argv
    lag = int(sys.argv[sys.argv.index("--lag") + 1]) if "--lag" in sys.argv else None
    if port:
        torch.set_num_threads(4)
    t0 = time.perf_counter()
    s, closures = (run_port_loop if port else run_jax_loop)(frames, scene, solver=solver, lag=lag)
    s_per_frame = (time.perf_counter() - t0) / len(frames)
    ok = [r for r in s.trajectory if r.state.name == "OK"]
    est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in ok])
    gt = np.stack([np.linalg.inv(scene.poses[r.frame_idx])[:3, 3] for r in ok])
    mp_ = s.mapper
    mode = "off" if not solver else "on" if lag is None else f"a stand-in at a fixed lag of {lag} frames"
    print(f"{'port' if port else 'JAX'} loop run (solver {mode}): {len(frames)} frames, OK frames {len(ok)}, "
          f"keyframes {len(s.map.keyframes)}, loops closed {s.loop_closer.closed_loops}, gba_skipped "
          f"{s.loop_closer.gba_skipped}", flush=True)
    if solver:
        print(f"local BA: submitted {getattr(mp_, 'ba_submitted', None)}, stale {getattr(mp_, 'ba_stale', None)}, failed "
              f"{getattr(mp_, 'ba_failed', None)}", flush=True)
    if isinstance(mp_.solver, LagProbe):
        lags = np.asarray(mp_.solver.lags)
        print(f"local BA lags in frames, submit to answer: {len(lags)} answered, median {np.median(lags)!r}, mean "
              f"{lags.mean()!r}, max {lags.max()!r}, counts {np.bincount(lags).tolist()}; child solve ms median "
              f"{np.median(mp_.solve_ms)!r}; host s per frame {s_per_frame!r}", flush=True)
    for kid, frame, cand, pre, post in closures:
        print(f"closure: keyframe {kid} (frame {frame}) to {cand}: KF-map ATE {pre!r} -> {post!r} m", flush=True)
    print(f"JAX_LOOP_OK_FRAMES = {len(ok)}", flush=True)
    print(f"JAX_LOOP_FRAME_ATE_M = {float(absolute_trajectory_error(est, gt).rmse)!r}", flush=True)
    if closures:
        print(f"JAX_LOOP_PRE_ATE_M, JAX_LOOP_POST_ATE_M = {closures[0][3]!r}, {closures[0][4]!r}", flush=True)
    print(f"JAX_LOOP_KF_ATE_M = {kf_map_ate(s.map, scene, absolute_trajectory_error)!r}", flush=True)
