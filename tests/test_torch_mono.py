"""Monocular SLAM of tpuslam_torch against tpuslam: the mapper's two-view
line and point triangulation, the mono tracker and the mono System.

- The tracker: both packages over tests/test_mono.py's 30-frame
  synthetic-feature sequence (seed 8; with corners of 200 scene points for
  the hybrid run) with mono mapping, the JAX package's RANSAC draws injected
  into the port and its 8-point solved in float64 as the port's is
  (``mono_parity``): the same first OK frame, the same keyframes up to the
  first that differs (the keyframe test is chaotic at its threshold, ROADMAP.md
  section 3), poses within 1e-3 (rad and m) over the frames before it, and
  the Sim(3) ATE no worse than the JAX package's x 1.05 + 0.01 m.
- The mapper: each keyframe event of the hybrid run, replayed from the map
  the JAX mapper triangulated in (carried over by ``convert.map_state`` /
  ``slam_map_from``): ``_create_new_maplines`` and ``_create_new_mappoints``
  make the same line and point ids with the same observations, their
  landmarks within 1e-3 (m; the lines' endpoints relative to their distance
  from the camera, with a unit floor).
- The System: ``System(cam, sensor="mono", device="cpu")`` over
  tests/test_hybrid.py's 16-frame QVGA mono frames (24 segments, 130
  points drawn as dots, rendered by the port's renderer for both). Hybrid:
  initialized within 2 frames of the JAX package and OK from there, the
  Sim(3) ATE no worse than the JAX package's x 1.05 + 0.01 m, and at least
  the JAX test's floors of 10 live points, 5 of them seen from two
  keyframes or more. Lines only: neither package initializes on 24
  segments (the same states frame by frame).

Run as a script, it prints the JAX package's numbers on chip_smoke.py's mono
sequences, rendered by the port's renderer, on the CPU, with cv2 hidden,
TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0, TPUSLAM_WARM_LOOP=0 and
TPUSLAM_BA_SUBPROCESS=0 (the JAX_MONO_* constants there):

    python tests/test_torch_mono.py mono   # the VGA walk, hybrid and lines only (~5 min)
    python tests/test_torch_mono.py draws 1 11   # lines only, RANSAC draws k = 1..10 (~2.5 min each)
    python tests/test_torch_mono.py loop   # the QVGA loop; the dwell grows until a loop closes
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import copy

import numpy as np
import pytest

from chip_smoke import kf_map_ate, sim3_ate
from mono_parity import jax_e8_float64, jax_samples, synthetic_point_features
from torch_parity import JaxAsOnTheCard, python_graph

MONO_ENV = {**JaxAsOnTheCard.ENV, "TPUSLAM_WARM_LOOP": "0", "TPUSLAM_BA_SUBPROCESS": "0"}


def mono_tracker_cfg(points: bool, max_frames_between_kf: int = 4):
    """benchmarks/ladder.py's mono tracker settings (the JAX package's
    TrackerConfig)."""
    from tpuslam.frontend.points import PointFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig

    return TrackerConfig(
        min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=max_frames_between_kf,
        points=PointFrontendParams() if points else None,
    )


class JaxMono(JaxAsOnTheCard):
    """JaxAsOnTheCard, with the loop closer's warm-up and the BA worker
    subprocess off too (the JAX System then runs synchronously, as the
    port's does)."""

    ENV = MONO_ENV


def run_jax_mono(cam, frames, tcfg, scene=None, loop_closing=True, mapping=True):
    """The JAX System(cam, sensor="mono") over uint8 frames. Returns (system,
    [(kid, frame, candidate, scale, pre ATE, post ATE)]) where the ATEs are
    the keyframe map's Sim(3) ATE before and after each closure (with
    ``scene``)."""
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.system import System

    with JaxMono():
        s = System(JIntrinsics(*cam), sensor="mono", mapping=mapping, loop_closing=loop_closing, tracker_cfg=tcfg)
        closures = []
        lc = s.loop_closer
        if lc is not None and scene is not None:
            inner = lc._close

            def close(kf, cand, *a):
                pre = kf_map_ate(s.map, scene, with_scale=True)
                ok = inner(kf, cand, *a)
                if ok:
                    closures.append((kf.kid, kf.frame_idx, cand, pre, kf_map_ate(s.map, scene, with_scale=True)))
                return ok

            lc._close = close
        for f, img in enumerate(frames):
            s.track_monocular(img, f * 0.05)
        s.shutdown()
    return s, closures


ATE_FACTOR, ATE_MARGIN_M = 1.05, 0.01
POSE_TOL = 1e-3
LANDMARK_TOL = 1e-3


# ---- the tracker and the mapper on synthetic features ----------------------


def _synthetic_sequence(points: bool, n_frames: int = 30):
    """tests/test_mono.py's sequence (seed 8): line features of each frame
    with 0.3 px noise, and with ``points`` corners of 200 scene points."""
    from test_mono import make_translating_scene
    from tpuslam.io.synthetic import synthetic_frame_features

    rng = np.random.default_rng(8)
    scene = make_translating_scene(rng, n_frames=n_frames)
    if points:
        scene = scene._replace(points=np.random.default_rng(80).uniform([-4, -3, 4], [4, 3, 12], (200, 3)).astype(np.float32))
    feats = []
    for f in range(n_frames):
        lf, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng)
        feats.append((lf, synthetic_point_features(scene, f, noise_px=0.3, rng=rng) if points else None))
    return scene, feats


def _synthetic_cfgs(points: bool):
    from tpuslam.backend.mapping import MapperConfig
    from tpuslam.frontend.points import PointFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig

    return TrackerConfig(max_frames_between_kf=6, points=PointFrontendParams() if points else None), MapperConfig()


def _jax_synthetic_run(points: bool):
    """The JAX tracker and mono mapper over the sequence (tests/test_mono.py's
    loop), the map recorded around each event's triangulation and each local
    BA."""
    from test_mono import CAM
    from tpuslam.backend import mapping as jmapping
    from tpuslam.backend.mapping import LocalMapper
    from tpuslam.frontend.tracking import Tracker
    from tpuslam.slammap.map import SlamMap
    from tpuslam_torch.convert import map_state

    scene, feats = _synthetic_sequence(points)
    tcfg, mcfg = _synthetic_cfgs(points)
    events, solves = [], []
    local_ba = jmapping.local_bundle_adjustment

    def recorded_ba(m, kid, *a, **k):
        before = copy.deepcopy(map_state(m))
        out = local_ba(m, kid, *a, **k)
        solves.append(dict(kid=kid, before=before, after=copy.deepcopy(map_state(m))))
        return out

    jmapping.local_bundle_adjustment = recorded_ba
    with JaxMono(), jax_e8_float64():
        smap = SlamMap()
        tracker = Tracker(CAM, smap, tcfg)
        mapper = LocalMapper(smap, CAM, mcfg, mono=True)
        tracker.on_new_keyframe = mapper.process
        mapper.on_map_changed = tracker.invalidate_local_map
        lines, pts = mapper._create_new_maplines, mapper._create_new_mappoints

        def tri_lines(kf):
            events.append(dict(kid=kf.kid, before=copy.deepcopy(map_state(smap)), recent=dict(mapper._recent)))
            lines(kf)

        def tri_points(kf):
            pts(kf)
            events[-1].update(after=copy.deepcopy(map_state(smap)), recent_after=dict(mapper._recent))

        mapper._create_new_maplines, mapper._create_new_mappoints = tri_lines, tri_points
        results = []
        try:
            for f, (lf, pf) in enumerate(feats):
                tracker.frame_idx = f
                tracker._cur_pfeats = pf
                results.append(tracker._track(lf, timestamp=f * 0.05, stereo=False))
        finally:
            jmapping.local_bundle_adjustment = local_ba
    return scene, results, events, solves


def _torch_synthetic_run(points: bool):
    from test_mono import CAM
    from tpuslam_torch.backend.mapping import LocalMapper
    from tpuslam_torch.convert import features_from, mapper_config_from, point_features_from, tracker_config_from
    from tpuslam_torch.frontend.initializer import MonoInitializer
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.geometry.camera import Intrinsics
    from tpuslam_torch.slammap.map import SlamMap

    _, feats = _synthetic_sequence(points)
    tcfg, mcfg = _synthetic_cfgs(points)
    cam = Intrinsics(*CAM)
    with python_graph():
        smap = SlamMap()
    tracker = Tracker(cam, smap, tracker_config_from(tcfg), device="cpu")
    tracker.mono_init = MonoInitializer(cam, sampler=jax_samples)
    mapper = LocalMapper(smap, cam, mapper_config_from(mcfg), mono=True, device="cpu")
    tracker.on_new_keyframe = mapper.process
    mapper.on_map_changed = tracker.invalidate_local_map
    results = []
    for f, (lf, pf) in enumerate(feats):
        tracker.frame_idx = f
        tracker._cur_pfeats = None if pf is None else point_features_from(pf)
        results.append(tracker._track(features_from(lf), timestamp=f * 0.05, stereo=False))
    return results


@pytest.fixture(scope="module")
def synthetic_runs():
    out = {}
    for points in (False, True):
        scene, jres, events, solves = _jax_synthetic_run(points)
        out[points] = (scene, jres, events, solves, _torch_synthetic_run(points))
    return out


def _rot_gap(A, B):
    R = A[:3, :3].T @ B[:3, :3]
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))


@pytest.mark.parametrize("points", [False, True], ids=["lines", "hybrid"])
def test_mono_tracker_matches_jax(synthetic_runs, points):
    """The same first OK frame and keyframes (up to the first that differs),
    poses within POSE_TOL (3e-3 in hybrid: the first local BA of the
    two-view window is scale free, see test_mono_local_ba_matches_jax) over
    the frames before the first whose inlier count differs, and the Sim(3)
    ATE bound."""
    scene, jres, _, _, tres = synthetic_runs[points]
    js = [r.state.name for r in jres]
    ts = [r.state.name for r in tres]
    first = js.index("OK")
    assert ts.index("OK") == first < len(js) // 2
    assert all(s == "OK" for s in ts[first:])
    jk = [r.frame_idx for r in jres if r.made_keyframe]
    tk = [r.frame_idx for r in tres if r.made_keyframe]
    split = next((i for i, (a, b) in enumerate(zip(jk, tk)) if a != b), min(len(jk), len(tk)))
    assert split >= 2, (jk, tk)  # the bootstrap's keyframe and the next agree
    assert jk[:split] == tk[:split]
    until = next((a.frame_idx for a, b in zip(jres, tres) if a.n_inliers != b.n_inliers), len(jres))
    assert until >= first + 5, until
    tol = 3e-3 if points else POSE_TOL
    for a, b in zip(jres[first:until], tres[first:until]):
        assert _rot_gap(a.T_cw, b.T_cw) <= tol and np.abs(a.T_cw[:3, 3] - b.T_cw[:3, 3]).max() <= tol, a.frame_idx
    bound = sim3_ate(jres, scene) * ATE_FACTOR + ATE_MARGIN_M
    assert sim3_ate(tres, scene) <= bound


@pytest.mark.parametrize("points", [False, True], ids=["lines", "hybrid"])
def test_mono_local_ba_matches_jax(synthetic_runs, points):
    """Each local BA of the run, replayed by this package from the map the
    JAX mapper solved: keyframe poses within POSE_TOL. Mono BA fixes only
    the oldest keyframe, so the two-view window's scale is free: its float32
    LMs land up to 2.6e-4 apart on the hybrid run's first window."""
    from test_mono import CAM
    from tpuslam.backend.local_ba import LocalBAConfig as JLocalBAConfig
    from tpuslam_torch.backend import local_ba as tlba
    from tpuslam_torch.convert import map_state, params_from, slam_map_from
    from tpuslam_torch.geometry.camera import Intrinsics

    _, _, _, solves, _ = synthetic_runs[points]
    assert len(solves) >= 6
    cfg = params_from(tlba.LocalBAConfig, JLocalBAConfig())
    for sv in solves:
        tmap = slam_map_from(sv["before"])
        tlba.local_bundle_adjustment(tmap, sv["kid"], Intrinsics(*CAM), cfg, device="cpu")
        for a, b in zip(map_state(tmap)["keyframes"], sv["after"]["keyframes"]):
            assert np.abs(a["T_cw"] - b["T_cw"]).max() <= POSE_TOL, (sv["kid"], a["kid"])


def _replay(event, points_run):
    from test_mono import CAM
    from tpuslam_torch.backend.mapping import LocalMapper
    from tpuslam_torch.convert import map_state, mapper_config_from, slam_map_from
    from tpuslam_torch.geometry.camera import Intrinsics

    tmap = slam_map_from(event["before"])
    mapper = LocalMapper(tmap, Intrinsics(*CAM), mapper_config_from(_synthetic_cfgs(points_run)[1]), mono=True, device="cpu")
    mapper._recent = dict(event["recent"])
    kf = tmap.keyframes[event["kid"]]
    mapper._create_new_maplines(kf)
    mapper._create_new_mappoints(kf)
    return map_state(tmap), mapper._recent


def test_mapper_triangulation_matches_jax(synthetic_runs):
    """Every keyframe event of the hybrid run: the same new lines and points
    (ids, observations, free lists), their landmarks within 1e-3."""
    _, _, events, _, _ = synthetic_runs[True]
    n_lines = n_points = 0
    for ev in events:
        got, recent = _replay(ev, True)
        want, before = ev["after"], ev["before"]
        for fam in ("lines", "points"):
            assert got[fam]["obs"] == want[fam]["obs"], (ev["kid"], fam)
            np.testing.assert_array_equal(got[fam]["alive"], want[fam]["alive"])
            assert got[fam]["free"] == want[fam]["free"]
        assert recent == ev["recent_after"]
        new_l = np.nonzero(want["lines"]["alive"] & ~before["lines"]["alive"])[0]
        new_p = np.nonzero(want["points"]["alive"] & ~before["points"]["alive"])[0]
        n_lines, n_points = n_lines + len(new_l), n_points + len(new_p)
        ep_t, ep_j = got["lines"]["endpoints"][new_l], want["lines"]["endpoints"][new_l]
        err = np.linalg.norm(ep_t - ep_j, axis=-1) / np.maximum(np.linalg.norm(ep_j, axis=-1), 1.0)
        assert err.size == 0 or err.max() <= LANDMARK_TOL, (ev["kid"], err.max())
        np.testing.assert_allclose(got["points"]["xyz"][new_p], want["points"]["xyz"][new_p], atol=LANDMARK_TOL)
    assert n_lines >= 20 and n_points >= 3, (n_lines, n_points)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mono_pose_lm_weights_match_jax(seed):
    """The monocular tracker's pose LM (``PoseOptConfig()``: the JAX
    package's IRLS formula, which every tracker form takes) against the JAX pose_optimize
    on ~25 lines with 5 gross outliers: poses within 2e-5, the same inliers.
    (With one weight per observation, seed 3 lands 7e-3 away.)"""
    import jax.numpy as jnp
    import torch

    from test_torch_geometry import J_CAM, T_CAM
    from tpuslam.backend import pose_opt as jpose
    from tpuslam.geometry import plucker as jpl
    from tpuslam.geometry import se3 as jse3
    from tpuslam.io.synthetic import make_wireframe_scene, observe_frame
    from tpuslam_torch.backend import pose_opt as tpose

    rng = np.random.default_rng(seed)
    scene = make_wireframe_scene(rng, n_segments=30, n_points=8, n_frames=3)
    obs = observe_frame(scene, 1, noise_px=0.5, rng=rng)
    L = np.array(jpl.plucker_normalize(jpl.plucker_from_points(jnp.asarray(scene.segments[:, 0]), jnp.asarray(scene.segments[:, 1]))))
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))) @ scene.poses[1]).astype(np.float32)
    valid = obs.seg_visible.astype(np.float32)
    ep = obs.seg_uv.copy()
    vis = np.nonzero(obs.seg_visible)[0]
    ep[vis[:5]] += rng.normal(size=(5, 2, 2)).astype(np.float32) * 6.0  # gross outliers
    ref = jpose.pose_optimize(
        jnp.asarray(T0), jnp.asarray(L), jnp.asarray(ep), jnp.asarray(valid),
        jnp.zeros((1, 3)), jnp.zeros((1, 2)), jnp.zeros((1,)), J_CAM,
    )
    out = tpose.pose_optimize(
        *(torch.from_numpy(x) for x in (T0, L, ep, valid)), T_CAM, tpose.PoseOptConfig()
    )
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose), atol=2e-5)
    np.testing.assert_array_equal(out.inlier_lines.numpy(), np.asarray(ref.inlier_lines))
    assert int(out.num_inliers) == int(ref.num_inliers) >= 20


# ---- the System on rendered frames -------------------------------------------


def _hybrid_fixture():
    """tests/test_hybrid.py's mono frames: QVGA at fx 200, 24 segments and 130
    points (drawn as dots) seen by a sideways walk of 0.08 m per frame, seed 0."""
    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_mono_scene, render_wireframe_image

    cam = Intrinsics(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240, baseline=0.1)
    rng = np.random.default_rng(0)
    scene = make_mono_scene(rng, 16, cam=cam, n_segments=24, n_points=130, step=0.08)
    frames = [render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=True) for f in range(16)]
    return cam, scene, frames


@pytest.fixture(scope="module")
def system_runs():
    from tpuslam_torch.convert import tracker_config_from
    from tpuslam_torch.system import System

    cam, scene, frames = _hybrid_fixture()
    out = {}
    for points in (True, False):
        jcfg = mono_tracker_cfg(points, max_frames_between_kf=3)
        js, _ = run_jax_mono(cam, frames, jcfg, loop_closing=False)
        with python_graph():
            ts = System(cam, sensor="mono", loop_closing=False, tracker_cfg=tracker_config_from(jcfg), device="cpu")
        for f, img in enumerate(frames):
            ts.track_monocular(img, f * 0.05)
        ts.shutdown()
        out[points] = (js, ts)
    return scene, out


@pytest.mark.parametrize("points", [True, False], ids=["hybrid", "lines"])
def test_mono_system_matches_jax(system_runs, points):
    """Hybrid: tracked from the JAX package's first OK frame on, within the
    ATE bound, with the point floors. Lines only, 24 segments give too few
    line matches for the two-view bootstrap: neither package initializes,
    and both keep frame 0 as the initializer's reference."""
    scene, out = system_runs
    js, ts = out[points]
    assert len(ts.trajectory) == 16
    jstates = [r.state.name for r in js.trajectory]
    tstates = [r.state.name for r in ts.trajectory]
    if not points:
        assert tstates == jstates == ["NOT_INITIALIZED"] * 16
        assert ts.tracker.mono_init.ref_idx == js.tracker._mono_init.ref_idx == 0
        return
    first = jstates.index("OK")
    assert tstates.index("OK") <= first + 2 and all(s == "OK" for s in tstates[tstates.index("OK"):])
    bound = sim3_ate(js.trajectory, scene) * ATE_FACTOR + ATE_MARGIN_M
    assert sim3_ate(ts.trajectory, scene) <= bound
    if points:
        live = ts.map.points.live_ids()
        assert len(live) >= 10 and (ts.map.points.n_obs[live] >= 2).sum() >= 5
        assert np.isfinite(ts.map.points.xyz[live]).all()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    what = sys.argv[1] if len(sys.argv) > 1 else "mono"
    if what == "draws":
        # lines only over other RANSAC draws: PRNGKey(frame_idx + 1000 k)
        import jax.random

        cam, scene, frames = chip_smoke.make_mono_frames()
        key = jax.random.PRNGKey
        k0, k1 = (int(a) for a in sys.argv[2:4])
        ates = []
        for k in range(k0, k1):
            jax.random.PRNGKey = lambda i, k=k: key(i + 1000 * k)
            try:
                s, _ = run_jax_mono(cam, frames, mono_tracker_cfg(False))
            finally:
                jax.random.PRNGKey = key
            ates.append(sim3_ate(s.trajectory, scene))
            states = [r.state.name for r in s.trajectory]
            print(f"JAX mono lines, draws k = {k}: first OK frame {states.index('OK')}, Sim(3) ATE {ates[-1]!r}", flush=True)
        print(f"JAX_MONO_LINES_DRAW_ATES_M[{k0}:{k1}] = {ates!r}", flush=True)
    elif what == "mono":
        cam, scene, frames = chip_smoke.make_mono_frames()
        for points in (True, False):
            s, _ = run_jax_mono(cam, frames, mono_tracker_cfg(points))
            tag = "HYBRID" if points else "LINES"
            states = [r.state.name for r in s.trajectory]
            first = states.index("OK")
            kfs = [r.frame_idx for r in s.trajectory if r.made_keyframe]
            pts = s.map.points.live_ids()
            print(
                f"JAX mono {tag.lower()}: states {states}; keyframes {kfs}; live lines {len(s.map.lines.live_ids())}, "
                f"live points {len(pts)}, 2+ observations {int((s.map.points.n_obs[pts] >= 2).sum())}",
                flush=True,
            )
            print(f"JAX_MONO_{tag}_FIRST_OK = {first}", flush=True)
            print(f"JAX_MONO_{tag}_OK_FRAMES = {states.count('OK')}", flush=True)
            print(f"JAX_MONO_{tag}_ATE_M = {sim3_ate(s.trajectory, scene)!r}", flush=True)
    else:
        for dwell in (20, 24, 32, 48):
            cam, scene, frames = chip_smoke.make_mono_loop_frames(dwell=dwell)
            s, closures = run_jax_mono(cam, frames, mono_tracker_cfg(True), scene=scene)
            lc = s.loop_closer
            ok = [r for r in s.trajectory if r.state.name == "OK"]
            print(
                f"JAX mono loop, dwell {dwell}: {len(frames)} frames, OK {len(ok)}, keyframes {len(s.map.keyframes)}, "
                f"loops closed {lc.closed_loops}, gba_skipped {lc.gba_skipped}, frame Sim(3) ATE {sim3_ate(s.trajectory, scene)!r}, "
                f"final keyframe-map Sim(3) ATE {kf_map_ate(s.map, scene, with_scale=True)!r}",
                flush=True,
            )
            for c in closures:
                print(f"closure: keyframe {c[0]} (frame {c[1]}) to {c[2]}: KF-map Sim(3) ATE {c[3]!r} -> {c[4]!r} m", flush=True)
            if closures:
                print(f"MONO_LOOP_DWELL = {dwell}", flush=True)
                print(f"JAX_MONO_LOOP_OK_FRAMES = {len(ok)}", flush=True)
                print(f"JAX_MONO_LOOP_KF_ATE_M = {kf_map_ate(s.map, scene, with_scale=True)!r}", flush=True)
                break
