"""Batched multi-sequence tracking and batched BA (BASELINE config #5):
tpuslam_torch.parallel against tpuslam.parallel on the same numpy inputs,
on the CPU at QVGA (the JAX runs shared through module-scoped fixtures).

- ``cam_batch``: the same (N,) float32 fields.
- ``batched_extract`` on 2 rendered QVGA frames: the valid segments of each
  image as sets against the JAX package's (as
  test_detect_lines_segment_sets_match_jax holds the detector: 95% within
  0.5 px each way, counts within 5%), and the port's batched extraction
  equal, field by field, to its own per-image extraction.
- ``batched_stereo`` on the JAX package's features with per-sequence
  ``fx * baseline``: the same stereo matches, depths within 1e-4 relative.
- ``batched_track_step`` on identical synthetic features with 3 mixed
  calibrations: poses within 1e-4 rad and 3e-4 m (the anchor tolerances of
  test_torch_semidirect.py), the same counts.
- ``MultiTracker`` over 3 sequences x 8 frames of synthetic features, a
  LocalMapper per sequence: one batched dispatch per steady frame (7),
  every later frame OK, poses against the JAX MultiTracker's; its
  ``track_stereo`` on rendered frames against one port Tracker per
  sequence.
- ``_toy_problem`` and ``batched_ba`` against the JAX package's, and the
  batched solve against a loop of the port's own ``run_lm``.

Run as a script, it prints the JAX MultiTracker's per-sequence ATEs for
chip_smoke.py's config-#5 phase (``make_multi_frames``: 8 VGA stereo
sequences with per-sequence calibrations, a LocalMapper each, the
JAX_MULTI_ATE_M constant there), on the CPU with cv2 hidden,
TPUSLAM_KF_DEFER_MS=0 and TPUSLAM_NATIVE_MAP=0:

    python tests/test_torch_parallel.py
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

from torch_parity import QVGA, JaxAsOnTheCard, image01, np_of, stereo_scene
from tpuslam_torch import Intrinsics
from tpuslam_torch.convert import features_from
from tpuslam_torch.frontend.frame import FrameFeatures, FrontendParams, StereoParams, extract_features
from tpuslam_torch.parallel import multi_seq as tms
from tpuslam_torch.parallel import sharded_ba as tsba


def mixed_cams(n: int, base: Intrinsics = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)):
    """tests/test_parallel.py's per-sequence calibrations (scaled with the
    image for QVGA)."""
    k = base.width / 640.0
    return [
        base._replace(
            fx=base.fx + 14.0 * s * k, fy=base.fy - 11.0 * s * k, cx=base.cx + 6.0 * s * k, cy=base.cy - 5.0 * s * k,
            baseline=0.11 + 0.015 * s,
        )
        for s in range(n)
    ]


def _jax_cam(c):
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    return JIntrinsics(*c)


def _stack_jax(per):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda *xs: jnp.stack(xs), *per)


def _stack_port(per):
    return FrameFeatures(*(torch.stack(xs) for xs in zip(*per)))


def test_cam_batch_matches_jax():
    """(N,) float32 fields, equal to the JAX package's."""
    from tpuslam.parallel.multi_seq import cam_batch as jcam_batch

    cams = mixed_cams(3)
    got, ref = tms.cam_batch(cams, device="cpu"), jcam_batch([_jax_cam(c) for c in cams])
    assert got._fields == ref._fields
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == (3,)
        np.testing.assert_array_equal(np_of(a), np.asarray(b))


# ---- extraction and stereo ---------------------------------------------------

EXTRACT = FrontendParams(max_lines=128)


@pytest.fixture(scope="module")
def extraction():
    """Two rendered QVGA stereo pairs; the JAX package's batched extraction
    and stereo on them, the port's batched extraction."""
    import jax.numpy as jnp

    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.frame import StereoParams as JStereoParams
    from tpuslam.parallel.multi_seq import batched_extract as jextract
    from tpuslam.parallel.multi_seq import batched_stereo as jstereo

    _, frames = stereo_scene(2)
    lefts = np.stack([image01(f[0]) for f in frames])
    rights = np.stack([image01(f[1]) for f in frames])
    jp = JFrontendParams(max_lines=EXTRACT.max_lines)
    jl, jr = jextract(jnp.asarray(lefts), jp), jextract(jnp.asarray(rights), jp)
    fxb = np.asarray([c.fx * c.baseline for c in mixed_cams(2, QVGA)], np.float32)
    jst = jstereo(jl, jr, jnp.asarray(fxb), JStereoParams())
    tl = tms.batched_extract(torch.from_numpy(lefts), EXTRACT)
    return dict(lefts=lefts, jl=jl, jr=jr, fxb=fxb, jst=jst, tl=tl)


def _segments(endpoints, valid):
    return np_of(endpoints)[np_of(valid) > 0.5]


def _matched(a, b, tol):
    """Fraction of segments in a with a segment in b whose endpoints lie
    within tol px (either orientation)."""
    if len(a) == 0:
        return 1.0
    d_same = np.abs(a[:, None] - b[None]).max(axis=(2, 3))
    d_flip = np.abs(a[:, None] - b[None, :, ::-1]).max(axis=(2, 3))
    return float((np.minimum(d_same, d_flip).min(axis=1) < tol).mean())


def test_batched_extract_matches_jax_and_single(extraction):
    """Each image's valid segments against the JAX package's batched
    extraction (slots need not line up: the support threshold is
    discontinuous and the moment sums add in another order): counts within
    5%, 95% of each side's segments within 0.5 px. The port's batched
    extraction equal, every field, to its per-image extraction."""
    tl, jl = extraction["tl"], extraction["jl"]
    for i in range(2):
        ts, js = _segments(tl.endpoints[i], tl.valid[i]), _segments(np.asarray(jl.endpoints[i]), np.asarray(jl.valid[i]))
        assert len(js) > 40
        assert abs(len(ts) - len(js)) <= 0.05 * len(js)
        assert _matched(js, ts, 0.5) >= 0.95 and _matched(ts, js, 0.5) >= 0.95
        single = extract_features(torch.from_numpy(extraction["lefts"][i]), EXTRACT)
        for name, a, b in zip(single._fields, tl, single):
            assert torch.equal(a[i], b), (i, name)


def test_batched_stereo_matches_jax(extraction):
    """Descriptor stereo on the JAX package's own features (both cameras),
    with a different fx * baseline per sequence: the same stereo matches
    (has_depth) and depths within 1e-4 relative (one float32 division)."""
    jl, jr, jst = extraction["jl"], extraction["jr"], extraction["jst"]
    tl = _stack_port([features_from(FrameFeatures(*(np.asarray(x[i]) for x in jl))) for i in range(2)])
    tr = _stack_port([features_from(FrameFeatures(*(np.asarray(x[i]) for x in jr))) for i in range(2)])
    got = tms.batched_stereo(tl, tr, torch.from_numpy(extraction["fxb"]), StereoParams())
    np.testing.assert_array_equal(np_of(got.has_depth), np.asarray(jst.has_depth))
    assert float(np_of(got.has_depth).sum()) > 20
    np.testing.assert_allclose(np_of(got.depth), np.asarray(jst.depth), rtol=1e-4, atol=0)


# ---- the batched tracking stage ------------------------------------------------

N_SEQ, N_FRAMES = 3, 8


def _sequences(n=N_SEQ, frames=N_FRAMES):
    """n wireframe scenes (seeds 200 + s) under the mixed calibrations, as
    tests/test_parallel.py builds them: (JAX cams, port cams, JAX scenes)."""
    from tpuslam.io.synthetic import make_wireframe_scene

    cams = mixed_cams(n)
    jcams = [_jax_cam(c) for c in cams]
    scenes = [
        make_wireframe_scene(np.random.default_rng(200 + s), n_segments=120, n_frames=frames, cam=jcams[s], motion_scale=0.02)
        for s in range(n)
    ]
    return jcams, cams, scenes


def _features(scenes, f):
    """Frame f's synthetic features of every sequence (JAX FrameFeatures,
    numpy leaves), the noise of tests/test_parallel.py's mixed-camera test."""
    from tpuslam.io.synthetic import synthetic_frame_features

    return [
        synthetic_frame_features(s, f, noise_px=0.3, rng=np.random.default_rng(f * 37 + i), with_depth=True)[0]
        for i, s in enumerate(scenes)
    ]


@pytest.mark.parametrize("form", ["batched", "single"])
def test_batched_track_step_matches_jax(form):
    """The coarse and fine stage for 3 sequences with different
    calibrations, on identical inputs (each JAX tracker initialized on frame
    0 gives the local map; frame 1's features and the motion prior): poses
    within 1e-4 rad and 3e-4 m, the same matched and inlier counts and depth
    counts in the packed rows. "single": the synchronous stereo tracker's
    two stages (``tracked_pose_step`` per sequence, the JAX IRLS formula
    since the repair of ROADMAP.md's fault 3.2) against the same JAX
    batched step."""
    import jax.numpy as jnp

    from test_torch_semidirect import _pose_gap
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
    from tpuslam.parallel.multi_seq import batched_track_step as jstep
    from tpuslam.parallel.multi_seq import cam_batch as jcam_batch
    from tpuslam.slammap.map import SlamMap as JSlamMap
    from tpuslam_torch.convert import local_map_from, tracker_config_from

    jcams, cams, scenes = _sequences(frames=2)
    f0, f1 = _features(scenes, 0), _features(scenes, 1)
    cfg = JTrackerConfig()
    with JaxAsOnTheCard():
        locs = []
        for s in range(N_SEQ):
            jt = JTracker(jcams[s], JSlamMap(), cfg)
            jt.frame_idx = 0
            jt._track(f0[s], 0.0, stereo=True)
            locs.append({k: np.asarray(v) for k, v in jt._local_map_arrays().items()})
            jt.close()
    T_pred = np.stack([s.poses[0] for s in scenes]).astype(np.float32)
    stack = lambda k: np.stack([loc[k] for loc in locs])  # noqa: E731
    ref = jstep(
        jnp.asarray(T_pred), *(jnp.asarray(stack(k)) for k in ("plucker", "ep3d", "bits", "valid")),
        _stack_jax(f1), jcam_batch(jcams), cfg.search_coarse, cfg.search_fine, cfg.pose_opt,
    )
    tlocs = [local_map_from(loc) for loc in locs]
    tcfg = tracker_config_from(cfg)
    if form == "batched":
        got = tms.batched_track_step(
            torch.from_numpy(T_pred), *(torch.stack([loc[k] for loc in tlocs]) for k in ("plucker", "ep3d", "bits", "valid")),
            _stack_port([features_from(f) for f in f1]), tms.cam_batch(cams, device="cpu"),
            tcfg.search_coarse, tcfg.search_fine, tcfg.pose_opt,
        )
    else:
        from tpuslam_torch.frontend.matcher import tracked_pose_step

        rows = []
        for s in range(N_SEQ):
            loc, f = tlocs[s], features_from(f1[s])
            args = (loc["plucker"], loc["ep3d"], loc["bits"], loc["valid"], f, cams[s])
            coarse = tracked_pose_step(torch.from_numpy(T_pred[s]), *args, tcfg.search_coarse, tcfg.pose_opt)
            fine = tracked_pose_step(coarse.pose, *args, tcfg.search_fine, tcfg.pose_opt)
            rows.append((fine.pose, torch.cat([fine.pose.reshape(-1), torch.stack([
                fine.num_matched.to(torch.float32), fine.num_inliers.to(torch.float32), f.has_depth.sum()])])))
        got = (torch.stack([r[0] for r in rows]),) + (None,) * 4 + (torch.stack([r[1] for r in rows]),)
    packed, packed_ref = np_of(got[5]), np.asarray(ref[5])
    for s in range(N_SEQ):
        ang, dc = _pose_gap(packed[s, :16].reshape(4, 4), packed_ref[s, :16].reshape(4, 4))
        assert ang <= 1e-4 and dc <= 3e-4, (s, ang, dc)
        np.testing.assert_array_equal(packed[s, 16:19], packed_ref[s, 16:19])
        assert packed[s, 17] >= 50
        np.testing.assert_array_equal(np_of(got[0][s]), packed[s, :16].reshape(4, 4))


@pytest.fixture(scope="module")
def multi_runs():
    """Both MultiTrackers (a LocalMapper per sequence, the JAX map's native
    mirror off) over the same synthetic features, their batched dispatches
    counted."""
    from tpuslam.backend.mapping import LocalMapper as JLocalMapper
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig
    from tpuslam.parallel import multi_seq as jms
    from tpuslam_torch.backend.mapping import LocalMapper
    from tpuslam_torch.convert import mapper_config_from

    jcams, cams, scenes = _sequences()
    runs = {}
    with JaxAsOnTheCard():
        jm = jms.MultiTracker(jcams)
        for s, tr in enumerate(jm.trackers):
            m = JLocalMapper(tr.map, jcams[s], JMapperConfig())
            tr.on_new_keyframe, m.on_map_changed = m.process, tr.invalidate_local_map
        tm = tms.MultiTracker(cams, device="cpu")
        for s, tr in enumerate(tm.trackers):
            m = LocalMapper(tr.map, cams[s], mapper_config_from(JMapperConfig()), device="cpu")
            tr.on_new_keyframe, m.on_map_changed = m.process, tr.invalidate_local_map
        for name, mod, mt in (("jax", jms, jm), ("port", tms, tm)):
            calls = {"batched": 0}
            real = mod.batched_track_step

            def counting(*a, _real=real, _calls=calls, **k):
                _calls["batched"] += 1
                return _real(*a, **k)

            mod.batched_track_step = counting
            try:
                res = []
                for f in range(N_FRAMES):
                    per = _features(scenes, f)
                    feats = _stack_jax(per) if name == "jax" else _stack_port([features_from(x) for x in per])
                    res.append(mt.track_features(feats, [f * 0.05] * N_SEQ))
            finally:
                mod.batched_track_step = real
            runs[name] = (res, calls["batched"], mt)
        for tr in jm.trackers:
            tr.close()
    return scenes, runs


def test_multi_tracker_one_dispatch_per_steady_frame(multi_runs):
    """Frame 0 initializes each sequence on its own path; every later frame
    is ONE batched dispatch for all sequences, in both packages, and every
    later frame tracks OK."""
    _, runs = multi_runs
    for name, (res, calls, _) in runs.items():
        assert calls == N_FRAMES - 1, (name, calls)
        assert all(r.state.name == "OK" for rs in res[1:] for r in rs), name


def test_multi_tracker_matches_jax(multi_runs):
    """Per sequence: the same keyframes, camera centres within 2e-3 m of the
    JAX MultiTracker's every frame (the tracking stage agrees to 3e-4 on
    identical inputs; local BA's float32 LM adds its rounding from the
    first keyframe window on: ROADMAP.md section 3, on local BA), and the
    last pose within 0.08 m of the ground truth (tests/test_parallel.py's
    bound)."""
    scenes, runs = multi_runs
    (jres, _, jm), (tres, _, tm) = runs["jax"], runs["port"]
    for s in range(N_SEQ):
        assert [r[s].made_keyframe for r in tres] == [r[s].made_keyframe for r in jres], s
        gaps = [
            np.linalg.norm(np.linalg.inv(a[s].T_cw)[:3, 3] - np.linalg.inv(b[s].T_cw)[:3, 3]) for a, b in zip(jres, tres)
        ]
        assert max(gaps) < 2e-3, (s, gaps)
        T = tm.trackers[s].T_cw
        d = np.linalg.norm(np.linalg.inv(T)[:3, 3] - np.linalg.inv(scenes[s].poses[N_FRAMES - 1])[:3, 3])
        assert d < 0.08, (s, d)


def test_multi_tracker_track_stereo_matches_single_trackers():
    """MultiTracker.track_stereo on rendered frames (2 QVGA sequences with
    their own calibrations, 3 frames) against one port Tracker per
    sequence: the same states and keyframes, frame 0's keyframe features
    equal (batched extraction and stereo), later poses within 1e-5 (the
    batched pose LM's products round apart from the single one's)."""
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    cams = mixed_cams(2, QVGA)
    seqs = [stereo_scene(3, cam=c, seed=s)[1] for s, c in enumerate(cams)]
    mt = tms.MultiTracker(cams, device="cpu")
    singles = [Tracker(c, SlamMap(), device="cpu") for c in cams]
    for f in range(3):
        got = mt.track_stereo(np.stack([q[f][0] for q in seqs]), np.stack([q[f][1] for q in seqs]), [f * 0.05] * 2)
        for s, tr in enumerate(singles):
            want = tr.track_stereo(seqs[s][f][0], seqs[s][f][1], f * 0.05)
            assert (got[s].state, got[s].made_keyframe) == (want.state, want.made_keyframe), (f, s)
            np.testing.assert_allclose(got[s].T_cw, want.T_cw, atol=1e-5)
    for s, tr in enumerate(singles):
        a, b = mt.trackers[s].map.keyframes[0].features, tr.map.keyframes[0].features
        for name in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), err_msg=name)


# ---- batched BA ----------------------------------------------------------------

CAM = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)


def test_toy_problem_matches_jax():
    """The same draws give the same problem: every field within 1e-5 plus
    1e-6 relative (the poses and lines pass through each package's float32
    se3_exp and Pluecker transform; pixel endpoints of ~300 px land one
    float32 spacing, 3e-5, apart)."""
    from tpuslam.parallel.sharded_ba import _toy_problem as jtoy

    got = tsba._toy_problem(np.random.default_rng(5), 3, 8, 32, CAM, device="cpu")
    ref = jtoy(np.random.default_rng(5), 3, 8, 32, _jax_cam(CAM))
    for name, a, b in zip(ref._fields, got, ref):
        assert np_of(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-6, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def ba_batch():
    rng = np.random.default_rng(0)
    return [tsba._toy_problem(rng, 3, 8, 32, CAM, device="cpu") for _ in range(4)]


def test_batched_ba_matches_single_solves(ba_batch):
    """batched_ba of 4 toy problems against a loop of the port's own run_lm,
    in float64: every field within 1e-8 plus 1e-6 relative (vmap runs the
    same LM, the same accept and reject decisions; 4 iterations, short of
    the converged costs of ~1e-15 where an accept test ties on rounding). In float32 the two roundings of the
    batched and the single products already move a step of these
    ill-conditioned line-only problems by 1e-4 in the first iteration (the
    JAX package's test_parallel.py holds its mesh against its single device
    to 0.15 for that reason), so float32 is held to the JAX package below."""
    from tpuslam_torch.backend.lm import BAProblem, LMConfig, run_lm

    probs = [BAProblem(*(x.double() if x.is_floating_point() else x for x in p)) for p in ba_batch]
    cfg = LMConfig(max_iters=4)  # short of convergence, where accept tests tie on rounding
    out = tsba.batched_ba(tsba.stack_problems(probs), CAM, cfg, mesh=tsba.make_mesh(1, device="cpu"))
    for i, p in enumerate(probs):
        single = run_lm(p, CAM, cfg)
        for name, a, b in zip(single._fields, out, single):
            np.testing.assert_allclose(np_of(a[i]), np_of(b), rtol=1e-6, atol=1e-8, err_msg=f"{i} {name}")


def test_batched_ba_matches_jax(ba_batch):
    """The same batch through the JAX package's batched_ba: both converge
    (noiseless observations: median final cost below 1e-2, as
    tests/test_parallel.py holds it), final costs within 1e-2 absolute, poses
    within 0.15 (tests/test_parallel.py's bound: line-only BA leaves weakly
    constrained directions on a near-zero-cost manifold)."""
    import jax
    import jax.numpy as jnp

    from tpuslam.backend.lm import BAProblem as JBAProblem
    from tpuslam.backend.lm import LMConfig as JLMConfig
    from tpuslam.parallel.sharded_ba import batched_ba as jbatched

    cfg = tsba.LMConfig(max_iters=15)
    out = tsba.batched_ba(tsba.stack_problems(ba_batch), CAM, cfg)
    jprobs = [JBAProblem(*(jnp.asarray(np_of(x)) for x in p)) for p in ba_batch]
    ref = jbatched(jax.tree.map(lambda *xs: jnp.stack(xs), *jprobs), _jax_cam(CAM), JLMConfig(max_iters=15))
    cost, cost_ref = np_of(out.cost), np.asarray(ref.cost)
    assert np.median(cost) < 1e-2 and np.median(cost_ref) < 1e-2
    np.testing.assert_allclose(cost, cost_ref, atol=1e-2)
    np.testing.assert_allclose(np_of(out.poses), np.asarray(ref.poses), atol=0.15)


def test_mesh_and_dryrun():
    """make_mesh takes the devices there are and refuses more; a mesh of
    several entries splits batched_ba's batch (two problems over two CPU
    entries, each in its shard process: a finite state per problem, on the
    mesh's first device; the
    split is held to the unsplit solve in tests/test_torch_mesh.py); the
    dryrun runs the whole config-#5 step on tiny shapes."""
    mesh = tsba.make_mesh(1, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.axis == "seq"
    with pytest.raises(ValueError):
        tsba.make_mesh(2, device="cpu")
    two = tsba.DeviceMesh((torch.device("cpu"), torch.device("cpu")))
    rng = np.random.default_rng(0)
    probs = tsba.stack_problems([tsba._toy_problem(rng, 3, 8, 32, CAM, "cpu") for _ in range(2)])
    try:
        state = tsba.batched_ba(probs, CAM, tsba.LMConfig(max_iters=2), mesh=two)
    finally:
        two.close()  # its shard processes end with the test
    assert tuple(state.poses.shape) == (2, 3, 4, 4) and state.poses.device == two.devices[0]
    assert bool(torch.all(torch.isfinite(state.cost)))
    tsba.dryrun(1, device="cpu")


# ---- chip_smoke.py's config-#5 phase: the JAX reference -------------------------


def run_jax_multi(cams, scenes, frames):
    """The JAX MultiTracker with a LocalMapper per sequence over the stereo
    frames (uint8 (left, right) per sequence and frame): per-sequence
    trajectories (lists of FrameResult)."""
    from tpuslam.backend.mapping import LocalMapper as JLocalMapper
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig
    from tpuslam.parallel.multi_seq import MultiTracker as JMultiTracker

    jcams = [_jax_cam(c) for c in cams]
    with JaxAsOnTheCard():
        mt = JMultiTracker(jcams)
        for s, tr in enumerate(mt.trackers):
            m = JLocalMapper(tr.map, jcams[s], JMapperConfig())
            tr.on_new_keyframe, m.on_map_changed = m.process, tr.invalidate_local_map
        traj = [[] for _ in cams]
        for f in range(len(frames[0])):
            lefts = np.stack([image01(seq[f][0]) for seq in frames])
            rights = np.stack([image01(seq[f][1]) for seq in frames])
            results = mt.track_stereo(lefts, rights, [f * 0.05] * len(cams))
            for s, r in enumerate(results):
                traj[s].append(r)
            print(f"frame {f}: {[r.state.name for r in results]}", flush=True)
        for tr in mt.trackers:
            tr.close()
    return traj


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    cams, scenes, frames = chip_smoke.make_multi_frames()
    traj = run_jax_multi(cams, scenes, frames)
    ates = [chip_smoke.ate_of(t, sc) for t, sc in zip(traj, scenes)]
    kfs = [[r.frame_idx for r in t if r.made_keyframe] for t in traj]
    print(f"keyframes per sequence: {kfs}", flush=True)
    print(f"JAX_MULTI_ATE_M = {ates!r}", flush=True)
