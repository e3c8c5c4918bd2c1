"""The hybrid point modules of tpuslam_torch against tpuslam's, module by
module, on dot frames rendered by the port (tests/test_hybrid.py's scene):
the renderer's dots, FAST/BRIEF corners, descriptor and direct corner
stereo, the joint pose LM and hybrid stage, point templates and the hybrid
Gauss-Newton, the point store and the keyframe database's point rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import DOTS, dot_scene, image01, np_of
from tpuslam.backend import pose_opt as jpo
from tpuslam.frontend import points as jpts
from tpuslam.geometry.camera import Intrinsics as JIntrinsics
from tpuslam.geometry.camera import project_points as j_project_points
from tpuslam.geometry.plucker import plucker_from_points as j_plucker_from_points
from tpuslam.geometry.se3 import se3_apply as j_se3_apply
from tpuslam.geometry.se3 import se3_retract as j_se3_retract
from tpuslam.kernels import align_direct as jad
from tpuslam.kernels import fast as jfast
from tpuslam.kernels import stereo_direct as jsd
from tpuslam_torch.backend import pose_opt as tpo
from tpuslam_torch.convert import features_from, point_features_from
from tpuslam_torch.frontend import points as tpts
from tpuslam_torch.frontend.frame import FrontendParams, host_prescale
from tpuslam_torch.io import synthetic as tsyn
from tpuslam_torch.kernels import align_direct as tad
from tpuslam_torch.kernels import fast as tfast
from tpuslam_torch.kernels import stereo_direct as tsd

J_DOTS = JIntrinsics(*DOTS)
PP = tpts.PointFrontendParams()
JPP = jpts.PointFrontendParams()


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(scope="module")
def dots():
    """Four dot frames, the JAX package's corners of frames 0 and 1 (left
    and right), and its line features of frame 0."""
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.frame import extract_features as j_extract

    scene, frames = dot_scene(4)
    imgs = [(image01(il), image01(ir)) for il, ir in frames]
    jc = [[jfast.detect_corners(jnp.asarray(im), 256, jfast.FASTParams()) for im in pair] for pair in imgs[:2]]
    jl = j_extract(jnp.asarray(imgs[0][0]), JFrontendParams())
    return dict(scene=scene, frames=frames, imgs=imgs, jc=jc, jl=jl)


# ---- renderer --------------------------------------------------------------


def test_renderer_dots_match_jax():
    """The dots (centre splat and satellites) and the noise, bit for bit the
    JAX renderer's on a scene with no visible line (the JAX package draws
    its lines with cv2; its dots are numpy)."""
    pytest.importorskip("cv2")
    from tpuslam.io import synthetic as jsyn

    scene = tsyn.make_wireframe_scene(np.random.default_rng(2), n_segments=1, n_points=120, n_frames=2, cam=DOTS)
    scene = scene._replace(segments=np.full_like(scene.segments, -50.0))  # behind the camera
    jscene = jsyn.SyntheticScene(scene.segments, scene.points, scene.poses, J_DOTS)
    for f in range(2):
        a = tsyn.render_wireframe_image(scene, f, noise=1.0, rng=np.random.default_rng(f), draw_points=True)
        b = jsyn.render_wireframe_image(jscene, f, noise=1.0, rng=np.random.default_rng(f), draw_points=True)
        np.testing.assert_array_equal(a, b)
        assert (a < 100).sum() > 50  # dots drawn
    obs, jobs = tsyn.observe_frame(scene, 1), jsyn.observe_frame(jscene, 1)
    np.testing.assert_array_equal(obs.pt_uv, jobs.pt_uv)
    np.testing.assert_array_equal(obs.pt_visible, jobs.pt_visible)


# ---- FAST / BRIEF ----------------------------------------------------------


def test_brief_pairs_match_jax():
    np.testing.assert_array_equal(tfast._brief_pairs(tfast.FASTParams()), jfast._brief_pairs(jfast.FASTParams()))


def _match_sets(uv_a, uv_b, tol):
    """Indices (i, j) pairing each point of a with the point of b within tol."""
    d = np.linalg.norm(uv_a[:, None, :] - uv_b[None, :, :], axis=-1)
    j = np.argmin(d, axis=1)
    ok = d[np.arange(len(uv_a)), j] <= tol
    return np.nonzero(ok)[0], j[ok]


@pytest.mark.parametrize("case", ["left0", "right1", "halved"])
def test_detect_corners_match_jax(dots, case):
    """Corners compared as sets: every valid corner of either package has
    one of the other's within 1e-3 px, the same count, the BRIEF words of
    matched corners exact and their responses within 1e-4 relative."""
    if case == "halved":  # a VGA dot frame halved on the host, as on the bench path
        from tpuslam_torch import Intrinsics

        vga = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
        _, frames = dot_scene(1, vga, seed=5, n_segments=140, n_points=200, motion_scale=0.02)
        img = image01(host_prescale(frames[0][0], FrontendParams(base_scale=0.5, prescaled=True)))
        ref = jfast.detect_corners(jnp.asarray(img), 256, jfast.FASTParams())
    else:
        f, side = (0, 0) if case == "left0" else (1, 1)
        img, ref = dots["imgs"][f][side], dots["jc"][f][side]
    got = tfast.detect_corners(_t(img), 256, tfast.FASTParams())
    v, rv = np_of(got.valid) > 0.5, np.asarray(ref.valid) > 0.5
    assert v.sum() == rv.sum() >= 40
    uv, ruv = np_of(got.uv)[v], np.asarray(ref.uv)[rv]
    i, j = _match_sets(uv, ruv, 1e-3)
    assert len(i) == len(uv) == len(ruv)
    np.testing.assert_array_equal(np_of(got.desc_bits)[v][i].astype(np.uint32), np.asarray(ref.desc_bits)[rv][j])
    np.testing.assert_allclose(np_of(got.response)[v][i], np.asarray(ref.response)[rv][j], rtol=1e-4)
    assert np.all(np_of(got.desc_bits)[~v] == 0) and np.all(np_of(got.uv)[~v] == 0)


# ---- corner stereo ---------------------------------------------------------


def test_stereo_point_depths_match_jax(dots):
    """Descriptor stereo on the JAX package's left and right corners: the
    same associations, disparities within 1e-3 px."""
    jl, jr = dots["jc"][0]
    fxb = float(np.float32(DOTS.fx * DOTS.baseline))
    ref = jpts.stereo_point_depths(jl, jr, fxb, JPP)
    got = tpts.stereo_point_depths(point_features_from(jl), point_features_from(jr), fxb, PP)
    ok = np.asarray(ref.has_depth) > 0.5
    np.testing.assert_array_equal(np_of(got.has_depth) > 0.5, ok)
    assert ok.sum() >= 15
    np.testing.assert_allclose(fxb / np_of(got.depth)[ok], fxb / np.asarray(ref.depth)[ok], atol=1e-3)


@pytest.mark.parametrize("coord_scale", [1.0, 0.5])
def test_direct_point_disparity_matches_jax(dots, coord_scale):
    """Direct corner stereo on the JAX package's corners: the same gates,
    disparities within 1e-3 px (0.5: the images halved, the corners in
    full-resolution pixels, as on the bench path)."""
    il, ir = dots["imgs"][0]
    jc = dots["jc"][0][0]
    uv, valid = np.asarray(jc.uv), np.asarray(jc.valid)
    p = tsd.DirectPointStereoParams(max_disp=64.0)
    if coord_scale != 1.0:
        half = FrontendParams(base_scale=0.5, prescaled=True)
        il, ir = (image01(host_prescale(x, half)) for x in dots["frames"][0])
        uv = uv * 2.0
        p = tsd.inject_coord_scale(p, 0.5, True)
    jp = jsd.DirectPointStereoParams(**p._asdict())
    d_ref, ok_ref = jsd.direct_point_disparity(jnp.asarray(il), jnp.asarray(ir), jnp.asarray(uv), jnp.asarray(valid), jp)
    d, ok = tsd.direct_point_disparity_body(_t(il), _t(ir), _t(uv), _t(valid), p)
    ok_ref = np.asarray(ok_ref) > 0.5
    np.testing.assert_array_equal(np_of(ok) > 0.5, ok_ref)
    assert ok_ref.sum() >= 15
    np.testing.assert_allclose(np_of(d)[ok_ref], np.asarray(d_ref)[ok_ref], atol=1e-3)
    got = tsd.direct_stereo_point_depths(_t(il), _t(ir), point_features_from(jc._replace(uv=jnp.asarray(uv))), 20.0, p)
    np.testing.assert_array_equal(np_of(got.has_depth), np_of(ok))


def test_triangulate_stereo_points_matches_jax(dots):
    jc = jpts.stereo_point_depths(*dots["jc"][0], float(np.float32(DOTS.fx * DOTS.baseline)), JPP)
    T_wc = np.linalg.inv(dots["scene"].poses[0]).astype(np.float32)
    xyz_ref, ok_ref = jpts.triangulate_stereo_points(T_wc, jc, J_DOTS)
    xyz, ok = tpts.triangulate_stereo_points(T_wc, point_features_from(jc), DOTS)
    np.testing.assert_array_equal(np_of(ok), np.asarray(ok_ref))
    np.testing.assert_allclose(np_of(xyz), np.asarray(xyz_ref), rtol=1e-6, atol=1e-6)


# ---- the joint pose LM and the hybrid stage ----------------------------------


def _pose_gap(T, T_ref):
    """(rotation angle rad, camera centre distance m) between two T_cw."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    dR = T[:3, :3] @ T_ref[:3, :3].T
    w = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    c, c_ref = -T[:3, :3].T @ T[:3, 3], -T_ref[:3, :3].T @ T_ref[:3, 3]
    return float(np.arctan2(np.linalg.norm(w), 0.5 * (np.trace(dR) - 1.0))), float(np.linalg.norm(c - c_ref))


@pytest.fixture(scope="module")
def landmarks(dots):
    """The scene's segments and points as a local map (padded to 256 /
    256), with noisy observations in frame 1 and a perturbed starting
    pose."""
    scene = dots["scene"]
    rng = np.random.default_rng(11)
    NL, NP = 256, 256
    segs = scene.segments
    nl = len(segs)
    ep3d = np.zeros((NL, 2, 3), np.float32)
    ep3d[: len(segs)] = segs
    ep3d[len(segs):] = segs[0]
    lvalid = np.zeros(NL, np.float32)
    lvalid[: len(segs)] = 1.0
    plucker = np.asarray(jax.vmap(lambda e: j_plucker_from_points(e[0], e[1]))(jnp.asarray(ep3d)))
    xyz = np.zeros((NP, 3), np.float32)
    xyz[: len(scene.points)] = scene.points
    pvalid = np.zeros(NP, np.float32)
    pvalid[: len(scene.points)] = 1.0
    T = scene.poses[1]
    obs = tsyn.observe_frame(scene, 1)
    l_ep = np.zeros((NL, 2, 2), np.float32)
    l_ep[:nl] = obs.seg_uv + rng.normal(0, 0.3, (nl, 2, 2))
    l_valid = lvalid * np.r_[obs.seg_visible, np.zeros(NL - nl, bool)]
    p_uv = np.zeros((NP, 2), np.float32)
    p_uv[: len(scene.points)] = obs.pt_uv + rng.normal(0, 0.3, obs.pt_uv.shape)
    p_uv[5:10] += 25.0  # gross outliers
    p_valid = pvalid * np.r_[obs.pt_visible, np.zeros(NP - len(scene.points), bool)]
    T0 = (tsyn._se3_exp_np(np.array([0.02, -0.01, 0.015, 0.004, -0.003, 0.002])) @ T).astype(np.float32)
    return dict(ep3d=ep3d, lvalid=lvalid, plucker=plucker, xyz=xyz, pvalid=pvalid, l_ep=l_ep.astype(np.float32),
                l_valid=l_valid.astype(np.float32), p_uv=p_uv, p_valid=p_valid.astype(np.float32), T0=T0, T=T)


def test_pose_optimize_with_points_matches_jax(landmarks):
    """The joint LM over line and point residuals: the pose within 1e-4 rad
    and 3e-4 m of the JAX package's, the same inlier masks (the gross point
    outliers rejected), the same inlier count."""
    m = landmarks
    cfg = jpo.PoseOptConfig()
    ref = jax.jit(lambda *a: jpo.pose_optimize(*a, cam=J_DOTS, cfg=cfg))(
        jnp.asarray(m["T0"]), jnp.asarray(m["plucker"]), jnp.asarray(m["l_ep"]), jnp.asarray(m["l_valid"]),
        jnp.asarray(m["xyz"]), jnp.asarray(m["p_uv"]), jnp.asarray(m["p_valid"]),
    )
    got = tpo.pose_optimize(
        _t(m["T0"]), _t(m["plucker"]), _t(m["l_ep"]), _t(m["l_valid"]), DOTS, tpo.PoseOptConfig(),
        points=_t(m["xyz"]), p_uv=_t(m["p_uv"]), p_valid=_t(m["p_valid"]),
    )
    ang, dc = _pose_gap(np_of(got.pose), np.asarray(ref.pose))
    assert ang <= 1e-4 and dc <= 3e-4, (ang, dc)
    np.testing.assert_array_equal(np_of(got.inlier_lines), np.asarray(ref.inlier_lines))
    np.testing.assert_array_equal(np_of(got.inlier_points), np.asarray(ref.inlier_points))
    assert int(got.num_inliers) == int(ref.num_inliers) and np_of(got.inlier_points)[5:10].sum() == 0
    ang_gt, dc_gt = _pose_gap(np_of(got.pose), m["T"])
    assert dc_gt < 0.01


def test_tracked_pose_step_hybrid_matches_jax(dots):
    """One hybrid stage from a perturbed pose: frame 0's lines and corners
    (direct stereo depths) as the local map, frame 1's JAX features as the
    frame; the same point matches, the line matches and counts, the pose
    within 1e-4 rad and 3e-4 m of the JAX package's."""
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.frame import extract_features as j_extract
    from tpuslam.frontend.matcher import ProjectionSearchParams as JSearch
    from tpuslam.frontend.matcher import triangulate_stereo_lines as j_tri_lines
    from tpuslam_torch.frontend.matcher import ProjectionSearchParams

    scene = dots["scene"]
    (il0, ir0), (il1, _) = dots["imgs"][:2]
    fxb = float(np.float32(DOTS.fx * DOTS.baseline))
    sd = jsd.DirectStereoParams(max_disp=64.0)
    f0 = jsd.direct_stereo_depths(jnp.asarray(il0), jnp.asarray(ir0), dots["jl"], fxb, sd)
    c0 = jsd.direct_stereo_point_depths(jnp.asarray(il0), jnp.asarray(ir0), dots["jc"][0][0], fxb, jsd.DirectPointStereoParams(max_disp=64.0))
    T_wc = jnp.asarray(np.linalg.inv(scene.poses[0]).astype(np.float32))
    plucker, ep3d, okl = j_tri_lines(T_wc, f0, J_DOTS)
    xyz, okp = jpts.triangulate_stereo_points(np.asarray(T_wc), c0, J_DOTS)
    line_local = dict(plucker=plucker, ep3d=ep3d, bits=f0.desc_bits, valid=okl)
    point_local = dict(xyz=xyz, bits=c0.desc_bits, valid=okp)
    assert float(okl.sum()) >= 20 and float(okp.sum()) >= 30
    fl1, fp1 = j_extract(jnp.asarray(il1), JFrontendParams()), dots["jc"][1][0]
    Tp = (tsyn._se3_exp_np(np.array([0.01, 0.0, -0.01, 0.002, 0.0, -0.002])) @ scene.poses[0]).astype(np.float32)
    ref = jpts.tracked_pose_step_hybrid(jnp.asarray(Tp), line_local, point_local, fl1, fp1, J_DOTS, JSearch(radius=50.0), JPP)

    def port(d):
        return {k: _t(np.asarray(v).astype(np.int64)) if k == "bits" else _t(np.asarray(v, np.float32)) for k, v in d.items()}

    got = tpts.tracked_pose_step_hybrid(
        _t(Tp), port(line_local), port(point_local), features_from(fl1), point_features_from(fp1), DOTS,
        ProjectionSearchParams(radius=50.0), PP,
    )
    np.testing.assert_array_equal(np_of(got.p_match_idx), np.asarray(ref.p_match_idx))
    np.testing.assert_array_equal(np_of(got.l_match_idx), np.asarray(ref.l_match_idx))
    assert int(got.num_matched) == int(ref.num_matched) and int((np.asarray(ref.p_match_idx) >= 0).sum()) >= 20
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 1
    ang, dc = _pose_gap(np_of(got.pose), np.asarray(ref.pose))
    assert ang <= 1e-4 and dc <= 3e-4, (ang, dc)


# ---- point templates and the hybrid Gauss-Newton -----------------------------

AP = tad.inject_coord_scale_align(tad.DirectAlignParams(align_cap=128, point_cap=256), 1.0, False)
JAP = jad.DirectAlignParams(**AP._asdict())


@pytest.fixture(scope="module")
def templates(dots, landmarks):
    m = landmarks
    img0 = dots["imgs"][0][0]
    T0 = dots["scene"].poses[0]
    ref = jax.jit(jad.anchor_point_templates_body, static_argnums=(4, 5))(
        jnp.asarray(img0), jnp.asarray(T0), jnp.asarray(m["xyz"]), jnp.asarray(m["pvalid"]), J_DOTS, JAP
    )
    got = tad.anchor_point_templates_body(_t(img0), _t(T0), _t(m["xyz"]), _t(m["pvalid"]), DOTS, AP)
    return ref, got


def test_point_templates_match_jax(templates):
    """Both axis templates of every point within 1e-4 (0..255 scale), the
    same per-axis validity."""
    ref, got = templates
    np.testing.assert_array_equal(np_of(got.tvalid), np.asarray(ref.tvalid))
    assert np.asarray(ref.tvalid).all(-1).sum() >= 40
    np.testing.assert_allclose(np_of(got.tmpl), np.asarray(ref.tmpl), atol=1e-4)


def test_search_point_templates_matches_jax(dots, templates):
    """The two-axis search in frame 1 from frame 0's pose: the same
    acceptance, measured uv within 1e-3 px."""
    ref, got = templates
    img255 = dots["imgs"][1][0] * 255.0
    T = dots["scene"].poses[0]
    m_ref, ok_ref = jax.jit(jad._search_point_templates, static_argnums=(3, 4))(jnp.asarray(img255), jnp.asarray(T), ref, J_DOTS, JAP)
    m, ok = tad._search_point_templates(_t(img255), _t(T), got, DOTS, AP)
    ok_ref = np.asarray(ok_ref) > 0.5
    np.testing.assert_array_equal(np_of(ok) > 0.5, ok_ref)
    assert ok_ref.sum() >= 30
    np.testing.assert_allclose(np_of(m)[ok_ref], np.asarray(m_ref)[ok_ref], atol=1e-3)


def test_point_jacobian_matches_jacfwd(landmarks):
    """The analytic point residual Jacobian of the hybrid Gauss-Newton
    against jax.jacfwd of the JAX package's residual (depth floored at
    1e-3), within 1e-4 relative, a point behind the camera included."""
    m = landmarks
    xyz = m["xyz"][:64].copy()
    xyz[3] = [0.0, 0.0, -1.0]  # behind the camera: the floor holds, its depth column is 0
    T, m_p = m["T"], m["p_uv"][:64]

    def res_pts(xi):
        Xc = j_se3_apply(j_se3_retract(jnp.asarray(T), xi), jnp.asarray(xyz))
        Xc = Xc.at[:, 2].set(jnp.maximum(Xc[:, 2], 1e-3))
        return j_project_points(J_DOTS, Xc) - jnp.asarray(m_p)

    z6 = jnp.zeros(6, jnp.float32)
    r_ref, J_ref = np.asarray(res_pts(z6)), np.asarray(jax.jacfwd(res_pts)(z6))
    r, J = tad.point_sample_residuals_and_jacobian(_t(T), _t(xyz), _t(m_p), DOTS)
    np.testing.assert_allclose(np_of(r), r_ref, rtol=1e-5, atol=1e-3)
    scale = np.abs(J_ref).max(axis=(1, 2), keepdims=True) + 1e-6
    np.testing.assert_allclose(np_of(J) / scale, J_ref / scale, atol=1e-4)


def test_align_frame_hybrid_matches_jax(dots, landmarks):
    """One hybrid follower: line and point templates from frame 0, frame 1
    aligned from frame 0's pose; the pose within 1e-3 (rad, m) of the JAX
    package's, the counts within 3."""
    m = landmarks
    A = AP.align_cap
    img0, img1 = dots["imgs"][0][0], dots["imgs"][1][0]
    T0 = dots["scene"].poses[0]
    args = (m["ep3d"][:A], m["lvalid"][:A])
    jtm = jax.jit(jad.anchor_templates_body, static_argnums=(4, 5))(jnp.asarray(img0), jnp.asarray(T0), *map(jnp.asarray, args), J_DOTS, JAP)
    jtp = jax.jit(jad.anchor_point_templates_body, static_argnums=(4, 5))(
        jnp.asarray(img0), jnp.asarray(T0), jnp.asarray(m["xyz"]), jnp.asarray(m["pvalid"]), J_DOTS, JAP
    )
    ref = jax.jit(jad.align_frame_hybrid_body, static_argnums=(5, 6))(
        jnp.asarray(img1), jnp.asarray(T0), jnp.asarray(m["plucker"][:A]), jtm, jtp, J_DOTS, JAP
    )
    ttm = tad.anchor_templates_body(_t(img0), _t(T0), *map(_t, args), DOTS, AP)
    ttp = tad.anchor_point_templates_body(_t(img0), _t(T0), _t(m["xyz"]), _t(m["pvalid"]), DOTS, AP)
    T, n_samp, n_units = tad.align_frame_hybrid_body(_t(img1), _t(T0), _t(m["plucker"][:A]), ttm, ttp, DOTS, AP)
    ang, dc = _pose_gap(np_of(T), np.asarray(ref[0]))
    assert ang <= 1e-3 and dc <= 1e-3, (ang, dc)
    assert abs(float(n_units) - float(ref[2])) <= 3 and float(ref[2]) >= 40
    assert abs(float(n_samp) - float(ref[1])) <= 6
    assert _pose_gap(np_of(T), dots["scene"].poses[1])[1] < 0.01


# ---- the point store and the database's point rows ----------------------------


class _KF:
    def __init__(self, kid, n):
        self.kid = kid
        self.point_ids = np.full(n, -1, np.int32)


def test_map_point_store_matches_jax():
    """A random sequence of allocate / observe / erase / kill / replace on
    both stores: equal arrays, observation dicts, free lists and keyframe
    slots after every step."""
    from tpuslam.slammap.points import MapPointStore as JStore
    from tpuslam_torch.slammap.points import MapPointStore as TStore

    rng = np.random.default_rng(7)
    stores = [JStore(64), TStore(64)]
    kfs = [{k: _KF(k, 32) for k in range(5)} for _ in stores]
    for step in range(400):
        op = rng.integers(0, 5)
        live = [int(p) for p in np.nonzero(stores[0].alive)[0]]
        args = dict(
            xyz=rng.normal(size=3).astype(np.float32), bits=rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32),
            kid=int(rng.integers(0, 5)), slot=int(rng.integers(0, 32)),
            a=int(rng.choice(live)) if live else -1, b=int(rng.choice(live)) if live else -1,
        )
        for st, kd in zip(stores, kfs):
            if op == 0 or not live:
                st.allocate(args["xyz"], args["bits"], args["kid"])
            elif op == 1:
                st.add_observation(args["a"], kd[args["kid"]], args["slot"])
            elif op == 2:
                st.erase_observation(args["a"], kd[args["kid"]])
            elif op == 3:
                st.kill(args["a"], kd)
            else:
                st.replace(args["a"], args["b"], kd)
        a, b = stores
        for name in ("xyz", "alive", "desc_bits", "n_obs", "first_kf"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=f"{name} at step {step}")
        assert a.obs == b.obs and a._free == b._free and a._next == b._next
        for k in range(5):
            np.testing.assert_array_equal(kfs[0][k].point_ids, kfs[1][k].point_ids)
    np.testing.assert_array_equal(a.live_ids(), b.live_ids())


def test_keyframe_database_point_rows_match_jax(dots):
    """Keyframes with line and corner descriptors in both databases (point
    slots 256): the same integer scores for queries with and without
    corners, and after a removal."""
    from tpuslam.backend.loop_closing import KeyFrameDatabase as JDB
    from tpuslam.slammap.map import KeyFrame as JKF
    from tpuslam_torch.backend.loop_closing import KeyFrameDatabase as TDB
    from tpuslam_torch.slammap.map import KeyFrame as TKF
    from tpuslam_torch.slammap.map import features_to_numpy, point_features_to_numpy

    jl = dots["jl"]
    rng = np.random.default_rng(3)
    jdb, tdb = JDB(point_slots=256), TDB(point_slots=256, device="cpu")
    for kid in range(5):
        flip = (rng.integers(0, 16, (256, 8)) * rng.integers(0, 2, (256, 1))).astype(np.uint32)  # low nibbles of half the rows
        jf = jl._replace(desc_bits=jnp.asarray(np.asarray(jl.desc_bits) ^ flip))
        jc = dots["jc"][kid % 2][kid // 3]
        jkf = JKF(kid, kid, 0.0, np.eye(4, dtype=np.float32), jax.tree_util.tree_map(np.asarray, jf), np.full(256, -1, np.int32),
                  point_features=jax.tree_util.tree_map(np.asarray, jc))
        tkf = TKF(kid, kid, 0.0, np.eye(4, dtype=np.float32), features_to_numpy(features_from(jf)), np.full(256, -1, np.int32),
                  point_features=point_features_to_numpy(point_features_from(jc)))
        jdb.add(jkf)
        tdb.add(tkf)
    jc = dots["jc"][1][0]
    for pb, pv in ((jc.desc_bits, jc.valid), (None, None)):
        ref = jdb.query_bits(np.asarray(jl.desc_bits), np.asarray(jl.valid), None if pb is None else np.asarray(pb), None if pv is None else np.asarray(pv))
        got = tdb.query_bits(np.asarray(jl.desc_bits), np.asarray(jl.valid), None if pb is None else np.asarray(pb), None if pv is None else np.asarray(pv))
        assert got == ref and max(ref.values()) > 0
    jdb.remove(2)
    tdb.remove(2)
    assert tdb.query(tkf) == jdb.query(jkf)
