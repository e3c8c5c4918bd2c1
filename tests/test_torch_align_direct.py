"""Semi-direct alignment: tpuslam_torch.kernels.align_direct against
tpuslam.kernels.align_direct on the bench scene's line map and its
host-prescaled VGA frames (coord_scale 0.5, as on the bench path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import image01, np_of, stereo_scene
from tpuslam.geometry.camera import Intrinsics as JIntrinsics
from tpuslam.geometry.camera import line_projection_matrix as j_line_projection_matrix
from tpuslam.geometry.plucker import plucker_from_points as j_plucker_from_points
from tpuslam.geometry.plucker import plucker_transform as j_plucker_transform
from tpuslam.geometry.se3 import se3_log as j_se3_log
from tpuslam.geometry.se3 import se3_retract as j_se3_retract
from tpuslam.kernels import align_direct as jad
from tpuslam_torch import Intrinsics
from tpuslam_torch.convert import params_from
from tpuslam_torch.frontend.frame import FrontendParams, host_prescale
from tpuslam_torch.kernels import align_direct as tad

VGA = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
J_VGA = JIntrinsics(*VGA)
P = tad.inject_coord_scale_align(tad.DirectAlignParams(), 0.5, True)
JP = jad.DirectAlignParams(**P._asdict())


@pytest.fixture(scope="module")
def bench():
    """The bench scene's segments as an A = 256 line map (140 lines, the
    rest padding), its poses, and its left frames halved on the host."""
    scene, frames = stereo_scene(4, VGA)
    A = P.align_cap
    segs = scene.segments[:A].astype(np.float32)
    ep3d = np.zeros((A, 2, 3), np.float32)
    ep3d[: len(segs)] = segs
    validf = np.zeros((A,), np.float32)
    validf[: len(segs)] = 1.0
    ep3d[len(segs):] = ep3d[0]  # padding rows: any finite line
    plucker = np.asarray(jax.vmap(lambda e: j_plucker_from_points(e[0], e[1]))(jnp.asarray(ep3d)))
    half = FrontendParams(base_scale=0.5, prescaled=True)
    imgs = [image01(host_prescale(il, half)) for il, _ in frames]
    poses = scene.poses.astype(np.float32)
    tm = jad.anchor_templates(jnp.asarray(imgs[0]), jnp.asarray(poses[0]), jnp.asarray(ep3d), jnp.asarray(validf), J_VGA, JP)
    return dict(ep3d=ep3d, validf=validf, plucker=plucker, imgs=imgs, poses=poses, tm=tm)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _port_templates(b):
    return tad.anchor_templates_body(_t(b["imgs"][0]), _t(b["poses"][0]), _t(b["ep3d"]), _t(b["validf"]), VGA, P)


def test_anchor_templates_match_jax(bench):
    """Templates within 1e-4 on the 0..255 scale, the same validity and
    search axes, sample points to float32 rounding."""
    ref, tm = bench["tm"], _port_templates(bench)
    assert float(np.asarray(ref.tvalid).sum()) > 150  # enough templates on the bench frame
    np.testing.assert_array_equal(np_of(tm.tvalid), np.asarray(ref.tvalid))
    np.testing.assert_array_equal(np_of(tm.vert), np.asarray(ref.vert))
    np.testing.assert_allclose(np_of(tm.p3d), np.asarray(ref.p3d), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_of(tm.tmpl), np.asarray(ref.tmpl), rtol=0, atol=1e-4)


def test_slide_zsad_matches_jax(bench):
    """On frame 1's windows under frame 0's pose: the same best placements,
    subpixel shifts within 1e-4 px, the same uniqueness decisions."""
    ref_tm = bench["tm"]
    Wt, R = P.template, P.search
    M = 2 * R + 1

    def windows(img, T, tm):
        Xc = jad.se3_apply(T, tm.p3d)
        uv = jad.project_points(J_VGA, Xc) * JP.coord_scale
        return jad._axis_window(img * 255.0, uv[..., 0], uv[..., 1], tm.vert[:, None], M - 1 + Wt, -(R + Wt // 2)) + (uv,)

    win, inb, uv = jax.jit(windows)(jnp.asarray(bench["imgs"][1]), jnp.asarray(bench["poses"][0]), ref_tm)
    d_ref, c_ref, u_ref = jax.jit(jad._slide_zsad, static_argnums=(3, 4, 5))(win, inb, ref_tm.tmpl, Wt, M, JP.ratio)
    d, c, u = tad._slide_zsad(_t(win), _t(inb), _t(ref_tm.tmpl), Wt, M, P.ratio)
    live = np.asarray(ref_tm.tvalid) > 0.5
    np.testing.assert_allclose(np_of(d)[live], np.asarray(d_ref)[live], rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_of(c)[live], np.asarray(c_ref)[live], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np_of(u)[live], np.asarray(u_ref)[live])
    # the window gather itself, at the same projections
    uv = np.asarray(uv)
    tw, ti = tad._axis_window(
        _t(bench["imgs"][1]) * 255.0, _t(uv[..., 0]), _t(uv[..., 1]), _t(ref_tm.vert)[:, None], M - 1 + Wt, -(R + Wt // 2)
    )
    np.testing.assert_array_equal(np_of(ti), np.asarray(inb))
    np.testing.assert_allclose(np_of(tw), np.asarray(win), rtol=0, atol=1e-4)


def _j_res_all(xi, T, plucker, mh):
    """The JAX package's Gauss-Newton residual (align_direct._gn_pose's
    res_all), for jax.jacfwd."""
    Tx = j_se3_retract(T, xi)
    L_c = jax.vmap(lambda Lw: j_plucker_transform(Tx, Lw))(plucker)
    l = (j_line_projection_matrix(J_VGA) @ L_c[:, :3, None])[..., 0]
    norm = jnp.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2 + 1e-9)
    return jnp.einsum("asc,ac->as", mh, l) / norm[:, None]


def test_gn_jacobian_matches_jacfwd(bench):
    """The analytic point-to-line Jacobian against jax.jacfwd of the JAX
    residual, at the JAX side's measured points on frame 1 and a pose a
    frame off: within 1e-4 relative."""
    T = jnp.asarray(bench["poses"][0])
    m, ok = jax.jit(jad._search_templates, static_argnums=(3, 4))(
        jnp.asarray(bench["imgs"][1]) * 255.0, T, bench["tm"], J_VGA, JP
    )
    mh = jnp.concatenate([m, jnp.ones_like(m[..., :1])], axis=-1)
    plucker = jnp.asarray(bench["plucker"])
    z6 = jnp.zeros((6,), jnp.float32)
    r_ref = np.asarray(_j_res_all(z6, T, plucker, mh))
    J_ref = np.asarray(jax.jacfwd(_j_res_all)(z6, T, plucker, mh))
    r, J = tad.line_sample_residuals_and_jacobian(_t(T), _t(plucker), _t(mh), VGA)
    live = np.asarray(ok) > 0.5
    assert live.sum() > 300
    np.testing.assert_allclose(np_of(r)[live], r_ref[live], rtol=1e-4, atol=1e-4)
    J, J_ref = np_of(J)[live], J_ref[live]
    scale = np.abs(J_ref).max(axis=0)  # per tangent direction
    assert np.all(np.abs(J - J_ref) <= 1e-4 * (np.abs(J_ref) + scale))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_align_frame_matches_jax(bench, k):
    """Frame k aligned from frame k-1's pose (a motion-model-grade error)
    with frame 0's templates: the pose within 1e-4 rad and 1e-4 m of the JAX
    package's, aligned lines within one, and the error well under the
    seed's."""
    T_pred = bench["poses"][k - 1]
    T_ref, n_samp_ref, n_lines_ref = jad.align_frame(
        jnp.asarray(bench["imgs"][k]), jnp.asarray(T_pred), jnp.asarray(bench["plucker"]), bench["tm"], J_VGA, JP
    )
    T, n_samp, n_lines = tad.align_frame_body(
        _t(bench["imgs"][k]), _t(T_pred), _t(bench["plucker"]), _port_templates(bench), VGA, P
    )
    T, T_ref = np_of(T), np.asarray(T_ref)
    d = np.asarray(j_se3_log(jnp.asarray(T @ np.linalg.inv(T_ref))))
    assert np.abs(d[3:]).max() <= 1e-4 and np.abs(d[:3]).max() <= 1e-4, d
    assert abs(float(n_lines) - float(n_lines_ref)) <= 1
    assert float(n_lines) >= 20
    err = np.linalg.norm(np.asarray(j_se3_log(jnp.asarray(T @ np.linalg.inv(bench["poses"][k])))))
    err_pred = np.linalg.norm(np.asarray(j_se3_log(jnp.asarray(T_pred @ np.linalg.inv(bench["poses"][k])))))
    assert err < 0.35 * err_pred + 1e-3, (err, err_pred)


def test_params_convert():
    """Every field of the JAX params, point_cap included, carries over."""
    j = jad.DirectAlignParams(align_cap=128, coord_scale=0.5, point_cap=64)
    assert params_from(tad.DirectAlignParams, j)._asdict() == j._asdict()
    for base_scale, prescaled in ((0.5, True), (0.5, False), (1.0, True)):
        ref = jad.inject_coord_scale_align(jad.DirectAlignParams(), base_scale, prescaled)
        assert tad.inject_coord_scale_align(tad.DirectAlignParams(), base_scale, prescaled)._asdict() == ref._asdict()


# ---- the bench's first chunk under TPUSLAM_BENCH_CAM=qvga ------------------------


@pytest.fixture(scope="module")
def qvga_chunk():
    """The port's bench System (``bench_configs()``) over the first 8 of the
    bench's 12 QVGA frames (``python tests/test_torch_bench.py gaps qvga``'s)
    on the CPU (detection at 160x120): the anchor-template call and every
    follower's inputs of its first semi-direct chunk (frames 1-6), recorded
    as the chunk program made them."""
    from tpuslam_torch import bench as tbench
    from tpuslam_torch import system as tsystem
    from tpuslam_torch.frontend import pipeline as tp

    rec = {"anchor": [], "followers": []}
    real_tm, real_step = tp.anchor_templates_body, tp._follower_step

    def anchor(img, T, ep3d, validf, cam, ap):
        rec["anchor"].append((img.clone(), T.clone(), ep3d.clone(), validf.clone(), ap))
        return real_tm(img, T, ep3d, validf, cam, ap)

    def follower(img, T_l, T_p, plucker_a, tm, cam, ap, min_inliers, tm_p=None):
        out = real_step(img, T_l, T_p, plucker_a, tm, cam, ap, min_inliers, tm_p)
        rec["followers"].append((img.clone(), T_l.clone(), T_p.clone(), plucker_a.clone(), tm))
        return out

    _, imgs = tbench.bench_scene(12, tbench.QVGA)
    tcfg, mcfg = tsystem.bench_configs()
    mp = pytest.MonkeyPatch()
    mp.setattr(tp, "anchor_templates_body", anchor)
    mp.setattr(tp, "_follower_step", follower)
    try:
        ts = tsystem.System(tbench.QVGA, sensor="stereo", loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cpu")
        for f, (il, ir) in enumerate(imgs[:8]):
            ts.track_stereo(il, ir, f * 0.05)
        ts.shutdown()
    finally:
        mp.undo()
    assert tcfg.chunk == 6 and len(rec["followers"]) >= 5
    return rec["anchor"][0], rec["followers"][:5]


def test_qvga_chunk_templates_match_jax(qvga_chunk):
    """The first QVGA chunk's anchor templates (160x120 image, the anchor's
    pose and map as the port's chunk had them) against the JAX package's on
    the same inputs: the same validity and search axes, intensities within
    1e-4 on the 0..255 scale."""
    (img, T, ep3d, validf, ap), _ = qvga_chunk
    from tpuslam_torch import bench as tbench

    jap = jad.DirectAlignParams(**ap._asdict())
    ref = jad.anchor_templates(*(jnp.asarray(np_of(x)) for x in (img, T, ep3d, validf)), JIntrinsics(*tbench.QVGA), jap)
    tm = tad.anchor_templates_body(img, T, ep3d, validf, tbench.QVGA, ap)
    assert float(np.asarray(ref.tvalid).sum()) > 150
    np.testing.assert_array_equal(np_of(tm.tvalid), np.asarray(ref.tvalid))
    np.testing.assert_array_equal(np_of(tm.vert), np.asarray(ref.vert))
    np.testing.assert_allclose(np_of(tm.tmpl), np.asarray(ref.tmpl), rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_qvga_chunk_follower_matches_jax(qvga_chunk, k):
    """Follower k of the bench's first QVGA chunk (frame k + 1) through both
    packages on identical inputs: its 160x120 image, the motion-model
    prediction from the port chunk's chain, the map lines and the anchor
    templates: the pose within 1e-5 rad and 1e-4 m of the JAX package's,
    the same good-sample and aligned-line counts. (Run as whole Systems, the
    two packages' frames 4-6 part by up to 3.2e-3 m: keyframe 0's map and
    the anchor's pose differ through the detector's float32 sums, and a
    template's uniqueness ratio near the gate's 0.9 crosses it; ROADMAP.md
    section 3.)"""
    from test_torch_semidirect import _pose_gap
    from tpuslam_torch import bench as tbench
    from tpuslam_torch.geometry.se3 import se3_inverse

    (_, _, _, _, ap), followers = qvga_chunk
    img, T_l, T_p, plucker_a, tm = followers[k - 1]
    T_pred = T_l @ se3_inverse(T_p) @ T_l
    jap = jad.DirectAlignParams(**ap._asdict())
    jtm = jad.AlignTemplates(*(jnp.asarray(np_of(x)) for x in tm))
    T_ref, n_samp_ref, n_lines_ref = jad.align_frame(
        *(jnp.asarray(np_of(x)) for x in (img, T_pred, plucker_a)), jtm, JIntrinsics(*tbench.QVGA), jap
    )
    T, n_samp, n_lines = tad.align_frame_body(img, T_pred, plucker_a, tm, tbench.QVGA, ap)
    ang, dist = _pose_gap(np_of(T), np.asarray(T_ref))
    assert ang <= 1e-5 and dist <= 1e-4, (ang, dist)
    assert (float(n_samp), float(n_lines)) == (float(n_samp_ref), float(n_lines_ref))
    assert float(n_lines) >= 30
