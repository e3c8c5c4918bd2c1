"""tpuslam_torch's matching, stereo association and tracking stage against
tpuslam's, on inputs carried across with tpuslam_torch.convert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_of
from tpuslam.frontend import frame as jframe
from tpuslam.frontend import matcher as jmatcher
from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
from tpuslam.geometry.camera import Intrinsics as JIntrinsics
from tpuslam.io.synthetic import make_wireframe_scene, synthetic_frame_features
from tpuslam.kernels import match as jmatch
from tpuslam.system import System as JSystem
from tpuslam_torch.convert import features_from, map_state, params_from, slam_map_from
from tpuslam_torch.frontend import frame as tframe
from tpuslam_torch.frontend import matcher as tmatcher
from tpuslam_torch.frontend.tracking import Tracker, TrackerConfig
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.kernels import match as tmatch

J_CAM = JIntrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
T_CAM = Intrinsics(*J_CAM)


def _words(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def _flip_bits(rng, w, n_bits):
    """Copy of w with n_bits random bits flipped in each row."""
    out = w.copy()
    for row in out:
        for b in rng.choice(256, n_bits, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _tied_words(rng):
    """A (64 rows) and B (48 rows) built from one pool of 40 descriptors with
    a few flipped bits, and exact duplicates in both: integer distances that
    tie often, with and without a clear best match."""
    pool = _words(rng, 40)
    a = _flip_bits(rng, pool[rng.integers(0, 40, 64)], 6)
    b = _flip_bits(rng, pool[rng.integers(0, 40, 48)], 6)
    a[40:50] = a[30:40]  # duplicate rows: ties in the column argmin
    b[40:48] = b[20:28]  # duplicate columns: ties in the row argmin
    return a, b


def test_hamming_distance_matches_jax(rng):
    a, b = _words(rng, 40), _words(rng, 30)
    d = np_of(tmatch.hamming_distance_matrix(*(torch.from_numpy(x.astype(np.int64)) for x in (a, b))))
    np.testing.assert_array_equal(d, np.asarray(jmatch.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(d, np.asarray(jmatch.hamming_distance_mxu(jnp.asarray(a), jnp.asarray(b), 256)))


@pytest.mark.parametrize(
    "gated,mutual,ratio", [(False, True, 0.95), (True, True, 0.95), (True, False, 1.0), (False, False, 1.0)]
)
def test_match_descriptors_matches_jax_with_ties(rng, gated, mutual, ratio):
    """Integer distances tie often: the chosen indices must follow
    jax.lax.top_k / argmin's lowest-index rule (ratio 1.0 lets tied best
    matches through, so the tie order decides the index)."""
    a, b = _tied_words(rng)
    va = (rng.random(64) < 0.9).astype(np.float32)
    vb = (rng.random(48) < 0.9).astype(np.float32)
    pen = np.where(rng.random((64, 48)) < 0.5, 0.0, 1e6).astype(np.float32) if gated else None
    params = jmatch.MatchParams(max_dist=120.0, ratio=ratio, mutual=mutual)
    ref = jmatch.match_descriptors(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb), params, None if pen is None else jnp.asarray(pen)
    )
    out = tmatch.match_descriptors(
        torch.from_numpy(a.astype(np.int64)), torch.from_numpy(va), torch.from_numpy(b.astype(np.int64)),
        torch.from_numpy(vb), params_from(tmatch.MatchParams, params), None if pen is None else torch.from_numpy(pen),
    )
    np.testing.assert_array_equal(np_of(out.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(np_of(out.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(np_of(out.dist), np.asarray(ref.dist))  # integers + exact penalties
    assert np_of(out.valid).sum() > 3


def test_penalties_match_jax(rng):
    ang_a, ang_b = (rng.uniform(-np.pi, np.pi, n).astype(np.float32) for n in (20, 30))
    len_a, len_b = (rng.uniform(5, 80, n).astype(np.float32) for n in (20, 30))
    mid_a, mid_b = (rng.uniform(0, 300, (n, 2)).astype(np.float32) for n in (20, 30))
    t = lambda x: torch.from_numpy(x)
    j = jnp.asarray
    pairs = [
        (tmatch.angle_penalty(t(ang_a), t(ang_b), 0.15), jmatch.angle_penalty(j(ang_a), j(ang_b), 0.15)),
        (tmatch.length_ratio_penalty(t(len_a), t(len_b), 0.6), jmatch.length_ratio_penalty(j(len_a), j(len_b), 0.6)),
        (tmatch.midpoint_radius_penalty(t(mid_a), t(mid_b), 40.0), jmatch.midpoint_radius_penalty(j(mid_a), j(mid_b), 40.0)),
        (tmatch.stereo_row_penalty(t(mid_a), t(mid_b), 12.0, 0.5, 200.0), jmatch.stereo_row_penalty(j(mid_a), j(mid_b), 12.0, 0.5, 200.0)),
    ]
    for out, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np_of(out) == 0, ref == 0)  # the gates open on the same pairs
        np.testing.assert_allclose(np_of(out), ref, rtol=1e-5)  # float32 penalties


@pytest.fixture(scope="module")
def scene():
    return make_wireframe_scene(np.random.default_rng(0), n_segments=140, n_frames=8, cam=J_CAM, motion_scale=0.02)


def _pair_features(scene, f, rng):
    """Detector-free left/right features of frame f (the JAX package's
    synthetic features: projected segments, identity-stable descriptors)."""
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -J_CAM.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    fl, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng)
    fr, _ = synthetic_frame_features(scene_r, f, noise_px=0.3, rng=rng)
    return fl, fr


def test_stereo_depths_and_triangulation_match_jax(scene):
    fl, fr = _pair_features(scene, 2, np.random.default_rng(1))
    fxb = J_CAM.fx * J_CAM.baseline
    ref = jframe.stereo_line_depths(fl, fr, fxb)
    out = tframe.stereo_line_depths(features_from(fl), features_from(fr), fxb)
    np.testing.assert_array_equal(np_of(out.has_depth), np.asarray(ref.has_depth))
    assert np_of(out.has_depth).sum() > 30
    np.testing.assert_allclose(np_of(out.depth), np.asarray(ref.depth), rtol=1e-5)  # float32 division
    T_wc = np.linalg.inv(scene.poses[2]).astype(np.float32)
    for a, b in zip(
        tmatcher.triangulate_stereo_lines(T_wc, out, T_CAM), jmatcher.triangulate_stereo_lines(T_wc, ref, J_CAM)
    ):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-4, atol=1e-4)  # world coords ~10 m


@pytest.fixture(scope="module")
def jax_map(scene):
    """A JAX System's map after 6 synthetic stereo frames, keyframes every 3."""
    rng = np.random.default_rng(2)
    js = JSystem(J_CAM, sensor="stereo", mapping=False, loop_closing=False)
    js.tracker.cfg = JTrackerConfig(max_frames_between_kf=3)
    for f in range(6):
        feats, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng, with_depth=True)
        js.tracker.frame_idx = f
        js.tracker._track(feats, 0.05 * f, stereo=True)
    assert len(js.map.keyframes) >= 2
    return js


def test_map_conversion_and_tracking_stage_match_jax(scene, jax_map):
    """The map carried across by convert.py gives the same local-map arrays,
    and one tracking stage on the next frame the same matches and inliers
    and the same pose to float32 rounding."""
    jt = jax_map.tracker
    tmap = slam_map_from(map_state(jax_map.map))
    tt = Tracker(T_CAM, tmap, TrackerConfig(), device="cpu")
    tt.ref_kf = jt.ref_kf
    jt._local_dirty = True
    j_local = jt._local_map_arrays()
    t_local = tt._local_map_arrays()
    np.testing.assert_array_equal(tt._local_ids, jt._local_ids)
    for k in ("plucker", "ep3d", "valid"):
        np.testing.assert_array_equal(np_of(t_local[k]), np.asarray(j_local[k]))
    np.testing.assert_array_equal(np_of(t_local["bits"]).astype(np.uint32), np.asarray(j_local["bits"]))
    assert np_of(t_local["valid"]).sum() > 50

    feats, _ = synthetic_frame_features(scene, 6, noise_px=0.3, rng=np.random.default_rng(3), with_depth=True)
    T_pred = (jt.velocity @ jt.last_T_cw).astype(np.float32)
    search = JTrackerConfig().search_coarse
    ref = jmatcher.tracked_pose_step(
        jnp.asarray(T_pred), j_local["plucker"], j_local["ep3d"], j_local["bits"], j_local["valid"], feats, J_CAM, search
    )
    out = tmatcher.tracked_pose_step(
        torch.from_numpy(T_pred), t_local["plucker"], t_local["ep3d"], t_local["bits"], t_local["valid"],
        features_from(feats), T_CAM, params_from(tmatcher.ProjectionSearchParams, search),
    )
    np.testing.assert_array_equal(np_of(out.match_idx), np.asarray(ref.match_idx))
    np.testing.assert_array_equal(np_of(out.inlier), np.asarray(ref.inlier))
    assert int(out.num_matched) == int(ref.num_matched) > 40
    assert int(out.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(np_of(out.pose), np.asarray(ref.pose), atol=5e-5)  # float32 LM, 16 iterations


def test_params_from_carries_nested_namedtuples():
    ref = jframe.FrontendParams(max_lines=96, lsd=jframe.LSDParams(ccl_rounds=20), lbd=jframe.LBDParams(patch=48))
    out = params_from(tframe.FrontendParams, ref)
    assert isinstance(out.lsd, tframe.LSDParams) and isinstance(out.lbd, tframe.LBDParams)
    assert out.max_lines == 96 and out.lsd.ccl_rounds == 20 and out.lbd.patch == 48
    assert out.lsd._asdict() == ref.lsd._asdict()
    with pytest.raises(ValueError, match="no fields"):
        params_from(tmatch.MatchParams, {"max_dist": 1.0, "bogus": 2})
