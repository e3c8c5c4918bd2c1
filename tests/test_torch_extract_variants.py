"""The front end's other branches in tpuslam_torch against tpuslam's: the
in-program resize (``base_scale`` without ``prescaled``) and radtan
undistortion of the feature geometry.

- The resize: the blur of sigma 0.5 (1/s - 1) and the antialiased linear
  resize within 1e-6 of the JAX package's (``jax.image.resize``, jitted as
  inside its extract), the detected segments as sets, and the semi-direct
  chunks over 12 QVGA frames resized on the device (the JAX bench's
  TPUSLAM_BENCH_HOSTSCALE=0): the same keyframes and poses within 2e-3 up
  to the first keyframe decision that differs, the ATE bound.
- Radtan (TUM fr1's coefficients on the bench camera at QVGA):
  ``undistort_pixels`` / ``distort_pixels`` within 1e-4 px of the JAX
  package's and a round trip within 0.05 px; ``extract_features`` with
  ``dist`` against the JAX package's, the valid segments as sets, their
  endpoints within 2 px of the true lines (median); the padding slots stay
  finite where the JAX package's turn NaN; ``ValueError`` without ``cam``;
  the synchronous descriptor-stereo tracker over 8 distorted frames against
  the JAX package's with its padding fault masked.

Run as a script, it prints the JAX package's numbers for chip_smoke.py's
radtan phase (the JAX_RADTAN_* constants there): the synchronous
descriptor-stereo tracker over the bench scene seen through TUM fr1's
distortion at VGA, on the CPU with cv2 hidden and the JAX package's
undistortion patched to leave padding slots alone (``jax_undistort_valid_only``;
~3 min):

    python tests/test_torch_extract_variants.py
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import QVGA, image01, np_of, stereo_scene
from torch_pipelined_parity import ate, keyframe_split, pose_gap, run_jax_tracker, run_port_tracker
from tpuslam_torch.frontend.frame import FrontendParams, extract_features, resize_to_base_scale
from tpuslam_torch.geometry.camera import Distortion, distort_pixels, undistort_pixels



def jax_undistort_valid_only():
    """Patch the JAX package's ``_undistort_feature_geometry`` (until the
    returned restore is called) to undistort the valid segments only, as the
    port does: its padding slots' endpoints at pixel (0, 0) lie beyond the
    model's largest distorted radius for TUM fr1's coefficients at fx 458,
    undistort to NaN there, and the NaN then poisons descriptor stereo (no
    depth on any line, so the tracker never initializes). The JAX extract
    looks the function up when it is traced: patch before the first call."""
    import jax.numpy as jnp

    from tpuslam.frontend import frame as jframe

    inner = jframe._undistort_feature_geometry

    def valid_only(feats, cam, dist):
        out = inner(feats, cam, dist)
        ok = feats.valid > 0.5
        return out._replace(
            endpoints=jnp.where(ok[:, None, None], out.endpoints, feats.endpoints),
            midpoint=jnp.where(ok[:, None], out.midpoint, feats.midpoint),
            angle=jnp.where(ok, out.angle, feats.angle),
            length=jnp.where(ok, out.length, feats.length),
        )

    jframe._undistort_feature_geometry = valid_only

    def restore():
        jframe._undistort_feature_geometry = inner

    return restore



RADTAN = Distortion(**chip_smoke.RADTAN)


def _matched(a, b, tol=0.5):
    """The share of segments (K, 2, 2) in ``a`` with a segment in ``b`` whose
    endpoints (either order) lie within ``tol`` px. The detector's support
    threshold is discontinuous and its moment sums run in another order, so
    the packages' segment sets are held as tests/test_torch_kernels.py's
    test_detect_lines_segment_sets_match_jax holds them: 95% of each side
    within 0.5 px, the counts within 5%."""
    d0 = np.abs(a[:, None] - b[None]).max(axis=(-1, -2))
    d1 = np.abs(a[:, None] - b[None, :, ::-1]).max(axis=(-1, -2))
    return float((np.minimum(d0, d1).min(axis=1) < tol).mean())


def _same_segment_sets(ep, ep_ref):
    assert len(ep_ref) >= 40 and abs(len(ep) - len(ep_ref)) <= 0.05 * len(ep_ref)
    assert _matched(ep, ep_ref) >= 0.95 and _matched(ep_ref, ep) >= 0.95, (_matched(ep, ep_ref), _matched(ep_ref, ep))


def _valid_endpoints(f):
    return np.asarray(np_of(f.endpoints))[np.asarray(np_of(f.valid)) > 0.5]


# ---- the in-program resize --------------------------------------------------


@pytest.mark.parametrize("shape", [(240, 320), (480, 640), (121, 163)])
def test_resize_matches_jax(shape):
    """The blur (radius 2 at base_scale 0.5) and the antialiased linear
    resize to (max(16, round(H s)), max(16, round(W s))): within 1e-6 of the
    JAX package's jitted ``jax.image.resize(gaussian_blur(img, ...))``."""
    import jax
    import jax.numpy as jnp

    from tpuslam.kernels.image import gaussian_blur as jblur

    rng = np.random.default_rng(shape[1])
    img = rng.random(shape, dtype=np.float32)
    fe = FrontendParams(base_scale=0.5)
    bh, bw = max(16, round(shape[0] * 0.5)), max(16, round(shape[1] * 0.5))
    ref = jax.jit(lambda x: jax.image.resize(jblur(x, 0.5), (bh, bw), method="linear"))(jnp.asarray(img))
    got = resize_to_base_scale(torch.from_numpy(img), fe)
    assert got.shape == (bh, bw)
    np.testing.assert_allclose(np_of(got), np.asarray(ref), atol=1e-6, rtol=0)


def test_extract_with_resize_matches_jax():
    """extract_features at base_scale 0.5 resized in the extract: the valid
    segments (full-resolution pixels) as sets against the JAX package's."""
    import jax.numpy as jnp

    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.frame import extract_features as jextract

    _, frames = stereo_scene(1)
    img = image01(frames[0][0])
    ref = jextract(jnp.asarray(img), JFrontendParams(base_scale=0.5))
    got = extract_features(torch.from_numpy(img), FrontendParams(base_scale=0.5))
    _same_segment_sets(_valid_endpoints(got), _valid_endpoints(ref))


@pytest.fixture(scope="module")
def hostscale_run():
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.kernels.align_direct import DirectAlignParams
    from tpuslam.kernels.stereo_direct import DirectStereoParams

    cfg = TrackerConfig(
        pipelined=True, chunk=6, direct_stereo=DirectStereoParams(max_disp=64.0), semidirect=DirectAlignParams(),
        frontend=JFrontendParams(base_scale=0.5),
    )
    scene, frames = stereo_scene(12)
    return scene, run_jax_tracker(QVGA, frames, cfg), run_port_tracker(QVGA, frames, cfg)


def test_semidirect_resized_on_device_matches_jax(hostscale_run):
    """Semi-direct chunks of 6 at base_scale 0.5 without host prescale (the
    resize inside each anchor's extract): one result per frame, every frame
    OK, anchors 1 and 7, the same keyframes and poses within 2e-3 up to the
    first keyframe decision that differs, the same dispatch order, the ATE
    within the JAX package's + 0.01 m."""
    scene, (jres, jlog), (tres, tlog, tr) = hostscale_run
    assert [r.frame_idx for r in tres] == [r.frame_idx for r in jres] == list(range(12))
    assert all(r.state.name == "OK" for r in tres) and tr.anchor_frames == [1, 7]
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    split = keyframe_split(jres, tres)
    assert split > 6, split
    for a, b in zip(jres[:split], tres[:split]):
        ang, dc = pose_gap(b.T_cw, a.T_cw)
        assert ang <= 2e-3 and dc <= 2e-3, (a.frame_idx, ang, dc)
    assert ate(tres, scene) <= ate(jres, scene) + 0.01


# ---- radtan -------------------------------------------------------------------


def _radtan_pixels(n=400, seed=0):
    """Pixels of the QVGA bench camera where the radtan model converges
    (the TUM fr1 coefficients on this camera: within ~0.6 of the
    principal point in normalized coordinates)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.55, 0.55, n) * QVGA.fx + QVGA.cx
    y = rng.uniform(-0.45, 0.45, n) * QVGA.fy + QVGA.cy
    return np.stack([x, y], -1).astype(np.float32)


def test_radtan_model_matches_jax():
    """undistort_pixels and distort_pixels within 1e-4 px of the JAX
    package's on the same pixels; undistorting the distorted pixels gives
    them back within 0.05 px."""
    import jax.numpy as jnp

    from tpuslam.geometry.camera import Distortion as JDistortion
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.geometry.camera import distort_pixels as jdistort
    from tpuslam.geometry.camera import undistort_pixels as jundistort

    uv = _radtan_pixels()
    jcam, jd = JIntrinsics(*QVGA), JDistortion(*RADTAN)
    d = distort_pixels(QVGA, RADTAN, torch.from_numpy(uv))
    np.testing.assert_allclose(np_of(d), np.asarray(jdistort(jcam, jd, jnp.asarray(uv))), atol=1e-4, rtol=0)
    u = undistort_pixels(QVGA, RADTAN, d)
    np.testing.assert_allclose(np_of(u), np.asarray(jundistort(jcam, jd, jnp.asarray(np_of(d)))), atol=1e-4, rtol=0)
    assert np.percentile(np.linalg.norm(np_of(u) - uv, axis=-1), 95) < 0.05
    np.testing.assert_allclose(np_of(undistort_pixels(QVGA, Distortion(), torch.from_numpy(uv))), uv, atol=1e-4)


@pytest.fixture(scope="module")
def radtan_frames():
    """The bench scene at QVGA over 8 frames, both cameras seen through TUM
    fr1's distortion (chip_smoke.py's remap)."""
    scene, frames = stereo_scene(8)
    return scene, [tuple(chip_smoke.distort_image(x, QVGA, chip_smoke.RADTAN) for x in pair) for pair in frames]


def test_extract_radtan_matches_jax(radtan_frames):
    """extract_features with ``dist`` on a distorted frame: the valid
    segments (undistorted pixels) as sets against the JAX package's; the median endpoint-to-true-line distance within 2 px; the
    padding slots finite (the JAX package's undistort to NaN, ROADMAP.md
    section 3)."""
    import jax.numpy as jnp

    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.frame import extract_features as jextract
    from tpuslam.geometry.camera import Distortion as JDistortion
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam_torch.io.synthetic import observe_frame

    scene, frames = radtan_frames
    img = image01(frames[0][0])
    ref = jextract(jnp.asarray(img), JFrontendParams(dist=JDistortion(*RADTAN), cam=JIntrinsics(*QVGA)))
    got = extract_features(torch.from_numpy(img), FrontendParams(dist=RADTAN, cam=QVGA))
    _same_segment_sets(_valid_endpoints(got), _valid_endpoints(ref))
    obs = observe_frame(scene, 0)
    assert np.median(chip_smoke.line_errors(np_of(got.endpoints), np_of(got.valid), obs.seg_uv[obs.seg_visible])) < 2.0
    pad = np_of(got.valid) < 0.5
    assert pad.any() and np.isfinite(np_of(got.endpoints)[pad]).all()
    assert np.isnan(np.asarray(ref.endpoints)[pad]).any()  # the reference's padding fault


def test_extract_radtan_needs_cam():
    with pytest.raises(ValueError, match="cam"):
        extract_features(torch.zeros(64, 64), FrontendParams(dist=RADTAN))


def test_radtan_tracker_matches_jax(radtan_frames):
    """The synchronous descriptor-stereo tracker over the distorted frames:
    every frame OK in both packages (the JAX package's undistortion patched to
    leave the padding slots alone, ``jax_undistort_valid_only``: without it
    no line gets a stereo depth and it never initializes), the same inlier
    counts and keyframes up to the first keyframe decision that differs,
    poses within 5e-3 there (the synchronous stereo pose LM keeps one Huber
    weight per observation, the JAX package one per residual family,
    ROADMAP.md section 3: 3.1e-3 m apart at frame 3 with the same inliers),
    the ATE within the JAX package's + 0.01 m."""
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.geometry.camera import Distortion as JDistortion
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    scene, frames = radtan_frames
    cfg = TrackerConfig(frontend=JFrontendParams(dist=JDistortion(*RADTAN), cam=JIntrinsics(*QVGA)))
    import jax

    jax.clear_caches()  # the extract is traced again with the patch
    restore = jax_undistort_valid_only()
    try:
        jres, _ = run_jax_tracker(QVGA, frames, cfg)
    finally:
        restore()
        jax.clear_caches()
    tres, _, _ = run_port_tracker(QVGA, frames, cfg)
    assert all(r.state.name == "OK" for r in jres) and all(r.state.name == "OK" for r in tres)
    split = keyframe_split(jres, tres)
    assert split > 4, split
    assert [r.n_inliers for r in tres[:split]] == [r.n_inliers for r in jres[:split]]
    for a, b in zip(jres[:split], tres[:split]):
        ang, dc = pose_gap(b.T_cw, a.T_cw)
        assert ang <= 5e-3 and dc <= 5e-3, (a.frame_idx, ang, dc)
    assert ate(tres, scene) <= ate(jres, scene) + 0.01


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from test_torch_pipelined import run_jax_system
    from tpuslam.frontend.frame import FrontendParams, extract_features
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.geometry.camera import Distortion, Intrinsics
    from tpuslam_torch.io.synthetic import observe_frame

    cam, dist, scene, frames = chip_smoke.make_radtan_frames()
    fe = FrontendParams(dist=Distortion(**dist), cam=Intrinsics(*cam))
    jax_undistort_valid_only()
    feats = extract_features(jnp.asarray(frames[0][0].astype(np.float32) / 255.0), fe)
    obs = observe_frame(scene, 0)
    errs = chip_smoke.line_errors(feats.endpoints, feats.valid, obs.seg_uv[obs.seg_visible])
    print(f"JAX radtan extract, frame 0 left: {len(errs)} segments, median endpoint-to-true-line {np.median(errs)!r} px", flush=True)
    js, traj = run_jax_system(cam, frames, TrackerConfig(frontend=fe), mapping=False)
    print(f"JAX radtan tracker: keyframes {[r.frame_idx for r in traj if r.made_keyframe]}, states {[r.state.name[0] for r in traj]}", flush=True)
    print(f"JAX_RADTAN_ATE_M = {chip_smoke.ate_of(traj, scene)!r}", flush=True)
