"""tpuslam_torch's monocular initializer against tpuslam's.

The port solves each 8-point hypothesis in float64 (ROADMAP.md section 3):
the JAX package's float32 normal equations put its E ~3e-3 (median, up to
0.75) off the float64 solution on the correspondences below, so ``_essential_from_8``
is held to a float64 numpy 8-point (within 1e-5, up to sign). The RANSAC draws
of the JAX package (``jax.random.categorical``) are injected into the port
(``samples``, ``sampler``): with the JAX package as it is, the best score
agrees within one row; with the JAX 8-point solved in float64 too
(``mono_parity.jax_e8_float64``), the best E agrees within 1e-5 up to sign
and the score and inliers exactly. ``recover_pose`` from one E: rotation
within 1e-3 rad, translation direction within 1e-3 (both packages' float32
SVD of E, whose two singular values are equal, leaves R up to 5e-4 rad off
a float64 one on seed 1's input). ``try_initialize`` on tests/test_mono.py's
synthetic VGA features (seed 4, frames 0 and 6), both packages on the
float64 8-point: the same ok mask and slots, T_10 within 1e-3 after the
gauge, the endpoints within 1e-3 relative (see ``_within_rel``), the hybrid
bootstrap's corners the same (ok, slots) and within 1e-3 relative; the
no-parallax case returns None in both. The JAX 8-point in these
comparisons is the port's float64 solve (``mono_parity``).

Run as a script, it prints how far the JAX package's float32 8-point solve
sits from a float64 one on the inputs of
``test_essential_from_8_matches_float64``: ``python tests/test_torch_initializer.py``.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mono_parity import essential_from_8_f64, jax_e8_float64, jax_samples, synthetic_point_features
from test_mono import CAM as J_CAM
from test_mono import make_translating_scene
from torch_parity import np_of
from tpuslam.frontend import initializer as ji
from tpuslam.geometry.se3 import se3_exp as j_se3_exp
from tpuslam.io.synthetic import synthetic_frame_features
from tpuslam_torch.convert import features_from, init_result_from, mono_init_params_from, point_features_from
from tpuslam_torch.frontend import initializer as ti
from tpuslam_torch.geometry.camera import Intrinsics

T_CAM = Intrinsics(*J_CAM)
SEEDS = [0, 1, 2]


def _correspondences(seed, n, fov=0.7, noise=0.3 / 458):
    """Normalized correspondences of n points seen from two poses."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-fov, fov, n), rng.uniform(-fov, fov, n), np.ones(n)] * rng.uniform(2, 8, (n, 1))
    T = np.asarray(j_se3_exp(jnp.asarray(np.array([-0.4, 0.05, 0.1, 0.02, -0.05, 0.01], np.float32))))
    X1 = X @ T[:3, :3].T + T[:3, 3]
    uv0 = (X[:, :2] / X[:, 2:] + rng.normal(size=(n, 2)) * noise).astype(np.float32)
    uv1 = (X1[:, :2] / X1[:, 2:] + rng.normal(size=(n, 2)) * noise).astype(np.float32)
    return uv0, uv1, T


def _sign_free(a, b):
    return np.minimum(np.abs(a - b).max(axis=(-2, -1)), np.abs(a + b).max(axis=(-2, -1)))


@pytest.mark.parametrize("seed", SEEDS)
def test_essential_from_8_matches_float64(seed):
    uv0, uv1, _ = _correspondences(seed, 64 * 8)
    a, b = uv0.reshape(64, 8, 2), uv1.reshape(64, 8, 2)
    Et = np_of(ti._essential_from_8(torch.from_numpy(a), torch.from_numpy(b)))
    E64 = essential_from_8_f64(a, b)
    assert Et.dtype == np.float32
    assert _sign_free(Et, E64).max() <= 1e-5
    with jax_e8_float64():  # the JAX package's batched form with the float64 solve: the same E
        Ej = np.asarray(jax.vmap(ji._essential_from_8)(jnp.asarray(a), jnp.asarray(b)))
    assert _sign_free(Et, Ej).max() <= 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_ransac_essential_matches_jax(seed):
    n = 240
    uv0, uv1, _ = _correspondences(seed, n)
    uv1[: n // 5] += np.random.default_rng(seed).normal(size=(n // 5, 2)).astype(np.float32) * 0.05  # outliers
    jp = ji.MonoInitParams(inlier_px=2.0 / 458)
    key = jax.random.PRNGKey(seed + 3)
    samples = torch.from_numpy(jax_samples(seed + 3, n, jp.n_hypotheses))
    args = (torch.from_numpy(uv0), torch.from_numpy(uv1), torch.ones(n))
    Et, inl_t, score_t = ti.ransac_essential(*args, mono_init_params_from(jp), samples=samples)
    jargs = (jnp.asarray(uv0), jnp.asarray(uv1), jnp.ones(n, jnp.float32), jp, key)
    _, _, score_j = ji.ransac_essential(*jargs)
    assert abs(float(score_t) - float(score_j)) <= 1.0
    with jax_e8_float64():
        Ej, inl_j, score_j = ji.ransac_essential(*jargs)
    assert _sign_free(np_of(Et), np.asarray(Ej)) <= 1e-5
    assert float(score_t) == float(score_j) >= 0.75 * n
    np.testing.assert_array_equal(np_of(inl_t), np.asarray(inl_j))


def _rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))


@pytest.mark.parametrize("seed", SEEDS)
def test_recover_pose_matches_jax(seed):
    n = 240
    uv0, uv1, T = _correspondences(seed, n)
    E = essential_from_8_f64(uv0, uv1).astype(np.float32)  # least squares over every row
    inl = np.ones(n, np.float32)
    Tj, vj = ji.recover_pose(jnp.asarray(E), jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(inl))
    Tt, vt = ti.recover_pose(*(torch.from_numpy(x) for x in (E, uv0, uv1, inl)))
    Tj, Tt = np.asarray(Tj), np_of(Tt)
    assert float(vt) == float(vj) >= 0.9 * n
    assert _rot_angle(Tt[:3, :3].T @ Tj[:3, :3]) <= 1e-3
    assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) <= 1e-3  # unit translations
    assert _rot_angle(Tt[:3, :3].T @ T[:3, :3]) < 0.02  # and the motion they stand for


def _init_pair(step=0.06, points=False, noise=0.3):
    rng = np.random.default_rng(4)
    scene = make_translating_scene(rng, step=step)
    if points:
        scene = scene._replace(points=np.random.default_rng(40).uniform([-4, -3, 4], [4, 3, 12], (200, 3)).astype(np.float32))
    frames = []
    for f in (0, 6) if step > 0.01 else (0, 1):
        feats, _ = synthetic_frame_features(scene, f, noise_px=noise, rng=rng)
        frames.append((f, feats, synthetic_point_features(scene, f, noise_px=noise, rng=rng) if points else None))
    return frames


def _run_both(frames, params):
    with jax_e8_float64():
        j = ji.MonoInitializer(J_CAM, params)
        jout = [j.try_initialize(feats, 0.05 * f, f, aux=aux) for f, feats, aux in frames]
    t = ti.MonoInitializer(T_CAM, mono_init_params_from(params), sampler=jax_samples)
    tout = [
        t.try_initialize(features_from(feats), 0.05 * f, f, aux=None if aux is None else point_features_from(aux))
        for f, feats, aux in frames
    ]
    return j, jout, t, tout


def _within_rel(got, want, rel):
    """Each 3D point within rel of its distance from the reference camera
    (a unit floor): a line almost along the optical axis (its ends at depths
    0.11 and 3.5 m in the hybrid pair) is that ill-conditioned."""
    assert got.shape == want.shape
    err = np.linalg.norm(got - want, axis=-1) / np.maximum(np.linalg.norm(want, axis=-1), 1.0)
    assert np.all(err <= rel), err.max()


@pytest.fixture(scope="module")
def init_runs():
    params = ji.MonoInitParams(min_parallax_px=8.0)
    return {points: _run_both(_init_pair(points=points), params) for points in (False, True)}


@pytest.mark.parametrize("points", [False, True], ids=["lines", "hybrid"])
def test_try_initialize_matches_jax(init_runs, points):
    j, jout, t, tout = init_runs[points]
    assert jout[0] is None and tout[0] is None  # the first frame becomes the reference
    jr, tr = init_result_from(jout[1]), tout[1]
    assert jr is not None and tr is not None
    assert jr[2] == tr[2] == 0 and jr[1] == tr[1]
    for k in (6, 7, 8):  # ok, slots0, slots1
        np.testing.assert_array_equal(tr[k], jr[k])
    assert tr[6].sum() >= 10
    np.testing.assert_allclose(tr[3], jr[3], atol=1e-3)  # T_10 after the gauge
    ok = tr[6]
    _within_rel(tr[5][ok], jr[5][ok], 1e-3)  # endpoints
    # the reference frame is handed back
    np.testing.assert_array_equal(np_of(tr[0].endpoints), np.asarray(jr[0].endpoints))
    jp, tp = j.init_points, t.init_points
    for k in (1, 2, 3):  # ok, slots0, slots1 of the corners
        np.testing.assert_array_equal(tp[k], jp[k])
    if points:
        assert tp[1].sum() >= 20
    _within_rel(tp[0][tp[1]], jp[0][jp[1]], 1e-3)


def test_no_parallax_no_init():
    frames = _init_pair(step=0.0005, noise=0.2)
    _, jout, _, tout = _run_both(frames, ji.MonoInitParams())
    assert jout == [None, None] and tout == [None, None]


def test_seeded_draws_repeat():
    """Without injected samples the port draws from a generator seeded with
    the frame index: two initializers agree bit for bit."""
    frames = _init_pair()
    outs = []
    for _ in range(2):
        t = ti.MonoInitializer(T_CAM, ti.MonoInitParams(min_parallax_px=8.0))
        outs.append([t.try_initialize(features_from(feats), 0.05 * f, f) for f, feats, _ in frames][1])
    assert outs[0] is not None
    for a, b in zip(outs[0][3:], outs[1][3:]):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    # how far the JAX package's float32 8-point solve sits from float64 on the
    # inputs of test_essential_from_8_matches_float64 (ROADMAP.md section 3)
    jax.config.update("jax_platforms", "cpu")
    for seed in SEEDS:
        uv0, uv1, _ = _correspondences(seed, 64 * 8)
        a, b = uv0.reshape(64, 8, 2), uv1.reshape(64, 8, 2)
        err = _sign_free(np.asarray(jax.vmap(ji._essential_from_8)(jnp.asarray(a), jnp.asarray(b))), essential_from_8_f64(a, b))
        print(f"seed {seed}: the JAX float32 E off float64 by {np.median(err):.3g} median, {err.max():.3g} max over 64 hypotheses")
