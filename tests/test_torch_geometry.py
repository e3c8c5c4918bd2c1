"""tpuslam_torch's geometry, line residual and pose LM against tpuslam's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_of
from tpuslam.backend import pose_opt as jpose
from tpuslam.backend import residuals as jres
from tpuslam.geometry import camera as jcam
from tpuslam.geometry import plucker as jpl
from tpuslam.geometry import se3 as jse3
from tpuslam.io.synthetic import make_wireframe_scene, observe_frame
from tpuslam_torch.backend import pose_opt as tpose
from tpuslam_torch.backend import residuals as tres
from tpuslam_torch.geometry import camera as tcam
from tpuslam_torch.geometry import plucker as tpl
from tpuslam_torch.geometry import se3 as tse3

J_CAM = jcam.Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)
T_CAM = tcam.Intrinsics(*J_CAM)


def _tangents(rng, n, scale=0.5):
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


def _lines(rng, n, dtype=np.float32):
    p = rng.uniform(-3, 3, (n, 3)) + np.array([0, 0, 8.0])
    q = p + rng.normal(size=(n, 3))
    return np.concatenate([np.cross(p, q), q - p], axis=-1).astype(dtype)


@pytest.mark.parametrize("scale", [1e-6, 0.3, 1.5])
def test_se3_inverse_matches_jax(rng, scale):
    """The inverse the chunk program's motion model takes, batched, and the
    motion-model product T_last @ inv(T_prev) @ T_last."""
    T = jse3.se3_exp(jnp.asarray(_tangents(rng, 16, scale)))
    Ti_t = tse3.se3_inverse(torch.from_numpy(np.asarray(T)))
    np.testing.assert_allclose(np_of(Ti_t), np.asarray(jse3.se3_inverse(T)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(Ti_t @ torch.from_numpy(np.asarray(T))), np.broadcast_to(np.eye(4), (16, 4, 4)), atol=1e-5)
    a, b = np.asarray(T[0]), np.asarray(T[1])
    ref = jnp.asarray(a) @ jse3.se3_inverse(jnp.asarray(b)) @ jnp.asarray(a)
    got = torch.from_numpy(a) @ tse3.se3_inverse(torch.from_numpy(b)) @ torch.from_numpy(a)
    np.testing.assert_allclose(np_of(got), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [1e-6, 0.3, 1.5])
def test_se3_matches_jax(rng, scale):
    xi = _tangents(rng, 32, scale)
    T_t = tse3.se3_exp(torch.from_numpy(xi))
    T_j = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(np_of(T_t), np.asarray(T_j), atol=2e-6)  # float32 elementary functions
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(_tangents(rng, 1, 0.3)[0])))
    np.testing.assert_allclose(
        np_of(tse3.se3_retract(torch.from_numpy(np.array(T0)), torch.from_numpy(xi))),
        np.asarray(jse3.se3_retract(jnp.asarray(T0), jnp.asarray(xi))),
        atol=1e-5,
    )
    drift = T_t.clone()
    drift[:, :3, :3] *= 1.001
    np.testing.assert_allclose(
        np_of(tse3.se3_orthonormalize(drift)), np.asarray(jse3.se3_orthonormalize(jnp.asarray(np_of(drift)))), atol=2e-6
    )


def test_plucker_matches_jax(rng):
    L = _lines(rng, 32)
    T = np.array(jse3.se3_exp(jnp.asarray(_tangents(rng, 1)[0])))
    delta = (rng.normal(size=(32, 4)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tpl.plucker_transform(torch.from_numpy(T), torch.from_numpy(L))),
        np.asarray(jpl.plucker_transform(jnp.asarray(T), jnp.asarray(L))),
        rtol=1e-5, atol=1e-4,  # moments up to ~30: float32 products
    )
    np.testing.assert_allclose(
        np_of(tpl.plucker_retract(torch.from_numpy(L), torch.from_numpy(delta))),
        np.asarray(jpl.plucker_retract(jnp.asarray(L), jnp.asarray(delta))),
        atol=1e-5,
    )


def _observations(rng, n=48):
    """Lines in front of a camera near the identity and noisy endpoints.
    Float64 lines, so the Klein constraint holds to float64 rounding (the
    residual's retraction re-projects it, the analytic Jacobian does not)."""
    L = _lines(rng, n, np.float64)
    T = np.array(jse3.se3_exp(jnp.asarray(_tangents(rng, 1, 0.05)[0])))
    ep = rng.uniform(50, 600, (n, 2, 2)).astype(np.float32)
    return T, L, ep


def test_line_jacobian_matches_ad_finite_differences_and_jax(rng):
    """Analytic pose Jacobian at zero tangent against torch.func.jacfwd and
    central differences (float64), and against the JAX package's jacfwd
    (float32); finite everywhere."""
    T, L, ep = _observations(rng)
    T64, L64, ep64 = (torch.from_numpy(a.astype(np.float64)) for a in (T, L, ep))
    L = L.astype(np.float32)
    r, J = tres.line_residuals_and_pose_jacobian(T64, L64, ep64, T_CAM)
    assert torch.isfinite(J).all()

    def f(xi):
        return tres.line_residual(xi, torch.zeros(4, dtype=torch.float64), T64, L64, ep64, T_CAM)

    zero = torch.zeros(6, dtype=torch.float64)
    J_ad = torch.func.jacfwd(f)(zero)  # (N, 2, 6)
    assert torch.isfinite(J_ad).all()
    torch.testing.assert_close(J, J_ad, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(r, f(zero), rtol=1e-9, atol=1e-9)
    eps = 1e-6
    J_fd = torch.stack([(f(eps * e) - f(-eps * e)) / (2 * eps) for e in torch.eye(6, dtype=torch.float64)], dim=-1)
    torch.testing.assert_close(J, J_fd, rtol=1e-5, atol=1e-4)  # central differences, h = 1e-6

    def jax_lr(Lw, e):
        g = lambda xi: jres.line_residual(xi, jnp.zeros(4), jnp.asarray(T), Lw, e, J_CAM)
        return jax.jacfwd(g)(jnp.zeros(6))

    J_jax = np.asarray(jax.vmap(jax_lr)(jnp.asarray(L), jnp.asarray(ep)))
    r32, J32 = tres.line_residuals_and_pose_jacobian(*map(torch.from_numpy, (T, L, ep)), T_CAM)
    scale = np.abs(J_jax).max(axis=-1, keepdims=True) + 1.0
    assert np.all(np.abs(np_of(J32) - J_jax) / scale < 2e-3)  # float32, residuals of ~100s of px


def test_pose_optimize_matches_jax(rng):
    scene = make_wireframe_scene(rng, n_segments=60, n_points=8, n_frames=3)
    obs = observe_frame(scene, 1, noise_px=0.3, rng=rng)
    gt = scene.poses[1]
    L = np.array(jpl.plucker_normalize(jpl.plucker_from_points(jnp.asarray(scene.segments[:, 0]), jnp.asarray(scene.segments[:, 1]))))
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))) @ gt).astype(np.float32)
    valid = obs.seg_visible.astype(np.float32)
    ep = obs.seg_uv.copy()
    ep[np.nonzero(obs.seg_visible)[0][:4]] += 60.0  # outliers the re-gating must drop
    ref = jpose.pose_optimize(
        jnp.asarray(T0), jnp.asarray(L), jnp.asarray(ep), jnp.asarray(valid),
        jnp.zeros((1, 3)), jnp.zeros((1, 2)), jnp.zeros((1,)), J_CAM,
    )
    out = tpose.pose_optimize(
        torch.from_numpy(T0), torch.from_numpy(L), torch.from_numpy(ep), torch.from_numpy(valid), T_CAM
    )
    # float32 LM on the same problem: the same minimum to float32 rounding
    np.testing.assert_allclose(np_of(out.pose), np.asarray(ref.pose), atol=2e-5)
    np.testing.assert_array_equal(np_of(out.inlier_lines), np.asarray(ref.inlier_lines))
    assert int(out.num_inliers) == int(ref.num_inliers) > 30
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-3)
    center = np.linalg.inv(np_of(out.pose).astype(np.float64))[:3, 3]
    assert np.linalg.norm(center - np.linalg.inv(gt.astype(np.float64))[:3, 3]) < 5e-3


def test_pose_optimize_off_klein_quadric_matches_jax(rng):
    """Lines whose moment is not orthogonal to their direction: the JAX
    residual moves each onto the Klein quadric by the orthonormal round
    trip, and so does the port's pose_optimize (once, at entry); lines on
    the quadric pass through with their bits. The same pose as the JAX
    package's within 2e-5 and the same inliers."""
    scene = make_wireframe_scene(rng, n_segments=60, n_points=8, n_frames=3)
    obs = observe_frame(scene, 1, noise_px=0.3, rng=rng)
    gt = scene.poses[1]
    L = np.array(jpl.plucker_normalize(jpl.plucker_from_points(jnp.asarray(scene.segments[:, 0]), jnp.asarray(scene.segments[:, 1]))))
    L[::2, :3] += (rng.normal(size=(30, 3)) * 0.3).astype(np.float32)  # every other line off the quadric
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.03, jnp.float32))) @ gt).astype(np.float32)
    valid = obs.seg_visible.astype(np.float32)
    ep = obs.seg_uv.copy()
    ref = jpose.pose_optimize(
        jnp.asarray(T0), jnp.asarray(L), jnp.asarray(ep), jnp.asarray(valid),
        jnp.zeros((1, 3)), jnp.zeros((1, 2)), jnp.zeros((1,)), J_CAM,
    )
    Lt = torch.from_numpy(L)
    out = tpose.pose_optimize(torch.from_numpy(T0), Lt, torch.from_numpy(ep), torch.from_numpy(valid), T_CAM)
    np.testing.assert_allclose(np_of(out.pose), np.asarray(ref.pose), atol=2e-5)
    np.testing.assert_array_equal(np_of(out.inlier_lines), np.asarray(ref.inlier_lines))
    moved = tpose._onto_klein_quadric(Lt)
    assert torch.equal(moved[1::2], Lt[1::2]) and not torch.equal(moved[::2], Lt[::2])
