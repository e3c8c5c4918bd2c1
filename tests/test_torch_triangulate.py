"""tpuslam_torch's two-view triangulation, image-line helpers and epipolar gate
against tpuslam's, on numpy inputs from seeds.

Tolerances: 1e-5 relative (to each vector's norm, with a unit floor) for
the closed forms (projection, planes, Pluecker two-view, ray endpoints,
relative pose, image lines, the gate).
The DLT point triangulation takes the smallest eigenvector of a 4x4 normal
matrix built at pixel scale (rows u P_2 - P_0 with fx 458), whose float32
solve is itself noisy: on these inputs (depths 3-10 m, a 0.25 m baseline,
0.3 px noise) the JAX package's float32 points sit up to 8.7e-5 relative
(7.6e-4 m) off a float64 numpy DLT of the same rows, and the port's float32
ones up to 8e-5. Both are held to the float64 DLT within 2e-4 relative and
to each other within 3e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import np_of
from tpuslam.geometry import camera as jcam
from tpuslam.geometry import triangulate as jtri
from tpuslam.geometry.se3 import se3_exp as j_se3_exp
from tpuslam.kernels import match as jmatch
from tpuslam_torch.geometry import camera as tcam
from tpuslam_torch.geometry import triangulate as ttri
from tpuslam_torch.kernels import match as tmatch

J_CAM = jcam.Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)
T_CAM = tcam.Intrinsics(*J_CAM)
REL = 1e-5
SEEDS = [0, 1, 2]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL):
    """|got - want| <= rel * max(|want|, 1), |.| the norm over the last axis
    (relative to each vector's size, with a unit floor near zero)."""
    got, want = np_of(got).astype(np.float64), np.asarray(want, np.float64)
    if want.ndim == 0 or want.shape[-1] > 6:  # scalars per row: compare them one by one
        got, want = got[..., None], want[..., None]
    scale = np.maximum(np.linalg.norm(want, axis=-1), 1.0)
    err = np.max(np.linalg.norm(got - want, axis=-1) / scale)
    assert err <= rel, err


def _poses(rng):
    """Two camera poses (world -> camera) with a sideways baseline."""
    xi = np.zeros((2, 6), np.float32)
    xi[1, :3] = [-0.25, 0.01, 0.02]
    xi[:, 3:] = rng.normal(size=(2, 3)) * 0.02
    return np.asarray(j_se3_exp(jnp.asarray(xi)))


def _scene(rng, n=200):
    X = np.c_[rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 10, n)]
    Y = X + rng.normal(size=(n, 3))
    return X, Y


def _project(T, X):
    Xc = X @ T[:3, :3].T + T[:3, 3]
    return np.c_[J_CAM.fx * Xc[:, 0] / Xc[:, 2] + J_CAM.cx, J_CAM.fy * Xc[:, 1] / Xc[:, 2] + J_CAM.cy]


def _views(rng, n=200, noise=0.3):
    """Pixels of n points and of the endpoints of n segments in two views."""
    T = _poses(rng)
    X, Y = _scene(rng, n)
    obs = {}
    for k in range(2):
        obs[k] = tuple((_project(T[k], Z) + rng.normal(size=(n, 2)) * noise).astype(np.float32) for Z in (X, Y))
    return T, obs


@pytest.mark.parametrize("seed", SEEDS)
def test_projection_and_planes_match_jax(seed):
    rng = np.random.default_rng(seed)
    T, obs = _views(rng)
    for k in range(2):
        Pj = jtri.projection_matrix(J_CAM, jnp.asarray(T[k]))
        Pt = ttri.projection_matrix(T_CAM, _t(T[k]))
        _close(Pt, Pj)
        lj = jcam.image_line_through(jnp.asarray(obs[k][0]), jnp.asarray(obs[k][1]))
        lt = tcam.image_line_through(_t(obs[k][0]), _t(obs[k][1]))
        _close(lt, lj)
        _close(ttri.plane_from_image_line(Pt, lt), jtri.plane_from_image_line(Pj, lj))
        # signed distances of the other view's points to these lines
        uv = obs[1 - k][0]
        _close(tcam.point_line_distance(lt, _t(uv)), jcam.point_line_distance(lj, jnp.asarray(uv)))


@pytest.mark.parametrize("seed", SEEDS)
def test_plucker_two_view_and_ray_endpoints_match_jax(seed):
    rng = np.random.default_rng(seed)
    T, obs = _views(rng)
    P = [np.asarray(jtri.projection_matrix(J_CAM, jnp.asarray(T[k]))) for k in range(2)]
    l = [np.asarray(jcam.image_line_through(jnp.asarray(obs[k][0]), jnp.asarray(obs[k][1]))) for k in range(2)]
    Lj = jtri.triangulate_plucker_two_view(*(jnp.asarray(a) for a in (P[0], P[1], l[0], l[1])))
    Lt = ttri.triangulate_plucker_two_view(*(_t(a) for a in (P[0], P[1], l[0], l[1])))
    _close(Lt, Lj)
    # the lines in camera 0 against the unit rays of view 0's endpoints
    Kinv = np.linalg.inv(np.asarray(J_CAM.K))
    rays = np.stack([np.c_[obs[0][e], np.ones(len(obs[0][e]))] @ Kinv.T for e in range(2)], axis=1).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    pj, sj = jtri.line_ray_endpoints(Lj, jnp.asarray(rays))
    pt, st = ttri.line_ray_endpoints(_t(np.asarray(Lj)), _t(rays))
    _close(pt, pj)
    _close(st, sj)


@pytest.mark.parametrize("seed", SEEDS)
def test_relative_pose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T = _poses(rng)
    _close(ttri.relative_pose(_t(T[0]), _t(T[1])), jtri.relative_pose(jnp.asarray(T[0]), jnp.asarray(T[1])))


def _dlt_f64(P0, P1, uv0, uv1):
    rows = []
    for P, uv in ((P0.astype(np.float64), uv0.astype(np.float64)), (P1.astype(np.float64), uv1.astype(np.float64))):
        rows += [uv[:, 0:1] * P[2] - P[0], uv[:, 1:2] * P[2] - P[1]]
    A = np.stack(rows, axis=-2)
    _, V = np.linalg.eigh(np.swapaxes(A, -1, -2) @ A)
    X = V[..., :, 0]
    return X[:, :3] / X[:, 3:]


@pytest.mark.parametrize("seed", SEEDS)
def test_triangulate_points_matches_jax_and_float64(seed):
    rng = np.random.default_rng(seed)
    T, obs = _views(rng)
    P = [np.asarray(jtri.projection_matrix(J_CAM, jnp.asarray(T[k]))) for k in range(2)]
    Xj = np.asarray(jtri.triangulate_points(*(jnp.asarray(a) for a in (P[0], P[1], obs[0][0], obs[1][0]))))
    Xt = np_of(ttri.triangulate_points(*(_t(a) for a in (P[0], P[1], obs[0][0], obs[1][0]))))
    X64 = _dlt_f64(P[0], P[1], obs[0][0], obs[1][0])
    norm = np.linalg.norm(X64, axis=-1)
    assert np.max(np.linalg.norm(Xj - X64, axis=-1) / norm) <= 2e-4  # the reference itself
    assert np.max(np.linalg.norm(Xt - X64, axis=-1) / norm) <= 2e-4
    assert np.max(np.linalg.norm(Xt - Xj, axis=-1) / norm) <= 3e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_epipolar_penalty_matches_jax(seed):
    """The two-view point gate: a fundamental matrix from the relative pose,
    corners of view 0 against view 1's (true matches and random others)."""
    rng = np.random.default_rng(seed)
    T, obs = _views(rng, n=96)
    T10 = T[1] @ np.linalg.inv(T[0])
    t = T10[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    Kinv = np.linalg.inv(np.asarray(J_CAM.K))
    F = (Kinv.T @ (tx @ T10[:3, :3]) @ Kinv).astype(np.float32)
    uv_a = obs[0][0]
    uv_b = np.concatenate([obs[1][0], rng.uniform([0, 0], [640, 480], (32, 2)).astype(np.float32)])
    pj = np.asarray(jmatch.epipolar_penalty(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(F), jnp.float32(3.0)))
    pt = np_of(tmatch.epipolar_penalty(_t(uv_a), _t(uv_b), _t(F), 3.0))
    assert (pj == 0).sum() >= 96  # the true matches pass the gate
    # the penalty is 1e6 x the distance beyond 3 px: 1e-5 relative, and 1e-5 px absolute
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=10.0)
