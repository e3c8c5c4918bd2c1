"""SE(3) and Sim(3) pose graphs of tpuslam_torch against tpuslam.

tests/test_posegraph.py's drifted circle (12 cameras looking inward, a
constant drift per odometry step, one loop edge at the true relative pose)
and a Sim(3) variant (the drift also grows the scale by 3% per step, the
loop edge at true scale), each padded as the loop closer pads it (poses to
16, edges to 64); tests/torch_loop_fixture.py builds them without JAX, for
the card tests too. The same numpy problem goes through both packages on the
CPU. Tolerances: optimized poses within 1e-4 (JAX's scatter-adds and the
port's fixed-order one-hot sums round differently), edge Jacobians within
1e-5 of ``jax.jacfwd``, fixed and pad poses bit-unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (torch threads)
from test_posegraph import _circle_poses
from torch_loop_fixture import GRAPH_N, circle_poses, pose_graph_fields
from tpuslam.backend import pose_graph as jpg
from tpuslam_torch.backend import pose_graph as tpg
from tpuslam_torch.convert import pose_graph_problem_from, sim3_graph_problem_from

N = GRAPH_N
POSE_TOL = 1e-4
JAC_TOL = 1e-5
ITERS = 12  # the loop closer's PoseGraphConfig().max_iters


def _problem(kind: str, pad: bool = True):
    return pose_graph_fields(kind, pad)


def _solve_jax(kind, fields):
    cfg = jpg.PoseGraphConfig(max_iters=ITERS)
    if kind == "se3":
        out, cost = jpg.optimize_pose_graph(jpg.PoseGraphProblem(*map(jnp.asarray, fields)), cfg)
    else:
        out, cost = jpg.optimize_pose_graph_sim3(jpg.Sim3GraphProblem(*map(jnp.asarray, fields)), cfg)
    return np.asarray(out), float(cost)


def _solve_torch(kind, fields):
    cfg = tpg.PoseGraphConfig(max_iters=ITERS)
    if kind == "se3":
        out, cost = tpg.optimize_pose_graph(pose_graph_problem_from(dict(zip(tpg.PoseGraphProblem._fields, fields))), cfg)
    else:
        out, cost = tpg.optimize_pose_graph_sim3(sim3_graph_problem_from(dict(zip(tpg.Sim3GraphProblem._fields, fields))), cfg)
    return out.numpy(), float(cost)


@pytest.fixture(scope="module", params=["se3", "sim3"])
def solved(request):
    kind = request.param
    fields, n_edges = _problem(kind)
    return kind, fields, n_edges, _solve_jax(kind, fields), _solve_torch(kind, fields)


def test_circle_matches_the_jax_tests():
    np.testing.assert_array_equal(circle_poses(N), _circle_poses(N))


def test_optimized_poses_match_jax(solved):
    kind, fields, _, (jout, jcost), (tout, tcost) = solved
    np.testing.assert_allclose(tout, jout, atol=POSE_TOL)
    assert tcost == pytest.approx(jcost, rel=1e-2, abs=1e-6)
    # the loop edge pulled the end of the chain toward the truth
    gt = _circle_poses(N)
    before = np.linalg.norm(fields[0][N - 1][:3, 3] - gt[N - 1][:3, 3])
    after = np.linalg.norm(tout[N - 1][:3, 3] - gt[N - 1][:3, 3])
    assert after < 0.5 * before, (after, before)


def test_fixed_and_pad_poses_bit_unchanged(solved):
    kind, fields, _, _, (tout, _) = solved
    fixed = fields[1] < 0.5
    assert fixed[0] and fixed[N:].all()
    np.testing.assert_array_equal(tout[fixed], fields[0][fixed])


def test_padding_is_masked(solved):
    """The padded problem gives the unpadded one's poses: pad poses and pad
    edges add exact zeros to the system."""
    kind, _, _, _, (tout, _) = solved
    fields, _ = _problem(kind, pad=False)
    bare, _ = _solve_torch(kind, fields)
    np.testing.assert_allclose(tout[:N], bare, atol=1e-6)


def _jax_jacobians(kind, Xi, Xj, M):
    if kind == "se3":
        res, D = jpg._edge_residual, 6
    else:
        res, D = jpg._sim3_edge_residual, 7

    def rj(a, b, m):
        f = lambda xi, xj: res(xi, xj, a, b, m)  # noqa: E731
        return jax.jacfwd(f, argnums=(0, 1))(jnp.zeros(D), jnp.zeros(D))

    return [np.asarray(x) for x in jax.jit(jax.vmap(rj))(jnp.asarray(Xi), jnp.asarray(Xj), jnp.asarray(M))]


@pytest.mark.parametrize("where", ["identity", "loop_edge"])
def test_edge_jacobians_match_jax(solved, where):
    """The odometry edges measure their own poses, so their residual is
    exactly log(I) = 0 at the first iteration; the loop edge's is not. The
    Jacobians are finite at both and agree with JAX's jacfwd."""
    kind, fields, n_edges, _, _ = solved
    poses, _, ei, ej, em = fields[:5]
    rows = np.arange(n_edges - 1) if where == "identity" else np.asarray([n_edges - 1])
    Xi, Xj, M = poses[ei[rows]], poses[ej[rows]], em[rows]
    g = tpg.SE3 if kind == "se3" else tpg.SIM3
    r, Ji, Jj = tpg.edge_jacobians(g, *(torch.from_numpy(np.ascontiguousarray(x)) for x in (Xi, Xj, M)))
    jJi, jJj = _jax_jacobians(kind, Xi, Xj, M)
    for got, want in ((Ji, jJi), (Jj, jJj)):
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), want, atol=JAC_TOL)
    if where == "identity":
        assert float(r.abs().max()) < 1e-5
