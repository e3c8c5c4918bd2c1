"""tpuslam_torch's BA back end against tpuslam's: Pluecker normalisation, the
residual Jacobians, one LM+Schur iteration and whole solves, the keyframe
database and DLT-Lines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_backend import CAM as J_CAM
from test_backend import build_synthetic_ba
from test_dlt import _make_problem
from torch_parity import np_of
from tpuslam.backend import dlt as jdlt
from tpuslam.backend import lm as jlm
from tpuslam.backend import residuals as jres
from tpuslam.backend.loop_closing import KeyFrameDatabase as JKeyFrameDatabase
from tpuslam.geometry import plucker as jpl
from tpuslam.geometry import se3 as jse3
from tpuslam_torch.backend import dlt as tdlt
from tpuslam_torch.backend import lm as tlm
from tpuslam_torch.backend import residuals as tres
from tpuslam_torch.backend.loop_closing import KeyFrameDatabase
from tpuslam_torch.convert import ba_problem_from
from tpuslam_torch.geometry import camera as tcam
from tpuslam_torch.geometry import plucker as tpl

T_CAM = tcam.Intrinsics(*J_CAM)
CHI2 = (7.378, 5.991)


def _lines(rng, n):
    p = rng.uniform(-3, 3, (n, 3)) + np.array([0, 0, 8.0])
    q = p + rng.normal(size=(n, 3))
    return np.concatenate([np.cross(p, q), q - p], axis=-1)


def test_plucker_normalize_matches_jax(rng):
    L = _lines(rng, 64).astype(np.float32)
    L[:, :3] += rng.normal(size=(64, 3)).astype(np.float32) * 0.01  # Klein violations to repair
    out = np_of(tpl.plucker_normalize(torch.from_numpy(L)))
    np.testing.assert_allclose(out, np.asarray(jpl.plucker_normalize(jnp.asarray(L))), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(out[:, 3:], axis=-1), 1.0, atol=1e-6)
    assert np.abs(np.sum(out[:, :3] * out[:, 3:], axis=-1)).max() < 1e-5  # Klein constraint
    p, q = rng.normal(size=(2, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tpl.plucker_from_points(torch.from_numpy(p), torch.from_numpy(q))),
        np.asarray(jpl.plucker_from_points(jnp.asarray(p), jnp.asarray(q))),
        atol=1e-6,
    )


def _obs(rng, n=32):
    """Normalised lines and points in front of a camera near the identity,
    noisy pixel observations, float64."""
    L = _lines(rng, n)
    v = np.linalg.norm(L[:, 3:], axis=-1, keepdims=True)
    L = L / v
    T = np.array(jse3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.05, jnp.float32)), np.float64)
    ep = rng.uniform(50, 600, (n, 2, 2))
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    uv = rng.uniform(100, 500, (n, 2))
    return T, L, ep, X, uv


@pytest.mark.parametrize("kind", ["line", "point"])
def test_jacobians_match_ad_finite_differences_and_jax(rng, kind):
    """Analytic pose and landmark Jacobians at zero tangent against
    torch.func.jacfwd through the retractions and central differences
    (float64), and against the JAX package's jacfwd (float32); finite at
    zero tangent (the retraction's so3_exp and atan2)."""
    T, L, ep, X, uv = _obs(rng)
    n = len(L)
    T64 = torch.from_numpy(T).expand(n, 4, 4)
    if kind == "line":
        lm, meas, ndl = torch.from_numpy(L), torch.from_numpy(ep), 4
        r, Jp, Jl = tres.line_residuals_and_jacobians(T64, lm, meas, T_CAM)
        res_t, res_j = tres.line_residual, jres.line_residual
    else:
        lm, meas, ndl = torch.from_numpy(X), torch.from_numpy(uv), 3
        r, Jp, Jl = tres.point_residuals_and_jacobians(T64, lm, meas, T_CAM)
        res_t, res_j = tres.point_residual, jres.point_residual

    def f(xi, d):
        return res_t(xi.expand(n, 6), d.expand(n, ndl), T64, lm, meas, T_CAM)

    z6, zl = torch.zeros(6, dtype=torch.float64), torch.zeros(ndl, dtype=torch.float64)
    J_ad = torch.func.jacfwd(f, argnums=(0, 1))(z6, zl)
    assert all(torch.isfinite(J).all() for J in (Jp, Jl, *J_ad))
    torch.testing.assert_close(r, f(z6, zl), rtol=1e-9, atol=1e-6)  # the scale eps of the line normaliser
    torch.testing.assert_close(Jp, J_ad[0], rtol=1e-7, atol=1e-6)
    torch.testing.assert_close(Jl, J_ad[1], rtol=1e-7, atol=1e-6)
    h = 1e-6
    fd_p = torch.stack([(f(h * e, zl) - f(-h * e, zl)) / (2 * h) for e in torch.eye(6, dtype=torch.float64)], -1)
    fd_l = torch.stack([(f(z6, h * e) - f(z6, -h * e)) / (2 * h) for e in torch.eye(ndl, dtype=torch.float64)], -1)
    torch.testing.assert_close(Jp, fd_p, rtol=1e-5, atol=1e-4)  # central differences, h = 1e-6
    torch.testing.assert_close(Jl, fd_l, rtol=1e-5, atol=1e-4)

    T32, lm32, meas32 = (np.asarray(a, np.float32) for a in (T, lm.numpy(), meas.numpy()))

    def jax_jac(x, m):
        g = lambda xi, d: res_j(xi, d, jnp.asarray(T32), x, m, J_CAM)
        return jax.jacfwd(g, argnums=(0, 1))(jnp.zeros(6), jnp.zeros(ndl))

    Jp_j, Jl_j = (np.asarray(a) for a in jax.vmap(jax_jac)(jnp.asarray(lm32), jnp.asarray(meas32)))
    fn = tres.line_residuals_and_jacobians if kind == "line" else tres.point_residuals_and_jacobians
    _, Jp32, Jl32 = fn(torch.from_numpy(T32).expand(n, 4, 4), torch.from_numpy(lm32), torch.from_numpy(meas32), T_CAM)
    for a, b in ((Jp32, Jp_j), (Jl32, Jl_j)):
        scale = np.abs(b).max(axis=-1, keepdims=True) + 1.0
        assert np.all(np.abs(np_of(a) - b) / scale < 2e-3)  # float32, entries up to ~1e3


def _problems(rng, outlier_frac):
    prob, gt_poses, _, _ = build_synthetic_ba(rng, noise_px=0.3, outlier_frac=outlier_frac)
    return prob, ba_problem_from(prob), np.asarray(gt_poses)


def _state0(prob):
    cfg = jlm.LMConfig()
    rl, rp = jlm._whitened_residuals(prob.poses, prob.lines, prob.points, prob, J_CAM)
    return jlm.BAState(prob.poses, jpl.plucker_normalize(prob.lines), prob.points, jnp.float32(cfg.lam0), jlm._robust_cost(rl, rp, prob, cfg))


def _residuals(pkg, state, prob, cam):
    return [np_of(r) for r in pkg._whitened_residuals(state.poses, state.lines, state.points, prob, cam)]


@pytest.mark.parametrize("outlier_frac", [0.0, 0.15])
def test_lm_iteration_matches_jax(rng, outlier_frac):
    """One LM+Schur step from the same state. Lines seen from nearly one
    plane are fixed along a direction only by the damping, so float32
    rounding moves them there freely: lines are compared through their
    residuals, the poses and points directly."""
    jprob, tprob, _ = _problems(rng, outlier_frac)
    js = _state0(jprob)
    ts = tlm.BAState(*[torch.from_numpy(np.array(x)) for x in js])
    js1 = jax.jit(lambda s: jlm._lm_iteration(s, jprob, J_CAM, jlm.LMConfig()))(js)
    ts1 = tlm._lm_iteration(ts, tprob, T_CAM, tlm.LMConfig())
    assert float(ts1.lam) == float(js1.lam)  # the same accept decision
    np.testing.assert_allclose(float(ts1.cost), float(js1.cost), rtol=2e-3)
    np.testing.assert_allclose(np_of(ts1.poses), np.asarray(js1.poses), atol=1e-3)
    np.testing.assert_allclose(np_of(ts1.points), np.asarray(js1.points), atol=2e-2)
    for a, b in zip(_residuals(tlm, ts1, tprob, T_CAM), _residuals(jlm, js1, jprob, J_CAM)):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.5)  # whitened px; outliers' reach ~200


def test_run_lm_matches_jax_noise_free(rng):
    """Noise-free problem: both solvers reach the ground truth, so their
    states agree to float32 convergence."""
    prob, gt_poses, _, _ = build_synthetic_ba(rng, noise_px=0.0)
    tprob = ba_problem_from(prob)
    js = jax.jit(lambda p: jlm.run_lm(p, J_CAM, jlm.LMConfig(max_iters=8)))(prob)
    ts = tlm.run_lm(tprob, T_CAM, tlm.LMConfig(max_iters=8))
    np.testing.assert_allclose(np_of(ts.poses), np.asarray(js.poses), atol=2e-4)
    np.testing.assert_allclose(np_of(ts.poses), np.asarray(gt_poses), atol=1e-3)
    np.testing.assert_allclose(np_of(ts.points), np.asarray(js.points), atol=1e-2)
    for a, b in zip(_residuals(tlm, ts, tprob, T_CAM), _residuals(jlm, js, prob, J_CAM)):
        np.testing.assert_allclose(a, b, atol=0.05)
    assert float(ts.cost) < 1e-3 and float(js.cost) < 1e-3
    for a, b in zip(tlm.chi2_outlier_mask(ts, tprob, T_CAM, *CHI2), jlm.chi2_outlier_mask(js, prob, J_CAM, *CHI2)):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))


def test_run_lm_gates_outliers_like_jax(rng):
    """15% gross outliers (the JAX package's test_outliers_gated protocol:
    solve, chi2-gate, solve again). The first solve stalls among outliers,
    where the accept test's ties fall by float32 rounding: the two packages'
    masks must agree on 85% of the observations, and the gated solves must
    reach the same accuracy and each other within it."""
    jprob, tprob, gt = _problems(rng, 0.15)
    cfg = jlm.LMConfig(max_iters=8)
    js = jlm.run_lm(jprob, J_CAM, cfg)
    ts = tlm.run_lm(tprob, T_CAM, tlm.LMConfig(max_iters=8))
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=0.1)
    jm = [np.asarray(m) for m in jlm.chi2_outlier_mask(js, jprob, J_CAM, *CHI2)]
    tm = [np_of(m) for m in tlm.chi2_outlier_mask(ts, tprob, T_CAM, *CHI2)]
    for a, b, v in zip(tm, jm, (np.asarray(jprob.l_valid), np.asarray(jprob.p_valid))):
        assert np.mean(a[v > 0] == b[v > 0]) > 0.85
    js2 = jlm.run_lm(jprob._replace(poses=js.poses, lines=js.lines, points=js.points, l_valid=jnp.asarray(jm[0]), p_valid=jnp.asarray(jm[1])), J_CAM, cfg)
    ts2 = tlm.run_lm(tprob._replace(poses=ts.poses, lines=ts.lines, points=ts.points, l_valid=torch.from_numpy(tm[0]), p_valid=torch.from_numpy(tm[1])), T_CAM, tlm.LMConfig(max_iters=8))
    for T in (np_of(ts2.poses), np.asarray(js2.poses)):
        assert np.abs(T[:, :3, 3] - gt[:, :3, 3]).max() < 0.05
    np.testing.assert_allclose(np_of(ts2.poses), np.asarray(js2.poses), atol=0.05)


def test_lm_solve_is_deterministic(rng):
    """The sums are fixed-order matmuls: two solves repeat bit for bit."""
    _, tprob, _ = _problems(rng, 0.0)
    a = tlm.run_lm(tprob, T_CAM, tlm.LMConfig(max_iters=3))
    b = tlm.run_lm(tprob, T_CAM, tlm.LMConfig(max_iters=3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


class _KF:
    def __init__(self, kid, bits, valid):
        self.kid = kid
        self.features = type("F", (), dict(desc_bits=bits, valid=valid))()
        self.point_features = None


def test_keyframe_database_scores_exactly_like_jax(rng):
    """Integer scores equal, through adds past the capacity, removals and a
    compaction."""
    K, W = 32, 8
    base = rng.integers(0, 2**32, size=(K, W), dtype=np.uint64).astype(np.uint32)
    kfs = []
    for kid in range(20):
        bits = base.copy()
        flip = rng.random(size=(K, W, 32)) < rng.uniform(0.02, 0.4)
        bits ^= np.packbits(flip, axis=-1, bitorder="little").view(np.uint32)[..., 0]
        kfs.append(_KF(kid, bits, (rng.random(K) < 0.85).astype(np.float32)))
    jdb, tdb = JKeyFrameDatabase(capacity_hint=8), KeyFrameDatabase(capacity_hint=8, device="cpu")
    q = _KF(99, base, (rng.random(K) < 0.9).astype(np.float32))

    def check():
        assert len(tdb) == len(jdb)
        assert tdb.query(q) == jdb.query(q)
        assert tdb.kids == jdb.kids

    for kf in kfs:
        jdb.add(kf)
        tdb.add(kf)
    check()
    assert max(jdb.query(q).values()) > 5 and min(jdb.query(q).values()) < max(jdb.query(q).values())
    for kid in (3, 7):
        jdb.remove(kid)
        tdb.remove(kid)
    check()
    for kid in range(20):  # enough removals to compact
        if kid not in (3, 7, 18, 19):
            jdb.remove(kid)
            tdb.remove(kid)
    assert len(tdb.kids) < 20  # compacted
    check()
    tdb.clear()
    assert tdb.query(q) == {}


@pytest.mark.parametrize("case", ["exact", "noisy", "masked", "degenerate"])
def test_dlt_lines_pose_matches_jax(rng, case):
    T, Xw, l2d = _make_problem(rng, M=60 if case == "noisy" else 40, noise=0.5 if case == "noisy" else 0.0)
    w = np.ones(len(Xw), np.float32)
    if case == "masked":
        l2d = l2d.copy()
        l2d[20:] = rng.normal(size=(len(l2d) - 20, 3))
        w[20:] = 0.0
    if case == "degenerate":
        w[3:] = 0.0
    Tj, okj = jdlt.dlt_lines_pose(jnp.asarray(l2d), jnp.asarray(Xw), jnp.asarray(w), J_CAM)
    Tt, okt = tdlt.dlt_lines_pose(*(torch.from_numpy(np.array(a)) for a in (l2d, Xw, w)), T_CAM)
    assert float(okt) == float(okj) == (0.0 if case == "degenerate" else 1.0)
    if case != "degenerate":
        np.testing.assert_allclose(np_of(Tt), np.asarray(Tj), atol=2e-3)  # float32 12x12 eigensolve
        np.testing.assert_allclose(np_of(Tt)[:3, 3], T[:3, 3], atol=0.15 if case == "noisy" else 1e-2)
    ep = rng.uniform(0, 600, (16, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(tdlt.image_line_coeffs(torch.from_numpy(ep))), np.asarray(jdlt.image_line_coeffs(jnp.asarray(ep))), rtol=1e-6
    )
