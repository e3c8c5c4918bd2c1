"""The loop-closure warm-up (tpuslam_torch.warmup.warm_loop_programs)
against tpuslam.warmup.warm_loop_programs, on the CPU.

Each package's warm-up runs with its solvers wrapped, so the test sees the
problems it builds and the results it gets:

- the toy essential-graph problem (16 poses, 64 edges from
  ``np.random.default_rng(0)``) is bit-equal in both packages, and its
  solve agrees within 1e-6 (SE(3) and Sim(3): every pose is the identity
  and every edge measures the identity, so both stay at the identity);
- the refinement at ``refine_cap`` = 256 gets bit-equal inputs, and its
  refined pose agrees with ``tpuslam.backend.loop_closing._refine_pose_jit``'s
  within 1e-5, with equal inlier counts. The drawn lines are not Pluecker
  lines (their moment and direction are not orthogonal): the JAX line
  residual passes every line through the orthonormal round trip, which
  moves such a line, and the port's ``pose_optimize`` does the same once
  at its entry (without it the poses parted by 0.28; ROADMAP.md section
  3, fault 3.4);
- ``System(device="cpu")`` runs the warm-up only under TPUSLAM_WARM_LOOP=1;
- a graph solve and a refinement give bit-equal results before and after
  the warm-up, which leaves numpy's and torch's global generators as they
  were.
"""

import numpy as np
import pytest
import torch

from torch_parity import QVGA, np_of
from tpuslam_torch.backend import pose_graph as tpg
from tpuslam_torch.backend import pose_opt as tpo
from tpuslam_torch.warmup import warm_loop_programs

GRAPH_TOL = 1e-6
REFINE_TOL = 1e-5


def _jax_cam():
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    return JIntrinsics(*QVGA)


def _capture(monkeypatch, module, name, seen: list):
    real = getattr(module, name)

    def wrapped(*a, **k):
        out = real(*a, **k)
        seen.append((a, k, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def warmups():
    """{mono: (JAX (graph, refine) calls, port (graph, refine) calls)} of
    both packages' warm-ups at refine_cap 256, stereo and mono."""
    from tpuslam.backend import loop_closing as jlc
    from tpuslam.backend import pose_graph as jpg
    from tpuslam.warmup import warm_loop_programs as jwarm

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mono in (False, True):
            jg, jr, tg, tr = [], [], [], []
            _capture(mp, jpg, "optimize_pose_graph_sim3" if mono else "optimize_pose_graph", jg)
            _capture(mp, jlc, "_refine_pose_jit", jr)
            _capture(mp, tpg, "optimize_pose_graph_sim3" if mono else "optimize_pose_graph", tg)
            _capture(mp, tpo, "pose_optimize", tr)
            jwarm(_jax_cam(), mono=mono, refine_cap=256)
            secs = warm_loop_programs(QVGA, mono=mono, refine_cap=256, device="cpu")
            assert set(secs) == {"pose_graph_s", "loop_refine_s"}
            assert len(jg) == len(jr) == len(tg) == len(tr) == 1
            out[mono] = (jg[0], jr[0], tg[0], tr[0])
            mp.undo()
    return out


@pytest.mark.parametrize("mono", [False, True], ids=["se3", "sim3"])
def test_warm_graph_matches_jax(warmups, mono):
    """The toy essential-graph problem bit-equal field by field, its solve
    (the optimized poses or similarities) within GRAPH_TOL."""
    (ja, _, jout), _, (ta, _, tout), _ = warmups[mono]
    jprob, tprob = ja[0], ta[0]
    assert jprob._fields == tprob._fields
    for name, x, y in zip(jprob._fields, jprob, tprob):
        np.testing.assert_array_equal(np.asarray(x), np_of(y), err_msg=name)
    assert tuple(ta[1]) == tuple(ja[1])  # PoseGraphConfig() in both
    np.testing.assert_allclose(np_of(tout[0]), np.asarray(jout[0]), atol=GRAPH_TOL)
    np.testing.assert_allclose(np_of(tout[0]), np.tile(np.eye(4), (16, 1, 1)), atol=GRAPH_TOL)


def test_warm_refine_matches_jax(warmups):
    """The refinement at refine_cap 256: the seed, lines, endpoints, points,
    pixels, masks and sigmas bit-equal to what the JAX warm-up hands
    ``_refine_pose_jit``, the refined pose within REFINE_TOL of its pose and
    the same inlier count."""
    _, (ja, _, jres), _, (ta, tk, tres) = warmups[False]
    T, l_pl, l_ep, l_val, p_xyz, p_uv, p_val, l_sig = (np.asarray(x) for x in ja[:8])
    pairs = [(T, ta[0]), (l_pl, ta[1]), (l_ep, ta[2]), (l_val, ta[3]), (l_sig, tk["l_sigma"]), (p_xyz, tk["points"]),
             (p_uv, tk["p_uv"]), (p_val, tk["p_valid"])]
    for i, (x, y) in enumerate(pairs):
        assert x.shape[0] in (4, 256)
        np.testing.assert_array_equal(x, np_of(y), err_msg=f"input {i}")
    assert ta[5] == tpo.PoseOptConfig() and tuple(ja[9]) == tuple(ta[5])
    assert np.abs(np.sum(l_pl[:, :3] * l_pl[:, 3:], axis=1)).max() > 1.0  # off the Klein quadric

    np.testing.assert_allclose(np_of(tres.pose), np.asarray(jres.pose), atol=REFINE_TOL)
    assert int(tres.num_inliers) == int(jres.num_inliers)


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_system_warms_only_when_asked(monkeypatch, env):
    """System(device="cpu") with loop closing calls warm_loop_programs
    (here a stand-in) once, with the loop closer's refine_cap, only when
    TPUSLAM_WARM_LOOP is "1"; the CPU default is off."""
    from tpuslam_torch import warmup
    from tpuslam_torch.system import System

    calls = []
    monkeypatch.setattr(warmup, "warm_loop_programs", lambda cam, **k: calls.append((cam, k)) or {"pose_graph_s": 0.0})
    if env is None:
        monkeypatch.delenv("TPUSLAM_WARM_LOOP", raising=False)
    else:
        monkeypatch.setenv("TPUSLAM_WARM_LOOP", env)
    monkeypatch.setenv("TPUSLAM_BA_SUBPROCESS", "0")
    s = System(QVGA, device="cpu")
    if env == "1":
        assert calls == [(QVGA, dict(mono=False, refine_cap=s.loop_closer.cfg.refine_cap, device=torch.device("cpu")))]
        assert s.warm_loop_s == {"pose_graph_s": 0.0}
    else:
        assert calls == [] and s.warm_loop_s is None
    System(QVGA, device="cpu", loop_closing=False)
    assert len(calls) == (env == "1")


def _solves():
    """A graph solve and a refinement on seeded inputs unlike the warm-up's
    (drifted poses, lines and pixels from a real-looking camera)."""
    from tpuslam_torch.geometry.se3 import se3_exp

    rng = np.random.default_rng(7)
    P, E = 16, 64
    poses = se3_exp(torch.as_tensor(rng.normal(size=(P, 6)) * 0.1, dtype=torch.float32))
    e_i = torch.as_tensor(rng.integers(0, P, E), dtype=torch.int32)
    e_j = (e_i + 1) % P
    meas = se3_exp(torch.as_tensor(rng.normal(size=(E, 6)) * 0.05, dtype=torch.float32))
    free = torch.ones(P)
    free[0] = 0.0
    prob = tpg.PoseGraphProblem(poses, free, e_i, e_j, meas, torch.ones(E), torch.ones(E))
    graph = tpg.optimize_pose_graph(prob, tpg.PoseGraphConfig())[0]
    C = 64
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    res = tpo.pose_optimize(
        f32(np.eye(4)), f32(rng.standard_normal((C, 6))), f32(rng.uniform(0, 240, (C, 2, 2))), torch.ones(C), QVGA,
        tpo.PoseOptConfig(), l_sigma=torch.ones(C), points=f32(rng.standard_normal((C, 3)) + [0, 0, 5.0]),
        p_uv=f32(rng.uniform(0, 240, (C, 2))), p_valid=torch.ones(C),
    )
    return graph, res.pose, res.num_inliers


def test_warmup_changes_no_result():
    """A graph solve and a refinement bit-equal before and after the
    warm-up (stereo and mono), which draws from its own generator only."""
    before = _solves()
    np_state, torch_state = np.random.get_state(), torch.random.get_rng_state()
    for mono in (False, True):
        warm_loop_programs(QVGA, mono=mono, refine_cap=256, device="cpu")
    after = _solves()
    assert torch.equal(torch.random.get_rng_state(), torch_state)
    assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), np_state))
    for x, y in zip(before, after):
        assert torch.equal(x, y)
