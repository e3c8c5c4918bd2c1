"""SO(3)/SE(3) logarithms and Sim(3) of tpuslam_torch against tpuslam.

The same numpy inputs, made from a seed, go through both packages' functions
on the CPU. Tolerance: 1e-5 relative (atol 1e-5 on values of order one),
rotation angles near 0 and near pi included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (torch threads)
from tpuslam.geometry import se3 as jse3
from tpuslam.geometry import sim3 as jsim3
from tpuslam_torch.geometry import se3 as tse3
from tpuslam_torch.geometry import sim3 as tsim3

RTOL = ATOL = 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _angles(kind: str, n: int = 64) -> np.ndarray:
    """(n, 3) axis-angle vectors: generic (|phi| up to ~2.5), near 0, near pi."""
    rng = np.random.default_rng({"generic": 0, "near_zero": 1, "near_pi": 2}[kind])
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = {
        "generic": rng.uniform(0.05, 2.5, n),
        "near_zero": 10.0 ** rng.uniform(-7, -3, n),
        "near_pi": np.pi - 10.0 ** rng.uniform(-5, -2, n),
    }[kind]
    return (axis * theta[:, None]).astype(np.float32)


@pytest.mark.parametrize("kind", ["generic", "near_zero", "near_pi"])
def test_so3_log_matches_jax(kind):
    R = np.asarray(jax.jit(jse3.so3_exp)(jnp.asarray(_angles(kind))))
    want = np.asarray(jax.jit(jse3.so3_log)(jnp.asarray(R)))
    got = tse3.so3_log(torch.from_numpy(R.copy())).numpy()
    _close(got, want)
    if kind != "near_pi":  # the angle itself round-trips away from pi's axis-sign ambiguity
        _close(got, _angles(kind), atol=1e-4)


@pytest.mark.parametrize("kind", ["generic", "near_zero"])
def test_se3_log_matches_jax(kind):
    rng = np.random.default_rng(3)
    xi = np.concatenate([rng.normal(size=(64, 3)).astype(np.float32), _angles(kind)], axis=1)
    T = np.asarray(jax.jit(jse3.se3_exp)(jnp.asarray(xi)))
    want = np.asarray(jax.jit(jse3.se3_log)(jnp.asarray(T)))
    got = tse3.se3_log(torch.from_numpy(T.copy())).numpy()
    _close(got, want)


def test_log_jacobian_at_identity_matches_jax():
    """d/dxi log(exp(xi) @ T0 @ T0^-1) at xi = 0 (the residual of an edge that
    measures its own poses) is finite, and equal to JAX's jacfwd."""
    rng = np.random.default_rng(4)
    T0 = np.asarray(jax.jit(jse3.se3_exp)(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.5)))
    Ti0 = np.linalg.inv(T0).astype(np.float32)
    jf = lambda xi: jse3.se3_log(jse3.se3_retract(jnp.asarray(T0), xi) @ jnp.asarray(Ti0))  # noqa: E731
    want = np.asarray(jax.jit(jax.jacfwd(jf))(jnp.zeros(6)))
    # batched, as the pose graph calls it (one edge)
    tf = lambda xi: tse3.se3_log(tse3.se3_retract(torch.from_numpy(T0.copy())[None], xi) @ torch.from_numpy(Ti0))  # noqa: E731
    got = torch.func.jacfwd(tf)(torch.zeros(1, 6))[0, :, 0].numpy()
    assert np.all(np.isfinite(got))
    _close(got, want)


def _sims(seed: int, n: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 7)).astype(np.float32) * np.float32(0.6)
    return np.asarray(jax.jit(jsim3.sim3_chart)(jnp.asarray(xi)))


def _sim3_case(name: str):
    """(torch function, JAX function, numpy arguments) of one Sim(3) function."""
    rng = np.random.default_rng(7)
    S = _sims(5)
    n = S.shape[0]
    s = rng.uniform(0.5, 2.0, n).astype(np.float32)
    R = np.asarray(jax.jit(jse3.so3_exp)(jnp.asarray(_angles("generic", n))))
    t = rng.normal(size=(n, 3)).astype(np.float32)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    xi = rng.normal(size=(n, 7)).astype(np.float32) * np.float32(0.3)
    T = np.asarray(jax.jit(jse3.se3_exp)(jnp.asarray(rng.normal(size=(n, 6)).astype(np.float32))))
    p, q = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) + 3.0
    L = np.concatenate([np.cross(p, q), q - p], axis=1).astype(np.float32)
    return {
        "make": ("sim3_make", (s, R, t)),
        "scale": ("sim3_scale", (S,)),
        "decompose": ("sim3_decompose", (S,)),
        "inverse": ("sim3_inverse", (S,)),
        "apply": ("sim3_apply", (S, pts)),
        "chart": ("sim3_chart", (xi,)),
        "chart_log": ("sim3_chart_log", (S,)),
        "retract": ("sim3_retract", (S, xi)),
        "from_se3": ("sim3_from_se3", (T, s)),
        "se3_from_sim3": ("se3_from_sim3", (S,)),
        "plucker_transform_sim3": ("plucker_transform_sim3", (S, L)),
    }[name]


SIM3_FUNCTIONS = [
    "make", "scale", "decompose", "inverse", "apply", "chart", "chart_log", "retract", "from_se3", "se3_from_sim3",
    "plucker_transform_sim3",
]


@pytest.mark.parametrize("name", SIM3_FUNCTIONS)
def test_sim3_matches_jax(name):
    fn, args = _sim3_case(name)
    want = jax.jit(getattr(jsim3, fn))(*[jnp.asarray(a) for a in args])
    got = getattr(tsim3, fn)(*[torch.from_numpy(np.array(a)) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_sim3_chart_jacobian_finite_at_zero():
    S0 = tsim3.sim3_make(torch.tensor([1.3]), torch.eye(3)[None], torch.tensor([[1.0, 0.0, 0.0]]))
    J = torch.func.jacfwd(lambda xi: tsim3.sim3_chart_log(tsim3.sim3_retract(S0, xi) @ tsim3.sim3_inverse(S0)))(torch.zeros(1, 7))
    J = J[0, :, 0].numpy()
    assert np.all(np.isfinite(J))
    np.testing.assert_allclose(J, np.eye(7), atol=1e-5)  # the chart's log is its local inverse
