"""Pose-graph optimization over SE(3) and Sim(3): the essential graph (torch).

Counterpart of ``tpuslam.backend.pose_graph``: a fixed-capacity edge list
with residuals

    r_e = log(M_e^-1 @ X_i @ X_j^-1)      (6 for SE(3), 7 for Sim(3))

weighted by sqrt(w_e) and masked by ``e_valid``; Jacobians by forward-mode
AD (``torch.func.jacfwd``) through left perturbations at zero, as the JAX
package takes them with ``jax.jacfwd``; ``max_iters`` damped Gauss-Newton
(LM) iterations with accept or reject; the (P D)^2 normal system solved by
a dense Cholesky.

What differs in form: the JAX package assembles H and b with scatter-adds,
whose literal port (``index_add_``) adds by float atomics in no fixed order
on CUDA. Here every block sum is a one-hot matmul (``backend.lm``'s
``_segment_sum`` / ``_pair_sum``), so a solve repeats bit for bit. The
accept flag stays a 0-d device tensor and the factorization is
``cholesky_ex``, so nothing in the loop waits for the device; a failed
factorization rejects its step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from tpuslam_torch.backend.lm import _pair_sum, _segment_sum
from tpuslam_torch.geometry.se3 import se3_inverse, se3_log, se3_retract
from tpuslam_torch.geometry.sim3 import sim3_chart_log, sim3_inverse, sim3_retract

_EPS = 1e-8


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor  # (P, 4, 4) T_cw initial values
    pose_free: torch.Tensor  # (P,) 1.0 = optimized
    e_i: torch.Tensor  # (E,) int32 edge endpoints
    e_j: torch.Tensor  # (E,)
    e_meas: torch.Tensor  # (E, 4, 4) measured T_i @ T_j^-1
    e_valid: torch.Tensor  # (E,)
    e_weight: torch.Tensor  # (E,) information scale (e.g. covisibility weight)


class Sim3GraphProblem(NamedTuple):
    sims: torch.Tensor  # (P, 4, 4) world->camera similarities S_cw
    pose_free: torch.Tensor  # (P,) 1.0 = optimized
    e_i: torch.Tensor  # (E,) int32
    e_j: torch.Tensor  # (E,)
    e_meas: torch.Tensor  # (E, 4, 4) measured S_i @ S_j^-1
    e_valid: torch.Tensor  # (E,)
    e_weight: torch.Tensor  # (E,)


class PoseGraphConfig(NamedTuple):
    max_iters: int = 12
    lam0: float = 1e-6
    lam_up: float = 4.0
    lam_down: float = 0.5


class _Group(NamedTuple):
    dim: int
    retract: object
    inverse: object
    log: object


SE3 = _Group(6, se3_retract, se3_inverse, se3_log)
SIM3 = _Group(7, sim3_retract, sim3_inverse, sim3_chart_log)


def edge_residuals(g: _Group, xi_i, xi_j, X_i, X_j, M):
    """(E, D) residuals log(M^-1 @ retract(X_i, xi_i) @ retract(X_j, xi_j)^-1);
    xi_i, xi_j are (D,) (the same tangent for every edge) or (E, D)."""
    Xi = g.retract(X_i, xi_i.expand(X_i.shape[:-2] + (g.dim,)))
    Xj = g.retract(X_j, xi_j.expand(X_j.shape[:-2] + (g.dim,)))
    return g.log(g.inverse(M) @ Xi @ g.inverse(Xj))


def edge_jacobians(g: _Group, X_i, X_j, M):
    """(r, J_i, J_j): (E, D) residuals at zero and their (E, D, D) Jacobians
    with respect to the left perturbations of each edge's two ends. Edge e's
    residual depends only on its own ends, so the Jacobian of all residuals
    with respect to one tangent shared by every edge is each edge's own."""
    z = X_i.new_zeros(g.dim)
    r = edge_residuals(g, z, z, X_i, X_j, M)
    Ji, Jj = jacfwd(lambda a, b: edge_residuals(g, a, b, X_i, X_j, M), argnums=(0, 1))(z, z)
    return r, Ji, Jj


def _cost(g: _Group, X, e_i, e_j, prob):
    z = X.new_zeros(g.dim)
    r = edge_residuals(g, z, z, X[e_i], X[e_j], prob.e_meas)
    r = r * torch.sqrt(prob.e_weight)[:, None] * prob.e_valid[:, None]
    return torch.sum(r * r)


def _iteration(g: _Group, X, lam, cost, prob, cfg: PoseGraphConfig):
    P, D = X.shape[0], g.dim
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    r, Ji, Jj = edge_jacobians(g, X[e_i], X[e_j], prob.e_meas)
    sw = (torch.sqrt(prob.e_weight) * prob.e_valid)[:, None]
    r = r * sw
    Ji = Ji * sw[..., None] * prob.pose_free[e_i][:, None, None]
    Jj = Jj * sw[..., None] * prob.pose_free[e_j][:, None, None]

    def blocks(Ja, Jb):
        return torch.einsum("eia,eib->eab", Ja, Jb)

    # the (P, P, D, D) system from edge blocks, each sum in edge order
    H_diag = _segment_sum(blocks(Ji, Ji), e_i, P) + _segment_sum(blocks(Jj, Jj), e_j, P)
    H = _pair_sum(blocks(Ji, Jj), e_i, P, e_j, P) + _pair_sum(blocks(Jj, Ji), e_j, P, e_i, P)
    H = H + torch.eye(P, dtype=X.dtype, device=X.device)[:, :, None, None] * H_diag[:, None]
    b = -(_segment_sum(torch.einsum("eia,ei->ea", Ji, r), e_i, P) + _segment_sum(torch.einsum("eia,ei->ea", Jj, r), e_j, P))

    Hf = H.permute(0, 2, 1, 3).reshape(P * D, P * D)
    diag = torch.diagonal(Hf)
    # fixed poses: identity rows (their b is already zero through pose_free)
    free = prob.pose_free.repeat_interleave(D)
    Hf = Hf * free[:, None] * free[None, :] + torch.diag(lam * diag + _EPS + (1.0 - free))
    Lc, info = torch.linalg.cholesky_ex(Hf)
    dx = torch.cholesky_solve(b.reshape(-1, 1), Lc)[:, 0].reshape(P, D) * prob.pose_free[:, None]

    cand = g.retract(X, dx)
    new_cost = _cost(g, cand, e_i, e_j, prob)
    accept = (new_cost < cost) & (info == 0)
    X = torch.where(accept, cand, X)
    lam = torch.clamp(torch.where(accept, lam * cfg.lam_down, lam * cfg.lam_up), 1e-10, 1e6)
    return X, lam, torch.where(accept, new_cost, cost)


def _optimize(g: _Group, X, prob, cfg: PoseGraphConfig):
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    cost = _cost(g, X, e_i, e_j, prob)
    lam = torch.full((), cfg.lam0, dtype=X.dtype, device=X.device)
    for _ in range(cfg.max_iters):
        X, lam, cost = _iteration(g, X, lam, cost, prob, cfg)
    return X, cost


def optimize_pose_graph(prob: PoseGraphProblem, cfg: PoseGraphConfig = PoseGraphConfig()):
    """(optimized poses (P, 4, 4), final cost), on the problem's device."""
    return _optimize(SE3, prob.poses, prob, cfg)


def optimize_pose_graph_sim3(prob: Sim3GraphProblem, cfg: PoseGraphConfig = PoseGraphConfig()):
    """(optimized similarities (P, 4, 4), final cost), on the problem's device."""
    return _optimize(SIM3, prob.sims, prob, cfg)
