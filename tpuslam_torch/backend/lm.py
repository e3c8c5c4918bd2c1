"""Batched Levenberg-Marquardt with explicit Schur elimination (torch).

Counterpart of ``tpuslam.backend.lm``: the same fixed-capacity, mask-padded
problem (``P`` poses with ``pose_free`` gauge masks, ``L`` Pluecker lines
on the 4-DoF orthonormal tangent, ``M`` points, ``OL``/``OP`` observations),
the same Huber IRLS weights, Marquardt damping and accept/reject, and the
same reduced camera system

    S = Hpp - sum_l W_l Hll_l^-1 W_l^T,   S dp = bp - W Hll^-1 bl

with landmark increments by back-substitution.

What differs in form:

- Jacobians are analytic (``backend.residuals``) instead of ``jax.jacfwd``.
- Every per-pose, per-landmark and per-(landmark, pose) sum is a one-hot
  matmul, not a scatter: ``index_add_`` on a CUDA tensor sums with atomics in
  no fixed order, and the accept test, the chi2 prune and the culling after
  it are discontinuous, so bit noise would grow into different maps from run
  to run. A matmul sums in a fixed order, so a solve repeats bit for bit.
- ``lax.scan`` is a Python loop of ``max_iters`` iterations; the accept flag
  stays a 0-d device tensor and the solves are the ``*_ex`` forms, so nothing
  in the loop waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.backend.residuals import (
    huber_weight,
    line_residuals,
    line_residuals_and_jacobians,
    point_residuals_and_jacobians,
)
from tpuslam_torch.geometry.camera import Intrinsics, project_points
from tpuslam_torch.geometry.plucker import plucker_normalize, plucker_retract
from tpuslam_torch.geometry.se3 import se3_apply, se3_retract

_EPS = 1e-8


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem (tensors on one device)."""

    poses: torch.Tensor  # (P, 4, 4) T_cw linearization points
    pose_free: torch.Tensor  # (P,) 1.0 = optimized, 0.0 = held fixed (gauge)
    lines: torch.Tensor  # (L, 6) Pluecker world lines
    line_valid: torch.Tensor  # (L,)
    points: torch.Tensor  # (M, 3) world points
    point_valid: torch.Tensor  # (M,)
    # line observations, padded to OL
    l_pose: torch.Tensor  # (OL,) int32
    l_line: torch.Tensor  # (OL,) int32
    l_endpoints: torch.Tensor  # (OL, 2, 2) detected segment endpoints (px)
    l_valid: torch.Tensor  # (OL,)
    l_sigma: torch.Tensor  # (OL,) measurement std in px
    # point observations, padded to OP
    p_pose: torch.Tensor  # (OP,) int32
    p_point: torch.Tensor  # (OP,) int32
    p_uv: torch.Tensor  # (OP, 2)
    p_valid: torch.Tensor  # (OP,)
    p_sigma: torch.Tensor  # (OP,)


class LMConfig(NamedTuple):
    max_iters: int = 10
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    huber_line: float = 2.0  # in sigma units
    huber_point: float = 2.45
    min_lam: float = 1e-8
    max_lam: float = 1e4


class BAState(NamedTuple):
    poses: torch.Tensor
    lines: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


def _one_hot(seg: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(n, O) matrix with a 1 at [seg[o], o]."""
    return (seg.long()[None, :] == torch.arange(n, device=seg.device)[:, None]).to(dtype)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Sum (O, ...) values into (n, ...) by segment id, in a fixed order."""
    O = values.shape[0]
    return (_one_hot(seg, n, values.dtype) @ values.reshape(O, -1)).reshape((n,) + values.shape[1:])


def _pair_sum(values: torch.Tensor, a: torch.Tensor, na: int, b: torch.Tensor, nb: int) -> torch.Tensor:
    """Sum (O, ...) values into (na, nb, ...) by the pair (a[o], b[o])."""
    O = values.shape[0]
    spread = _one_hot(b, nb, values.dtype).T[:, :, None] * values.reshape(O, 1, -1)  # (O, nb, k)
    return _segment_sum(spread, a, na).reshape((na, nb) + values.shape[1:])


def _whitened_residuals(state_poses, state_lines, state_points, prob: BAProblem, cam: Intrinsics):
    """Per-observation whitened residuals (no robust weighting)."""
    rl = line_residuals(state_poses[prob.l_pose.long()], state_lines[prob.l_line.long()], prob.l_endpoints, cam)
    X_c = se3_apply(state_poses[prob.p_pose.long()], state_points[prob.p_point.long()])
    rp = project_points(cam, X_c) - prob.p_uv
    return rl / prob.l_sigma[:, None], rp / prob.p_sigma[:, None]


def _robust_cost(rl, rp, prob: BAProblem, cfg: LMConfig):
    """True Huber objective (used for accept/reject decisions)."""

    def huber(sq_norm, delta):
        n = torch.sqrt(sq_norm + _EPS)
        return torch.where(n <= delta, sq_norm, 2.0 * delta * n - delta * delta)

    cl = huber(torch.sum(rl * rl, dim=-1), cfg.huber_line) * prob.l_valid
    cp = huber(torch.sum(rp * rp, dim=-1), cfg.huber_point) * prob.p_valid
    return torch.sum(cl) + torch.sum(cp)


def _lm_iteration(state: BAState, prob: BAProblem, cam: Intrinsics, cfg: LMConfig) -> BAState:
    P = prob.poses.shape[0]
    Lc = prob.lines.shape[0]
    M = prob.points.shape[0]
    l_pose, l_line = prob.l_pose.long(), prob.l_line.long()
    p_pose, p_point = prob.p_pose.long(), prob.p_point.long()

    # ---- residuals + Jacobians at zero tangent -------------------------
    rl, Jlp, Jll = line_residuals_and_jacobians(state.poses[l_pose], state.lines[l_line], prob.l_endpoints, cam)
    rp, Jpp, Jpx = point_residuals_and_jacobians(state.poses[p_pose], state.points[p_point], prob.p_uv, cam)

    # ---- whitening + robust IRLS weights + masks -----------------------
    rl = rl / prob.l_sigma[:, None]
    Jlp = Jlp / prob.l_sigma[:, None, None]
    Jll = Jll / prob.l_sigma[:, None, None]
    rp = rp / prob.p_sigma[:, None]
    Jpp = Jpp / prob.p_sigma[:, None, None]
    Jpx = Jpx / prob.p_sigma[:, None, None]

    wl = huber_weight(torch.linalg.norm(rl, dim=-1), cfg.huber_line) * prob.l_valid
    wp = huber_weight(torch.linalg.norm(rp, dim=-1), cfg.huber_point) * prob.p_valid
    swl = torch.sqrt(wl)[:, None]
    swp = torch.sqrt(wp)[:, None]
    rl_w, Jlp_w, Jll_w = rl * swl, Jlp * swl[..., None], Jll * swl[..., None]
    rp_w, Jpp_w, Jpx_w = rp * swp, Jpp * swp[..., None], Jpx * swp[..., None]

    # gauge: zero the Jacobian columns of fixed poses; invalid landmarks:
    # zero their Jacobians
    Jlp_w = Jlp_w * prob.pose_free[l_pose][:, None, None]
    Jpp_w = Jpp_w * prob.pose_free[p_pose][:, None, None]
    Jll_w = Jll_w * prob.line_valid[l_line][:, None, None]
    Jpx_w = Jpx_w * prob.point_valid[p_point][:, None, None]

    # ---- block assembly ------------------------------------------------
    def tb(Ja, Jb):  # (O, 2, a), (O, 2, b) -> (O, a, b)
        return torch.einsum("oia,oib->oab", Ja, Jb)

    def tr(Ja, r):  # (O, 2, a), (O, 2) -> (O, a)
        return torch.einsum("oia,oi->oa", Ja, r)

    Hpp = _segment_sum(tb(Jlp_w, Jlp_w), l_pose, P) + _segment_sum(tb(Jpp_w, Jpp_w), p_pose, P)  # (P, 6, 6)
    bp = -(_segment_sum(tr(Jlp_w, rl_w), l_pose, P) + _segment_sum(tr(Jpp_w, rp_w), p_pose, P))  # (P, 6)
    Hll = _segment_sum(tb(Jll_w, Jll_w), l_line, Lc)  # (L, 4, 4)
    bl = -_segment_sum(tr(Jll_w, rl_w), l_line, Lc)
    Hxx = _segment_sum(tb(Jpx_w, Jpx_w), p_point, M)  # (M, 3, 3)
    bx = -_segment_sum(tr(Jpx_w, rp_w), p_point, M)

    # pose-landmark coupling, dense over (landmark, pose) pairs
    Wl = _pair_sum(tb(Jlp_w, Jll_w), l_line, Lc, l_pose, P)  # (L, P, 6, 4)
    Wx = _pair_sum(tb(Jpp_w, Jpx_w), p_point, M, p_pose, P)  # (M, P, 6, 3)

    # ---- damping -------------------------------------------------------
    lam = state.lam

    def damp(H, extra_eps):
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        return H + torch.diag_embed(lam * d + extra_eps)

    def eye(n):
        return torch.eye(n, dtype=Hpp.dtype, device=Hpp.device)

    Hpp_d = torch.where((prob.pose_free < 0.5)[:, None, None], eye(6), damp(Hpp, _EPS))
    Hll_d = torch.where((prob.line_valid < 0.5)[:, None, None], eye(4), damp(Hll, _EPS))
    Hxx_d = torch.where((prob.point_valid < 0.5)[:, None, None], eye(3), damp(Hxx, _EPS))
    Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
    Hxx_inv = torch.linalg.inv_ex(Hxx_d)[0]

    # ---- Schur complement: reduced camera system -----------------------
    Al = Wl.permute(0, 3, 1, 2).reshape(Lc, 4, P * 6)  # (L, 4, P6)
    Ax = Wx.permute(0, 3, 1, 2).reshape(M, 3, P * 6)  # (M, 3, P6)
    S_full = torch.einsum("pik,pq->piqk", Hpp_d, eye(P)).reshape(P * 6, P * 6)
    HinvAl = Hll_inv @ Al  # (L, 4, P6)
    HinvAx = Hxx_inv @ Ax
    S_full = S_full - torch.einsum("lai,laj->ij", Al, HinvAl)
    S_full = S_full - torch.einsum("mai,maj->ij", Ax, HinvAx)
    rhs = bp.reshape(P * 6) - torch.einsum("laj,la->j", HinvAl, bl) - torch.einsum("maj,ma->j", HinvAx, bx)
    S_full = S_full + _EPS * eye(P * 6)
    dp = torch.linalg.solve_ex(S_full, rhs)[0].reshape(P, 6) * prob.pose_free[:, None]

    # ---- back-substitution --------------------------------------------
    dl = (Hll_inv @ (bl - torch.einsum("lpia,pi->la", Wl, dp))[..., None])[..., 0] * prob.line_valid[:, None]
    dx = (Hxx_inv @ (bx - torch.einsum("mpia,pi->ma", Wx, dp))[..., None])[..., 0] * prob.point_valid[:, None]

    # ---- candidate + accept/reject ------------------------------------
    cand_poses = se3_retract(state.poses, dp)
    cand_lines = plucker_normalize(plucker_retract(state.lines, dl))
    cand_points = state.points + dx
    new_cost = _robust_cost(*_whitened_residuals(cand_poses, cand_lines, cand_points, prob, cam), prob, cfg)
    accept = new_cost < state.cost
    return BAState(
        poses=torch.where(accept, cand_poses, state.poses),
        lines=torch.where(accept, cand_lines, state.lines),
        points=torch.where(accept, cand_points, state.points),
        lam=torch.clamp(torch.where(accept, lam * cfg.lam_down, lam * cfg.lam_up), cfg.min_lam, cfg.max_lam),
        cost=torch.where(accept, new_cost, state.cost),
    )


def run_lm(prob: BAProblem, cam: Intrinsics, cfg: LMConfig = LMConfig()) -> BAState:
    """Run ``cfg.max_iters`` LM iterations, all on the problem's device."""
    rl0, rp0 = _whitened_residuals(prob.poses, prob.lines, prob.points, prob, cam)
    state = BAState(
        poses=prob.poses,
        lines=plucker_normalize(prob.lines),
        points=prob.points,
        lam=torch.full((), cfg.lam0, dtype=prob.poses.dtype, device=prob.poses.device),
        cost=_robust_cost(rl0, rp0, prob, cfg),
    )
    for _ in range(cfg.max_iters):
        state = _lm_iteration(state, prob, cam, cfg)
    return state


def chi2_outlier_mask(state: BAState, prob: BAProblem, cam: Intrinsics, chi2_line: float, chi2_point: float):
    """Per-observation inlier masks from whitened squared residual norms."""
    rl, rp = _whitened_residuals(state.poses, state.lines, state.points, prob, cam)
    inl_l = (torch.sum(rl * rl, dim=-1) < chi2_line).to(prob.l_valid.dtype) * prob.l_valid
    inl_p = (torch.sum(rp * rp, dim=-1) < chi2_point).to(prob.p_valid.dtype) * prob.p_valid
    return inl_l, inl_p
