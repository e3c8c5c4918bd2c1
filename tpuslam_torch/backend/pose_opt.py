"""Pose-only optimization: the per-frame refine of the tracking path (torch).

Counterpart of ``tpuslam.backend.pose_opt.pose_optimize``: LM over one
SE(3) pose with the landmarks fixed, line observations and, when given,
point observations (the hybrid front end) in one normal system, ``rounds``
rounds of ``iters_per_round`` iterations with chi-squared re-gating between
rounds. The loops are Python loops over device tensors; the accept step is
a ``torch.where`` on the device, so nothing in them waits for the device.

The IRLS weights follow the JAX package's as written: its
``jnp.linalg.norm(r, -1)`` takes -1 as the norm's ``ord``, so each residual
family gets one Huber weight, from the matrix norm min_j sum_i |r_ij| over
all its rows, instead of one per observation (:func:`_family_norm`). With
lines alone that common weight cancels in the step (a Gauss-Newton step, the
Huber cost deciding acceptance); with both families it sets their relative
weight. Every tracker form takes this formula, stereo and mono: with one
weight per observation the lines-only LM left the JAX package's pose on
identical inputs (the semi-direct anchor 1.9e-4 m against 6.5e-6 m, the
monocular tracker 1e-2 m within 12 frames; ROADMAP.md section 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.backend.residuals import (
    huber_weight,
    line_residuals,
    line_residuals_and_pose_jacobian,
    point_residuals_and_jacobians,
)
from tpuslam_torch.geometry.camera import Intrinsics, project_points
from tpuslam_torch.geometry.plucker import plucker_retract
from tpuslam_torch.geometry.se3 import se3_apply, se3_retract

_EPS = 1e-8
_KLEIN_TOL = 1e-5  # |n.v| / (|n| |v|) beyond float32 rounding: off the Klein quadric


class PoseOptConfig(NamedTuple):
    rounds: int = 4
    iters_per_round: int = 4
    lam0: float = 1e-3
    huber_line: float = 2.0
    huber_point: float = 2.45
    chi2_line: float = 7.378  # 95% for 2 DoF
    chi2_point: float = 5.991


class PoseOptResult(NamedTuple):
    pose: torch.Tensor  # (4, 4)
    inlier_lines: torch.Tensor  # (KL,) final line-observation inlier mask
    inlier_points: torch.Tensor  # (KP,) final point-observation inlier mask (KP = 0 without points)
    cost: torch.Tensor  # final robust cost
    num_inliers: torch.Tensor  # inlier count (int32)


def _family_norm(r: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(r, -1)`` of an (N, 2) residual matrix: ord -1, the
    smallest column sum of absolute values."""
    return torch.amin(torch.sum(torch.abs(r), dim=0))


def _onto_klein_quadric(lines: torch.Tensor) -> torch.Tensor:
    """The JAX line residual passes each line through the orthonormal round
    trip, ``plucker_retract(L, 0)``. On a line off the Klein quadric that
    moves the line, not only its scale; on a line on it (every line the
    system builds, |n.v| / (|n| |v|) ~1e-7) it changes rounding alone, which
    the loop configuration amplifies into other keyframes. So the round trip
    is applied, once (the lines are fixed here), to the lines off the
    quadric by more than ``_KLEIN_TOL``, and the others keep their bits."""
    n, v = lines[..., :3], lines[..., 3:]
    off = torch.abs(torch.sum(n * v, dim=-1)) > _KLEIN_TOL * torch.linalg.norm(n, dim=-1) * torch.linalg.norm(v, dim=-1)
    ortho = plucker_retract(lines, torch.zeros(lines.shape[:-1] + (4,), dtype=lines.dtype, device=lines.device))
    return torch.where(off[..., None], ortho, lines)


def _huber(sq: torch.Tensor, delta: float) -> torch.Tensor:
    n = torch.sqrt(sq + _EPS)
    return torch.where(n <= delta, sq, 2.0 * delta * n - delta * delta)


def pose_optimize(
    T_init: torch.Tensor,
    lines: torch.Tensor,  # (KL, 6) world Pluecker lines matched to this frame
    l_endpoints: torch.Tensor,  # (KL, 2, 2) detected segment endpoints
    l_valid: torch.Tensor,  # (KL,)
    cam: Intrinsics,
    cfg: PoseOptConfig = PoseOptConfig(),
    l_sigma: Optional[torch.Tensor] = None,
    points: Optional[torch.Tensor] = None,  # (KP, 3) world points matched to this frame
    p_uv: Optional[torch.Tensor] = None,  # (KP, 2) their corner pixels
    p_valid: Optional[torch.Tensor] = None,  # (KP,)
    p_sigma: Optional[torch.Tensor] = None,
) -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks with re-gating."""
    KL = lines.shape[0]
    dev, dt = T_init.device, T_init.dtype
    if l_sigma is None:
        l_sigma = torch.ones((KL,), dtype=dt, device=dev)
    hybrid = points is not None
    if hybrid and p_sigma is None:
        p_sigma = torch.ones((points.shape[0],), dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    lines = _onto_klein_quadric(lines)

    def whitened(T):
        rl = line_residuals(T, lines, l_endpoints, cam) / l_sigma[:, None]
        rp = (project_points(cam, se3_apply(T, points)) - p_uv) / p_sigma[:, None] if hybrid else None
        return rl, rp

    def robust_cost(T, ml, mp):
        rl, rp = whitened(T)
        cost = torch.sum(_huber(torch.sum(rl * rl, dim=-1), cfg.huber_line) * ml)
        if hybrid:
            cost = cost + torch.sum(_huber(torch.sum(rp * rp, dim=-1), cfg.huber_point) * mp)
        return cost

    T = T_init
    ml = l_valid.to(dt)
    mp = p_valid.to(dt) if hybrid else None
    for _ in range(cfg.rounds):
        lam = torch.full((), cfg.lam0, dtype=dt, device=dev)  # a fill, not a host copy
        cost = robust_cost(T, ml, mp)
        for _ in range(cfg.iters_per_round):
            rl, Jl = line_residuals_and_pose_jacobian(T, lines, l_endpoints, cam)
            rl = rl / l_sigma[:, None]
            Jl = Jl / l_sigma[:, None, None]
            wl = huber_weight(_family_norm(rl), cfg.huber_line) * ml
            H = torch.einsum("oia,o,oib->ab", Jl, wl, Jl)
            b = torch.einsum("oia,o,oi->a", Jl, wl, rl)
            if hybrid:
                rp, Jp, _ = point_residuals_and_jacobians(T, points, p_uv, cam)
                rp = rp / p_sigma[:, None]
                Jp = Jp / p_sigma[:, None, None]
                wp = huber_weight(_family_norm(rp), cfg.huber_point) * mp
                H = H + torch.einsum("oia,o,oib->ab", Jp, wp, Jp)
                b = b + torch.einsum("oia,o,oi->a", Jp, wp, rp)
            Hd = H + lam * torch.diag(torch.diag(H)) + _EPS * eye6
            dx = torch.linalg.solve_ex(Hd, -b)[0]  # no error check: no device sync
            T_cand = se3_retract(T, dx)
            new_cost = robust_cost(T_cand, ml, mp)
            accept = new_cost < cost
            T = torch.where(accept, T_cand, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
            cost = torch.where(accept, new_cost, cost)
        rl, rp = whitened(T)
        ml = (torch.sum(rl * rl, dim=-1) < cfg.chi2_line).to(dt) * l_valid
        if hybrid:
            mp = (torch.sum(rp * rp, dim=-1) < cfg.chi2_point).to(dt) * p_valid
    n_in = torch.sum(ml) + (torch.sum(mp) if hybrid else 0.0)
    return PoseOptResult(
        pose=T,
        inlier_lines=ml,
        inlier_points=mp if hybrid else torch.zeros((0,), dtype=dt, device=dev),
        cost=robust_cost(T, ml, mp),
        num_inliers=n_in.to(torch.int32),
    )
