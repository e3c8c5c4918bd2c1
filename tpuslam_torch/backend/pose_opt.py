"""Pose-only optimization: the per-frame refine of the tracking path (torch).

Counterpart of ``tpuslam.backend.pose_opt.pose_optimize`` for line
observations: LM over one SE(3) pose with the landmarks fixed, ``rounds``
rounds of ``iters_per_round`` iterations with chi-squared re-gating between
rounds. The loops are Python loops over device tensors; the accept step is
a ``torch.where`` on the device, so nothing in them waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.backend.residuals import (
    huber_weight,
    line_residuals,
    line_residuals_and_pose_jacobian,
)
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.geometry.se3 import se3_retract

_EPS = 1e-8


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
    cost: torch.Tensor  # final robust cost
    num_inliers: torch.Tensor  # inlier count (int32)


def pose_optimize(
    T_init: torch.Tensor,
    lines: torch.Tensor,  # (KL, 6) world Pluecker lines matched to this frame
    l_endpoints: torch.Tensor,  # (KL, 2, 2) detected segment endpoints
    l_valid: torch.Tensor,  # (KL,)
    cam: Intrinsics,
    cfg: PoseOptConfig = PoseOptConfig(),
    l_sigma: Optional[torch.Tensor] = None,
) -> PoseOptResult:
    """Optimize one camera pose against fixed line landmarks with re-gating."""
    KL = lines.shape[0]
    dev, dt = T_init.device, T_init.dtype
    if l_sigma is None:
        l_sigma = torch.ones((KL,), dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def whitened(T):
        return line_residuals(T, lines, l_endpoints, cam) / l_sigma[:, None]

    def robust_cost(T, ml):
        rl = whitened(T)
        sq = torch.sum(rl * rl, dim=-1)
        n = torch.sqrt(sq + _EPS)
        h = torch.where(n <= cfg.huber_line, sq, 2.0 * cfg.huber_line * n - cfg.huber_line * cfg.huber_line)
        return torch.sum(h * ml)

    T = T_init
    ml = l_valid.to(dt)
    for _ in range(cfg.rounds):
        lam = torch.full((), cfg.lam0, dtype=dt, device=dev)  # a fill, not a host copy
        cost = robust_cost(T, ml)
        for _ in range(cfg.iters_per_round):
            rl, Jl = line_residuals_and_pose_jacobian(T, lines, l_endpoints, cam)
            rl = rl / l_sigma[:, None]
            Jl = Jl / l_sigma[:, None, None]
            wl = huber_weight(torch.linalg.norm(rl, dim=-1), cfg.huber_line) * ml
            H = torch.einsum("oia,o,oib->ab", Jl, wl, Jl)
            b = -torch.einsum("oia,o,oi->a", Jl, wl, rl)
            Hd = H + lam * torch.diag(torch.diag(H)) + _EPS * eye6
            dx = torch.linalg.solve_ex(Hd, b)[0]  # no error check: no device sync
            T_cand = se3_retract(T, dx)
            new_cost = robust_cost(T_cand, ml)
            accept = new_cost < cost
            T = torch.where(accept, T_cand, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
            cost = torch.where(accept, new_cost, cost)
        rl = whitened(T)
        ml = (torch.sum(rl * rl, dim=-1) < cfg.chi2_line).to(dt) * l_valid
    return PoseOptResult(
        pose=T,
        inlier_lines=ml,
        cost=robust_cost(T, ml),
        num_inliers=torch.sum(ml).to(torch.int32),
    )
