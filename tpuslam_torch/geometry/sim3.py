"""Sim(3) operations for monocular loop closure (torch).

Counterpart of ``tpuslam.geometry.sim3``. A similarity is a (..., 4, 4)
matrix ``S = [[s R, t], [0, 1]]`` acting on points as ``x' = s R x + t``. The
LM tangent is the product chart ``xi = [rho(3), phi(3), lam(1)]``,

    chart(xi) = [[exp(lam) so3_exp(phi), rho], [0, 1]],

with ``chart(0) = I`` and an exact local inverse (``sim3_chart_log``).
Outputs are built with ``stack``/``cat`` (no in-place writes), so
``torch.func`` can differentiate through them.
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.se3 import so3_exp, so3_log

_EPS = 1e-12


def sim3_make(s, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(scale, (..., 3, 3), (..., 3)) -> (..., 4, 4) similarity."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    top = torch.cat([s[..., None, None] * R, t[..., :, None]], dim=-1)
    zeros = torch.zeros(top.shape[:-2] + (1, 3), dtype=R.dtype, device=R.device)
    bottom = torch.cat([zeros, torch.ones_like(zeros[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    """s from the s R block: det(s R) = s^3 (the cube root taken in float64,
    as close to a rounded cbrt as the JAX package's)."""
    det = torch.clamp(torch.linalg.det(S[..., :3, :3]), min=_EPS)
    return (det.double() ** (1.0 / 3.0)).to(det.dtype)


def sim3_decompose(S: torch.Tensor):
    """-> (s, R, t)."""
    s = sim3_scale(S)
    return s, S[..., :3, :3] / s[..., None, None], S[..., :3, 3]


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    s, R, t = sim3_decompose(S)
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t)
    return sim3_make(s_inv, Rt, t_inv)


def sim3_apply(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """x' = s R x + t for (..., 3) points."""
    return torch.einsum("...ij,...j->...i", S[..., :3, :3], pts) + S[..., :3, 3]


def sim3_chart(xi: torch.Tensor) -> torch.Tensor:
    """xi (..., 7) = [rho, phi, lam] -> (..., 4, 4) similarity."""
    return sim3_make(torch.exp(xi[..., 6]), so3_exp(xi[..., 3:6]), xi[..., :3])


def sim3_chart_log(S: torch.Tensor) -> torch.Tensor:
    """Inverse of sim3_chart: (..., 4, 4) -> (..., 7)."""
    s, R, t = sim3_decompose(S)
    return torch.cat([t, so3_log(R), torch.log(torch.clamp(s, min=_EPS))[..., None]], dim=-1)


def sim3_retract(S: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-perturbation retraction S <- chart(xi) @ S (AD-safe at xi = 0)."""
    return sim3_chart(xi) @ S


def sim3_from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    """SE(3) pose (R, t) and a scale -> the similarity (s R, t)."""
    return sim3_make(torch.as_tensor(s, dtype=T.dtype, device=T.device), T[..., :3, :3], T[..., :3, 3])


def se3_from_sim3(S: torch.Tensor) -> torch.Tensor:
    """The corrected camera pose of a world->camera similarity: [R | t / s]
    (the camera centre re-expressed in the rescaled world)."""
    s, R, t = sim3_decompose(S)
    top = torch.cat([R, (t / s[..., None])[..., :, None]], dim=-1)
    zeros = torch.zeros(top.shape[:-2] + (1, 3), dtype=S.dtype, device=S.device)
    bottom = torch.cat([zeros, torch.ones_like(zeros[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def plucker_transform_sim3(S: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """A Pluecker line (n, v) moved by S = (s, R, t): v' = R v and
    n' = s R n + t x R v (the common factor s of p' x q' dropped)."""
    s, R, t = sim3_decompose(S)
    Rv = torch.einsum("...ij,...j->...i", R, L[..., 3:])
    Rn = torch.einsum("...ij,...j->...i", R, L[..., :3])
    return torch.cat([s[..., None] * Rn + torch.linalg.cross(t, Rv, dim=-1), Rv], dim=-1)
