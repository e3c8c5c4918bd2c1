"""Pluecker 3D lines and the orthonormal 4-DoF parameterization (torch).

Same conventions as ``tpuslam.geometry.plucker``: a line is a (..., 6)
tensor ``[n, v]`` (moment, direction); the landmark retraction updates the
orthonormal form ``U <- U exp([d0,d1,d2]^)``, ``theta <- theta + d3``.
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.se3 import so3_exp

_EPS = 1e-9


def plucker_from_points(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Line through 3D points p, q: (..., 6) = [n, v], v = q - p, n = p x q."""
    return torch.cat([torch.linalg.cross(p, q, dim=-1), q - p], dim=-1)


def plucker_normalize(L: torch.Tensor) -> torch.Tensor:
    """Storage form: |v| = 1 and the Klein constraint re-projected
    (n <- n - (n.v_hat) v_hat)."""
    n, v = L[..., :3], L[..., 3:]
    v_norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    v_hat = v / torch.clamp(v_norm, min=_EPS)
    n_proj = n - torch.sum(n * v_hat, dim=-1, keepdim=True) * v_hat
    return torch.cat([n_proj, v_hat * v_norm], dim=-1) / torch.clamp(v_norm, min=_EPS)


def plucker_transform(T: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Transform (..., 6) Pluecker lines by (..., 4, 4) SE(3): world -> camera."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    n, v = L[..., :3], L[..., 3:]
    Rv = (R @ v[..., None])[..., 0]
    n_c = (R @ n[..., None])[..., 0] + torch.linalg.cross(t.expand_as(Rv), Rv, dim=-1)
    return torch.cat([n_c, Rv], dim=-1)


def plucker_to_orthonormal(L: torch.Tensor):
    """(..., 6) -> (U (..., 3, 3), theta (...,)); |n| ~ 0 handled with a
    fallback unit vector orthogonal to v."""
    n, v = L[..., :3], L[..., 3:]
    n_norm = torch.linalg.norm(n, dim=-1)
    v_norm = torch.linalg.norm(v, dim=-1)
    v_hat = v / torch.clamp(v_norm, min=_EPS)[..., None]
    smallest = torch.argmin(torch.abs(v_hat), dim=-1)
    e = torch.eye(3, dtype=L.dtype, device=L.device)[smallest]
    fallback = torch.linalg.cross(v_hat, e, dim=-1)
    fallback = fallback / torch.clamp(torch.linalg.norm(fallback, dim=-1, keepdim=True), min=_EPS)
    degen = (n_norm < 1e-7)[..., None]
    u1 = torch.where(degen, fallback, n / torch.clamp(n_norm, min=_EPS)[..., None])
    u1 = u1 - torch.sum(u1 * v_hat, dim=-1, keepdim=True) * v_hat
    u1 = u1 / torch.clamp(torch.linalg.norm(u1, dim=-1, keepdim=True), min=_EPS)
    u2 = v_hat
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)  # columns
    theta = torch.atan2(v_norm, n_norm)
    return U, theta


def orthonormal_to_plucker(U: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`plucker_to_orthonormal` (up to the global line scale)."""
    w1 = torch.cos(theta)[..., None]
    w2 = torch.sin(theta)[..., None]
    return torch.cat([w1 * U[..., :, 0], w2 * U[..., :, 1]], dim=-1)


def plucker_retract(L: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """4-DoF orthonormal update around L (delta = [dU (3,), dtheta])."""
    U, theta = plucker_to_orthonormal(L)
    U_new = U @ so3_exp(delta[..., :3])
    return orthonormal_to_plucker(U_new, theta + delta[..., 3])


def plucker_closest_point(L: torch.Tensor) -> torch.Tensor:
    """The line's point closest to the origin: (v x n) / |v|^2."""
    n, v = L[..., :3], L[..., 3:]
    v2 = torch.sum(v * v, dim=-1, keepdim=True)
    return torch.linalg.cross(v, n, dim=-1) / torch.clamp(v2, min=_EPS)


def plucker_distance_to_origin(L: torch.Tensor) -> torch.Tensor:
    """|n| / |v|."""
    n, v = L[..., :3], L[..., 3:]
    return torch.linalg.norm(n, dim=-1) / torch.clamp(torch.linalg.norm(v, dim=-1), min=_EPS)


def plucker_point_at(L: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The point closest to the origin plus t times the unit direction."""
    v = L[..., 3:]
    v_hat = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=_EPS)
    return plucker_closest_point(L) + t[..., None] * v_hat
