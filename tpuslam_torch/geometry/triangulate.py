"""Two-view triangulation of points and Pluecker lines (torch).

Counterpart of ``tpuslam.geometry.triangulate``. A 3D line is the
intersection of the two planes back-projected from its image lines,
``pi_i = P_i^T l_i`` with ``P_i = K [R_i | t_i]`` (3x4, world -> image).
Writing ``pi_i = (a_i, d_i)``:

    v = a_1 x a_2            (line direction)
    n = d_1 a_2 - d_2 a_1    (line moment, n = p x v for p on the line)
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.camera import Intrinsics, intrinsic_matrix
from tpuslam_torch.geometry.se3 import se3_inverse

_EPS = 1e-9


def projection_matrix(cam: Intrinsics, T_cw: torch.Tensor) -> torch.Tensor:
    """World -> image 3x4 projection P = K [R | t] from a world -> camera pose."""
    return intrinsic_matrix(cam, T_cw.device, T_cw.dtype) @ T_cw[..., :3, :4]


def plane_from_image_line(P: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Back-project (..., 3) image lines through (..., 3, 4) P: pi = P^T l."""
    return (P.transpose(-1, -2) @ l[..., None])[..., 0]


def triangulate_plucker_two_view(P1: torch.Tensor, P2: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Image lines in two views -> world-frame Pluecker (..., 6) = [n, v].

    Degenerate when the two back-projected planes are parallel: |v| ~ 0
    (callers gate on it). Each plane is scaled to a unit normal first, which
    scales (n, v) uniformly and keeps float32's cancellation in
    n = d1 a2 - d2 a1 small against pixel-scale coefficients."""
    pi1 = plane_from_image_line(P1, l1)
    pi2 = plane_from_image_line(P2, l2)
    pi1 = pi1 / torch.clamp(torch.linalg.norm(pi1[..., :3], dim=-1, keepdim=True), min=_EPS)
    pi2 = pi2 / torch.clamp(torch.linalg.norm(pi2[..., :3], dim=-1, keepdim=True), min=_EPS)
    a1, d1 = pi1[..., :3], pi1[..., 3]
    a2, d2 = pi2[..., :3], pi2[..., 3]
    v = torch.linalg.cross(a1, a2, dim=-1)
    n = d1[..., None] * a2 - d2[..., None] * a1
    return torch.cat([n, v], dim=-1)


def triangulate_points(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """DLT point triangulation, batched: (..., 2) pixels in two views -> (..., 3).

    The smallest eigenvector of the 4x4 normal matrix A^T A, as the JAX
    package takes it."""
    rows = []
    for P, uv in ((P1, uv1), (P2, uv2)):
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        rows.append(u * P[..., 2, :] - P[..., 0, :])
        rows.append(v * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)  # (..., 4, 4)
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    X = V[..., :, 0]
    w = X[..., 3:4]
    Xh = X / torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)
    return Xh[..., :3]


def line_ray_endpoints(L: torch.Tensor, rays: torch.Tensor):
    """Points of (..., 6) camera-frame Pluecker lines closest to (..., 2, 3)
    unit viewing rays of a segment's endpoints (rays from the camera
    centre). Returns (points (..., 2, 3), s (..., 2) the ray parameters:
    s <= 0 puts the closest point behind the camera)."""
    n, v = L[..., :3], L[..., 3:]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    u = v / torch.clamp(vn, min=_EPS)
    p0 = torch.linalg.cross(v, n, dim=-1) / torch.clamp(vn * vn, min=_EPS)  # closest point to the origin
    u2 = u[..., None, :]
    p02 = p0[..., None, :]
    b = torch.sum(u2 * rays, dim=-1)  # (..., 2)
    wu = torch.sum(p02 * u2, dim=-1)
    wr = torch.sum(p02 * rays, dim=-1)
    denom = torch.clamp(1.0 - b * b, min=1e-9)
    t = (b * wr - wu) / denom
    s = (wr - b * wu) / denom
    return p02 + t[..., None] * u2, s


def stereo_depth_from_disparity(cam: Intrinsics, disparity: torch.Tensor) -> torch.Tensor:
    """Rectified stereo: z = fx * baseline / d (d at least 1e-6)."""
    return cam.fx * cam.baseline / torch.clamp(disparity, min=1e-6)


def relative_pose(T1_cw: torch.Tensor, T2_cw: torch.Tensor) -> torch.Tensor:
    """T_21, mapping camera-1 coordinates to camera-2 coordinates."""
    return T2_cw @ se3_inverse(T1_cw)
