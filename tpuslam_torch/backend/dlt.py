"""DLT-Lines: camera pose from 3D-line <-> 2D-line correspondences (torch).

Counterpart of ``tpuslam.backend.dlt``. Every image line l and any point X
on its 3D line satisfy l^T P X~ = 0 with P = K [R | t]; the two landmark
endpoints give two linear equations per line in the 12 entries of P. The
eigenvector of the smallest eigenvalue of the stacked normal matrix is P up
to scale, the signed cube root of the determinant of its left 3x3 block
recovers scale and sign at once, and an SVD re-orthonormalizes R. Image
lines are taken to normalized camera coordinates and the world points are
Hartley-normalized, so the float32 eigensolve is well conditioned.

torch has no ``cbrt``: the signed cube root is sign(d) |d|^(1/3). The signs
of the eigenvector and of the SVD factors do not matter: the signed scale
and the determinant fix absorb them.
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.camera import Intrinsics


def dlt_lines_pose(
    l2d: torch.Tensor,  # (M, 3) pixel-frame image-line coefficients
    Xw: torch.Tensor,  # (M, 2, 3) two world points per corresponding 3D line
    w: torch.Tensor,  # (M,) f32 {0, 1} correspondence validity
    cam: Intrinsics,
):
    """Returns (T_cw (4, 4), ok (f32 scalar)): ok < 0.5 flags a degenerate
    system (too few or ill-conditioned correspondences)."""
    M = l2d.shape[0]
    f32, dev = torch.float32, l2d.device
    nw = torch.clamp(torch.sum(w), min=1e-6)
    KT = torch.tensor([[cam.fx, 0.0, 0.0], [0.0, cam.fy, 0.0], [cam.cx, cam.cy, 1.0]], dtype=f32, device=dev)
    l = l2d @ KT.T
    l = l / (torch.linalg.norm(l[:, :2], dim=-1, keepdim=True) + 1e-12)
    mu = torch.sum(w[:, None, None] * Xw, dim=(0, 1)) / (2.0 * nw)
    dev_ = (Xw - mu) * w[:, None, None]
    sc = torch.sqrt(torch.sum(dev_**2) / (6.0 * nw)) + 1e-9
    Xn = (Xw - mu) / sc  # (M, 2, 3)

    # rows: the coefficient of P'_ij is l_i * X~_j
    Xh = torch.cat([Xn, torch.ones((M, 2, 1), dtype=f32, device=dev)], dim=-1)  # (M, 2, 4)
    A = (l[:, None, :, None] * Xh[:, :, None, :]).reshape(M * 2, 12)
    A = A * torch.repeat_interleave(w, 2)[:, None]
    G = A.T @ A  # (12, 12)
    _, evecs = torch.linalg.eigh(G)
    Pn = evecs[:, 0].reshape(3, 4)  # eigenvector of the smallest eigenvalue
    # denormalize: X~ = T_n X with T_n = [[I/sc, -mu/sc], [0, 1]]
    Tn = torch.eye(4, dtype=f32, device=dev)
    Tn[:3, :3] = Tn[:3, :3] / sc
    Tn[:3, 3] = -mu / sc
    B = Pn @ Tn  # (3, 4) ~ [R | t] up to signed scale

    det = torch.linalg.det(B[:, :3])
    s = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)  # signed scale: det(sR) = s^3
    ok_scale = torch.abs(s) > 1e-12
    B = B / torch.where(ok_scale, s, torch.ones_like(s))
    U, S, Vt = torch.linalg.svd(B[:, :3])
    D = torch.diag(torch.stack([torch.ones_like(s), torch.ones_like(s), torch.linalg.det(U @ Vt)]))
    T = torch.eye(4, dtype=f32, device=dev)
    T[:3, :3] = U @ D @ Vt
    T[:3, 3] = B[:, 3]

    # degeneracy flags: enough rows, non-vanishing scale, near-orthonormal B
    enough = nw >= 6.0
    rot_dev = torch.max(torch.abs(S / torch.clamp(S[0], min=1e-9) - 1.0))
    ok = enough.to(f32) * ok_scale.to(f32) * (rot_dev < 0.5).to(f32)
    return T, ok


def image_line_coeffs(endpoints: torch.Tensor) -> torch.Tensor:
    """(K, 2, 2) segment pixel endpoints -> (K, 3) homogeneous line coeffs."""
    ones = torch.ones_like(endpoints[:, 0, :1])
    return torch.linalg.cross(torch.cat([endpoints[:, 0], ones], -1), torch.cat([endpoints[:, 1], ones], -1), dim=-1)
