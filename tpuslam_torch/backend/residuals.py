"""Line and point reprojection residuals and their Jacobians (torch).

Counterpart of ``tpuslam.backend.residuals``. The residual of one line
observation is the signed distance of the two detected endpoints to the
projected line,

    l = K_L n_c,   e = [x_s^T l, x_e^T l] / sqrt(l1^2 + l2^2 + eps);

a point's is its pixel reprojection error. The JAX package takes the
Jacobians by forward-mode AD through the retractions at zero tangent; the
``*_and_*jacobian*`` functions here write them out:

- pose (left perturbation exp(xi^) T): the camera-frame moment moves by
  dn = [rho]x v_c + [phi]x n_c, so dn/d(rho, phi) = [-[v_c]x, -[n_c]x]; a
  camera-frame point moves by dX = rho - [X_c]x phi;
- line landmark (U <- U exp(d^), theta <- theta + d3 on the orthonormal
  form): at d = 0, with U = [u1, u2, u3], the line (|n| u1, |v| u2) moves by
  dn = -|n| u3 d1 + |n| u2 d2 - |v| u1 d3, dv = |v| u3 d0 - |v| u1 d2
  + |n| u2 d3 (the residual is scale-free, so the unit-scale retraction's
  derivative is taken at the stored scale);
- point landmark: dX_c/dx = R.
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.camera import Intrinsics, line_projection_matrix, project_points
from tpuslam_torch.geometry.plucker import plucker_retract, plucker_to_orthonormal, plucker_transform
from tpuslam_torch.geometry.se3 import se3_apply, se3_retract, so3_hat

_EPS = 1e-9


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _endpoint_distances(l: torch.Tensor, endpoints: torch.Tensor):
    """(..., 3) image lines, (..., 2, 2) endpoints -> (..., 2) signed distances
    and the normaliser sqrt(l0^2 + l1^2 + eps)."""
    norm = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2 + _EPS)
    num = torch.stack(
        [torch.sum(_homog(endpoints[..., 0, :]) * l, dim=-1), torch.sum(_homog(endpoints[..., 1, :]) * l, dim=-1)],
        dim=-1,
    )
    return num / norm[..., None], norm


def line_residual(
    xi: torch.Tensor,
    delta: torch.Tensor,
    T_cw: torch.Tensor,
    L_w: torch.Tensor,
    endpoints: torch.Tensor,
    cam: Intrinsics,
) -> torch.Tensor:
    """Residual of line observations at tangent (xi (..., 6), delta (..., 4)).

    endpoints: (..., 2, 2) detected segment endpoints in pixels. Returns
    (..., 2) signed endpoint-to-line distances in pixels."""
    T = se3_retract(T_cw, xi)
    L_c = plucker_transform(T, plucker_retract(L_w, delta))
    KL = line_projection_matrix(cam, device=L_c.device).to(L_c.dtype)
    l = (KL @ L_c[..., :3, None])[..., 0]
    return _endpoint_distances(l, endpoints)[0]


def point_residual(
    xi: torch.Tensor,
    dx: torch.Tensor,
    T_cw: torch.Tensor,
    X_w: torch.Tensor,
    uv: torch.Tensor,
    cam: Intrinsics,
) -> torch.Tensor:
    """Residual of point observations at tangent (xi (..., 6), dx (..., 3)):
    (..., 2) pixel error, projected minus measured."""
    return project_points(cam, se3_apply(se3_retract(T_cw, xi), X_w + dx)) - uv


def _project(T_cw, L_w, cam):
    """Camera-frame lines and their image lines (..., 3)."""
    L_c = plucker_transform(T_cw, L_w)
    KL = line_projection_matrix(cam, device=L_c.device).to(L_c.dtype)
    return L_c, (KL @ L_c[..., :3, None])[..., 0], KL


def line_residuals(T_cw: torch.Tensor, L_w: torch.Tensor, endpoints: torch.Tensor, cam: Intrinsics) -> torch.Tensor:
    """:func:`line_residual` at zero tangent without the retractions: the
    residual is invariant to the line's scale, which is all the orthonormal
    round trip changes for lines that satisfy the Klein constraint
    (``pose_opt.pose_optimize`` applies it once to lines that do not)."""
    return _endpoint_distances(_project(T_cw, L_w, cam)[1], endpoints)[0]


def _line_jacobian_parts(T_cw, L_w, endpoints, cam):
    """Residuals, dr/dl (N, 2, 3) and the pose Jacobian's moment part."""
    L_c, l, KL = _project(T_cw, L_w, cam)
    n_c, v_c = L_c[..., :3], L_c[..., 3:]
    r, norm = _endpoint_distances(l, endpoints)
    dn = -torch.cat([so3_hat(v_c), so3_hat(n_c)], dim=-1)  # (N, 3, 6)
    x = _homog(endpoints)  # (N, 2, 3)
    grad_norm = torch.stack([l[..., 0], l[..., 1], torch.zeros_like(l[..., 0])], dim=-1)  # (N, 3)
    dr_dl = x / norm[..., None, None] - (r / (norm * norm)[..., None])[..., None] * grad_norm[..., None, :]
    return r, dr_dl, KL, dn


def line_residuals_and_pose_jacobian(
    T_cw: torch.Tensor, L_w: torch.Tensor, endpoints: torch.Tensor, cam: Intrinsics
):
    """Residuals (N, 2) of N line observations at pose T_cw and their
    Jacobians (N, 2, 6) w.r.t. the left pose perturbation xi at xi = 0."""
    r, dr_dl, KL, dn = _line_jacobian_parts(T_cw, L_w, endpoints, cam)
    return r, dr_dl @ (KL @ dn)


def line_residuals_and_jacobians(
    T_cw: torch.Tensor, L_w: torch.Tensor, endpoints: torch.Tensor, cam: Intrinsics
):
    """Residuals (N, 2), pose Jacobians (N, 2, 6) and landmark Jacobians
    (N, 2, 4) of N line observations at zero tangent (T_cw (N, 4, 4), L_w
    (N, 6) satisfying the Klein constraint)."""
    r, dr_dl, KL, dn = _line_jacobian_parts(T_cw, L_w, endpoints, cam)
    U, _ = plucker_to_orthonormal(L_w)
    u1, u2, u3 = U[..., 0], U[..., 1], U[..., 2]
    nn = torch.linalg.norm(L_w[..., :3], dim=-1, keepdim=True)
    vn = torch.linalg.norm(L_w[..., 3:], dim=-1, keepdim=True)
    z = torch.zeros_like(u1)
    dn_w = torch.stack([z, -nn * u3, nn * u2, -vn * u1], dim=-1)  # (N, 3, 4)
    dv_w = torch.stack([vn * u3, z, -vn * u1, nn * u2], dim=-1)
    R, t = T_cw[..., :3, :3], T_cw[..., :3, 3]
    dn_c = R @ dn_w + so3_hat(t) @ (R @ dv_w)
    return r, dr_dl @ (KL @ dn), dr_dl @ (KL @ dn_c)


def point_residuals_and_jacobians(T_cw: torch.Tensor, X_w: torch.Tensor, uv: torch.Tensor, cam: Intrinsics):
    """Residuals (N, 2), pose Jacobians (N, 2, 6) and point Jacobians
    (N, 2, 3) of N point observations at zero tangent."""
    X_c = se3_apply(T_cw, X_w)
    r = project_points(cam, X_c) - uv
    z = X_c[..., 2]
    zc = torch.clamp(z, min=_EPS)
    live = (z > _EPS).to(z.dtype)  # the clamp's derivative
    zero = torch.zeros_like(z)
    dpi = torch.stack(
        [
            torch.stack([cam.fx / zc, zero, -cam.fx * X_c[..., 0] / (zc * zc) * live], dim=-1),
            torch.stack([zero, cam.fy / zc, -cam.fy * X_c[..., 1] / (zc * zc) * live], dim=-1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    eye = torch.eye(3, dtype=X_c.dtype, device=X_c.device).expand(X_c.shape[:-1] + (3, 3))
    dX_dxi = torch.cat([eye, -so3_hat(X_c)], dim=-1)  # (N, 3, 6)
    return r, dpi @ dX_dxi, dpi @ T_cw[..., :3, :3]


def huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel: w = min(1, delta / |r|)."""
    return torch.clamp(delta / torch.clamp(r_norm, min=_EPS), max=1.0)
