"""Line reprojection residual and its pose Jacobian (torch).

Counterpart of ``tpuslam.backend.residuals`` (line residual only; the point
residual comes with hybrid points). The residual of one observation is the
signed distance of the two detected endpoints to the projected line,

    l = K_L n_c,   e = [x_s^T l, x_e^T l] / sqrt(l1^2 + l2^2 + eps).

The JAX package takes the pose Jacobian by forward-mode AD through the
retraction at zero tangent; :func:`line_residuals_and_pose_jacobian` writes
it out. At xi = 0 the left perturbation exp(xi^) moves the camera-frame
moment by dn = [rho]x v_c + [phi]x n_c, so dn/d(rho, phi) = [-[v_c]x, -[n_c]x].
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.camera import Intrinsics, line_projection_matrix
from tpuslam_torch.geometry.plucker import plucker_retract, plucker_transform
from tpuslam_torch.geometry.se3 import se3_retract, so3_hat

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


def _project(T_cw, L_w, cam):
    """Camera-frame lines and their image lines (..., 3)."""
    L_c = plucker_transform(T_cw, L_w)
    KL = line_projection_matrix(cam, device=L_c.device).to(L_c.dtype)
    return L_c, (KL @ L_c[..., :3, None])[..., 0], KL


def line_residuals(T_cw: torch.Tensor, L_w: torch.Tensor, endpoints: torch.Tensor, cam: Intrinsics) -> torch.Tensor:
    """:func:`line_residual` at zero tangent without the retractions: the
    residual is invariant to the line's scale, which is all the orthonormal
    round trip changes (for lines that satisfy the Klein constraint)."""
    return _endpoint_distances(_project(T_cw, L_w, cam)[1], endpoints)[0]


def line_residuals_and_pose_jacobian(
    T_cw: torch.Tensor, L_w: torch.Tensor, endpoints: torch.Tensor, cam: Intrinsics
):
    """Residuals (N, 2) of N line observations at pose T_cw and their
    Jacobians (N, 2, 6) w.r.t. the left pose perturbation xi at xi = 0."""
    L_c, l, KL = _project(T_cw, L_w, cam)
    n_c, v_c = L_c[:, :3], L_c[:, 3:]
    r, norm = _endpoint_distances(l, endpoints)
    dn = -torch.cat([so3_hat(v_c), so3_hat(n_c)], dim=-1)  # (N, 3, 6)
    dl = KL @ dn  # (N, 3, 6)
    x = _homog(endpoints)  # (N, 2, 3)
    grad_norm = torch.stack([l[:, 0], l[:, 1], torch.zeros_like(l[:, 0])], dim=-1)  # (N, 3)
    dr_dl = x / norm[:, None, None] - (r / (norm * norm)[:, None])[..., None] * grad_norm[:, None, :]
    return r, dr_dl @ dl


def huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel: w = min(1, delta / |r|)."""
    return torch.clamp(delta / torch.clamp(r_norm, min=_EPS), max=1.0)
