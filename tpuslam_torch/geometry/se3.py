"""SE(3) Lie group operations on 4x4 homogeneous matrices (torch).

Same conventions as ``tpuslam.geometry.se3``: a pose ``T`` is a (..., 4, 4)
world->camera transform, the tangent is ``xi = [rho, phi]``, and the LM
retraction is the left perturbation ``T <- exp(xi^) @ T``.

Every function broadcasts over leading batch dimensions and builds its
outputs with ``stack``/``cat`` (no in-place writes), so ``torch.func``
transforms can differentiate through them. The small-angle branches use
``torch.where`` with safe denominators, keeping gradients finite at zero.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix [w]_x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _theta2_coeffs(t2: torch.Tensor):
    """sin(x)/x, (1-cos x)/x^2, (x-sin x)/x^3 as AD-safe functions of x^2."""
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (safe_t2 * t))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    t2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _theta2_coeffs(t2)
    W = so3_hat(phi)
    W2 = W @ W
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * W2


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(phi) = I + cosc*W + sinc3*W^2 (AD-safe at 0)."""
    t2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _theta2_coeffs(t2)
    W = so3_hat(phi)
    W2 = W @ W
    return _eye3(W) + b[..., None, None] * W + c[..., None, None] * W2


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle.

    theta / sin(theta) * w, with w = vee(R - R^T) / 2 = sin(theta) * axis; the
    factor is an even function of theta, smooth in sin^2, so the gradient is
    finite at the identity. Within 0.999 of cos = -1 the axis comes from the
    column of R + I with the largest diagonal entry."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = so3_vee(R - R.transpose(-1, -2)) * 0.5
    s2 = torch.sum(w * w, dim=-1)

    small = s2 < 1e-10
    sin_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta_g = torch.atan2(sin_safe, cos_theta)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta_g / sin_safe)
    phi_generic = scale[..., None] * w
    theta = torch.where(small, torch.sqrt(torch.clamp(s2, min=0.0)), theta_g)

    near_pi = cos_theta < -0.999
    Rp = R + _eye3(R)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(Rp, k[..., None, None].expand(k.shape + (3, 1)), dim=-1)[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    phi_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian V^-1 = I - W/2 + k(theta) W^2, with
    k = (1 - theta cot(theta / 2) / 2) / theta^2 even in theta (AD-safe at 0)."""
    t2 = torch.sum(phi * phi, dim=-1)
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe_t2)
    cot_term = torch.where(small, 1.0 / 12.0 + t2 / 720.0, (1.0 - 0.5 * t / torch.tan(0.5 * t)) / safe_t2)
    W = so3_hat(phi)
    return _eye3(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) [[R, t], [0, 1]]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    zeros = torch.zeros(R.shape[:-2] + (1, 3), dtype=R.dtype, device=R.device)
    bottom = torch.cat([zeros, torch.ones_like(zeros[..., :1])], dim=-1)  # no host->device copy
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, phi] -> (..., 4, 4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return _homogeneous(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = (_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block onto SO(3) (Gram-Schmidt), keep t.

    Kept exactly as the JAX package has it: a pose chain fed back through
    ``se3_inverse`` (a transpose) amplifies any drift off SO(3) every cycle.
    """
    R = T[..., :3, :3]
    r0 = R[..., :, 0]
    r0 = r0 / torch.clamp(torch.linalg.norm(r0, dim=-1, keepdim=True), min=1e-12)
    r1 = R[..., :, 1]
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    Rn = torch.stack([r0, r1, r2], dim=-1)
    return _homogeneous(Rn, T[..., :3, 3])


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a (..., 4, 4) rigid transform: [[R^T, -R^T t], [0, 1]]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform (..., 3) points by (..., 4, 4)."""
    return (T[..., :3, :3] @ pts[..., None])[..., 0] + T[..., :3, 3]


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-perturbation retraction T <- exp(xi^) @ T used by the pose LM."""
    return se3_exp(xi) @ T
