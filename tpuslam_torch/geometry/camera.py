"""Pinhole camera model: point projection, Pluecker line projection and the
radial-tangential distortion model (torch).

Counterpart of ``tpuslam.geometry.camera``. Projection assumes ideal
(undistorted) pixels; a camera with radtan distortion is handled at the
feature level: segments are detected on the distorted image and their
endpoints undistorted (:func:`undistort_pixels`, ``frontend/frame.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

_EPS = 1e-9


class Intrinsics(NamedTuple):
    """Pinhole intrinsics; same fields and defaults as the JAX package's."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    baseline: float = 0.0  # stereo baseline in meters (0 => monocular)


class Distortion(NamedTuple):
    """Radial-tangential (OpenCV "radtan") coefficients: zeros for rectified
    stereo, non-zero for TUM fr1/fr2 and raw EuRoC."""

    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @property
    def is_zero(self) -> bool:
        return self.k1 == 0.0 and self.k2 == 0.0 and self.p1 == 0.0 and self.p2 == 0.0


@functools.lru_cache(maxsize=32)
def _line_projection_matrix(cam: Intrinsics, device: str) -> torch.Tensor:
    return torch.tensor(
        [
            [cam.fy, 0.0, 0.0],
            [0.0, cam.fx, 0.0],
            [-cam.fy * cam.cx, -cam.fx * cam.cy, cam.fx * cam.fy],
        ],
        dtype=torch.float32,
        device=device,
    )


def line_projection_matrix(cam: Intrinsics, device=None) -> torch.Tensor:
    """K_L such that l = K_L @ n_c projects the line moment to image-line
    coeffs (one copy per camera and device, built once: the tracking loop
    asks for it every LM iteration). Do not modify the returned tensor.

    A camera whose fields are tensors (one sequence's row of a batch of
    calibrations, ``parallel.multi_seq.cam_batch``, under ``torch.func.vmap``)
    gets its matrix built from them, the products in float32 as the JAX
    package forms them under its vmap."""
    if isinstance(cam.fx, torch.Tensor):
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        zero = torch.zeros_like(fx)
        return torch.stack([
            torch.stack([fy, zero, zero]),
            torch.stack([zero, fx, zero]),
            torch.stack([-fy * cx, -fx * cy, fx * fy]),
        ])
    return _line_projection_matrix(cam, str(torch.device("cpu") if device is None else torch.device(device)))


def project_points(cam: Intrinsics, pts_c: torch.Tensor) -> torch.Tensor:
    """Camera-frame (..., 3) points -> (..., 2) pixels (no distortion)."""
    z = torch.clamp(pts_c[..., 2:3], min=_EPS)
    u = cam.fx * (pts_c[..., 0:1] / z) + cam.cx
    v = cam.fy * (pts_c[..., 1:2] / z) + cam.cy
    return torch.cat([u, v], dim=-1)


def backproject_pixels(cam: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels and (...,) depths -> (..., 3) camera-frame points."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def project_plucker_line(cam: Intrinsics, L_c: torch.Tensor) -> torch.Tensor:
    """Camera-frame Pluecker lines (..., 6) -> image-line coefficients (..., 3)."""
    KL = line_projection_matrix(cam, L_c.device)
    return (KL @ L_c[..., :3, None])[..., 0]


@functools.lru_cache(maxsize=32)
def _intrinsic_matrix(cam: Intrinsics, device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def intrinsic_matrix(cam: Intrinsics, device=None, dtype=torch.float32) -> torch.Tensor:
    """The 3x3 calibration matrix K (the JAX package's ``Intrinsics.K``), one
    copy per camera, device and dtype (the mapper asks for it at every
    keyframe). Do not modify the returned tensor."""
    return _intrinsic_matrix(cam, str(torch.device("cpu") if device is None else torch.device(device)), dtype)


def image_line_through(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Homogeneous image line through two (..., 2) pixels: l = p_h x q_h."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    qh = torch.cat([q, torch.ones_like(q[..., :1])], dim=-1)
    return torch.linalg.cross(ph, qh, dim=-1)


def point_line_distance(l: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Signed distance of (..., 2) pixels to (..., 3) homogeneous image lines."""
    num = l[..., 0] * uv[..., 0] + l[..., 1] * uv[..., 1] + l[..., 2]
    den = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return num / torch.clamp(den, min=_EPS)


def _distort_normalized(dist: Distortion, x: torch.Tensor, y: torch.Tensor):
    r2 = x * x + y * y
    radial = 1.0 + dist.k1 * r2 + dist.k2 * r2 * r2
    xd = x * radial + 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
    return xd, yd


def undistort_pixels(cam: Intrinsics, dist: Distortion, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """(..., 2) distorted pixels -> (..., 2) ideal pinhole pixels: the
    fixed-point inversion of the radtan model (OpenCV's undistortPoints
    iteration), ``iters`` rounds with the radial factor floored at 1e-6."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = torch.clamp(1.0 + dist.k1 * r2 + dist.k2 * r2 * r2, min=1e-6)
        dx = 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
        dy = dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy], dim=-1)


def distort_pixels(cam: Intrinsics, dist: Distortion, uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) ideal pinhole pixels -> distorted pixels (the forward model)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    xd, yd = _distort_normalized(dist, x, y)
    return torch.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], dim=-1)
