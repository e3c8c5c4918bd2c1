"""Pinhole camera model: point projection and Pluecker line projection (torch).

Zero distortion only (rectified stereo input); the radtan model of
``tpuslam.geometry.camera`` is not ported yet.
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
    """Radial-tangential coefficients (the front end takes zeros only)."""

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
    asks for it every LM iteration). Do not modify the returned tensor."""
    return _line_projection_matrix(cam, str(torch.device("cpu") if device is None else torch.device(device)))


def project_points(cam: Intrinsics, pts_c: torch.Tensor) -> torch.Tensor:
    """Camera-frame (..., 3) points -> (..., 2) pixels (no distortion)."""
    z = torch.clamp(pts_c[..., 2:3], min=_EPS)
    u = cam.fx * (pts_c[..., 0:1] / z) + cam.cx
    v = cam.fy * (pts_c[..., 1:2] / z) + cam.cy
    return torch.cat([u, v], dim=-1)


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
