"""Per-frame feature extraction and stereo association (torch).

Counterpart of ``tpuslam.frontend.frame``: pyramid -> line detection -> LBD
per level, the levels merged into one fixed-capacity set in level-0 pixel
coordinates, and descriptor stereo for endpoint depths. At ``base_scale``
below 1 the detector runs on a smaller image and the merged geometry is
reported in full-resolution pixels. The smaller image comes either from the
host (``prescaled=True``: :func:`host_prescale` halves each frame before it
goes to the device) or from the device (the in-program resize: a mild
Gaussian, then the antialiased linear resize of ``jax.image.resize``).
With radtan distortion (``dist`` and ``cam``) detection runs on the
distorted image and the segment geometry is undistorted afterwards.

:func:`extract_features` also takes a (B, H, W) batch of images of one
shape (``tpuslam/parallel/multi_seq.py`` batched_extract vmaps the JAX
extractor over them): the kernels run batched, one set of launches for the
batch, and the eager steps between them carry the leading axis (the
detector and the LBD pooling written for it, the level merge through
``torch.func.vmap``, which cannot pass through the ctypes kernels but needs
none inside it). The pyramid's resize and the LBD's band sums are matrix
products, which run per image (cuBLAS rounds a batched product unlike its
single ones). Every field of the result then carries the B axis, each
image's equal to its own call's, on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch.geometry.camera import Distortion, Intrinsics, undistort_pixels
from tpuslam_torch.kernels.image import (
    build_pyramid,
    gaussian_blur,
    gaussian_blur_batch,
    gradients_xy,
    gradients_xy_batch,
    resize_linear,
    sqrt_rn,
)
from tpuslam_torch.kernels.lbd import LBDParams, lbd_descriptors
from tpuslam_torch.kernels.lsd import DetectedLines, LSDParams, detect_lines, topk_stable
from tpuslam_torch.kernels.match import (
    MatchParams,
    angle_penalty,
    length_ratio_penalty,
    match_descriptors,
    stereo_row_penalty,
)


class FrontendParams(NamedTuple):
    max_lines: int = 256  # merged per-frame capacity K
    n_levels: int = 2
    scale: float = 0.8
    # detect + describe at this fraction of the input resolution; geometry is
    # reported at full resolution (sigma scaled up)
    base_scale: float = 1.0
    # the caller (Tracker.track_stereo) downscales each frame to base_scale
    # on the host with host_prescale before it goes to the device; without
    # it extract_features resizes on the device
    prescaled: bool = False
    lsd: LSDParams = LSDParams()
    lbd: LBDParams = LBDParams()
    # radtan distortion: detection on the distorted image, the segment
    # geometry undistorted afterwards (``cam`` required when non-zero);
    # stereo association still assumes rectified cameras
    dist: Distortion = Distortion()
    cam: Optional[Intrinsics] = None


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame line features (level-0 pixel coords)."""

    endpoints: torch.Tensor  # (K, 2, 2)
    valid: torch.Tensor  # (K,) f32 {0, 1}
    angle: torch.Tensor  # (K,)
    length: torch.Tensor  # (K,)
    midpoint: torch.Tensor  # (K, 2)
    response: torch.Tensor  # (K,)
    level: torch.Tensor  # (K,) int32 pyramid level
    sigma: torch.Tensor  # (K,) measurement std in px (grows with level)
    desc: torch.Tensor  # (K, 72) float LBD
    desc_bits: torch.Tensor  # (K, n_bits/32) int64 words of the binary LBD
    depth: torch.Tensor  # (K, 2) metric depth at each endpoint, 0 = unknown
    has_depth: torch.Tensor  # (K,) f32 {0, 1}


def _merge_levels(per_level, params: FrontendParams) -> FrameFeatures:
    """Scale per-level detections to level 0 and keep top-K by response."""
    K = params.max_lines
    dev = per_level[0][0].endpoints.device
    rows = []
    for lvl, (det, desc, bits) in enumerate(per_level):
        up = (1.0 / params.base_scale) / (params.scale**lvl)
        rows.append(
            dict(
                endpoints=det.endpoints * up,
                valid=det.valid,
                angle=det.angle,
                length=det.length * up,
                midpoint=det.midpoint * up,
                response=det.response * up * up,  # support area in level-0 px
                level=torch.full((K,), lvl, dtype=torch.int32, device=dev),
                sigma=torch.full((K,), up, dtype=torch.float32, device=dev),
                desc=desc,
                bits=bits,
            )
        )
    cat = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    score = cat["response"] * cat["valid"] - (1.0 - cat["valid"])
    order = topk_stable(score, K)
    return FrameFeatures(
        endpoints=cat["endpoints"][order],
        valid=cat["valid"][order],
        angle=cat["angle"][order],
        length=cat["length"][order],
        midpoint=cat["midpoint"][order],
        response=cat["response"][order],
        level=cat["level"][order],
        sigma=cat["sigma"][order],
        desc=cat["desc"][order],
        desc_bits=cat["bits"][order],
        depth=torch.zeros((K, 2), dtype=torch.float32, device=dev),
        has_depth=torch.zeros((K,), dtype=torch.float32, device=dev),
    )


def prescaled_shape(H: int, W: int, params: FrontendParams):
    """Image shape the extractor gets for (H, W) input frames: (H, W) itself
    unless prescaled host ingest is on."""
    if not params.prescaled or params.base_scale == 1.0:
        return H, W
    s = params.base_scale
    return max(16, int(round(H * s))), max(16, int(round(W * s)))


def host_prescale(img, params: FrontendParams):
    """Host-side downscale to ``base_scale`` for prescaled ingest, keeping the
    dtype (u8 frames stay u8 on their way to the device): the 2x2 area mean
    of ``tpuslam.frontend.frame.host_prescale`` without cv2, rounded to u8,
    for base_scale 0.5. (The JAX package takes a cv2 Gaussian + bilinear
    resize instead where cv2 imports; this package has no cv2 form.)"""
    if not params.prescaled or params.base_scale == 1.0:
        return img
    img = np.asarray(img)
    H, W = img.shape
    bh, bw = prescaled_shape(H, W, params)
    s = params.base_scale
    if bh * 2 <= H and bw * 2 <= W and abs(s - 0.5) < 1e-6:
        a = img[: bh * 2, : bw * 2].astype(np.float32)
        m = 0.25 * (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2])
        return m.round().astype(img.dtype) if img.dtype == np.uint8 else m.astype(img.dtype)
    raise NotImplementedError(f"host_prescale: base_scale {s} (only the 2x2 area mean, base_scale 0.5, is ported)")


def _undistort_feature_geometry(feats: FrameFeatures, cam: Intrinsics, dist: Distortion) -> FrameFeatures:
    """Valid segments' endpoints undistorted, their midpoint, angle and
    length recomputed from them. Padding slots keep their geometry: the JAX
    package undistorts them too, and a padding endpoint at pixel (0, 0) lies
    beyond the model's largest distorted radius for strong distortion (TUM
    fr1's at fx 458), where the fixed point diverges to NaN, which then
    poisons descriptor stereo (ROADMAP.md section 3)."""
    ep = undistort_pixels(cam, dist, feats.endpoints)  # (K, 2, 2)
    d = ep[:, 1] - ep[:, 0]
    ok = feats.valid > 0.5
    return feats._replace(
        endpoints=torch.where(ok[:, None, None], ep, feats.endpoints),
        midpoint=torch.where(ok[:, None], 0.5 * (ep[:, 0] + ep[:, 1]), feats.midpoint),
        angle=torch.where(ok, torch.atan2(d[:, 1], d[:, 0]), feats.angle),
        length=torch.where(ok, sqrt_rn(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]), feats.length),
    )


def resize_to_base_scale(img: torch.Tensor, params: FrontendParams) -> torch.Tensor:
    """The in-program resize: a Gaussian of sigma 0.5 (1 / s - 1) (a mild
    antialias: at s = 0.5 the blur kernel at radius 2), then the antialiased
    linear resize to (max(16, round(H s)), max(16, round(W s))). An (H, W)
    image or a (B, H, W) batch."""
    H, W = img.shape[-2:]
    s = params.base_scale
    bh, bw = max(16, int(round(H * s))), max(16, int(round(W * s)))
    blur = gaussian_blur_batch if img.dim() == 3 else gaussian_blur
    return resize_linear(blur(img, 0.5 * (1.0 / s - 1.0)), (bh, bw))


def extract_features(img: torch.Tensor, params: FrontendParams = FrontendParams()) -> FrameFeatures:
    """(H, W) float32 image in [0, 1] -> FrameFeatures, on the image's device;
    a (B, H, W) batch -> FrameFeatures whose fields lead with B. With
    ``prescaled`` the image is already at ``base_scale`` of the frame;
    without it a ``base_scale`` below 1 resizes it here."""
    if not params.dist.is_zero and params.cam is None:
        raise ValueError("FrontendParams.cam required when distortion is set")
    batched = img.dim() == 3
    if params.base_scale != 1.0 and not params.prescaled:
        img = resize_to_base_scale(img, params)
    grads = gradients_xy_batch if batched else gradients_xy
    per_level = []
    for lim in build_pyramid(img, params.n_levels, params.scale):
        det: DetectedLines = detect_lines(lim, params.max_lines, params.lsd)
        gx, gy = grads(lim, 255.0)
        desc, bits = lbd_descriptors(gx, gy, det.endpoints, params.lbd)
        per_level.append((det, desc, bits))
    if batched:
        feats = torch.func.vmap(lambda pl: _merge_levels(pl, params))(per_level)
    else:
        feats = _merge_levels(per_level, params)
    if not params.dist.is_zero:
        undistort = lambda f: _undistort_feature_geometry(f, params.cam, params.dist)  # noqa: E731
        feats = torch.func.vmap(undistort)(feats) if batched else undistort(feats)
    return feats


class StereoParams(NamedTuple):
    max_dy: float = 12.0  # midpoint row tolerance (rectified)
    min_disp: float = 0.5
    max_disp: float = 200.0
    angle_tol: float = 0.15
    min_len_ratio: float = 0.6
    match: MatchParams = MatchParams(max_dist=110.0, ratio=0.95)


def _x_at_row(endpoints: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x where each (K, 2, 2) segment crosses image row y (K,) (extrapolated)."""
    p0, p1 = endpoints[:, 0], endpoints[:, 1]
    dy = p1[:, 1] - p0[:, 1]
    t = (y - p0[:, 1]) / torch.where(torch.abs(dy) < 1e-6, torch.sign(dy) * 1e-6 + 1e-9, dy)
    return p0[:, 0] + t * (p1[:, 0] - p0[:, 0])


def stereo_line_depths(
    left: FrameFeatures,
    right: FrameFeatures,
    fx_baseline: float,
    params: StereoParams = StereoParams(),
    near_horizontal_deg: float = 10.0,
) -> FrameFeatures:
    """Associate left<->right lines and recover endpoint depths (rectified
    stereo: disparity where the right line crosses each left endpoint's row;
    near-horizontal lines rejected)."""
    pen = (
        stereo_row_penalty(left.midpoint, right.midpoint, params.max_dy, params.min_disp, params.max_disp)
        + angle_penalty(left.angle, right.angle, params.angle_tol)
        + length_ratio_penalty(left.length, right.length, params.min_len_ratio)
    )
    m = match_descriptors(left.desc_bits, left.valid, right.desc_bits, right.valid, params.match, pen)
    ep_l = left.endpoints
    r_ep = right.endpoints[torch.clamp(m.idx, min=0)]
    xr0 = _x_at_row(r_ep, ep_l[:, 0, 1])
    xr1 = _x_at_row(r_ep, ep_l[:, 1, 1])
    disp = torch.stack([ep_l[:, 0, 0] - xr0, ep_l[:, 1, 0] - xr1], dim=-1)
    disp_okf = torch.prod(((disp > params.min_disp) & (disp < params.max_disp)).to(torch.float32), dim=-1)
    ang = torch.fmod(torch.abs(left.angle), math.pi)
    ang = torch.minimum(ang, math.pi - ang)
    # jnp.deg2rad rounds its operands to float32 before multiplying
    min_ang = float(np.float32(near_horizontal_deg) * np.float32(np.pi / 180))
    steepf = (ang > min_ang).to(torch.float32)
    okf = m.valid * disp_okf * steepf
    # fx_baseline: a number, or a sequence's entry of a batch's (N,) tensor
    # under vmap (parallel.multi_seq.batched_stereo)
    fxb = fx_baseline if isinstance(fx_baseline, torch.Tensor) else float(np.float32(fx_baseline))
    depth = okf[:, None] * fxb / torch.clamp(disp, min=1e-6)
    return left._replace(depth=depth, has_depth=okf)
