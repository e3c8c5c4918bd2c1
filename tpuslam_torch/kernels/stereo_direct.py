"""Direct epipolar disparity search for line endpoints (torch).

Counterpart of ``tpuslam.kernels.stereo_direct`` (lines): the right camera
is never detected on. For each valid left segment, S samples along it each
correlate a horizontal window of the left image (zero-mean SAD) against the
same row of the right image over D integer disparities; an integer argmin
with a parabola subpixel gives one disparity per sample, and an IRLS affine
fit along the segment gives the two endpoint disparities.

The JAX package computes this outside any Pallas kernel, so it is plain
PyTorch here, on the caller's device: two flat window gathers, then static
slices and cumulative-sum moving means over the fetched windows, W passes of
(K, S, D) arithmetic. The corner variant (:func:`direct_point_disparity_body`)
correlates one (rows x window) patch per corner the same way.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch


class DirectStereoParams(NamedTuple):
    """Same fields and defaults as the JAX package's."""

    n_samples: int = 8  # S sample points per segment
    window: int = 12  # correlation window width W (px, along the row)
    max_disp: float = 128.0  # disparity search range (integer grid 0..D-1)
    min_disp: float = 0.5
    min_samples: int = 4  # valid samples required for the affine fit
    max_fit_rms: float = 0.75  # px: residual gate on the affine fit
    ratio: float = 0.85  # best/second-best cost uniqueness gate
    min_contrast: float = 3.0  # left-window stddev gate (0..255 scale)
    max_cost: float = 28.0  # mean ZSAD gate (0..255 scale)
    near_horizontal_deg: float = 10.0
    irls_sigma: float = 0.6  # px: residual scale for the IRLS reweighting
    # the image pair is at coord_scale x the coordinate frame of `endpoints`
    # (host-prescaled half-resolution ingest): endpoints are multiplied by
    # this before sampling and the disparity divided by it (full-resolution
    # px). window/disp/rms above are in image px.
    coord_scale: float = 1.0


def inject_coord_scale(p: DirectStereoParams, base_scale: float, prescaled: bool) -> DirectStereoParams:
    """Adapt the params to prescaled host ingest: the correlation images are
    at base_scale while feature geometry stays full-resolution. No-op if the
    config already set an explicit coord_scale."""
    if prescaled and base_scale != 1.0 and p.coord_scale == 1.0:
        return p._replace(coord_scale=base_scale, max_disp=max(8.0, round(p.max_disp * base_scale)))
    return p


def linspace_np(start: float, stop: float, num: int) -> np.ndarray:
    """float32 ``jnp.linspace(start, stop, num)`` as XLA evaluates it inside a
    jitted program: its simplifier turns ``iota / div`` into ``iota * (1 /
    div)`` and folds ``stop * (1 / div)`` into one constant, so element i is
    ``start * (1 - i * r) + i * (stop * r)`` with r = 1 / div, each step
    rounded to float32 (``jnp.linspace`` outside ``jit`` and
    ``torch.linspace`` differ from it in the last bit here and there)."""
    f32 = np.float32
    div = num - 1
    r = f32(1) / f32(div)
    br = f32(f32(stop) * r)
    i = np.arange(div, dtype=f32)
    head = f32(start) * (f32(1) - i * r) + i * br
    return np.concatenate([head, [f32(stop)]]).astype(f32)


@functools.lru_cache(maxsize=32)
def _linspace(start: float, stop: float, num: int, device: str) -> torch.Tensor:
    return torch.from_numpy(linspace_np(start, stop, num)).to(device)


def linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """:func:`linspace_np` on ``device``, uploaded once per device (the
    tracking loop asks for it every frame). Do not modify the result."""
    return _linspace(start, stop, num, str(torch.device(device)))


def moving_mean(win: torch.Tensor, W: int) -> torch.Tensor:
    """Mean of each length-W window of the last axis (len L -> L - W + 1)."""
    cs = torch.cumsum(win, dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    return (cs[..., W:] - cs[..., :-W]) / float(W)


def subpixel_argmin(cost: torch.Tensor, ratio: float):
    """Integer argmin over the last axis (lowest index among ties), the best
    cost, the uniqueness test ``best < ratio * best outside +-2`` and the
    parabola offset in [-1, 1]: (best, cbest, uniq, sub)."""
    n = cost.shape[-1]
    best = torch.argmin(cost, dim=-1)
    cbest = torch.amin(cost, dim=-1)
    grid = torch.arange(n, device=cost.device)
    near = (torch.abs(grid - best[..., None]) <= 2).to(torch.float32)
    c2 = torch.amin(cost + near * 1e6, dim=-1)
    uniq = cbest < ratio * c2
    cm1 = torch.gather(cost, -1, torch.clamp(best - 1, 0, n - 1)[..., None])[..., 0]
    cp1 = torch.gather(cost, -1, torch.clamp(best + 1, 0, n - 1)[..., None])[..., 0]
    denom = torch.clamp(cm1 - 2.0 * cbest + cp1, min=1e-6)
    sub = torch.clamp(0.5 * (cm1 - cp1) / denom, -1.0, 1.0)
    return best, cbest, uniq, sub


def direct_line_disparity_body(
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    endpoints: torch.Tensor,
    validf: torch.Tensor,
    angle: torch.Tensor,
    p: DirectStereoParams,
):
    """Per-endpoint disparities of left segments by direct epipolar search.

    img_l/img_r: (H, W) float32 in [0, 1], rectified. endpoints: (K, 2, 2)
    px. validf/angle: (K,) float32 / rad. Returns (disp (K, 2), okf (K,)
    float32)."""
    H, W_img = img_l.shape
    K = endpoints.shape[0]
    S, W = p.n_samples, p.window
    D = int(p.max_disp)
    dev = img_l.device
    if p.coord_scale != 1.0:
        endpoints = endpoints * p.coord_scale
    L = (img_l * 255.0).reshape(-1)
    R = (img_r * 255.0).reshape(-1)

    t = linspace(0.1, 0.9, S, dev)
    p0, p1 = endpoints[:, 0], endpoints[:, 1]
    pts = p0[:, None, :] + t[None, :, None] * (p1 - p0)[:, None, :]  # (K, S, 2)
    x, y = pts[..., 0], pts[..., 1]
    yi = torch.clamp(torch.round(y).to(torch.int64), 0, H - 1)
    xi = torch.round(x).to(torch.int64)

    # left profile window (one flat gather, K*S*W elements)
    colL = xi[..., None] + torch.arange(-(W // 2), W - W // 2, device=dev)  # (K, S, W)
    l_inb = (colL >= 0) & (colL < W_img)
    profL = L[yi[..., None] * W_img + torch.clamp(colL, 0, W_img - 1)]

    # right row span covering every disparity window: the window for
    # disparity d starts at column xi - d - W//2, so the spans of all d in
    # [0, D) form one contiguous range of D - 1 + W columns per sample
    span = D - 1 + W
    colR = (xi - (D - 1) - W // 2)[..., None] + torch.arange(span, device=dev)  # (K, S, span)
    r_inb = (colR >= 0) & (colR < W_img)
    winR = R[yi[..., None] * W_img + torch.clamp(colR, 0, W_img - 1)]

    # zero-mean SAD over the sliding window; span index j is disparity D-1-j
    mR = moving_mean(winR, W)  # (K, S, D)
    mL = torch.mean(profL, dim=-1, keepdim=True)
    okR = moving_mean(r_inb.to(torch.float32), W)  # 1.0 iff fully in-bounds
    cost_j = torch.zeros_like(mR)
    for w in range(W):
        cost_j = cost_j + torch.abs((winR[..., w : w + D] - mR) - (profL[..., w : w + 1] - mL))
    cost_j = cost_j / float(W) + (1.0 - (okR > 0.999).to(torch.float32)) * 1e6
    cost = torch.flip(cost_j, dims=(-1,))  # (K, S, D) indexed by disparity

    best, cbest, uniq, sub = subpixel_argmin(cost, p.ratio)
    # the correlation measures the content shift between two windows both
    # referenced to column xi: that is the local disparity
    d_s = best.to(torch.float32) + sub  # (K, S)

    contrast = torch.std(profL, dim=-1, correction=0)  # population std, as jnp.std
    samp_ok = (
        uniq
        & (cbest < p.max_cost)
        & (contrast > p.min_contrast)
        & torch.all(l_inb, dim=-1)
        & (y >= 0.0)
        & (y <= H - 1.0)
    ).to(torch.float32)

    # robust affine fit d(t) = a + b t over the samples: 1 LS + 2 IRLS rounds
    w_s = samp_ok
    tb = t[None, :].expand(K, S)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(3):
        sw = torch.sum(w_s, dim=-1)
        st_ = torch.sum(w_s * tb, dim=-1)
        stt = torch.sum(w_s * tb * tb, dim=-1)
        sd = torch.sum(w_s * d_s, dim=-1)
        std_ = torch.sum(w_s * tb * d_s, dim=-1)
        det = sw * stt - st_ * st_
        well = torch.abs(det) > 1e-6
        detc = torch.where(well, det, torch.ones_like(det))
        a = torch.where(well, (stt * sd - st_ * std_) / detc, zero)
        b = torch.where(well, (sw * std_ - st_ * sd) / detc, zero)
        r = d_s - (a[:, None] + b[:, None] * tb)
        w_s = samp_ok / (1.0 + (r / p.irls_sigma) ** 2)

    r = d_s - (a[:, None] + b[:, None] * tb)
    n_ok = torch.sum(samp_ok, dim=-1)
    rms = torch.sqrt(torch.sum(samp_ok * r * r, dim=-1) / torch.clamp(n_ok, min=1.0))
    disp = torch.stack([a, a + b], dim=-1)  # (K, 2): t = 0 and t = 1 endpoints

    ang = torch.fmod(torch.abs(angle), math.pi)
    ang = torch.minimum(ang, math.pi - ang)
    # jnp.deg2rad rounds its operands to float32 before multiplying
    steep = ang > float(np.float32(p.near_horizontal_deg) * np.float32(np.pi / 180))
    okf = (
        (validf > 0.5)
        & (n_ok >= p.min_samples)
        & (rms <= p.max_fit_rms)
        & torch.all(disp > p.min_disp, dim=-1)
        & torch.all(disp < p.max_disp, dim=-1)
        & steep
    ).to(torch.float32)
    return disp / p.coord_scale, okf


def direct_stereo_depths(img_l: torch.Tensor, img_r: torch.Tensor, feats, fx_baseline: float, p: DirectStereoParams = DirectStereoParams()):
    """Fill ``depth``/``has_depth`` of left FrameFeatures from the right
    image (no right-camera detection)."""
    disp, okf = direct_line_disparity_body(img_l, img_r, feats.endpoints, feats.valid, feats.angle, p)
    depth = okf[:, None] * float(np.float32(fx_baseline)) / torch.clamp(disp, min=1e-6)
    return feats._replace(depth=depth, has_depth=okf)


class DirectPointStereoParams(NamedTuple):
    """Same fields and defaults as the JAX package's."""

    window: int = 12  # correlation window width (px along the row)
    rows: int = 5  # vertical patch extent: a corner needs 2-D support
    max_disp: float = 128.0
    min_disp: float = 0.5
    ratio: float = 0.8  # best/second-best uniqueness gate
    min_contrast: float = 4.0  # patch stddev gate (0..255 scale)
    max_cost: float = 25.0  # mean ZSAD gate (0..255 scale)
    coord_scale: float = 1.0  # see DirectStereoParams.coord_scale


def direct_point_disparity_body(img_l: torch.Tensor, img_r: torch.Tensor, uv: torch.Tensor, validf: torch.Tensor, p: DirectPointStereoParams):
    """Per-corner disparity by direct epipolar patch correlation: one
    (rows x window) zero-mean-SAD patch per corner slid over the disparity
    range on the same rows of the right image, integer argmin and parabola
    subpixel. img_l/img_r: (H, W) float32 in [0, 1], rectified; uv: (K, 2)
    px. Returns (disp (K,), okf (K,) float32)."""
    H, W_img = img_l.shape
    K = uv.shape[0]
    W, RW = p.window, p.rows
    D = int(p.max_disp)
    dev = img_l.device
    if p.coord_scale != 1.0:
        uv = uv * p.coord_scale
    L = (img_l * 255.0).reshape(-1)
    R = (img_r * 255.0).reshape(-1)

    xi = torch.round(uv[:, 0]).to(torch.int64)
    yi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64)[:, None] + torch.arange(-(RW // 2), RW - RW // 2, device=dev), 0, H - 1)

    colL = xi[:, None] + torch.arange(-(W // 2), W - W // 2, device=dev)  # (K, W)
    l_inb = (colL >= 0) & (colL < W_img)
    profL = L[yi[:, :, None] * W_img + torch.clamp(colL, 0, W_img - 1)[:, None, :]]  # (K, RW, W)

    span = D - 1 + W
    colR = (xi - (D - 1) - W // 2)[:, None] + torch.arange(span, device=dev)  # (K, span)
    r_inb = (colR >= 0) & (colR < W_img)
    winR = R[yi[:, :, None] * W_img + torch.clamp(colR, 0, W_img - 1)[:, None, :]]  # (K, RW, span)

    # zero-mean SAD: per-patch means over the whole (RW x W) patch
    mR = torch.mean(moving_mean(winR, W), dim=1, keepdim=True)  # (K, 1, D)
    mL = torch.mean(profL, dim=(1, 2))[:, None, None]  # (K, 1, 1)
    cost_j = torch.zeros((K, 1, D), dtype=torch.float32, device=dev)
    for w in range(W):
        cost_j = cost_j + torch.sum(torch.abs((winR[:, :, w : w + D] - mR) - (profL[:, :, w : w + 1] - mL)), dim=1, keepdim=True)
    cost_j = cost_j[:, 0, :] / float(W * RW)
    okR = moving_mean(r_inb.to(torch.float32), W)  # (K, D), 1.0 iff fully in-bounds
    cost_j = cost_j + (1.0 - (okR > 0.999).to(torch.float32)) * 1e6
    cost = torch.flip(cost_j, dims=(-1,))  # (K, D) indexed by disparity

    best, cbest, uniq, sub = subpixel_argmin(cost, p.ratio)
    disp = best.to(torch.float32) + sub
    contrast = torch.std(profL, dim=(1, 2), correction=0)
    okf = (
        (validf > 0.5)
        & uniq
        & (cbest < p.max_cost)
        & (contrast > p.min_contrast)
        & torch.all(l_inb, dim=-1)
        & (disp > p.min_disp)
        & (disp < p.max_disp - 1.0)
        & (uv[:, 1] >= 0.0)
        & (uv[:, 1] <= H - 1.0)
    ).to(torch.float32)
    return disp / p.coord_scale, okf


def direct_stereo_point_depths(img_l: torch.Tensor, img_r: torch.Tensor, pfeats, fx_baseline: float, p: DirectPointStereoParams = DirectPointStereoParams()):
    """Fill ``depth``/``has_depth`` of left PointFeatures from the right
    image (no right-camera corner detection)."""
    disp, okf = direct_point_disparity_body(img_l, img_r, pfeats.uv, pfeats.valid, p)
    depth = okf * float(np.float32(fx_baseline)) / torch.clamp(disp, min=1e-6)
    return pfeats._replace(depth=depth, has_depth=okf)
