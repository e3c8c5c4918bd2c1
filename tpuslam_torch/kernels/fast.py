"""FAST corner detector and patch-BRIEF point descriptor (torch).

Counterpart of ``tpuslam.kernels.fast``; see that module for the method.
Every pixel runs the FAST-9/16 segment test at once: the 16 circle samples
are 16 static rolls, the brighter and darker tests bit-pack into a 16-bit
ring per pixel, and a run of 9 set bits is found by shifted ANDs of the ring
unrolled to 32 bits. The score is the larger of the summed brighter and
darker excesses; non-maximum suppression keeps a pixel that equals its 5x5
window's maximum and, among equal maxima, the highest flat index (a second
max-pool over the indices); the top K by score are refined to subpixel by a
polarity-aware 7x7 contrast centroid and described by BRIEF-256 on a 32x32
patch of the image blurred at sigma 2.

The JAX package computes all of this through XLA outside any Pallas kernel,
so it is plain PyTorch on the caller's device, except the BRIEF smoothing:
it is ``kernels.image.gaussian_blur``, the hand blur kernel on a CUDA tensor
(radius 6 at sigma 2). Ties in the score order break towards the lower
pixel index, as ``jax.lax.top_k``'s do (:func:`kernels.lsd.topk_stable`).
The segment test's thresholds I + t and I - t are rounded once from the
[0, 1] image, as XLA's fused multiply-adds round them (``_fma``): a corner
whose score ties another's within a dot's plateau is then kept or suppressed
as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuslam_torch.kernels.image import gaussian_blur
from tpuslam_torch.kernels.lsd import topk_stable


class FASTParams(NamedTuple):
    """Same fields and defaults as the JAX package's."""

    threshold: float = 20.0  # intensity margin t on the 0..255 scale
    arc: int = 9  # contiguous circle arc length (FAST-9/16)
    nms_radius: int = 2  # non-max suppression window radius
    border: int = 17  # keep-out border (descriptor patch reach)
    blur_sigma: float = 2.0  # BRIEF smoothing sigma
    patch: int = 32  # descriptor window (PATCH x PATCH)
    n_bits: int = 256
    pair_radius: int = 13  # max |offset| of BRIEF test positions


class PointFeatures(NamedTuple):
    """Fixed-capacity per-frame corner features (level-0 pixel coords)."""

    uv: torch.Tensor  # (K, 2) x, y
    valid: torch.Tensor  # (K,) f32 {0, 1}
    response: torch.Tensor  # (K,) FAST score
    desc_bits: torch.Tensor  # (K, n_bits / 32) int64 words of the uint32 descriptor
    depth: torch.Tensor  # (K,) metric depth, 0 = unknown (stereo fills)
    has_depth: torch.Tensor  # (K,) f32 {0, 1}


# Bresenham circle of radius 3, in ring order (dy, dx)
_CIRCLE = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]


def _brief_pairs(params: FASTParams) -> np.ndarray:
    """The fixed BRIEF pattern, (n_bits, 2) flat in-patch indices:
    Gaussian offsets from a fixed seed (part of the descriptor's
    definition), the JAX package's draw for draw."""
    rs = np.random.RandomState(7)
    P = params.patch
    c = P // 2
    sigma = params.pair_radius / 2.0
    pts = []
    while len(pts) < 2 * params.n_bits:
        o = rs.normal(0.0, sigma, 2)
        if np.max(np.abs(o)) <= params.pair_radius:
            y, x = int(round(c + o[0])), int(round(c + o[1]))
            if 0 <= y < P and 0 <= x < P:
                pts.append(y * P + x)
    a = np.asarray(pts[: params.n_bits], np.int32)
    b = np.asarray(pts[params.n_bits :], np.int32)
    b = np.where(a == b, (b + P + 1) % (P * P), b)  # never compare a cell to itself
    return np.stack([a, b], axis=1)


@functools.lru_cache(maxsize=8)
def _pairs_on(params: FASTParams, device: str):
    """The pair pattern as two index tensors and the bit weights of each
    descriptor bit, uploaded once per device."""
    pairs = _brief_pairs(params)
    shift = torch.arange(params.n_bits, dtype=torch.int64) % 32
    return (
        torch.from_numpy(pairs[:, 0].astype(np.int64)).to(device),
        torch.from_numpy(pairs[:, 1].astype(np.int64)).to(device),
        (torch.ones((), dtype=torch.int64) << shift).to(device),
    )


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static shift with wrap-around (``jnp.roll``); the border keep-out
    blocks the wrap."""
    return torch.roll(x, (dy, dx), dims=(0, 1))


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add), through
    float64, where the float32 product is exact."""
    return (a.double() * b + c).float()


def _has_run(ring: torch.Tensor, n: int) -> torch.Tensor:
    """float32 {0, 1}: n or more contiguous set bits on the 16-bit ring."""
    x = ring | (ring << 16)  # the ring unrolled into 32 bits
    run = 1
    while run * 2 <= n:
        x = x & (x >> run)
        run *= 2
    if run < n:
        x = x & (x >> (n - run))
    return ((x & 0xFFFF) != 0).to(torch.float32)


def _max_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r + 1)^2 window maximum, outside the image -inf (XLA's "SAME")."""
    return F.max_pool2d(x[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]


def detect_corners(img: torch.Tensor, max_points: int = 256, params: FASTParams = FASTParams()) -> PointFeatures:
    """FAST-9 corners of an (H, W) float32 image in [0, 1], on its device.

    Returns PointFeatures with capacity ``max_points`` (mask-padded),
    depth and has_depth zero (stereo association fills them)."""
    H, W = img.shape
    K = max_points
    dev = img.device
    I = img * 255.0
    t = params.threshold

    ring_b = torch.zeros((H, W), dtype=torch.int64, device=dev)
    ring_d = torch.zeros((H, W), dtype=torch.int64, device=dev)
    exc_b = torch.zeros((H, W), dtype=torch.float32, device=dev)
    exc_d = torch.zeros((H, W), dtype=torch.float32, device=dev)
    hi, lo = _fma(img, 255.0, t), _fma(img, 255.0, -t)
    for i, (dy, dx) in enumerate(_CIRCLE):
        s = _shift(I, -dy, -dx)  # the value at p + (dy, dx)
        ring_b = ring_b | ((s > hi).to(torch.int64) << i)
        ring_d = ring_d | ((s < lo).to(torch.int64) << i)
        exc_b = exc_b + torch.clamp(s - hi, min=0.0)
        exc_d = exc_d + torch.clamp(lo - s, min=0.0)

    cornerf = torch.maximum(_has_run(ring_b, params.arc), _has_run(ring_d, params.arc))
    score = torch.maximum(exc_b, exc_d) * cornerf

    # border keep-out (also blocks the rolls' wrap-around)
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)
    bdr = params.border
    inside = ((yy >= bdr) & (yy < H - bdr) & (xx >= bdr) & (xx < W - bdr)).to(torch.float32)
    score = score * inside

    # NMS: a pixel equal to its window maximum; among equal maxima within a
    # window the higher flat index survives
    r = params.nms_radius
    mx = _max_pool(score, r)
    is_max = (score >= mx).to(torch.float32) * (score > 0).to(torch.float32)
    idx_f = (yy * W + xx).to(torch.float32)  # exact in float32: H * W < 2^24
    g = torch.where(is_max > 0, idx_f, torch.full_like(idx_f, -1.0))
    keepf = is_max * (idx_f >= _max_pool(g, r)).to(torch.float32)
    flat_score = (score * keepf).reshape(-1)

    idx = topk_stable(flat_score, K)
    top = flat_score[idx]
    ky, kx = idx // W, idx % W
    validf = (top > 0.0).to(torch.float32)

    # subpixel: polarity-aware contrast centroid over a 7x7 window (the
    # window start clamped into the image, as dynamic_slice clamps it)
    RW = 3
    ar = torch.arange(2 * RW + 1, device=dev)
    wy0 = torch.clamp(torch.clamp(ky, min=RW) - RW, 0, H - (2 * RW + 1))
    wx0 = torch.clamp(torch.clamp(kx, min=RW) - RW, 0, W - (2 * RW + 1))
    win = I[(wy0[:, None] + ar)[:, :, None], (wx0[:, None] + ar)[:, None, :]]  # (K, 7, 7)
    darkf = (exc_b[ky, kx] > exc_d[ky, kx]).to(torch.float32)
    w_dark = torch.amax(win, dim=(1, 2), keepdim=True) - win
    w_bright = win - torch.amin(win, dim=(1, 2), keepdim=True)
    w = darkf[:, None, None] * w_dark + (1.0 - darkf)[:, None, None] * w_bright
    grid = torch.arange(-RW, RW + 1, dtype=torch.float32, device=dev)
    wsum = torch.clamp(torch.sum(w, dim=(1, 2)), min=1e-6)
    dyf = torch.clamp(torch.sum(w * grid[None, :, None], dim=(1, 2)) / wsum, -1.0, 1.0)
    dxf = torch.clamp(torch.sum(w * grid[None, None, :], dim=(1, 2)) / wsum, -1.0, 1.0)
    uv = torch.stack([kx.to(torch.float32) + dxf, ky.to(torch.float32) + dyf], dim=-1)

    # BRIEF on one contiguous patch per corner
    S = gaussian_blur(I, params.blur_sigma)
    P = params.patch
    px0 = torch.clamp(kx - P // 2, 0, max(W - P, 0))
    py0 = torch.clamp(ky - P // 2, 0, max(H - P, 0))
    arp = torch.arange(P, device=dev)
    patches = S[(py0[:, None] + arp)[:, :, None], (px0[:, None] + arp)[:, None, :]].reshape(K, P * P)
    ia, ib, weight = _pairs_on(params, str(dev))
    bits = (patches[:, ia] < patches[:, ib]).to(torch.int64)  # (K, n_bits)
    words = torch.sum((bits * weight).view(K, params.n_bits // 32, 32), dim=-1)
    words = words * validf[:, None].to(torch.int64)

    return PointFeatures(
        uv=uv * validf[:, None],
        valid=validf,
        response=top * validf,
        desc_bits=words,
        depth=torch.zeros((K,), dtype=torch.float32, device=dev),
        has_depth=torch.zeros((K,), dtype=torch.float32, device=dev),
    )
