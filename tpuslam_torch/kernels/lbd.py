"""Line Band Descriptor (LBD-style) as dense patch pooling (torch).

Counterpart of ``tpuslam.kernels.lbd``: one PATCH x PATCH window per
segment, band statistics of the four directional gradient channels, and a
256-bit binary descriptor from a fixed comparison pattern. The binary words
are int64 tensors holding the uint32 bit patterns of the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class LBDParams(NamedTuple):
    n_bands: int = 9  # m
    band_width: int = 7  # w (rows per band)
    patch: int = 64  # sampling window (PATCH x PATCH) around the midpoint
    n_bits: int = 256  # binarized descriptor length


def _pair_pattern(n_floats: int, n_bits: int) -> np.ndarray:
    """Deterministic comparison pairs for binarization (fixed seed — part of
    the descriptor definition; identical to the JAX package's)."""
    rs = np.random.RandomState(42)
    pairs = []
    seen = set()
    while len(pairs) < n_bits:
        i, j = rs.randint(0, n_floats, 2)
        if i != j and (i, j) not in seen:
            seen.add((i, j))
            pairs.append((i, j))
    return np.asarray(pairs, np.int32)


@functools.lru_cache(maxsize=8)
def _pairs_on(n_floats: int, n_bits: int, device: str) -> torch.Tensor:
    """The pair pattern on ``device``, built and uploaded once (a host copy
    per call would stall the card's queue)."""
    return torch.from_numpy(_pair_pattern(n_floats, n_bits)).long().to(device)


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-9)


def _band_sums(eq: str, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, a)`` over the segments, per image of a batch.
    cuBLAS picks its algorithm (and so its summation order) by the shape of
    the whole batched product, so one product over N images' segments would
    round each image differently from its own call: a batch runs one
    product per image, each of the single call's shape."""
    if x.dim() == len(eq.split(",")[0]):
        return torch.einsum(eq, x, a)
    return torch.stack([torch.einsum(eq, xi, ai) for xi, ai in zip(x, a)])


def lbd_descriptors(
    gx: torch.Tensor,
    gy: torch.Tensor,
    endpoints: torch.Tensor,  # (K, 2, 2) [[x0,y0],[x1,y1]] px
    params: LBDParams = LBDParams(),
):
    """Float + binary LBD descriptors for K segments.

    Returns (desc_float (K, 8*m) L2-normalized, desc_bits (K, n_bits/32)
    int64 words in [0, 2**32)). Degenerate (zero-length / padded) segments
    yield zeros. With (N, H, W) gradient planes and (N, K, 2, 2) endpoints
    (a batch of images), every output leads with N, each image's equal to
    its own call's."""
    m, w, P = params.n_bands, params.band_width, params.patch
    H, W = gx.shape[-2:]
    K = endpoints.shape[-3]
    lead = endpoints.shape[:-3]
    dev = gx.device

    p0 = endpoints[..., 0, :]
    p1 = endpoints[..., 1, :]
    d = p1 - p0
    length = torch.linalg.norm(d, dim=-1, keepdim=True)
    dL = d / torch.clamp(length, min=1e-6)  # parallel unit vector
    dO = torch.stack([-dL[..., 1], dL[..., 0]], dim=-1)  # orthogonal
    mid = 0.5 * (p0 + p1)

    # one contiguous patch per segment (corner clipped inside the image)
    cx = torch.clamp(torch.round(mid[..., 0]).to(torch.int32) - P // 2, 0, max(W - P, 0))
    cy = torch.clamp(torch.round(mid[..., 1]).to(torch.int32) - P // 2, 0, max(H - P, 0))
    ar = torch.arange(P, device=dev)
    rows = (cy.long()[..., None] + ar)[..., :, None]  # (K, P, 1)
    cols = (cx.long()[..., None] + ar)[..., None, :]  # (K, 1, P)
    at = (rows, cols)
    if lead:  # the image of each segment's patch
        at = (torch.arange(gx.shape[0], device=dev).view(-1, 1, 1, 1), rows, cols)
    pgx = gx[at]  # (K, P, P)
    pgy = gy[at]

    def per_seg(v):  # (..., K) -> (..., K, 1, 1)
        return v[..., None, None]

    # per-pixel line-frame coordinates
    grid = ar.to(torch.float32)
    ax = grid[None, None, :] + per_seg(cx.to(torch.float32)) - per_seg(mid[..., 0])
    ay = grid[None, :, None] + per_seg(cy.to(torch.float32)) - per_seg(mid[..., 1])
    t = ax * per_seg(dL[..., 0]) + ay * per_seg(dL[..., 1])  # parallel coord
    n = ax * per_seg(dO[..., 0]) + ay * per_seg(dO[..., 1])  # perpendicular

    gL = pgx * per_seg(dL[..., 0]) + pgy * per_seg(dL[..., 1])
    gO = pgx * per_seg(dO[..., 0]) + pgy * per_seg(dO[..., 1])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ch = torch.stack(
        [torch.maximum(gO, zero), torch.maximum(-gO, zero), torch.maximum(gL, zero), torch.maximum(-gL, zero)],
        dim=-1,
    )  # (K, P, P, 4)

    R = m * w
    half_len = per_seg(torch.clamp(0.5 * length[..., 0], max=P / 2.0 - 1.0))
    fg = torch.exp(-0.5 * (n / (R / 2.0)) ** 2)
    in_len = torch.clamp(half_len + 1.0 - torch.abs(t), 0.0, 1.0)
    wgt = fg * in_len  # (K, P, P)

    band_centers = (torch.arange(m, dtype=torch.float32, device=dev) - (m - 1) / 2.0) * w
    a = torch.clamp(1.0 - torch.abs((n[..., None] - band_centers) / w), 0.0, 1.0)  # (K, P, P, m)

    flat_ch = (ch * wgt[..., None]).reshape(*lead, K, P * P, 4)
    flat_ch2 = (ch * ch * wgt[..., None]).reshape(*lead, K, P * P, 4)
    flat_a = a.reshape(*lead, K, P * P, m)
    flat_w = wgt.reshape(*lead, K, P * P)

    s1 = _band_sums("kpc,kpm->kmc", flat_ch, flat_a)  # (K, m, 4)
    s2 = _band_sums("kpc,kpm->kmc", flat_ch2, flat_a)
    s0 = _band_sums("kp,kpm->km", flat_w, flat_a)[..., None]  # (K, m, 1)
    mean = s1 / torch.clamp(s0, min=1e-6)
    var = torch.clamp(s2 / torch.clamp(s0, min=1e-6) - mean * mean, min=0.0)
    std = torch.sqrt(var)
    desc = torch.cat([mean, std], dim=-1).reshape(*lead, K, 8 * m)

    # L2 normalize mean-part and std-part separately, clamp, renormalize
    desc = torch.cat([_l2n(desc[..., : 4 * m]), _l2n(desc[..., 4 * m :])], dim=-1)
    desc = _l2n(torch.clamp(desc, -0.4, 0.4))

    keep = (length[..., 0] >= 1e-3).to(torch.float32)[..., None]
    desc = desc * keep

    # binarize with the fixed pair pattern, pack 32 bits per int64 word
    pairs = _pairs_on(8 * m, params.n_bits, str(dev))
    bits = (desc[..., pairs[:, 0]] > desc[..., pairs[:, 1]]).to(torch.int64)  # (K, B)
    shifts = torch.arange(params.n_bits, device=dev) % 32
    words = (bits << shifts).view(*lead, K, params.n_bits // 32, 32).sum(dim=-1)
    words = words * keep.to(torch.int64)
    return desc, words
