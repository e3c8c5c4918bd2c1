"""The plain reference of the front end's line detector, and the comparison
of the program's detections with it.

A frozen copy, in plain PyTorch, of the method the port's detector
implements (``tpuslam_torch.kernels.lsd.detect_lines`` with its default
``LSDParams``, the pyramid of ``frontend.frame.extract_features``): a
Gaussian prefilter, central-difference gradients on the 0..255 scale, the
support mask and the 8-neighbour angle-compatibility plane, 64 rounds of
min/max label propagation and one pointer jump, the K components spanning
most, their weighted moments and extents along the principal direction,
the validity tests, and the merge of collinear fragments. It takes a
(B, H, W) batch and runs every float step in ``dtype`` (bfloat16 is the
control); labels stay integers. It imports nothing of the program.

:func:`det_gap` compares two sets of detections segment by segment.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

K = 256  # segment slots per image (FrontendParams.max_lines)
N_LEVELS, LEVEL_SCALE, PYR_SIGMA = 2, 0.8, 0.6  # the pyramid
PREFILTER_SIGMA = 0.75
ANGLE_TOL, QUANT = math.pi / 8, 2.0
MIN_LENGTH, MIN_SUPPORT, MIN_DENSITY, MAX_WIDTH = 15.0, 20, 0.35, 8.0
CCL_ROUNDS = 64
MERGE_ANGLE, MERGE_PERP, MERGE_GAP, MERGE_ROUNDS = 0.06, 2.0, 12.0, 6
MATCH_PX = 1.0  # a segment matches another whose both endpoints lie within this (px)

_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


class Segments(NamedTuple):
    endpoints: torch.Tensor  # (B, K, 2, 2) px
    valid: torch.Tensor  # (B, K) bool


def _taps(sigma: float, dt, dev) -> torch.Tensor:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return (k / torch.sum(k)).to(dt).to(dev)


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of (B, H, W) images, edge padding, rows then columns."""
    k = _taps(sigma, img.dtype, img.device)
    r = k.numel() // 2
    x = F.pad(img[:, None], (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return F.conv2d(x, k.view(1, 1, -1, 1))[:, 0]


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of the antialiased linear resize: the triangle
    kernel widened by 1 / scale when downsampling, columns normalised."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None]) / ks)
    w = w / w.sum(axis=0, keepdims=True)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def level_shapes(H: int, W: int):
    """(h, w) of each pyramid level of an (H, W) image."""
    shapes = [(H, W)]
    for _ in range(1, N_LEVELS):
        h, w = shapes[-1]
        shapes.append((max(16, int(round(h * LEVEL_SCALE))), max(16, int(round(w * LEVEL_SCALE)))))
    return shapes


def pyramid(img: torch.Tensor):
    """Levels of (B, H, W) images: the image, then each level blurred by
    PYR_SIGMA / LEVEL_SCALE and resized by LEVEL_SCALE."""
    levels = [img]
    for shape in level_shapes(*img.shape[-2:])[1:]:
        h, w = levels[-1].shape[-2:]
        wh = torch.as_tensor(_resize_weights(h, shape[0]), dtype=img.dtype, device=img.device)
        ww = torch.as_tensor(_resize_weights(w, shape[1]), dtype=img.dtype, device=img.device)
        levels.append(wh.T @ blur(levels[-1], PYR_SIGMA / LEVEL_SCALE) @ ww)
    return levels


def _shift(x, dy, dx):
    return torch.roll(x, (dy, dx), dims=(-2, -1))


def _principal_direction(mxx, myy, mxy):
    tr = mxx + myy
    det = mxx * myy - mxy * mxy
    lam1 = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    e1 = torch.stack([mxy, lam1 - mxx], dim=-1)
    e2 = torch.stack([lam1 - myy, mxy], dim=-1)
    ev = torch.where((torch.linalg.norm(e1, dim=-1) > torch.linalg.norm(e2, dim=-1))[..., None], e1, e2)
    return ev / torch.clamp(torch.linalg.norm(ev, dim=-1, keepdim=True), min=1e-9)


def _slot_sums(cols: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """(B, V, N) columns summed per (B, N) slot in [0, S) -> (B, V, S)."""
    B, V, N = cols.shape
    flat = (slot.long() + S * torch.arange(B, device=cols.device)[:, None]).reshape(-1)
    acc = torch.zeros((B * S, V), dtype=cols.dtype, device=cols.device)
    acc.index_add_(0, flat, cols.permute(0, 2, 1).reshape(B * N, V))
    return acc.view(B, S, V).permute(0, 2, 1)


def _slot_extreme(vals: torch.Tensor, slot: torch.Tensor, S: int, how: str) -> torch.Tensor:
    B, N = vals.shape
    flat = (slot.long() + S * torch.arange(B, device=vals.device)[:, None]).reshape(-1)
    fill = math.inf if how == "amin" else -math.inf
    out = torch.full((B * S,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, flat, vals.reshape(-1), how, include_self=False).view(B, S)


def detect(img: torch.Tensor) -> Segments:
    """Segments of each (B, H, W) image in [0, 1], computed in img.dtype."""
    dt, dev = img.dtype, img.device
    B, H, W = img.shape
    N = H * W
    x = blur(img, PREFILTER_SIGMA) * 255.0
    gx, gy = torch.zeros_like(x), torch.zeros_like(x)
    gx[:, :, 1:-1] = (x[:, :, 2:] - x[:, :, :-2]) * 0.5
    gy[:, 1:-1, :] = (x[:, 2:, :] - x[:, :-2, :]) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    mag[:, 0, :] = mag[:, -1, :] = 0
    mag[:, :, 0] = mag[:, :, -1] = 0
    rho, cos_tol = QUANT / math.sin(ANGLE_TOL), math.cos(ANGLE_TOL)
    support = mag > rho
    oks = []
    for dy, dx in _OFFSETS:
        dots = gx * _shift(gx, dy, dx) + gy * _shift(gy, dy, dx)
        oks.append(support & _shift(support, dy, dx) & (dots > cos_tol * mag * _shift(mag, dy, dx)))
    idx = torch.arange(N, dtype=torch.int64, device=dev).view(1, H, W).expand(B, H, W)
    lab = torch.where(support, idx, torch.full_like(idx, N))
    mx = torch.where(support, idx, torch.full_like(idx, -1))
    big, neg = torch.full_like(lab, N), torch.full_like(mx, -1)
    for _ in range(CCL_ROUNDS):
        lm, mm = lab, mx
        for ok, (dy, dx) in zip(oks, _OFFSETS):
            lm = torch.minimum(lm, torch.where(ok, _shift(lab, dy, dx), big))
            mm = torch.maximum(mm, torch.where(ok, _shift(mx, dy, dx), neg))
        lab, mx = lm, mm
    # one pointer jump, then one more masked min round
    lf = lab.reshape(B, N)
    lut = torch.cat([lf, lf.new_full((B, 1), N)], dim=-1)
    lab = torch.minimum(torch.gather(lut, -1, lf), lf).view(B, H, W)
    m = lab
    for ok, (dy, dx) in zip(oks, _OFFSETS):
        m = torch.minimum(m, torch.where(ok, _shift(lab, dy, dx), big))
    lab = m.reshape(B, N)
    sup = support.reshape(B, N)

    pix = torch.arange(N, device=dev)
    ys, xs = (pix // W).to(dt), (pix % W).to(dt)
    far = torch.clamp(mx.reshape(B, N), min=0)
    span = torch.hypot((far % W).to(dt) - xs, (far // W).to(dt) - ys)
    key = torch.where((lab == pix) & sup, span + 1.0, torch.zeros_like(span))
    roots = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :K]

    slot_of = torch.full((B, N + 1), K, dtype=torch.long, device=dev)
    slot_of.scatter_(1, roots, torch.arange(K, device=dev).expand(B, K))
    member = torch.gather(slot_of, 1, lab)
    w = torch.where(sup, mag.reshape(B, N), torch.zeros((), dtype=dt, device=dev))
    wx, wy = w * xs, w * ys
    cols = torch.stack([sup.to(dt), w, wx, wy, wx * xs, wy * ys, wx * ys], dim=1)
    count, sw, swx, swy, swxx, swyy, swxy = _slot_sums(cols, member, K + 1)[..., :K].unbind(1)
    csw = torch.clamp(sw, min=1e-6)
    cx, cy = swx / csw, swy / csw
    ev = _principal_direction(swxx / csw - cx * cx, swyy / csw - cy * cy, swxy / csw - cx * cy)

    pad = torch.zeros((B, 1), dtype=dt, device=dev)
    cxm, cym = torch.gather(torch.cat([cx, pad], 1), 1, member), torch.gather(torch.cat([cy, pad], 1), 1, member)
    evx = torch.gather(torch.cat([ev[..., 0], pad], 1), 1, member)
    evy = torch.gather(torch.cat([ev[..., 1], pad], 1), 1, member)
    relx, rely = xs - cxm, ys - cym
    t = relx * evx + rely * evy
    tn = -relx * evy + rely * evx
    t_min = _slot_extreme(t, member, K + 1, "amin")[:, :K]
    t_max = _slot_extreme(t, member, K + 1, "amax")[:, :K]
    sn2 = _slot_sums((w * tn * tn)[:, None], member, K + 1)[:, 0, :K]
    width = 2.0 * torch.sqrt(3.0 * torch.clamp(sn2 / csw, min=1e-9))
    empty = count < 0.5
    t_min = torch.where(empty, torch.zeros_like(t_min), t_min)
    t_max = torch.where(empty, torch.zeros_like(t_max), t_max)
    length = t_max - t_min
    p0 = torch.stack([cx + t_min * ev[..., 0], cy + t_min * ev[..., 1]], dim=-1)
    p1 = torch.stack([cx + t_max * ev[..., 0], cy + t_max * ev[..., 1]], dim=-1)
    density = count / torch.clamp(length * torch.clamp(width, min=1.0), min=1e-6)
    valid = (count >= MIN_SUPPORT) & (length >= MIN_LENGTH) & (density >= MIN_DENSITY) & (width <= MAX_WIDTH)
    return _merge(torch.stack([p0, p1], dim=-2), valid, count, width, torch.atan2(ev[..., 1], ev[..., 0]),
                  torch.stack([cx, cy], dim=-1))


def _merge(ep, valid, resp, width, angle, mid) -> Segments:
    """Collinear, nearly touching segments merged: a K x K adjacency,
    min-label rounds with pointer jumps over it, per-group endpoint moments."""
    B = ep.shape[0]
    dt, dev = ep.dtype, ep.device
    p0, p1 = ep[..., 0, :], ep[..., 1, :]
    d = p1 - p0
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)

    def rel(p):
        return p[:, None, :, :] - mid[:, :, None, :]

    def perp(p):
        r = rel(p)
        return torch.abs(r[..., 0] * (-dn[:, :, None, 1]) + r[..., 1] * dn[:, :, None, 0])

    def along(p):
        r = rel(p)
        return r[..., 0] * dn[:, :, None, 0] + r[..., 1] * dn[:, :, None, 1]

    da = torch.fmod(torch.abs(angle[:, :, None] - angle[:, None, :]), math.pi)
    da = torch.minimum(da, math.pi - da)
    tj0, tj1 = along(p0), along(p1)
    ti = torch.sum((ep - mid[:, :, None, :]) * dn[:, :, None, :], dim=-1)
    gap = torch.maximum(torch.minimum(tj0, tj1) - ti.max(-1).values[:, :, None],
                        ti.min(-1).values[:, :, None] - torch.maximum(tj0, tj1))
    adj = (perp(p0) < MERGE_PERP) & (perp(p1) < MERGE_PERP) & (da < MERGE_ANGLE) & (gap < MERGE_GAP)
    adj = adj & valid[:, :, None] & valid[:, None, :]
    adj = adj & adj.transpose(-1, -2) | torch.eye(K, dtype=torch.bool, device=dev)
    ar = torch.arange(K, device=dev)
    labels = ar.expand(B, K)
    for _ in range(MERGE_ROUNDS):
        labels = torch.min(torch.where(adj, labels[:, None, :], K), dim=-1).values
        labels = torch.gather(labels, -1, labels)
    w = resp * valid.to(dt)
    epw = 0.5 * w[..., None]
    cols = torch.stack([
        w, torch.sum(ep[..., 0] * epw, -1), torch.sum(ep[..., 1] * epw, -1), torch.sum(ep[..., 0] ** 2 * epw, -1),
        torch.sum(ep[..., 1] ** 2 * epw, -1), torch.sum(ep[..., 0] * ep[..., 1] * epw, -1), w * width,
    ], dim=1)
    sw_, sx, sy, sxx, syy, sxy, _ = _slot_sums(cols, labels, K).unbind(1)
    sw_ = torch.clamp(sw_, min=1e-6)
    ex, ey = sx / sw_, sy / sw_
    ev = _principal_direction(sxx / sw_ - ex * ex, syy / sw_ - ey * ey, sxy / sw_ - ex * ey)
    at = labels[..., None].expand(B, K, 2)
    gd = torch.gather(ev, 1, at)
    gc = torch.gather(torch.stack([ex, ey], -1), 1, at)
    t_ep = torch.sum((ep - gc[:, :, None, :]) * gd[:, :, None, :], dim=-1)
    inf = torch.full_like(t_ep, math.inf)
    t_lo = torch.min(torch.where(valid[..., None], t_ep, inf), -1).values
    t_hi = torch.max(torch.where(valid[..., None], t_ep, -inf), -1).values
    g_lo = _slot_extreme(t_lo, labels, K, "amin")
    g_hi = _slot_extreme(t_hi, labels, K, "amax")
    g_lo = torch.where(torch.isfinite(g_lo), g_lo, torch.zeros_like(g_lo))
    g_hi = torch.where(torch.isfinite(g_hi), g_hi, torch.zeros_like(g_hi))
    c = torch.stack([ex, ey], -1)
    return Segments(torch.stack([c + g_lo[..., None] * ev, c + g_hi[..., None] * ev], dim=-2),
                    (labels == ar) & valid)


def detect_levels(frames_u8: np.ndarray, device, dtype=torch.float32):
    """Per pyramid level the Segments of (B, H, W) uint8 frames (the image
    the system is handed, over 255), in ``dtype``."""
    img = torch.as_tensor(np.ascontiguousarray(frames_u8), device=device).to(torch.float32) / 255.0
    return [detect(lv) for lv in pyramid(img.to(dtype))]


def unmatched(a_ep: np.ndarray, a_ok: np.ndarray, b_ep: np.ndarray, b_ok: np.ndarray, tol: float = MATCH_PX):
    """(segments of a with no segment of b within ``tol`` at both ends, in
    either order; count of a's valid segments)."""
    A, Bs = a_ep[a_ok > 0.5].astype(np.float64), b_ep[b_ok > 0.5].astype(np.float64)
    if len(A) == 0:
        return 0, 0
    if len(Bs) == 0:
        return len(A), len(A)
    d = lambda i, j: np.linalg.norm(A[:, None, i] - Bs[None, :, j], axis=-1)  # noqa: E731
    same = np.maximum(d(0, 0), d(1, 1))
    swap = np.maximum(d(0, 1), d(1, 0))
    best = np.minimum(same, swap).min(axis=1)
    return int(np.sum(~(best <= tol))), len(A)


def det_gap(pairs) -> float:
    """Over (program, reference) pairs of one image's (endpoints, valid),
    the share of valid segments, of both sides pooled, that have no match on
    the other side."""
    miss = total = 0
    for (pe, pv), (re_, rv) in pairs:
        m1, n1 = unmatched(pe, pv, re_, rv)
        m2, n2 = unmatched(re_, rv, pe, pv)
        miss += m1 + m2
        total += n1 + n2
    return miss / total if total else math.inf
