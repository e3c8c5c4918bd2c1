"""LSD-style line segment detector by connected-component labelling (torch).

Counterpart of ``tpuslam.kernels.lsd``; see that module for the method. The
label propagation is a kernel wrapper: :func:`ccl_propagate` launches the
CUDA kernel of ``csrc/ccl.cu`` on a CUDA tensor and runs the plain PyTorch
version :func:`_ccl_torch` on a CPU tensor; both are bit-equal to
``tpuslam.kernels.lsd._ccl_xla``. ``LAUNCHES["ccl"]`` counts kernel calls
made on the card, ``KERNEL_LAUNCHES["ccl"]`` the device launches of those
calls: each launch runs k rounds on shared-memory tiles (:data:`CCL_TILE`),
so a call of R rounds is ceil(R / k) launches.

Three places differ in form from the JAX code, not in result:

- The top-K root selection must reproduce ``jax.lax.top_k``'s tie order:
  the unused slots take the lowest-index zero-key pixels (row 0, never in
  the support mask, so they collect no members). ``torch.topk`` promises no
  order among ties and can pick a non-root pixel that is still another
  pixel's label; :func:`topk_stable` is a stable descending sort instead.
- The per-component moments: XLA fuses the (K, N) one-hot compare into its
  reductions, eager PyTorch would materialise it (315 MB per temporary at
  VGA). Each label is instead mapped to its slot (other labels to a dump
  slot K) and reduced with ``index_add_`` / ``scatter_reduce``. Float sums
  run in another order, so moments agree to float rounding, not bitwise.
- ``jnp.hypot`` is written out with JAX's own formula, so the root keys,
  and with them the slot order, are bit-equal.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tpuslam_torch.kernels import cuda_lib
from tpuslam_torch.kernels.image import gaussian_blur, image_gradients, sqrt_rn

LAUNCHES = {"ccl": 0}
KERNEL_LAUNCHES = {"ccl": 0}

# (TY, TX, k) of the CUDA kernel: each launch runs k synchronous rounds on a
# TY x TX output tile inside a wrap-indexed (TY + 2k) x (TX + 2k) window in
# shared memory. The wrapper passes it to the C function, and
# tests/test_torch_ccl_tiles.py models the same schedule in numpy. The
# fastest of the tiles timed at 480x640 on an H100 (csrc/ccl.cu, PERF.md),
# and the only instance the library builds.
CCL_TILE = (32, 32, 8)


class LSDParams(NamedTuple):
    angle_tol: float = math.pi / 8  # 22.5 deg
    quant: float = 2.0  # gradient quantization error bound (on [0,255] scale)
    min_length: float = 15.0  # px, at detection level
    min_support: int = 20  # pixels in component
    min_density: float = 0.35  # support / (length * width)
    max_width: float = 8.0  # px, reject blobs
    ccl_rounds: int = 64  # min/max-propagation rounds = base geodesic reach
    ccl_jumps: int = 1  # pointer-jump rounds after propagation
    prefilter_sigma: float = 0.75  # pre-smoothing (0 = off)
    merge_fragments: bool = True  # collinear post-merge (junction splits)
    ccl: str = "auto"  # the JAX package's CCL backend switch; here the
    # tensor's device decides (CUDA kernel on the card, plain version on CPU)


class DetectedLines(NamedTuple):
    endpoints: torch.Tensor  # (K, 2, 2) [[x0,y0],[x1,y1]] in px
    valid: torch.Tensor  # (K,) f32 {0,1}
    response: torch.Tensor  # (K,) support pixel count
    angle: torch.Tensor  # (K,) segment direction angle
    width: torch.Tensor  # (K,) rectangle width
    midpoint: torch.Tensor  # (K, 2)
    length: torch.Tensor  # (K,)


_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift a 2-D tensor by (dy, dx) with wrap-around, as ``jnp.roll``."""
    return torch.roll(x, (dy, dx), dims=(0, 1))


def _compat_masks(compat_bits: torch.Tensor):
    return [((compat_bits >> d) & 1) > 0 for d in range(len(_OFFSETS))]


def _ccl_torch(labels: torch.Tensor, maxlab: torch.Tensor, compat_bits: torch.Tensor, rounds: int):
    """Plain version: R synchronous rounds of masked 8-neighbour min-label and
    max-label propagation (the math of ``lsd._ccl_xla``)."""
    H, W = labels.shape
    big = torch.full_like(labels, H * W)
    neg = torch.full_like(maxlab, -1)
    oks = _compat_masks(compat_bits)
    lab, mx = labels, maxlab
    for _ in range(rounds):
        lm, mm = lab, mx
        for ok, (dy, dx) in zip(oks, _OFFSETS):
            lm = torch.minimum(lm, torch.where(ok, _shift(lab, dy, dx), big))
            mm = torch.maximum(mm, torch.where(ok, _shift(mx, dy, dx), neg))
        lab, mx = lm, mm
    return lab, mx


def _check_ccl_planes(labels, maxlab, compat_bits):
    for t, name in ((labels, "labels"), (maxlab, "maxlab"), (compat_bits, "compat_bits")):
        cuda_lib.require_plane(t, torch.int32, f"ccl_propagate {name}")
    if not (labels.shape == maxlab.shape == compat_bits.shape):
        raise ValueError("ccl_propagate: planes differ in shape")
    if not (labels.device == maxlab.device == compat_bits.device):
        raise ValueError("ccl_propagate: planes on different devices")


def _ccl_cuda(labels, maxlab, compat_bits, rounds: int):
    _check_ccl_planes(labels, maxlab, compat_bits)
    H, W = labels.shape
    lab_out, mx_out, lab_tmp, mx_tmp = (torch.empty_like(labels) for _ in range(4))
    n = ctypes.c_int(0)
    code = cuda_lib.library().tpuslam_ccl(
        labels.data_ptr(), maxlab.data_ptr(), compat_bits.data_ptr(),
        lab_out.data_ptr(), mx_out.data_ptr(), lab_tmp.data_ptr(), mx_tmp.data_ptr(),
        H, W, int(rounds), *CCL_TILE, ctypes.byref(n), cuda_lib.stream_of(labels),
    )
    cuda_lib.check(code, "ccl_propagate")
    LAUNCHES["ccl"] += 1
    KERNEL_LAUNCHES["ccl"] += n.value
    return lab_out, mx_out


def _ccl_per_round_cuda(labels, maxlab, compat_bits, rounds: int):
    """The per-round form of the kernel (its first form): one launch per
    round, for timing and bit-equality checks beside :func:`_ccl_cuda` on
    the card. The detector never calls it, and it counts no launches."""
    _check_ccl_planes(labels, maxlab, compat_bits)
    H, W = labels.shape
    lab_out, mx_out, lab_tmp, mx_tmp = (torch.empty_like(labels) for _ in range(4))
    code = cuda_lib.library().tpuslam_ccl_per_round(
        labels.data_ptr(), maxlab.data_ptr(), compat_bits.data_ptr(),
        lab_out.data_ptr(), mx_out.data_ptr(), lab_tmp.data_ptr(), mx_tmp.data_ptr(),
        H, W, int(rounds), cuda_lib.stream_of(labels),
    )
    cuda_lib.check(code, "ccl_propagate (per round)")
    return lab_out, mx_out


def ccl_propagate(labels: torch.Tensor, maxlab: torch.Tensor, compat_bits: torch.Tensor, rounds: int):
    """(H, W) int32 labels (H*W at non-support), max labels (-1 there) and
    compat bits -> the planes after ``rounds`` propagation rounds. Kernel on
    CUDA tensors, plain version on CPU tensors."""
    if cuda_lib.on_card(labels):
        return _ccl_cuda(labels, maxlab, compat_bits, rounds)
    return _ccl_torch(labels, maxlab, compat_bits, rounds)


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, ties broken towards
    the lower index — the order ``jax.lax.top_k`` gives."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` step for step (bit-equal in float32)."""
    a, b = torch.abs(a), torch.abs(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * sqrt_rn(1 + torch.square(lo / safe)))


def _principal_direction(mxx, myy, mxy):
    """Unit eigenvector of the larger eigenvalue of [[mxx, mxy], [mxy, myy]]."""
    tr = mxx + myy
    det = mxx * myy - mxy * mxy
    lam1 = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    e1 = torch.stack([mxy, lam1 - mxx], dim=-1)
    e2 = torch.stack([lam1 - myy, mxy], dim=-1)
    use_e1 = torch.linalg.norm(e1, dim=-1) > torch.linalg.norm(e2, dim=-1)
    ev = torch.where(use_e1[:, None], e1, e2)
    return ev / torch.clamp(torch.linalg.norm(ev, dim=-1, keepdim=True), min=1e-9)


def ccl_inputs(img: torch.Tensor, params: LSDParams = LSDParams()):
    """The detector up to label propagation: prefilter, gradients, support
    mask and the bit-packed neighbour-compatibility plane. Returns (gx, gy,
    mag, support, labels0, maxlab0, compat_bits); the last three are what
    :func:`ccl_propagate` takes."""
    H, W = img.shape
    N = H * W
    dev = img.device
    if params.prefilter_sigma > 0:
        img = gaussian_blur(img, params.prefilter_sigma)
    gx, gy, mag, _ = image_gradients(img * 255.0)  # thresholds on 0..255

    rho = params.quant / math.sin(params.angle_tol)
    support = mag > rho

    # neighbour compatibility as one bit-packed int32 plane (angle agreement
    # through the gradient dot product, as in the JAX package)
    cos_tol = math.cos(params.angle_tol)
    compat_bits = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for d, (dy, dx) in enumerate(_OFFSETS):
        dots = gx * _shift(gx, dy, dx) + gy * _shift(gy, dy, dx)
        ok = support & _shift(support, dy, dx) & (dots > cos_tol * mag * _shift(mag, dy, dx))
        compat_bits = compat_bits | (ok.to(torch.int32) << d)

    idx = torch.arange(N, dtype=torch.int32, device=dev).view(H, W)
    labels0 = torch.where(support, idx, torch.full_like(idx, N))
    maxlab0 = torch.where(support, idx, torch.full_like(idx, -1))
    return gx, gy, mag, support, labels0, maxlab0, compat_bits


def detect_lines(img: torch.Tensor, max_lines: int = 256, params: LSDParams = LSDParams()) -> DetectedLines:
    """Detect line segments in an (H, W) float32 image in [0, 1].

    Returns DetectedLines with capacity ``max_lines`` (mask-padded)."""
    H, W = img.shape
    N = H * W
    K = max_lines
    dev = img.device
    gx, gy, mag, support, labels0, maxlab0, compat_bits = ccl_inputs(img, params)

    # connected components: min/max-label propagation + pointer jumps
    jumps = params.ccl_jumps if W <= 768 else max(params.ccl_jumps, 3)
    labels, maxlab = ccl_propagate(labels0, maxlab0, compat_bits, params.ccl_rounds)
    if jumps:
        oks = _compat_masks(compat_bits)
        big = torch.full_like(labels, N)
    for _ in range(jumps):
        lf = labels.reshape(-1)
        lut = torch.cat([lf, lf.new_full((1,), N)])
        labels = torch.minimum(lut[torch.clamp(lf, max=N).long()], lf).view(H, W)
        m = labels
        for ok, (dy, dx) in zip(oks, _OFFSETS):
            m = torch.minimum(m, torch.where(ok, _shift(labels, dy, dx), big))
        labels = m

    flat_labels = labels.reshape(-1)  # N marks non-support
    flat_support = support.reshape(-1)

    # top-K roots by spanned diagonal
    pix = torch.arange(N, dtype=torch.int32, device=dev)
    ys_i, xs_i = pix // W, pix % W
    xs = xs_i.to(torch.float32)
    ys = ys_i.to(torch.float32)
    far = torch.clamp(maxlab.reshape(-1), min=0)
    span = _hypot((far % W - xs_i).to(torch.float32), (far // W - ys_i).to(torch.float32))
    is_root = (flat_labels == pix) & flat_support
    key = torch.where(is_root, span + 1.0, torch.zeros_like(span))
    comp_ids = topk_stable(key, K)  # (K,) root pixel indices

    # per-component moments: label -> slot, dump slot K for everything else
    slot_of_label = torch.full((N + 1,), K, dtype=torch.long, device=dev)
    slot_of_label[comp_ids.long()] = torch.arange(K, device=dev)
    member = slot_of_label[flat_labels.long()]  # (N,) in [0, K]
    w = torch.where(flat_support, mag.reshape(-1), torch.zeros_like(xs))

    def red(*vals):  # each (N,) -> (K,)
        src = torch.stack(vals, dim=1)
        acc = torch.zeros((K + 1, len(vals)), dtype=torch.float32, device=dev)
        return acc.index_add_(0, member, src)[:K].unbind(1)

    wx, wy = w * xs, w * ys
    count, sw, swx, swy, swxx, swyy, swxy = red(
        flat_support.to(torch.float32), w, wx, wy, wx * xs, wy * ys, wx * ys
    )
    csw = torch.clamp(sw, min=1e-6)
    cx = swx / csw
    cy = swy / csw
    mxx = swxx / csw - cx * cx
    myy = swyy / csw - cy * cy
    mxy = swxy / csw - cx * cy
    resp = count
    ev = _principal_direction(mxx, myy, mxy)

    # extents along the principal direction, normal second moment
    pad = torch.zeros(1, dtype=torch.float32, device=dev)
    cxm = torch.cat([cx, pad])[member]
    cym = torch.cat([cy, pad])[member]
    evm = torch.cat([ev, torch.zeros((1, 2), dtype=torch.float32, device=dev)])[member]
    relx = xs - cxm
    rely = ys - cym
    t = relx * evm[:, 0] + rely * evm[:, 1]
    tn = -relx * evm[:, 1] + rely * evm[:, 0]
    inf = torch.full((K + 1,), math.inf, dtype=torch.float32, device=dev)
    t_min = inf.scatter_reduce(0, member, t, "amin", include_self=False)[:K]
    t_max = (-inf).scatter_reduce(0, member, t, "amax", include_self=False)[:K]
    (sn2,) = red(w * tn * tn)
    width = 2.0 * torch.sqrt(3.0 * torch.clamp(sn2 / csw, min=1e-9))

    empty = count < 0.5
    t_min = torch.where(empty, torch.zeros_like(t_min), t_min)
    t_max = torch.where(empty, torch.zeros_like(t_max), t_max)
    length = t_max - t_min
    p0 = torch.stack([cx + t_min * ev[:, 0], cy + t_min * ev[:, 1]], dim=-1)
    p1 = torch.stack([cx + t_max * ev[:, 0], cy + t_max * ev[:, 1]], dim=-1)

    density = resp / torch.clamp(length * torch.clamp(width, min=1.0), min=1e-6)
    valid = (
        (resp >= params.min_support)
        & (length >= params.min_length)
        & (density >= params.min_density)
        & (width <= params.max_width)
    )
    det = DetectedLines(
        endpoints=torch.stack([p0, p1], dim=1),
        valid=valid.to(torch.float32),
        response=resp,
        angle=torch.atan2(ev[:, 1], ev[:, 0]),
        width=width,
        midpoint=torch.stack([cx, cy], dim=-1),
        length=length,
    )
    if params.merge_fragments:
        det = merge_collinear(det)
    return det


def merge_collinear(
    det: DetectedLines,
    tol_angle: float = 0.06,
    tol_perp: float = 2.0,
    max_gap: float = 12.0,
    n_rounds: int = 6,
) -> DetectedLines:
    """Merge collinear, nearly-touching segments (junction/stair fragments):
    a K x K adjacency, min-label propagation over it, per-group moments."""
    K = det.endpoints.shape[0]
    dev = det.endpoints.device
    validb = det.valid > 0.5
    p0, p1 = det.endpoints[:, 0], det.endpoints[:, 1]
    d = p1 - p0
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)

    def rel_to_i(p):  # (K, 2) points -> (K, K, 2): p[j] relative to midpoint i
        return p[None, :, :] - det.midpoint[:, None, :]

    def perp_to_i(p):  # (K, K): distance of p[j] to line i
        rel = rel_to_i(p)
        return torch.abs(rel[..., 0] * (-dn[:, None, 1]) + rel[..., 1] * dn[:, None, 0])

    def proj_to_i(p):  # (K, K): coordinate of p[j] along line i
        rel = rel_to_i(p)
        return rel[..., 0] * dn[:, None, 0] + rel[..., 1] * dn[:, None, 1]

    perp_ok = (perp_to_i(p0) < tol_perp) & (perp_to_i(p1) < tol_perp)
    da = torch.fmod(torch.abs(det.angle[:, None] - det.angle[None, :]), math.pi)
    da = torch.minimum(da, math.pi - da)
    ang_ok = da < tol_angle

    tj0, tj1 = proj_to_i(p0), proj_to_i(p1)
    j_lo = torch.minimum(tj0, tj1)
    j_hi = torch.maximum(tj0, tj1)
    ti = torch.sum((det.endpoints - det.midpoint[:, None, :]) * dn[:, None, :], dim=-1)
    i_lo = torch.min(ti, dim=1).values[:, None]
    i_hi = torch.max(ti, dim=1).values[:, None]
    gap = torch.maximum(j_lo - i_hi, i_lo - j_hi)
    gap_ok = gap < max_gap

    vv = validb[:, None] & validb[None, :]
    adj = perp_ok & ang_ok & gap_ok & vv
    adj = adj & adj.T
    adj = adj | torch.eye(K, dtype=torch.bool, device=dev)

    ar = torch.arange(K, device=dev)
    labels = ar
    for _ in range(n_rounds):
        labels = torch.min(torch.where(adj, labels[None, :], K), dim=1).values
        labels = labels[labels]  # pointer jump

    is_rep = (labels == ar) & validb
    w = det.response * det.valid

    def seg(x):
        return torch.zeros(K, dtype=x.dtype, device=dev).index_add_(0, labels, x)

    sw = torch.clamp(seg(w), min=1e-6)
    epw = 0.5 * w[:, None]
    ep = det.endpoints
    ex = seg(torch.sum(ep[..., 0] * epw, dim=1)) / sw
    ey = seg(torch.sum(ep[..., 1] * epw, dim=1)) / sw
    exx = seg(torch.sum(ep[..., 0] ** 2 * epw, dim=1)) / sw - ex * ex
    eyy = seg(torch.sum(ep[..., 1] ** 2 * epw, dim=1)) / sw - ey * ey
    exy = seg(torch.sum(ep[..., 0] * ep[..., 1] * epw, dim=1)) / sw - ex * ey
    ev = _principal_direction(exx, eyy, exy)

    gd = ev[labels]
    gc = torch.stack([ex, ey], dim=-1)[labels]
    t_ep = torch.sum((ep - gc[:, None, :]) * gd[:, None, :], dim=-1)  # (K, 2)
    inf = torch.full_like(t_ep, math.inf)
    t_lo = torch.min(torch.where(validb[:, None], t_ep, inf), dim=1).values
    t_hi = torch.max(torch.where(validb[:, None], t_ep, -inf), dim=1).values
    kinf = torch.full((K,), math.inf, dtype=t_lo.dtype, device=dev)
    g_lo = kinf.scatter_reduce(0, labels, t_lo, "amin", include_self=False)
    g_hi = (-kinf).scatter_reduce(0, labels, t_hi, "amax", include_self=False)
    g_lo = torch.where(torch.isfinite(g_lo), g_lo, torch.zeros_like(g_lo))
    g_hi = torch.where(torch.isfinite(g_hi), g_hi, torch.zeros_like(g_hi))

    c = torch.stack([ex, ey], dim=-1)
    new_resp = seg(w)
    return DetectedLines(
        endpoints=torch.stack([c + g_lo[:, None] * ev, c + g_hi[:, None] * ev], dim=1),
        valid=is_rep.to(torch.float32),
        response=new_resp,
        angle=torch.atan2(ev[:, 1], ev[:, 0]),
        width=seg(w * det.width) / sw,
        midpoint=c + 0.5 * (g_lo + g_hi)[:, None] * ev,
        length=g_hi - g_lo,
    )
