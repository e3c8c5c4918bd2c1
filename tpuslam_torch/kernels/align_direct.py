"""Semi-direct pose alignment of a frame against the 3D line map (torch).

Counterpart of ``tpuslam.kernels.align_direct`` (lines): the anchor frame of
a chunk, which ran the full detector and pose LM, cuts a photometric
template at S points along each local map line's projection
(:func:`anchor_templates_body`). Each following frame projects the same 3D
points under its motion-model pose, slides each template along the image
axis most perpendicular to the line (zero-mean SAD, integer argmin +
parabola subpixel; :func:`_search_templates`), takes the best placement as a
point on the observed line, and refines the 6-DoF pose by Gauss-Newton over
the point-to-projected-line residual with Huber weights (:func:`_gn_pose`).

The JAX package computes this outside any Pallas kernel, so it is plain
PyTorch on the caller's device. Its Gauss-Newton takes the Jacobian by
``jax.jacfwd``; here it is written out: for the camera-frame line (n, v)
under the left perturbation exp(xi^) T, dn/d(rho, phi) = [-[v]x, -[n]x], and
the residual r = m^T l / sqrt(l1^2 + l2^2 + eps) of l = K_L n has
dr/dl = m / |l|_12 - r / |l|_12^2 * (l1, l2, 0).

Hybrid chunks align map points beside the lines: each point carries two 1-D
templates through its anchor projection (a row profile searched along x and
a column profile searched along y, :func:`anchor_point_templates_body`,
:func:`_search_point_templates`), a full 2-DoF reprojection constraint in
the same Gauss-Newton (:func:`align_frame_hybrid_body`); the point residual's
Jacobian is written out too (:func:`point_sample_residuals_and_jacobian`).

The sample points and their projections round as the JAX package's jitted
bodies do: XLA contracts each ``a * b + c`` there into one fused
multiply-add, and a bilinear template sample on a strong edge moves by up to
0.005 (0..255 scale) per float32 ulp of its projected coordinate. ``_fma``
rounds such steps once, through float64 (where the float32 product is
exact), on the CPU and the card alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.geometry.camera import Intrinsics, line_projection_matrix, project_points
from tpuslam_torch.geometry.plucker import plucker_transform
from tpuslam_torch.geometry.se3 import se3_apply, se3_retract, so3_hat
from tpuslam_torch.kernels.stereo_direct import linspace, moving_mean, subpixel_argmin

_EPS = 1e-9


class DirectAlignParams(NamedTuple):
    """Same fields and defaults as the JAX package's."""

    n_samples: int = 6  # S sample points per landmark segment
    template: int = 8  # Wt template width (px along the search axis)
    search: int = 8  # max |shift| (px); the cost is evaluated at 2*search+1 placements
    gn_iters: int = 4  # Gauss-Newton iterations over the pose
    rounds: int = 2  # search + GN rounds (the second re-searches from the refined pose)
    huber_px: float = 1.0  # Huber width on the point-to-line residual (full-res px)
    max_cost: float = 20.0  # mean ZSAD acceptance gate (0..255 intensity scale)
    min_contrast: float = 4.0  # template stddev gate (0..255 scale)
    ratio: float = 0.9  # best/second-best uniqueness gate on the cost
    max_res_px: float = 1.5  # per-sample inlier gate after GN (full-res px)
    min_line_samples: int = 3  # good samples for a line to count as aligned
    align_cap: int = 256  # A: static cap on local-map lines used
    min_z: float = 0.05
    # the image is at coord_scale x the coordinate frame of the landmark
    # geometry (prescaled half-resolution ingest): projections are multiplied
    # by this before sampling, measured points divided back to full-res px;
    # template/search widths above are image px
    coord_scale: float = 1.0
    point_cap: int = 256  # P: map points aligned beside the lines (hybrid)


class AlignTemplates(NamedTuple):
    """Per-(line, sample) photometric templates from the anchor frame."""

    p3d: torch.Tensor  # (A, S, 3) world-frame sample points on the 3D segments
    tmpl: torch.Tensor  # (A, S, Wt) float32 anchor intensity profile (0..255)
    vert: torch.Tensor  # (A,) float32 {0, 1}: 1 = search along y (line mostly horizontal)
    tvalid: torch.Tensor  # (A, S) float32 sample validity


class PointAlignTemplates(NamedTuple):
    """Per-point photometric templates: two orthogonal 1-D profiles through
    the anchor projection."""

    p3d: torch.Tensor  # (P, 3) world-frame map points
    tmpl: torch.Tensor  # (P, 2, Wt) float32; [:, 0] = row searched along x, [:, 1] = column searched along y
    tvalid: torch.Tensor  # (P, 2) float32 per-axis validity


def inject_coord_scale_align(p: DirectAlignParams, base_scale: float, prescaled: bool) -> DirectAlignParams:
    """Adapt the params to prescaled host ingest (images at base_scale,
    geometry at full resolution). No-op if coord_scale is already set."""
    if prescaled and base_scale != 1.0 and p.coord_scale == 1.0:
        return p._replace(coord_scale=base_scale)
    return p


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add); scalars
    count as float32."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else float(np.float32(x)) for x in (a, b, c))
    return (a * b + c).float()


def _project(T: torch.Tensor, X: torch.Tensor, cam: Intrinsics):
    """Camera-frame points (..., 3) of world points X under T, and their
    pixels (..., 2): ``se3_apply`` and ``project_points`` with the JAX
    package's fused multiply-adds."""
    R = T[:3, :3]
    Xc = _fma(R[:, 2], X[..., 2:3], _fma(R[:, 1], X[..., 1:2], R[:, 0] * X[..., 0:1])) + T[:3, 3]
    z = torch.clamp(Xc[..., 2:3], min=_EPS)
    uv = torch.cat([_fma(cam.fx, Xc[..., 0:1] / z, cam.cx), _fma(cam.fy, Xc[..., 1:2] / z, cam.cy)], dim=-1)
    return Xc, uv


def _axis_window(img255: torch.Tensor, u: torch.Tensor, v: torch.Tensor, vert: torch.Tensor, span: int, lo_off: int):
    """Intensity window along each sample's search axis: bilinear along the
    axis, nearest across it. ``vert`` broadcasts against u/v (1: the axis is
    y at a fixed column; 0: x at a fixed row). Returns (win (..., span), inb
    (..., span)) with win[k] = I(ax + lo_off + k) at the continuous axis
    coordinate ax: one flat gather of span + 1 pixels per sample, lerped."""
    H, W = img255.shape
    dev = img255.device
    is_v = vert > 0.5
    ax = torch.where(is_v, v, u)  # fractional along-axis coordinate
    cr = torch.where(is_v, u, v)  # cross coordinate (quantized: along the line)
    # far-off projections (points near the camera plane) stay far off: the
    # clamp only keeps the integer casts defined
    ax = torch.clamp(ax, -(2.0**24), 2.0**24)
    cri = torch.round(torch.clamp(cr, -(2.0**24), 2.0**24)).to(torch.int64)
    cross_lim = torch.where(is_v, W, H)
    cr_ok = (cri >= 0) & (cri < cross_lim)
    cric = torch.minimum(torch.clamp(cri, min=0), cross_lim - 1)
    af = torch.floor(ax)
    frac = ax - af
    pos = af.to(torch.int64)[..., None] + (lo_off + torch.arange(span + 1, device=dev))  # (..., span+1)
    lim = torch.where(is_v, H, W)[..., None]
    inb1 = (pos >= 0) & (pos < lim) & cr_ok[..., None]
    posc = torch.minimum(torch.clamp(pos, min=0), lim - 1)
    flat = torch.where(is_v[..., None], posc * W + cric[..., None], cric[..., None] * W + posc)
    g = img255.reshape(-1)[flat]
    win = (1.0 - frac[..., None]) * g[..., :span] + frac[..., None] * g[..., 1:]
    return win, inb1[..., :span] & inb1[..., 1:]


def _sample_points(ep3d: torch.Tensor, S: int) -> torch.Tensor:
    """(A, 2, 3) world endpoints -> (A, S, 3) sample points along segments."""
    t = linspace(0.08, 0.92, S, ep3d.device)
    e0, e1 = ep3d[:, 0], ep3d[:, 1]
    return _fma(t[None, :, None], (e1 - e0)[:, None, :], e0[:, None, :])


def anchor_templates_body(
    img: torch.Tensor,
    T_anchor: torch.Tensor,
    ep3d: torch.Tensor,
    validf: torch.Tensor,
    cam: Intrinsics,
    p: DirectAlignParams,
) -> AlignTemplates:
    """Photometric templates of the local map under the anchor's pose.

    img: (H, W) float32 in [0, 1], the anchor's left image at coord_scale.
    T_anchor: (4, 4) accepted anchor pose T_cw. ep3d: (A, 2, 3) world
    endpoints of the local map lines (sliced to align_cap by the caller)."""
    S, Wt = p.n_samples, p.template
    p3d = _sample_points(ep3d, S)
    Xc, uv = _project(T_anchor, p3d, cam)
    zok = Xc[..., 2] > p.min_z
    uv = uv * p.coord_scale  # (A, S, 2) image px
    # search axis from the projected segment direction at the anchor pose
    ep_c, ep_uv = _project(T_anchor, ep3d, cam)
    d2 = ep_uv[:, 1] - ep_uv[:, 0]
    vert = (torch.abs(d2[:, 0]) >= torch.abs(d2[:, 1])).to(torch.float32)
    win, inb = _axis_window(img * 255.0, uv[..., 0], uv[..., 1], vert[:, None], Wt, -(Wt // 2))
    contrast = torch.std(win, dim=-1, correction=0)
    seg_ok = torch.sum(d2 * d2, dim=-1) > 1.0  # degenerate projection guard
    tvalid = (
        zok
        & torch.all(inb, dim=-1)
        & (contrast > p.min_contrast)
        & (validf > 0.5)[:, None]
        & seg_ok[:, None]
        & torch.all(ep_c[..., 2] > p.min_z, dim=-1)[:, None]
    ).to(torch.float32)
    return AlignTemplates(p3d=p3d, tmpl=win, vert=vert, tvalid=tvalid)


def _slide_zsad(win: torch.Tensor, inb: torch.Tensor, tmpl: torch.Tensor, Wt: int, M: int, ratio: float):
    """Sliding zero-mean SAD of each template over its window and the
    subpixel argmin. win/inb: (..., M - 1 + Wt); tmpl: (..., Wt). Returns
    (delta (...,) subpixel shift in [-R, R], cbest (...,), uniq (...,))."""
    mwin = moving_mean(win, Wt)  # (..., M)
    mt = torch.mean(tmpl, dim=-1, keepdim=True)
    okw = moving_mean(inb.to(torch.float32), Wt)  # 1.0 iff fully in-bounds
    cost = torch.zeros_like(mwin)
    for w in range(Wt):
        cost = cost + torch.abs((win[..., w : w + M] - mwin) - (tmpl[..., w : w + 1] - mt))
    cost = cost / float(Wt) + (1.0 - (okw > 0.999).to(torch.float32)) * 1e6
    best, cbest, uniq, sub = subpixel_argmin(cost, ratio)
    delta = best.to(torch.float32) - (M - 1) // 2 + sub  # image px along the axis
    return delta, cbest, uniq


def _search_templates(img255: torch.Tensor, T: torch.Tensor, tm: AlignTemplates, cam: Intrinsics, p: DirectAlignParams):
    """Slide each template along its axis around its projection under T.
    Returns (m (A, S, 2) measured points in full-res px, ok (A, S) float32)."""
    Wt, R = p.template, p.search
    M = 2 * R + 1
    Xc, uv = _project(T, tm.p3d, cam)
    zok = Xc[..., 2] > p.min_z
    uv = uv * p.coord_scale  # (A, S, 2) image px
    win, inb = _axis_window(img255, uv[..., 0], uv[..., 1], tm.vert[:, None], M - 1 + Wt, -(R + Wt // 2))
    delta, cbest, uniq = _slide_zsad(win, inb, tm.tmpl, Wt, M, p.ratio)
    axis_vec = torch.stack([1.0 - tm.vert, tm.vert], dim=-1)[:, None, :]  # (A, 1, 2)
    m = (uv + delta[..., None] * axis_vec) / p.coord_scale  # full-res px
    ok = (
        uniq
        & (cbest < p.max_cost)
        & zok
        & (tm.tvalid > 0.5)
        & (torch.abs(delta) < float(R))  # reject rail-pinned placements
    ).to(torch.float32)
    return m, ok


def line_sample_residuals(T: torch.Tensor, plucker: torch.Tensor, mh: torch.Tensor, cam: Intrinsics):
    """Residuals (A, S) of homogeneous sample points ``mh`` (A, S, 3) to the
    projections of the world lines ``plucker`` (A, 6) under T, and the
    pieces of their Jacobian: (r, l, norm, L_c, K_L)."""
    L_c = plucker_transform(T, plucker)
    KL = line_projection_matrix(cam, device=L_c.device).to(L_c.dtype)
    l = (KL @ L_c[:, :3, None])[..., 0]  # (A, 3)
    norm = torch.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2 + _EPS)
    r = torch.sum(mh * l[:, None, :], dim=-1) / norm[:, None]
    return r, l, norm, L_c, KL


def line_sample_residuals_and_jacobian(T: torch.Tensor, plucker: torch.Tensor, mh: torch.Tensor, cam: Intrinsics):
    """Residuals (A, S) and their Jacobians (A, S, 6) w.r.t. the left pose
    perturbation xi = (rho, phi) at xi = 0 (``jax.jacfwd`` of the JAX
    package's ``res_all``)."""
    r, l, norm, L_c, KL = line_sample_residuals(T, plucker, mh, cam)
    dn = -torch.cat([so3_hat(L_c[:, 3:]), so3_hat(L_c[:, :3])], dim=-1)  # (A, 3, 6)
    dl = KL @ dn  # (A, 3, 6)
    grad_norm = torch.stack([l[:, 0], l[:, 1], torch.zeros_like(l[:, 0])], dim=-1)  # (A, 3)
    dr_dl = mh / norm[:, None, None] - (r / (norm * norm)[:, None])[..., None] * grad_norm[:, None, :]
    return r, dr_dl @ dl


_MIN_POINT_Z = 1e-3  # the point residual's depth floor (camera plane guard)


def point_sample_residuals_and_jacobian(T: torch.Tensor, pts3d: torch.Tensor, m_p: torch.Tensor, cam: Intrinsics):
    """Reprojection residuals (P, 2) of world points under T against the
    measured pixels ``m_p``, the camera-frame depth floored at 1e-3 (an
    outlier swinging behind the camera must not put inf into the normal
    equations), and their Jacobians (P, 2, 6) w.r.t. the left pose
    perturbation at 0: dX_c/d(rho, phi) = [I, -[X_c]x], through the floor
    (zero where it holds) and the pinhole."""
    Xc = se3_apply(T, pts3d)
    live = (Xc[:, 2] > _MIN_POINT_Z).to(Xc.dtype)
    z = torch.clamp(Xc[:, 2], min=_MIN_POINT_Z)
    Xf = torch.stack([Xc[:, 0], Xc[:, 1], z], dim=-1)
    r = project_points(cam, Xf) - m_p
    zero = torch.zeros_like(z)
    dpi = torch.stack(
        [
            torch.stack([cam.fx / z, zero, -cam.fx * Xc[:, 0] / (z * z) * live], dim=-1),
            torch.stack([zero, cam.fy / z, -cam.fy * Xc[:, 1] / (z * z) * live], dim=-1),
        ],
        dim=-2,
    )  # (P, 2, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[0], 3, 3)
    return r, dpi @ torch.cat([eye, -so3_hat(Xc)], dim=-1)


def _gn_pose(
    T0: torch.Tensor, plucker: torch.Tensor, m: torch.Tensor, w_ok: torch.Tensor, cam: Intrinsics, p: DirectAlignParams,
    pts3d: torch.Tensor | None = None, m_p: torch.Tensor | None = None, w_p: torch.Tensor | None = None,
):
    """Gauss-Newton over the left-perturbation pose tangent with Huber IRLS
    weights, ``p.gn_iters`` iterations and no host sync (the step is capped,
    not branched on); with ``pts3d`` the 2-DoF point residuals of the hybrid
    followers join the same system. Returns (T, r_final (A, S)), and
    rp_final (P, 2) third with ``pts3d``."""
    mh = torch.cat([m, torch.ones_like(m[..., :1])], dim=-1)  # (A, S, 3)
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    hybrid = pts3d is not None
    T = T0
    for _ in range(p.gn_iters):
        r, J = line_sample_residuals_and_jacobian(T, plucker, mh, cam)
        w = w_ok * torch.clamp(p.huber_px / torch.clamp(torch.abs(r), min=_EPS), max=1.0)
        Jf = J.reshape(-1, 6)
        wf = w.reshape(-1)
        H = Jf.T @ (Jf * wf[:, None])
        b = Jf.T @ (wf * r.reshape(-1))
        if hybrid:
            rp, Jp = point_sample_residuals_and_jacobian(T, pts3d, m_p, cam)
            wp = w_p[:, None] * torch.clamp(p.huber_px / torch.clamp(torch.abs(rp), min=_EPS), max=1.0)
            Jpf = Jp.reshape(-1, 6)
            wpf = wp.reshape(-1)
            H = H + Jpf.T @ (Jpf * wpf[:, None])
            b = b + Jpf.T @ (wpf * rp.reshape(-1))
        lam = 1e-4 * torch.trace(H) / 6.0 + 1e-6
        xi = -torch.linalg.solve_ex(H + lam * eye6, b)[0]  # no error check: no device sync
        # a degenerate system (too few constraints) must not launch the pose
        nrm = torch.sqrt(torch.sum(xi * xi))
        xi = xi * torch.clamp(0.5 / torch.clamp(nrm, min=1e-9), max=1.0)
        T = se3_retract(T, xi)
    r = line_sample_residuals(T, plucker, mh, cam)[0]
    if hybrid:
        return T, r, point_sample_residuals_and_jacobian(T, pts3d, m_p, cam)[0]
    return T, r


def align_frame_body(
    img: torch.Tensor,
    T_pred: torch.Tensor,
    plucker: torch.Tensor,
    tm: AlignTemplates,
    cam: Intrinsics,
    p: DirectAlignParams,
):
    """One semi-direct frame: template search + Gauss-Newton pose refine,
    ``p.rounds`` times. img: (H, W) float32 in [0, 1] (left image at
    coord_scale); T_pred: (4, 4) motion-model prediction; plucker: (A, 6)
    world lines of the templates. Returns (T_new, n_samples_good,
    n_lines_good), the counts as float32 scalars."""
    img255 = img * 255.0
    T = T_pred
    for _ in range(max(1, p.rounds)):
        m, ok = _search_templates(img255, T, tm, cam, p)
        T, r = _gn_pose(T, plucker, m, ok, cam, p)
    good = ok * (torch.abs(r) < p.max_res_px).to(torch.float32)  # (A, S)
    line_good = (torch.sum(good, dim=-1) >= float(p.min_line_samples)).to(torch.float32)
    return T, torch.sum(good), torch.sum(line_good)


def _point_windows(img255: torch.Tensor, uv: torch.Tensor, span: int, lo_off: int):
    """Both axis windows of each point, x then y: (win (P, 2, span), inb
    (P, 2, span))."""
    P_ = uv.shape[0]
    vert = torch.arange(2, dtype=torch.float32, device=uv.device).expand(P_, 2)  # 0: along x, 1: along y
    return _axis_window(img255, uv[:, 0:1].expand(P_, 2), uv[:, 1:2].expand(P_, 2), vert, span, lo_off)


def anchor_point_templates_body(
    img: torch.Tensor,
    T_anchor: torch.Tensor,
    xyz: torch.Tensor,
    validf: torch.Tensor,
    cam: Intrinsics,
    p: DirectAlignParams,
) -> PointAlignTemplates:
    """Two orthogonal 1-D templates per map point from the anchor image:
    a row profile (searched along x) and a column profile (searched along
    y), each gated on contrast on its own. img: (H, W) float32 in [0, 1];
    xyz: (P, 3) world points (sliced to point_cap by the caller)."""
    Wt = p.template
    Xc, uv = _project(T_anchor, xyz, cam)
    zok = Xc[:, 2] > p.min_z
    win, inb = _point_windows(img * 255.0, uv * p.coord_scale, Wt, -(Wt // 2))  # (P, 2, Wt)
    contrast = torch.std(win, dim=-1, correction=0)
    tvalid = (zok[:, None] & torch.all(inb, dim=-1) & (contrast > p.min_contrast) & (validf > 0.5)[:, None]).to(torch.float32)
    return PointAlignTemplates(p3d=xyz, tmpl=win, tvalid=tvalid)


def _search_point_templates(img255: torch.Tensor, T: torch.Tensor, tm: PointAlignTemplates, cam: Intrinsics, p: DirectAlignParams):
    """Slide each point's two templates around its projection under T.
    Returns (m (P, 2) measured uv in full-res px, ok (P,) float32: both axes
    pass their gates and the point is in front)."""
    Wt, R = p.template, p.search
    M = 2 * R + 1
    Xc, uv = _project(T, tm.p3d, cam)
    zok = Xc[:, 2] > p.min_z
    uv = uv * p.coord_scale  # (P, 2) image px
    win, inb = _point_windows(img255, uv, M - 1 + Wt, -(R + Wt // 2))  # (P, 2, span)
    delta, cbest, uniq = _slide_zsad(win, inb, tm.tmpl, Wt, M, p.ratio)  # (P, 2)
    m = (uv + delta) / p.coord_scale  # u from the x search, v from the y search
    ok_axis = uniq & (cbest < p.max_cost) & (tm.tvalid > 0.5) & (torch.abs(delta) < float(R))
    return m, (torch.all(ok_axis, dim=-1) & zok).to(torch.float32)


def align_frame_hybrid_body(
    img: torch.Tensor,
    T_pred: torch.Tensor,
    plucker: torch.Tensor,
    tm: AlignTemplates,
    tm_p: PointAlignTemplates,
    cam: Intrinsics,
    p: DirectAlignParams,
):
    """Hybrid semi-direct frame: line and point template search, one joint
    Gauss-Newton per round. Returns (T_new, n_samples_good, n_units_good),
    a unit being an aligned line or an aligned point, as float32 scalars."""
    img255 = img * 255.0
    T = T_pred
    for _ in range(max(1, p.rounds)):
        m, ok = _search_templates(img255, T, tm, cam, p)
        m_p, ok_p = _search_point_templates(img255, T, tm_p, cam, p)
        T, r, rp = _gn_pose(T, plucker, m, ok, cam, p, pts3d=tm_p.p3d, m_p=m_p, w_p=ok_p)
    good_l = ok * (torch.abs(r) < p.max_res_px).to(torch.float32)  # (A, S)
    line_good = (torch.sum(good_l, dim=-1) >= float(p.min_line_samples)).to(torch.float32)
    good_p = ok_p * torch.all(torch.abs(rp) < p.max_res_px, dim=-1).to(torch.float32)
    return T, torch.sum(good_l) + 2.0 * torch.sum(good_p), torch.sum(line_good) + torch.sum(good_p)
