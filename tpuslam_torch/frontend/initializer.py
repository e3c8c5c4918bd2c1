"""Monocular two-view bootstrap (torch).

Counterpart of ``tpuslam.frontend.initializer``: match line segments between
a reference frame and the current frame, treat the matched segments'
endpoints (and, with hybrid points, the matched corners) as point
correspondences, estimate the essential matrix with an 8-point RANSAC whose
hypotheses are all solved in one batched call, recover (R, t) by cheirality
voting and triangulate the matched lines from their back-projected planes.
``MonoInitializer.try_initialize`` keeps the reference frame on the host and
resets it when parallax or matches run out.

The RANSAC draws its 8-row samples uniformly among the valid rows, with
replacement, from a ``torch.Generator`` on the rows' device seeded with the
frame index (the JAX package draws them with ``jax.random.categorical`` from
``PRNGKey(frame_idx)``, which this package cannot reproduce). A caller can
pass the samples (``ransac_essential``'s ``samples``, ``MonoInitializer``'s
``sampler``) to score the same hypotheses as the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.geometry.camera import Intrinsics, image_line_through
from tpuslam_torch.geometry.triangulate import projection_matrix, triangulate_plucker_two_view, triangulate_points
from tpuslam_torch.kernels.match import MatchParams, match_descriptors


class MonoInitParams(NamedTuple):
    """Same names and defaults as ``tpuslam.frontend.initializer.MonoInitParams``."""

    min_matches: int = 12
    n_hypotheses: int = 256  # RANSAC hypotheses, all solved in one batched call
    inlier_px: float = 2.0  # Sampson distance threshold
    min_inlier_ratio: float = 0.5
    min_parallax_px: float = 12.0  # median endpoint displacement
    max_frame_gap: int = 40
    match: MatchParams = MatchParams(max_dist=100.0, ratio=0.9)


def _essential_from_8(uv0n: torch.Tensor, uv1n: torch.Tensor) -> torch.Tensor:
    """The 8-point algorithm on normalized coordinates, batched: (..., 8, 2)
    twice -> (..., 3, 3) E with singular values (1, 1, 0), in the inputs'
    dtype.

    Solved in float64: the smallest eigenvector of the normal matrix A^T A
    squares A's condition number, and in float32 (the JAX package's form)
    E is off the float64 one by ~3e-3 median and up to ~1 over the
    hypotheses of a wide view with 0.3 px noise, so two float32 libraries
    pick different hypotheses from the same samples."""
    dtype = uv0n.dtype
    uv0n, uv1n = uv0n.to(torch.float64), uv1n.to(torch.float64)
    x0, y0 = uv0n[..., 0], uv0n[..., 1]
    x1, y1 = uv1n[..., 0], uv1n[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], dim=-1)  # (..., 8, 9)
    # the smallest right singular vector, as the smallest eigenvector of A^T A
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    E = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    # project onto the essential manifold
    U, _, Vt = torch.linalg.svd(E)
    return (U @ torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)) @ Vt).to(dtype)


def _sampson_sq(E: torch.Tensor, uv0n: torch.Tensor, uv1n: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distances of (N, 2) normalized correspondences under
    (..., 3, 3) E -> (..., N)."""
    x0 = torch.cat([uv0n, torch.ones_like(uv0n[..., :1])], dim=-1)  # (N, 3)
    x1 = torch.cat([uv1n, torch.ones_like(uv1n[..., :1])], dim=-1)
    Ex0 = x0 @ E.transpose(-1, -2)  # (..., N, 3)
    Etx1 = x1 @ E
    num = torch.sum(x1 * Ex0, dim=-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def ransac_essential(
    uv0n: torch.Tensor,
    uv1n: torch.Tensor,
    valid: torch.Tensor,
    params: MonoInitParams,
    generator: Optional[torch.Generator] = None,
    samples: Optional[torch.Tensor] = None,
):
    """Batched 8-point RANSAC: every hypothesis in one solve. ``samples``
    (H, 8) row indices, if given, replace the draws from ``generator``.
    ``params.inlier_px`` is in normalized units here (the caller divides by
    the focal length). Returns (E (3, 3), inliers (N,) float32 {0, 1}, the
    inlier count as a float32 0-d tensor)."""
    validf = valid.to(torch.float32)
    if samples is None:
        H = params.n_hypotheses
        samples = torch.multinomial(validf, H * 8, replacement=True, generator=generator).reshape(H, 8)
    samples = samples.to(uv0n.device)
    Es = _essential_from_8(uv0n[samples], uv1n[samples])  # (H, 3, 3)
    thr = params.inlier_px**2
    d2 = _sampson_sq(Es, uv0n, uv1n)  # (H, N)
    inlf = (d2 < thr).to(torch.float32) * validf[None, :]
    scores = torch.sum(inlf, dim=1)
    best = torch.argmax(scores)
    return Es[best], inlf[best], scores[best]


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def recover_pose(E: torch.Tensor, uv0n: torch.Tensor, uv1n: torch.Tensor, inliers: torch.Tensor):
    """Decompose E into its 4 (R, t) candidates and pick one by cheirality
    votes over the inlier rows (``inliers``: float32 {0, 1}). Returns (T_10
    (4, 4) with a unit translation, the winner's votes as a 0-d tensor)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])  # the candidates (R1, t), (R1, -t), (R2, t), (R2, -t)
    ts = torch.stack([t, -t, t, -t])
    P0 = torch.cat([torch.eye(3, dtype=E.dtype, device=E.device), torch.zeros(3, 1, dtype=E.dtype, device=E.device)], dim=1)
    P1 = torch.cat([Rs, ts[:, :, None]], dim=2)  # (4, 3, 4)
    X = triangulate_points(P0, P1[:, None], uv0n[None], uv1n[None])  # (4, N, 3) in frame 0
    X1 = X @ Rs.transpose(-1, -2) + ts[:, None, :]
    front = (X[..., 2] > 0).to(torch.float32) * (X1[..., 2] > 0).to(torch.float32)
    votes = torch.sum(front * inliers[None], dim=1)
    best = torch.argmax(votes)
    T = torch.eye(4, dtype=E.dtype, device=E.device)
    T[:3, :3] = Rs[best]
    T[:3, 3] = ts[best]
    return T, votes[best]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MonoInitializer:
    """Holds a reference frame and tries the two-view bootstrap on each new
    frame. ``sampler(frame_idx, n_rows, n_hypotheses)``, if given, returns
    the RANSAC's (H, 8) row samples instead of the seeded draws."""

    def __init__(
        self,
        cam: Intrinsics,
        params: MonoInitParams = MonoInitParams(),
        sampler: Optional[Callable[[int, int, int], object]] = None,
    ):
        self.cam = cam
        self.params = params
        self.sampler = sampler
        self.ref: Optional[FrameFeatures] = None
        self.ref_t = 0.0
        self.ref_idx = -1
        self.ref_aux = None  # the reference frame's corners (hybrid points)
        self.init_points = None

    def _set_ref(self, feats, timestamp, frame_idx, aux=None):
        self.ref = feats
        self.ref_t = timestamp
        self.ref_idx = frame_idx
        self.ref_aux = aux

    def try_initialize(self, feats: FrameFeatures, timestamp: float, frame_idx: int, aux=None):
        """None until two frames bootstrap the map; then (reference features,
        its timestamp, its frame index, T_10 (4, 4), world Pluecker lines
        (n, 6), endpoints (n, 2, 3), ok (n,), reference slots (n,), current
        slots (n,)), with the corner triangulations (xyz, ok, reference
        slots, current slots) in ``init_points``. The world frame is the
        reference camera's; the median landmark depth is scaled to 2."""
        p = self.params
        if self.ref is None or frame_idx - self.ref_idx > p.max_frame_gap:
            self._set_ref(feats, timestamp, frame_idx, aux)
            return None
        dev = feats.endpoints.device
        m = match_descriptors(self.ref.desc_bits, self.ref.valid, feats.desc_bits, feats.valid, p.match)
        mvalid = _np(m.valid)
        n = int(mvalid.sum())
        # hybrid bootstrap: matched corners join the RANSAC as extra rows
        p_slots0 = p_slots1 = None
        p_uv0 = p_uv1 = np.zeros((0, 2), np.float32)
        if aux is not None and self.ref_aux is not None:
            pm = match_descriptors(self.ref_aux.desc_bits, self.ref_aux.valid, aux.desc_bits, aux.valid, p.match)
            pmv = _np(pm.valid) > 0.5
            p_slots0 = np.nonzero(pmv)[0]
            p_slots1 = _np(pm.idx)[p_slots0]
            p_uv0 = _np(self.ref_aux.uv)[p_slots0]
            p_uv1 = _np(aux.uv)[p_slots1]
        n_pts = len(p_uv0)
        if 2 * n + n_pts < 2 * p.min_matches:
            if n < 5 and n_pts < 10:
                self._set_ref(feats, timestamp, frame_idx, aux)
            return None
        idx = _np(m.idx)
        ep0 = _np(self.ref.endpoints)  # (K, 2, 2)
        ep1 = _np(feats.endpoints)
        slots0 = np.nonzero(mvalid)[0]
        slots1 = idx[slots0]
        a0 = ep0[slots0]  # (n, 2, 2)
        a1 = ep1[slots1]
        # endpoint correspondences: flip a1 where its direction opposes a0's
        d0 = a0[:, 1] - a0[:, 0]
        d1 = a1[:, 1] - a1[:, 0]
        flip = np.sum(d0 * d1, axis=-1) < 0
        a1[flip] = a1[flip][:, ::-1]
        disp = np.concatenate([np.linalg.norm(a0 - a1, axis=-1).mean(axis=-1), np.linalg.norm(p_uv0 - p_uv1, axis=-1)])
        if np.median(disp) < p.min_parallax_px:
            return None

        n_line_rows = 2 * n
        uv0 = np.concatenate([a0.reshape(-1, 2), p_uv0.astype(np.float32)])
        uv1 = np.concatenate([a1.reshape(-1, 2), p_uv1.astype(np.float32)])
        cam = self.cam
        f = 0.5 * (cam.fx + cam.fy)
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
        Kinv = np.linalg.inv(K)
        uv0n = torch.from_numpy(((uv0 - [cam.cx, cam.cy]) / [cam.fx, cam.fy]).astype(np.float32)).to(dev)
        uv1n = torch.from_numpy(((uv1 - [cam.cx, cam.cy]) / [cam.fx, cam.fy]).astype(np.float32)).to(dev)
        params_n = p._replace(inlier_px=p.inlier_px / f)  # the threshold in normalized units
        samples = None
        if self.sampler is not None:
            samples = self.sampler(frame_idx, len(uv0), p.n_hypotheses)
            samples = (samples if isinstance(samples, torch.Tensor) else torch.from_numpy(np.array(samples))).to(torch.int64)
        gen = torch.Generator(device=dev)
        gen.manual_seed(frame_idx)
        E, inl, score = ransac_essential(uv0n, uv1n, torch.ones(len(uv0), device=dev), params_n, gen, samples)
        T10, votes = recover_pose(E, uv0n, uv1n, inl)
        score, votes = (int(x) for x in torch.stack([score, votes]).cpu())
        if score < 2 * p.min_matches * p.min_inlier_ratio:
            return None
        if votes < score * 0.6:
            return None

        # the matched lines from their back-projected planes; the corner pairs by DLT
        P0 = projection_matrix(cam, torch.eye(4, device=dev))
        P1 = projection_matrix(cam, T10)
        a0d = torch.from_numpy(np.ascontiguousarray(a0)).to(dev)
        a1d = torch.from_numpy(np.ascontiguousarray(a1)).to(dev)
        L = triangulate_plucker_two_view(
            P0, P1, image_line_through(a0d[:, 0], a0d[:, 1]), image_line_through(a1d[:, 0], a1d[:, 1])
        )  # (n, 6) world (= frame-0) Pluecker
        X = None
        if n_pts:
            X = triangulate_points(
                P0, P1, torch.from_numpy(p_uv0.astype(np.float32)).to(dev), torch.from_numpy(p_uv1.astype(np.float32)).to(dev)
            )
        T10, L, inl = _np(T10), _np(L), _np(inl)  # one read back each
        # endpoint 3D positions: each endpoint ray's closest point on its line
        ep3d = np.zeros((len(slots0), 2, 3), np.float32)
        ok = np.zeros(len(slots0), bool)
        inl_np = inl > 0.5
        inl2 = inl_np[:n_line_rows].reshape(-1, 2)
        for i in range(len(slots0)):
            nvec, v = L[i, :3], L[i, 3:]
            vn = np.linalg.norm(v)
            if vn < 1e-6 or not inl2[i].all():
                continue
            good = True
            for e in range(2):
                ray = Kinv @ np.array([a0[i, e, 0], a0[i, e, 1], 1.0])
                ray = ray / np.linalg.norm(ray)
                # line: x = p0 + t u; ray: x = s ray
                u = v / vn
                p0l = np.cross(v, nvec) / (vn * vn)
                Amat = np.stack([u, -ray], axis=1)
                ts, *_ = np.linalg.lstsq(Amat, -p0l, rcond=None)
                pt = p0l + ts[0] * u
                if ts[1] <= 0.05:  # behind the camera
                    good = False
                ep3d[i, e] = pt
            ok[i] = good
        p_xyz = np.zeros((n_pts, 3), np.float32)
        p_ok = np.zeros(n_pts, bool)
        if n_pts:
            X = _np(X)
            X1 = X @ T10[:3, :3].T + T10[:3, 3]
            p_ok = inl_np[n_line_rows:] & np.isfinite(X).all(axis=-1) & (X[:, 2] > 0.05) & (X1[:, 2] > 0.05)
            p_xyz = X.astype(np.float32)
        if 2 * ok.sum() + p_ok.sum() < 2 * p.min_matches:
            return None
        # the mono gauge: median landmark depth -> 2.0
        depths = np.concatenate([ep3d[ok][:, :, 2].ravel(), p_xyz[p_ok][:, 2]])
        scale = 2.0 / max(np.median(depths), 1e-3)
        ep3d *= scale
        p_xyz *= scale
        T10[:3, 3] *= scale
        # Pluecker lines again from the scaled endpoints
        Lw = np.concatenate([np.cross(ep3d[:, 0], ep3d[:, 1]), ep3d[:, 1] - ep3d[:, 0]], axis=-1).astype(np.float32)
        self.init_points = (
            p_xyz,
            p_ok,
            p_slots0 if p_slots0 is not None else np.zeros(0, np.int64),
            p_slots1 if p_slots1 is not None else np.zeros(0, np.int64),
        )
        ref = self.ref
        self.ref = None
        return (ref, self.ref_t, self.ref_idx, T10.astype(np.float32), Lw, ep3d, ok, slots0, slots1)
