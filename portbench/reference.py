"""The plain reference the benchmark judges the port's answers by.

Plain NumPy and PyTorch; it imports nothing of the program. Two parts:

- tracking: the resolved poses against the stream's ground truth
  (:func:`ate`, with a frozen copy of the Umeyama alignment of the port's
  ``eval/ate.py``, and :func:`rpe`, frame to frame);
- local BA: each captured window solved again from the same start by the
  published algorithm, written here in plain PyTorch (:func:`ba_solve`:
  Levenberg-Marquardt with Huber IRLS weights and Marquardt damping over
  left pose increments and the lines' 4-DoF orthonormal increments, its
  Jacobians by forward-mode AD through the retractions at zero tangent, as
  the JAX package takes them), its Huber cost and its poses compared with
  those of the program's answer (:func:`ba_cost`, :func:`ba_compare`).

The line detector's reference is ``detector.py``. ``dtype`` arguments run a
part in a lower precision: that is the control.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

# ---- tracking ---------------------------------------------------------------


def align_umeyama(src: np.ndarray, dst: np.ndarray):
    """Least-squares R src + t ~= dst (rigid). src, dst: (N, 3). -> (R, t)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def centres(T_cw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) T_cw -> (N, 3) camera centres in the world."""
    R, t = T_cw[:, :3, :3], T_cw[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def ate(est_T_cw: np.ndarray, gt_T_cw: np.ndarray) -> float:
    """RMSE (m) of the camera centres after the rigid alignment."""
    est, gt = centres(est_T_cw.astype(np.float64)), centres(gt_T_cw.astype(np.float64))
    if len(est) < 3:
        return float("inf")
    R, t = align_umeyama(est, gt)
    return float(np.sqrt(np.mean(np.sum((est @ R.T + t - gt) ** 2, axis=1))))


def rpe(est_a: np.ndarray, est_b: np.ndarray, gt_a: np.ndarray, gt_b: np.ndarray) -> float:
    """RMS (m) over pairs of frames (a, b) of the translation of the error
    between the estimated and the true relative motion, inv(gt_rel) est_rel
    with rel = T_cw(b) inv(T_cw(a)); it does not depend on the world frame
    either side is in."""
    if len(est_a) == 0:
        return float("inf")
    f = lambda x: np.asarray(x, np.float64)  # noqa: E731
    err = np.linalg.inv(f(gt_b) @ np.linalg.inv(f(gt_a))) @ (f(est_b) @ np.linalg.inv(f(est_a)))
    return float(np.sqrt(np.mean(np.sum(err[:, :3, 3] ** 2, axis=1))))


def world_gt(gt_T_cw: np.ndarray, first: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """The ground truth in the system's world (the first frame's camera):
    T_cw @ inv(first), computed in ``dtype``."""
    g = torch.from_numpy(np.asarray(gt_T_cw, np.float64))
    f = torch.from_numpy(np.linalg.inv(np.asarray(first, np.float64)))
    return (g.to(dtype) @ f.to(dtype)).to(torch.float64).numpy()


# ---- local BA ---------------------------------------------------------------


class BAWindow(NamedTuple):
    """One local-BA window as the program's solver received it, in numpy."""

    poses: np.ndarray  # (P, 4, 4) T_cw
    pose_free: np.ndarray  # (P,)
    lines: np.ndarray  # (L, 6) Pluecker (n, v)
    line_valid: np.ndarray  # (L,)
    l_pose: np.ndarray  # (O,)
    l_line: np.ndarray  # (O,)
    l_endpoints: np.ndarray  # (O, 2, 2) px
    l_valid: np.ndarray  # (O,)
    l_sigma: np.ndarray  # (O,)

    @classmethod
    def of(cls, arrays: Dict[str, np.ndarray]) -> "BAWindow":
        return cls(*(np.asarray(arrays[f]) for f in cls._fields))


def _eye(x):
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (3, 3))


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _coeffs(phi):
    """sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3 of t = |phi|, with
    their series near 0 (exact derivatives at 0)."""
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = t2 < 1e-6
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    return a, b, c


def _so3_exp(phi):
    a, b, _ = _coeffs(phi)
    W = _hat(phi)
    return _eye(phi) + a * W + b * (W @ W)


def _se3_exp_apply(xi, T):
    """exp(xi^) @ T for xi = (rho, phi)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    _, b, c = _coeffs(phi)
    W = _hat(phi)
    R = _so3_exp(phi)
    t = ((_eye(phi) + b * W + c * (W @ W)) @ rho[..., None])[..., 0]
    top = torch.cat([R @ T[..., :3, :3], (R @ T[..., :3, 3:]) + t[..., None]], dim=-1)
    return torch.cat([top, T[..., 3:, :]], dim=-2)


def _normalize(L):
    """|v| = 1 and n made orthogonal to v."""
    n, v = L[..., :3], L[..., 3:]
    vn = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)
    vh = v / vn
    n = n - torch.sum(n * vh, dim=-1, keepdim=True) * vh
    return torch.cat([n, vh * vn], dim=-1) / vn


def _orthonormal(L):
    """(U, theta) of lines: U's columns the unit moment, the unit direction
    and their cross product; theta = atan2(|v|, |n|)."""
    n, v = L[..., :3], L[..., 3:]
    nn, vn = torch.linalg.norm(n, dim=-1), torch.linalg.norm(v, dim=-1)
    vh = v / torch.clamp(vn, min=1e-9)[..., None]
    e = torch.eye(3, dtype=L.dtype, device=L.device)[torch.argmin(torch.abs(vh), dim=-1)]
    fb = torch.linalg.cross(vh, e, dim=-1)
    fb = fb / torch.clamp(torch.linalg.norm(fb, dim=-1, keepdim=True), min=1e-9)
    u1 = torch.where((nn < 1e-7)[..., None], fb, n / torch.clamp(nn, min=1e-9)[..., None])
    u1 = u1 - torch.sum(u1 * vh, dim=-1, keepdim=True) * vh
    u1 = u1 / torch.clamp(torch.linalg.norm(u1, dim=-1, keepdim=True), min=1e-9)
    return torch.stack([u1, vh, torch.linalg.cross(u1, vh, dim=-1)], dim=-1), torch.atan2(vn, nn)


def _retract_line(U, theta, d):
    Un = U @ _so3_exp(d[..., :3])
    th = theta + d[..., 3]
    return torch.cat([torch.cos(th)[..., None] * Un[..., :, 0], torch.sin(th)[..., None] * Un[..., :, 1]], dim=-1)


def _K_L(cam, dt, dev):
    """Maps a camera-frame line moment to image-line coefficients."""
    return torch.tensor([[cam.fy, 0.0, 0.0], [0.0, cam.fx, 0.0], [-cam.fy * cam.cx, -cam.fx * cam.cy, cam.fx * cam.fy]],
                        dtype=dt, device=dev)


def _residual(T, L, ep, KL):
    """Signed distances (..., 2) of the two observed endpoints ep (..., 2, 2)
    to the projection of the world line L (Pluecker n, v) seen from T_cw."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rv = (R @ L[..., 3:, None])[..., 0]
    n_c = (R @ L[..., :3, None])[..., 0] + torch.linalg.cross(t, Rv, dim=-1)
    l = (KL @ n_c[..., None])[..., 0]
    norm = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2 + 1e-9)
    num = ep[..., 0] * l[..., None, 0] + ep[..., 1] * l[..., None, 1] + l[..., None, 2]
    return num / norm[..., None]


def _huber(sq, delta: float):
    n = torch.sqrt(sq + 1e-8)
    return torch.where(n <= delta, sq, 2.0 * delta * n - delta * delta)


class _Problem:
    """A window's valid observations on a device in one dtype."""

    def __init__(self, w: BAWindow, cam, dt, dev):
        keep = np.asarray(w.l_valid) > 0.5
        t = lambda a, d=dt: torch.as_tensor(np.asarray(a), device=dev).to(d)  # noqa: E731
        self.pose, self.line = t(w.l_pose[keep], torch.long), t(w.l_line[keep], torch.long)
        self.ep, self.sigma = t(w.l_endpoints[keep]), t(w.l_sigma[keep])
        self.free, self.valid = t(w.pose_free > 0.5, torch.bool), t(w.line_valid > 0.5, torch.bool)
        self.KL = _K_L(cam, dt, dev)

    def cost(self, poses, lines, delta):
        r = _residual(poses[self.pose], lines[self.line], self.ep, self.KL) / self.sigma[:, None]
        return torch.sum(_huber(torch.sum(r * r, dim=-1), delta))


def ba_cost(w: BAWindow, cam, poses: np.ndarray, lines: np.ndarray, delta: float, device="cpu") -> float:
    """The Huber cost (float64) of the window's valid observations at
    ``poses`` (P, 4, 4) and Pluecker ``lines`` (L, 6): the sum over
    observations of huber(|r / sigma|^2), r the signed distances of the two
    observed endpoints to the projected line."""
    p = _Problem(w, cam, torch.float64, device)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)  # noqa: E731
    return float(p.cost(f(poses), _normalize(f(lines)), delta))


def ba_solve(w: BAWindow, cam, lm: dict, dtype=torch.float64, device="cpu"):
    """The window solved by ``lm["max_iters"]`` Levenberg-Marquardt
    iterations from its start (Marquardt damping from ``lam0``, times
    ``lam_down`` on an accepted step and ``lam_up`` on a rejected one,
    within [``min_lam``, ``max_lam``]; Huber weights at ``huber_line``
    sigmas; the poses the window holds fixed held), in ``dtype`` (the
    normal equations' solve in at least float32: torch solves no lower
    one). Returns float64 (poses (P, 4, 4), lines (L, 6))."""
    dt, dev = dtype, device
    p = _Problem(w, cam, dt, dev)
    delta = float(lm["huber_line"])
    poses = torch.as_tensor(np.asarray(w.poses, np.float64), device=dev).to(dt)
    lines = _normalize(torch.as_tensor(np.asarray(w.lines, np.float64), device=dev).to(dt))
    free = torch.nonzero(p.free).flatten()
    valid = torch.nonzero(p.valid).flatten()
    Pf, Lv, O = len(free), len(valid), len(p.pose)
    if O == 0:
        return poses.to(torch.float64).cpu().numpy(), lines.to(torch.float64).cpu().numpy()
    col_p = torch.full((poses.shape[0],), -1, dtype=torch.long, device=dev)
    col_p[free] = torch.arange(Pf, device=dev) * 6
    col_l = torch.full((lines.shape[0],), -1, dtype=torch.long, device=dev)
    col_l[valid] = 6 * Pf + torch.arange(Lv, device=dev) * 4
    N = 6 * Pf + 4 * Lv
    cp, cl = col_p[p.pose], col_l[p.line]
    rows = torch.arange(2 * O, device=dev).reshape(O, 2, 1)
    solve_dt = torch.float64 if dt == torch.float64 else torch.float32

    def res_at(xi, d, T, U, th, ep, KL, sigma):
        return _residual(_se3_exp_apply(xi, T), _retract_line(U, th, d), ep, KL) / sigma

    jac = torch.vmap(torch.func.jacfwd(res_at, argnums=(0, 1)), in_dims=(0, 0, 0, 0, 0, 0, None, 0))
    cost = p.cost(poses, lines, delta)
    lam = float(lm["lam0"])
    for _ in range(int(lm["max_iters"])):
        T_o, L_o = poses[p.pose], lines[p.line]
        U, th = _orthonormal(L_o)
        Jp, Jl = jac(torch.zeros((O, 6), dtype=dt, device=dev), torch.zeros((O, 4), dtype=dt, device=dev),
                     T_o, U, th, p.ep, p.KL, p.sigma)  # (O, 2, 6), (O, 2, 4)
        Jp, Jl = Jp.to(dt), Jl.to(dt)
        r = _residual(T_o, L_o, p.ep, p.KL) / p.sigma[:, None]
        wgt = torch.clamp(delta / torch.clamp(torch.linalg.norm(r, dim=-1), min=1e-9), max=1.0)
        J = torch.zeros((2 * O, N), dtype=dt, device=dev)
        okp, okl = (cp >= 0).to(dt)[:, None, None], (cl >= 0).to(dt)[:, None, None]
        J.index_put_((rows.expand(O, 2, 6), (cp.clamp(min=0)[:, None, None] + torch.arange(6, device=dev)).expand(O, 2, 6)),
                     Jp * okp, accumulate=True)
        J.index_put_((rows.expand(O, 2, 4), (cl.clamp(min=0)[:, None, None] + torch.arange(4, device=dev)).expand(O, 2, 4)),
                     Jl * okl, accumulate=True)
        ww = wgt.repeat_interleave(2)
        H = (J.T @ (J * ww[:, None])).to(solve_dt)
        g = (J.T @ (ww * r.reshape(-1))).to(solve_dt)
        step = torch.linalg.solve(H + torch.diag(lam * torch.diagonal(H) + 1e-8), -g).to(dt)
        cand_p = poses.clone()
        cand_p[free] = _se3_exp_apply(step[: 6 * Pf].reshape(Pf, 6), poses[free])
        cand_l = lines.clone()
        Uv, thv = _orthonormal(lines[valid])
        cand_l[valid] = _normalize(_retract_line(Uv, thv, step[6 * Pf:].reshape(Lv, 4)))
        c_new = p.cost(cand_p, cand_l, delta)
        if bool(c_new < cost):
            poses, lines, cost = cand_p, cand_l, c_new
            lam = max(lam * float(lm["lam_down"]), float(lm["min_lam"]))
        else:
            lam = min(lam * float(lm["lam_up"]), float(lm["max_lam"]))
    return poses.to(torch.float64).cpu().numpy(), lines.to(torch.float64).cpu().numpy()


def ba_compare(windows, answers, cam, lm: dict, device="cpu", dtype=torch.float64) -> Dict[str, float]:
    """How far the answers lie from the reference's own solves of the same
    windows: ``ba_gap``, the costs pooled, sum |C(answer) - C(reference)| /
    sum C(reference), each cost the float64 Huber cost of :func:`ba_cost`;
    ``ba_pose_m``, the largest distance (m) between a pose's camera centre
    in the answer and in the reference. ``answers`` holds (poses, lines) per
    window; None puts the reference's own solve in ``dtype`` in the
    answer's place (the control)."""
    num = den = 0.0
    pose_m = 0.0
    delta = float(lm["huber_line"])
    for w, ans in zip(windows, answers):
        ref_p, ref_l = ba_solve(w, cam, lm, torch.float64, device)
        c_ref = ba_cost(w, cam, ref_p, ref_l, delta, device)
        if ans is None:
            ans = ba_solve(w, cam, lm, dtype, device)
        num += abs(ba_cost(w, cam, *ans, delta, device) - c_ref)
        den += c_ref
        gap = np.linalg.norm(centres(np.asarray(ans[0], np.float64)) - centres(ref_p), axis=1)
        pose_m = max(pose_m, float(np.max(gap)) if len(gap) else 0.0)
    if den <= 0 or not math.isfinite(num):
        return {"ba_gap": math.inf, "ba_pose_m": math.inf}
    return {"ba_gap": num / den, "ba_pose_m": pose_m if math.isfinite(pose_m) else math.inf}
