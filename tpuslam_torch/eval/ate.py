"""Absolute trajectory error (SURVEY §6.1: the reference's end-to-end metric).

Follows the standard TUM evaluation semantics: associate estimated and
ground-truth poses by timestamp, rigidly (or similarity, for monocular)
align with Umeyama's closed form, report translational RMSE.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares s*R*src + t ~= dst. src/dst: (N, 3). Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    n: int
    scale: float


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association. Returns (idx_est, idx_gt)."""
    ie, ig = [], []
    j = 0
    order = np.argsort(t_gt)
    t_gt_s = t_gt[order]
    for i, t in enumerate(t_est):
        j = np.searchsorted(t_gt_s, t)
        cands = [c for c in (j - 1, j) if 0 <= c < len(t_gt_s)]
        if not cands:
            continue
        best = min(cands, key=lambda c: abs(t_gt_s[c] - t))
        if abs(t_gt_s[best] - t) <= max_dt:
            ie.append(i)
            ig.append(order[best])
    return np.asarray(ie, int), np.asarray(ig, int)


def absolute_trajectory_error(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    t_est: np.ndarray | None = None,
    t_gt: np.ndarray | None = None,
    with_scale: bool = False,
    max_dt: float = 0.02,
) -> ATEResult:
    """ATE RMSE after alignment. Positions: (N, 3) camera centers (world)."""
    if t_est is not None and t_gt is not None:
        ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
        est = est_positions[ie]
        gt = gt_positions[ig]
    else:
        n = min(len(est_positions), len(gt_positions))
        est = est_positions[:n]
        gt = gt_positions[:n]
    if len(est) < 3:
        return ATEResult(float("inf"), float("inf"), float("inf"), float("inf"), len(est), 1.0)
    s, R, t = align_umeyama(est, gt, with_scale)
    err = np.linalg.norm((s * (R @ est.T).T + t) - gt, axis=1)
    return ATEResult(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        n=len(est),
        scale=s,
    )
