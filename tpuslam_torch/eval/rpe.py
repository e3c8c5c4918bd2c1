"""Relative pose error (drift per step / per second)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RPEResult(NamedTuple):
    trans_rmse: float
    rot_rmse_deg: float
    n: int


def relative_pose_error(est_T_wc: np.ndarray, gt_T_wc: np.ndarray, delta: int = 1) -> RPEResult:
    """est/gt: (N, 4, 4) camera-to-world poses, frame-index aligned."""
    n = min(len(est_T_wc), len(gt_T_wc)) - delta
    if n < 1:
        return RPEResult(float("inf"), float("inf"), 0)
    te, re = [], []
    for i in range(n):
        de = np.linalg.inv(est_T_wc[i]) @ est_T_wc[i + delta]
        dg = np.linalg.inv(gt_T_wc[i]) @ gt_T_wc[i + delta]
        err = np.linalg.inv(dg) @ de
        te.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        re.append(np.degrees(np.arccos(c)))
    te = np.asarray(te)
    re = np.asarray(re)
    return RPEResult(
        trans_rmse=float(np.sqrt((te**2).mean())),
        rot_rmse_deg=float(np.sqrt((re**2).mean())),
        n=n,
    )
