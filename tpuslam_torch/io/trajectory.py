"""Trajectory writers: TUM and KITTI formats (SURVEY §7 'checkpoint/resume':
`SaveTrajectoryTUM/KITTI` equivalents; consumed by eval tooling)."""

from __future__ import annotations

from typing import List

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def save_trajectory_tum(path: str, timestamps: List[float], poses_T_cw: List[np.ndarray]):
    """TUM format: `timestamp tx ty tz qx qy qz qw` of T_wc (camera in world)."""
    with open(path, "w") as f:
        for t, T_cw in zip(timestamps, poses_T_cw):
            T = np.asarray(T_cw)
            R = T[:3, :3].T
            p = -R @ T[:3, 3]
            q = _quat_from_R(R)
            f.write(
                f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_trajectory_kitti(path: str, poses_T_cw: List[np.ndarray]):
    """KITTI format: 12 row-major entries of the 3x4 T_wc per line."""
    with open(path, "w") as f:
        for T_cw in poses_T_cw:
            T = np.asarray(T_cw)
            R = T[:3, :3].T
            p = -R @ T[:3, 3]
            M = np.concatenate([R, p[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")
