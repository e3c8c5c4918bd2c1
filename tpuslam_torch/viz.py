"""Offline visualization: matplotlib PNGs of a run (counterpart of
``tpuslam.viz``).

- `plot_trajectory`: top-down (x-z) estimated vs ground-truth path
- `plot_map`: 3D line landmarks (and points) + keyframe positions
- `draw_frame_overlay`: detected segments on the input image, tracked
  inliers green, the rest red (features may be tensors on any device)
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def plot_trajectory(
    est_positions: np.ndarray,
    gt_positions: Optional[np.ndarray] = None,
    path: str = "trajectory.png",
    title: str = "trajectory (top-down)",
):
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(est_positions[:, 0], est_positions[:, 2], "b-", lw=1.2, label="estimate")
    if gt_positions is not None:
        ax.plot(gt_positions[:, 0], gt_positions[:, 2], "k--", lw=1.0, label="ground truth")
    ax.scatter([est_positions[0, 0]], [est_positions[0, 2]], c="g", s=30, label="start")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_map(slam_map, path: str = "map.png", max_lines: int = 2000):
    """3D map: line landmarks + keyframe positions."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    st = slam_map.lines
    ids = st.live_ids()[:max_lines]
    for lid in ids:
        ep = st.endpoints[lid]
        ax.plot(ep[:, 0], ep[:, 2], ep[:, 1], "b-", lw=0.6, alpha=0.6)
    n_pts = 0
    pst = getattr(slam_map, "points", None)
    if pst is not None:
        pids = pst.live_ids()[:max_lines]
        n_pts = len(pids)
        if n_pts:
            xyz = pst.xyz[pids]
            ax.scatter(xyz[:, 0], xyz[:, 2], xyz[:, 1], c="m", s=2, alpha=0.5)
    if slam_map.keyframes:
        centers = np.stack([kf.center for kf in slam_map.keyframes.values()])
        ax.plot(centers[:, 0], centers[:, 2], centers[:, 1], "r.-", ms=4, lw=0.8)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")
    ax.set_title(f"map: {len(ids)} lines, {n_pts} points, {len(slam_map.keyframes)} keyframes")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def draw_frame_overlay(
    img: np.ndarray,
    feats,
    inlier_slots: Optional[np.ndarray] = None,
    path: str = "frame.png",
):
    """Frame overlay: detected segments (green = tracked inlier, red = not)."""
    plt = _require_mpl()
    img = _host(img)
    fig, ax = plt.subplots(figsize=(9, 7))
    ax.imshow(img, cmap="gray", vmin=0, vmax=1)
    ep = _host(feats.endpoints)
    valid = _host(feats.valid) > 0.5
    inl = set() if inlier_slots is None else set(int(s) for s in _host(inlier_slots))
    for k in np.nonzero(valid)[0]:
        color = "lime" if int(k) in inl else "red"
        ax.plot(ep[k, :, 0], ep[k, :, 1], color=color, lw=1.2)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.set_title(f"{valid.sum()} segments, {len(inl)} tracked")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
