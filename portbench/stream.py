"""The benchmark's camera streams: scene, periodic path, renderer, noise.

Frozen copies, so that the yardstick does not move with the program:

- :func:`scene_segments` draws the wireframe room of the port's
  ``io.synthetic.make_wireframe_scene`` (the same draws, in the same order,
  so a seed gives the same segments);
- :func:`render` is its ``render_wireframe_image`` without points and
  without noise: anti-aliased lines of 2 px between the rounded projected
  endpoints of every visible segment; with radtan distortion on the rig
  (new here) each segment is drawn as the distorted curve it images to,
  a polyline of pieces of at most :data:`PIECE_PX` pixels;
- :func:`periodic_path` is new: a closed camera path of ``L`` frames whose
  frame ``L`` is frame 0, with continuous velocity across the wrap, so a
  stream replays cyclically for as long as a window lasts.

Clean frames are rendered once per checkout into ``portbench/cache``; each
run adds image noise drawn from its ``--seed`` (:func:`noisy_frames`).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from multiprocessing import get_context
from pathlib import Path
from typing import NamedTuple

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent / "cache"


PIECE_PX = 8.0  # longest piece of a distorted segment's polyline (px)


class Rig(NamedTuple):
    """A rectified stereo rig: pinhole intrinsics of the left camera, the
    right one ``baseline`` metres along its x axis, both imaging through the
    same radial-tangential (OpenCV radtan) distortion ``k1, k2, p1, p2``."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    baseline: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @classmethod
    def of(cls, d: dict) -> "Rig":
        return cls(**{k: d[k] for k in cls._fields if k in d})

    @property
    def distorted(self) -> bool:
        return any(getattr(self, k) != 0.0 for k in ("k1", "k2", "p1", "p2"))

    def distort(self, x: np.ndarray, y: np.ndarray):
        """Normalised pinhole coordinates -> distorted pixels."""
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return np.stack([self.fx * xd + self.cx, self.fy * yd + self.cy], axis=-1)


def scene_segments(seed: int, n_segments: int) -> np.ndarray:
    """(S, 2, 3) float32 world segments of the box room: the draws of
    ``make_wireframe_scene(np.random.default_rng(seed), n_segments)``."""
    rng = np.random.default_rng(seed)
    centers = np.stack(
        [rng.uniform(-4, 4, n_segments), rng.uniform(-3, 3, n_segments), rng.uniform(4, 12, n_segments)], axis=-1
    )
    dirs = rng.normal(size=(n_segments, 3))
    axis_mask = rng.random(n_segments) < 0.6
    axes = np.eye(3)[rng.integers(0, 3, n_segments)]
    dirs = np.where(axis_mask[:, None], axes, dirs)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12
    half = rng.uniform(0.4, 1.6, (n_segments, 1))
    return np.stack([centers - dirs * half, centers + dirs * half], axis=1).astype(np.float32)


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    cy, sy, cp, sp, cr, sr = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch), math.cos(roll), math.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


def _path_pose(theta: float, radius: float, amp: float) -> np.ndarray:
    """T_wc at phase ``theta`` of the unit-shaped path scaled by ``radius``
    (m) and ``amp`` (rad): an ellipse in x-z with a figure-eight in height,
    the view swinging in yaw, pitch and a little roll."""
    T = np.eye(4)
    T[:3, :3] = _rot(amp * math.sin(theta + 0.3), 0.5 * amp * math.sin(2 * theta + 1.0), 0.2 * amp * math.sin(theta))
    T[:3, 3] = radius * np.array([math.sin(theta), 0.25 * math.sin(2 * theta), 0.5 * (math.cos(theta) - 1.0)])
    return T


def _mean_steps(L: int, radius: float, amp: float):
    """Mean translation (m) and rotation (deg) from frame to frame."""
    poses = [_path_pose(2 * math.pi * f / L, radius, amp) for f in range(L + 1)]
    dt, dr = [], []
    for a, b in zip(poses, poses[1:]):
        rel = np.linalg.inv(a) @ b
        dt.append(np.linalg.norm(rel[:3, 3]))
        dr.append(math.degrees(math.acos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))))
    return float(np.mean(dt)), float(np.mean(dr))


def periodic_path(L: int, step_m: float, step_deg: float) -> np.ndarray:
    """(L, 4, 4) float64 T_cw of a closed path whose mean step from frame to
    frame is ``step_m`` metres and ``step_deg`` degrees; frame f is phase
    2 pi f / L, so frame L would be frame 0 and the velocity is continuous
    across the wrap."""
    m0, _ = _mean_steps(L, 1.0, 0.0)
    radius = step_m / m0
    _, r0 = _mean_steps(L, radius, 0.1)
    amp = 0.1 * step_deg / r0  # the rotation step is linear in the amplitude at these sizes
    return np.stack([np.linalg.inv(_path_pose(2 * math.pi * f / L, radius, amp)) for f in range(L)])


def project(segments: np.ndarray, T_cw: np.ndarray, rig: Rig, dtype=np.float64):
    """Projected endpoints (S, 2, 2) and visibility (S,) of world segments,
    computed in ``dtype`` (both endpoints in front by 0.2 m and inside the
    image, as the renderer draws them)."""
    seg = segments.astype(dtype)
    R, t = T_cw[:3, :3].astype(dtype), T_cw[:3, 3].astype(dtype)
    Xc = seg @ R.T + t
    z = Xc[..., 2]
    zs = np.maximum(z, dtype(1e-9))
    uv = np.stack([dtype(rig.fx) * Xc[..., 0] / zs + dtype(rig.cx), dtype(rig.fy) * Xc[..., 1] / zs + dtype(rig.cy)], axis=-1)
    inside = (uv[..., 0] >= 0) & (uv[..., 0] < rig.width) & (uv[..., 1] >= 0) & (uv[..., 1] < rig.height)
    vis = (z[:, 0] > 0.2) & (z[:, 1] > 0.2) & inside[:, 0] & inside[:, 1]
    return uv, vis


def _draw_line_aa(img: np.ndarray, p, q, color: float, thickness: int) -> None:
    """Anti-aliased thick segment from pixel p to pixel q, in place: each
    pixel centre in the segment's box blends towards ``color`` by its
    coverage clip(thickness / 2 + 0.5 - d, 0, 1), d its distance to the
    segment."""
    H, W = img.shape
    reach = thickness / 2.0 + 0.5
    x0 = max(int(np.floor(min(p[0], q[0]) - reach)), 0)
    x1 = min(int(np.ceil(max(p[0], q[0]) + reach)), W - 1)
    y0 = max(int(np.floor(min(p[1], q[1]) - reach)), 0)
    y1 = min(int(np.ceil(max(p[1], q[1]) + reach)), H - 1)
    if x0 > x1 or y0 > y1:
        return
    xs = np.arange(x0, x1 + 1, dtype=np.float32)[None, :]
    ys = np.arange(y0, y1 + 1, dtype=np.float32)[:, None]
    px, py = float(p[0]), float(p[1])
    dx, dy = float(q[0]) - px, float(q[1]) - py
    len2 = dx * dx + dy * dy
    s = np.clip(((xs - px) * dx + (ys - py) * dy) / len2, 0.0, 1.0) if len2 > 0 else np.zeros((1, 1), np.float32)
    dist = np.hypot(xs - (px + s * dx), ys - (py + s * dy))
    cover = np.clip(reach - dist, 0.0, 1.0).astype(np.float32)
    patch = img[y0 : y1 + 1, x0 : x1 + 1]
    patch += (np.float32(color) - patch) * cover


def render(segments: np.ndarray, T_cw: np.ndarray, rig: Rig, bg: float = 200.0, fg: float = 40.0) -> np.ndarray:
    """Clean uint8 image of the wireframe seen from ``T_cw``."""
    if rig.distorted:
        return _render_distorted(segments, T_cw, rig, bg, fg)
    img = np.full((rig.height, rig.width), bg, np.float32)
    uv, vis = project(segments, T_cw, rig, np.float32)
    for s in np.nonzero(vis)[0]:
        _draw_line_aa(img, np.round(uv[s, 0]).astype(int), np.round(uv[s, 1]).astype(int), fg, 2)
    return np.clip(img, 0, 255).astype(np.uint8)


def _render_distorted(segments, T_cw, rig: Rig, bg: float, fg: float, thickness: int = 2) -> np.ndarray:
    """The wireframe through the rig's distortion: each segment with both
    ends 0.2 m in front whose every polyline vertex falls inside the image,
    its coverage that of its nearest piece, clip(thickness / 2 + 0.5 - d,
    0, 1). Blending the segments one after another towards ``fg`` leaves
    fg + (bg - fg) prod(1 - coverage) in each pixel, whatever the order."""
    H, W = rig.height, rig.width
    seg = segments.astype(np.float64)
    Xc = seg @ T_cw[:3, :3].T + T_cw[:3, 3]
    reach = thickness / 2.0 + 0.5
    starts, ends, sid = [], [], []
    for s in range(len(seg)):
        a, b = Xc[s]
        if a[2] <= 0.2 or b[2] <= 0.2:
            continue
        pin = np.array([rig.fx * (a[0] / a[2] - b[0] / b[2]), rig.fy * (a[1] / a[2] - b[1] / b[2])])
        n = int(min(max(np.ceil(np.linalg.norm(pin) / PIECE_PX), 1), 512))
        P = a + np.linspace(0.0, 1.0, n + 1)[:, None] * (b - a)
        uv = rig.distort(P[:, 0] / P[:, 2], P[:, 1] / P[:, 2])
        if not ((uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)).all():
            continue
        starts.append(uv[:-1])
        ends.append(uv[1:])
        sid.append(np.full(n, len(sid)))
    if not sid:
        return np.full((H, W), np.clip(np.round(bg), 0, 255), np.uint8)
    p, q, sid = np.concatenate(starts), np.concatenate(ends), np.concatenate(sid)
    lo = np.floor(np.minimum(p, q) - reach).astype(np.int64)
    m = int(np.ceil(np.max(np.abs(q - p)) + 2 * reach)) + 2  # window side that holds every piece's reach
    xs = lo[:, 0, None, None] + np.arange(m)[None, None, :]
    ys = lo[:, 1, None, None] + np.arange(m)[None, :, None]
    d = (q - p)[:, :, None, None]
    len2 = np.maximum(np.sum(d * d, axis=1), 1e-12)
    t = np.clip(((xs - p[:, 0, None, None]) * d[:, 0] + (ys - p[:, 1, None, None]) * d[:, 1]) / len2, 0.0, 1.0)
    dist = np.hypot(xs - (p[:, 0, None, None] + t * d[:, 0]), ys - (p[:, 1, None, None] + t * d[:, 1]))
    cover = np.clip(reach - dist, 0.0, 1.0)
    hit = (cover > 0) & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    key = (sid[:, None, None] * (H * W) + ys * W + xs)[hit]
    keys, inv = np.unique(key, return_inverse=True)
    seg_cover = np.zeros(len(keys))
    np.maximum.at(seg_cover, inv, cover[hit])
    keep = np.ones(H * W)
    np.multiply.at(keep, keys % (H * W), 1.0 - seg_cover)
    img = fg + (bg - fg) * keep.reshape(H, W)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


class Stream(NamedTuple):
    """One sequence: its segments, its ground-truth T_cw per path frame, the
    frame offset it starts at, and its rig."""

    segments: np.ndarray  # (S, 2, 3)
    poses: np.ndarray  # (L, 4, 4) T_cw of the left camera
    offset: int
    rig: Rig

    def gt(self, j: int) -> np.ndarray:
        """T_cw of the j-th frame handed in."""
        return self.poses[(j + self.offset) % len(self.poses)]


def streams(traffic: dict, rig: Rig, n_seq: int):
    """The ``n_seq`` sequences of a traffic mix on ``rig``: sequence s draws
    its segments from scene seed ``scene_seed + s`` and starts
    ``s * L / n_seq`` frames into the path (phases offset)."""
    L = int(traffic["lap_frames"])
    poses = periodic_path(L, float(traffic["step_m"]), float(traffic["step_deg"]))
    return [
        Stream(scene_segments(int(traffic["scene_seed"]) + s, int(traffic["segments"])), poses, (s * L) // n_seq, rig)
        for s in range(n_seq)
    ]


def _render_pair(args):
    segments, T_cw, rig = args
    Tb = np.eye(4)
    Tb[0, 3] = -rig.baseline
    return render(segments, T_cw, rig), render(segments, Tb @ T_cw, rig)


def _cache_key(traffic: dict, rig: Rig, n_seq: int) -> str:
    text = json.dumps({"traffic": traffic, "rig": rig._asdict(), "n_seq": n_seq, "form": 2}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def clean_frames(traffic: dict, rig: Rig, n_seq: int) -> np.ndarray:
    """(n_seq, L, 2, H, W) uint8 clean (left, right) frames of every path
    frame of every sequence, each at its path frame (not offset), rendered
    once per checkout into :data:`CACHE_DIR` and read from there after."""
    path = CACHE_DIR / f"frames_{_cache_key(traffic, rig, n_seq)}.npy"
    if path.exists():
        return np.load(path, mmap_mode="r")
    seqs = streams(traffic, rig, n_seq)
    jobs = [(s.segments, s.poses[f], rig) for s in seqs for f in range(len(s.poses))]
    with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        pairs = pool.map(_render_pair, jobs, chunksize=8)
    out = np.stack([np.stack(p) for p in pairs]).reshape(n_seq, -1, 2, rig.height, rig.width)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
    np.save(tmp, out)
    os.replace(tmp, path)
    return np.load(path, mmap_mode="r")


def noisy_frames(clean: np.ndarray, seed: int, sigma: float, device) -> np.ndarray:
    """``clean`` (n_seq, L, 2, H, W) uint8 plus Gaussian noise of ``sigma``
    grey levels drawn from ``seed`` by a torch generator on ``device``,
    rounded and clipped to uint8, back in host memory (the recording the
    system is fed). A few large calls, one sequence at a time."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = np.empty(clean.shape, np.uint8)
    for s in range(clean.shape[0]):
        x = torch.from_numpy(np.array(clean[s])).to(device)
        noise = torch.randn(x.shape, generator=gen, device=device, dtype=torch.float32) * sigma
        out[s] = torch.clamp(torch.round(x.to(torch.float32) + noise), 0, 255).to(torch.uint8).cpu().numpy()
        del x, noise
    return out
