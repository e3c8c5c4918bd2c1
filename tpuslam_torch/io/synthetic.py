"""Procedural synthetic wireframe scenes and their rendered frames (numpy).

``make_wireframe_scene`` and ``make_loop_scene`` are copies of the JAX
package's (``tpuslam.io.synthetic``), so the same seed gives the same scene, and
``observe_frame`` its segment and point projection.
``render_wireframe_image`` draws with numpy alone: the JAX package draws
its lines with ``cv2.line``, which the machines that run the port may not
have; its point dots (Gaussian splats, ``draw_points``) are numpy there too
and are copied here step for step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from tpuslam_torch.geometry.camera import Intrinsics


def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """Numpy SE(3) exponential (rho, phi) -> 4x4."""
    rho, phi = xi[:3], xi[3:]
    t = np.linalg.norm(phi)
    W = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]], np.float64)
    if t < 1e-8:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        W2 = W @ W
        R = np.eye(3) + np.sin(t) / t * W + (1 - np.cos(t)) / t**2 * W2
        V = np.eye(3) + (1 - np.cos(t)) / t**2 * W + (t - np.sin(t)) / t**3 * W2
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


class SyntheticScene(NamedTuple):
    segments: np.ndarray  # (S, 2, 3) 3D segment endpoints (world)
    points: np.ndarray  # (Q, 3) 3D points (world)
    poses: np.ndarray  # (F, 4, 4) ground-truth T_cw per frame
    cam: Intrinsics


def make_wireframe_scene(
    rng: np.random.Generator,
    n_segments: int = 120,
    n_points: int = 200,
    n_frames: int = 60,
    cam: Intrinsics | None = None,
    motion_scale: float = 0.04,
) -> SyntheticScene:
    """Box-room wireframe seen from a smooth random-walk trajectory (the JAX
    package's generator, draw for draw)."""
    if cam is None:
        cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)
    centers = np.stack(
        [
            rng.uniform(-4, 4, n_segments),
            rng.uniform(-3, 3, n_segments),
            rng.uniform(4, 12, n_segments),
        ],
        axis=-1,
    )
    dirs = rng.normal(size=(n_segments, 3))
    axis_mask = rng.random(n_segments) < 0.6
    axes = np.eye(3)[rng.integers(0, 3, n_segments)]
    dirs = np.where(axis_mask[:, None], axes, dirs)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12
    half = rng.uniform(0.4, 1.6, (n_segments, 1))
    segments = np.stack([centers - dirs * half, centers + dirs * half], axis=1)

    points = np.stack(
        [
            rng.uniform(-4, 4, n_points),
            rng.uniform(-3, 3, n_points),
            rng.uniform(4, 12, n_points),
        ],
        axis=-1,
    )

    vels = rng.normal(size=(n_frames, 6)) * motion_scale
    for i in range(1, n_frames):
        vels[i] = 0.9 * vels[i - 1] + 0.1 * vels[i]
    vels[:, 3:] *= 0.3  # gentler rotation
    T = np.eye(4, dtype=np.float32)
    poses = []
    for i in range(n_frames):
        T = (_se3_exp_np(vels[i]) @ T).astype(np.float32)
        poses.append(T.copy())
    return SyntheticScene(
        segments=segments.astype(np.float32),
        points=points.astype(np.float32),
        poses=np.stack(poses),
        cam=cam,
    )



def make_loop_scene(
    rng: np.random.Generator,
    n_segments: int = 240,
    n_frames: int = 80,
    radius: float = 6.0,
    room: float = 16.0,
    cam: Intrinsics | None = None,
) -> SyntheticScene:
    """The camera circles inside a wireframe room and comes back to its
    start, looking along its path: the loop-closure scene (the JAX package's
    generator, draw for draw). Segments are scattered on a cylinder of walls
    of radius ``room``; the scene has no points."""
    if cam is None:
        cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)
    ang = rng.uniform(0, 2 * np.pi, n_segments)
    h = rng.uniform(-2.5, 2.5, n_segments)
    centers = np.stack([room * np.cos(ang), h, room * np.sin(ang)], axis=-1)
    dirs = rng.normal(size=(n_segments, 3))
    axis_mask = rng.random(n_segments) < 0.6
    axes = np.eye(3)[rng.integers(0, 3, n_segments)]
    dirs = np.where(axis_mask[:, None], axes, dirs)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12
    half = rng.uniform(0.5, 2.0, (n_segments, 1))
    segments = np.stack([centers - dirs * half, centers + dirs * half], axis=1)

    poses = []
    for f in range(n_frames):
        a = 2 * np.pi * f / n_frames
        c = np.array([radius * np.cos(a), 0.0, radius * np.sin(a)])
        z = np.array([-np.sin(a), 0.0, np.cos(a)])  # along the direction of motion
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[:3, :3] = np.stack([x, y, z], axis=1)
        T_wc[:3, 3] = c
        poses.append(np.linalg.inv(T_wc).astype(np.float32))
    return SyntheticScene(
        segments=segments.astype(np.float32),
        points=np.zeros((0, 3), np.float32),
        poses=np.stack(poses),
        cam=cam,
    )


def make_mono_scene(
    rng: np.random.Generator,
    n_frames: int = 30,
    cam: Intrinsics | None = None,
    n_segments: int = 60,
    n_points: int = 120,
    step: float = 0.06,
) -> SyntheticScene:
    """The monocular walk of benchmarks/ladder.py (``_mono_scene``): a
    wireframe scene (``make_wireframe_scene``'s draws for 2 frames) seen by a
    camera that moves sideways by ``step`` per frame, its height wobbling by
    0.02 sin(0.5 f): the parallax that two-view initialization and the
    mapper's triangulation need."""
    scene = make_wireframe_scene(rng, n_segments=n_segments, n_points=n_points, n_frames=2, cam=cam)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    for f in range(n_frames):
        poses[f, 0, 3] = -f * step
        poses[f, 1, 3] = 0.02 * np.sin(f * 0.5)
    return scene._replace(poses=poses)


def make_mono_loop_scene(
    rng: np.random.Generator, n_frames: int = 120, dwell: int = 20, cam: Intrinsics | None = None
) -> SyntheticScene:
    """The monocular loop of benchmarks/ladder.py (``mono_loop``):
    ``make_loop_scene`` with 260 segments, the camera on a circle of radius
    5 m in a room of radius 14 m over ``n_frames``, then its first ``dwell``
    poses again (the revisit that loop detection needs)."""
    scene = make_loop_scene(rng, n_segments=260, n_frames=n_frames, radius=5.0, room=14.0, cam=cam)
    return scene._replace(poses=np.concatenate([scene.poses, scene.poses[:dwell]]))


class FrameObservations(NamedTuple):
    seg_uv: np.ndarray  # (S, 2, 2) projected segment endpoints (px)
    seg_visible: np.ndarray  # (S,) bool — both endpoints in front & in image
    pt_uv: np.ndarray  # (Q, 2) projected scene points (px)
    pt_visible: np.ndarray  # (Q,) bool — in front & in image


def observe_frame(
    scene: SyntheticScene, frame: int, min_z: float = 0.2, margin: float = 0.0, *, noise_px: float = 0.0,
    rng: np.random.Generator | None = None,
) -> FrameObservations:
    """Projected segments and points of one frame, with Gaussian pixel noise
    of ``noise_px`` from ``rng`` (the JAX package's draws, in its order)."""
    cam = scene.cam
    T = scene.poses[frame]
    R, t = T[:3, :3], T[:3, 3]

    def project(X):
        Xc = X @ R.T + t
        z = Xc[:, 2]
        uv = np.stack(
            [
                cam.fx * Xc[:, 0] / np.maximum(z, 1e-9) + cam.cx,
                cam.fy * Xc[:, 1] / np.maximum(z, 1e-9) + cam.cy,
            ],
            axis=-1,
        )
        return uv, z

    p_uv, p_z = project(scene.segments[:, 0])
    q_uv, q_z = project(scene.segments[:, 1])

    def in_image(uv):
        return (uv[:, 0] >= margin) & (uv[:, 0] < cam.width - margin) & (uv[:, 1] >= margin) & (
            uv[:, 1] < cam.height - margin
        )

    pt_uv, pt_z = project(scene.points)
    seg_uv = np.stack([p_uv, q_uv], axis=1)
    seg_visible = (p_z > min_z) & (q_z > min_z) & in_image(p_uv) & in_image(q_uv)
    pt_visible = (pt_z > min_z) & in_image(pt_uv)
    if noise_px > 0:
        seg_uv = seg_uv + rng.normal(size=seg_uv.shape) * noise_px
        pt_uv = pt_uv + rng.normal(size=pt_uv.shape) * noise_px
    return FrameObservations(
        seg_uv=seg_uv.astype(np.float32),
        seg_visible=seg_visible,
        pt_uv=pt_uv.astype(np.float32),
        pt_visible=pt_visible,
    )


def synthetic_frame_features(
    scene: SyntheticScene,
    frame: int,
    capacity: int = 256,
    noise_px: float = 0.0,
    rng: np.random.Generator | None = None,
    with_depth: bool = False,
    desc_seed: int = 1234,
    device="cuda",
):
    """Detector-bypassing FrameFeatures (the JAX package's, draw for draw):
    the projected ground-truth segments with identity-stable binary
    descriptors (segment s always hashes to the same 256 bits), so matching
    is exact and the tracking stages can run on their own. Returns
    (FrameFeatures on ``device``, the visible segment ids)."""
    import torch

    from tpuslam_torch.device import resolve_device
    from tpuslam_torch.frontend.frame import FrameFeatures

    dev = resolve_device(device)
    obs = observe_frame(scene, frame, noise_px=noise_px, rng=rng)
    S = scene.segments.shape[0]
    drs = np.random.RandomState(desc_seed)
    all_bits = drs.randint(0, 2**32, size=(S, 8), dtype=np.uint64).astype(np.uint32)
    all_desc = drs.standard_normal((S, 72)).astype(np.float32)
    vis = np.nonzero(obs.seg_visible)[0][:capacity]
    n = len(vis)
    K = capacity
    ep = np.zeros((K, 2, 2), np.float32)
    valid = np.zeros(K, np.float32)
    angle = np.zeros(K, np.float32)
    length = np.zeros(K, np.float32)
    mid = np.zeros((K, 2), np.float32)
    desc = np.zeros((K, 72), np.float32)
    bits = np.zeros((K, 8), np.int64)
    depth = np.zeros((K, 2), np.float32)
    has_depth = np.zeros(K, np.float32)
    ep[:n] = obs.seg_uv[vis]
    valid[:n] = 1.0
    d = ep[:n, 1] - ep[:n, 0]
    angle[:n] = np.arctan2(d[:, 1], d[:, 0])
    length[:n] = np.linalg.norm(d, axis=-1)
    mid[:n] = ep[:n].mean(axis=1)
    desc[:n] = all_desc[vis]
    bits[:n] = all_bits[vis]
    if with_depth:
        T = scene.poses[frame]
        seg_c = scene.segments @ T[:3, :3].T + T[:3, 3]
        depth[:n] = seg_c[vis][:, :, 2]
        has_depth[:n] = np.all(depth[:n] > 0.1, axis=-1).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    feats = FrameFeatures(
        endpoints=t(ep), valid=t(valid), angle=t(angle), length=t(length), midpoint=t(mid), response=t(length.copy()),
        level=t(np.zeros(K, np.int32)), sigma=t(np.ones(K, np.float32)), desc=t(desc), desc_bits=t(bits),
        depth=t(depth), has_depth=t(has_depth),
    )
    return feats, vis


def _draw_line_aa(img: np.ndarray, p, q, color: float, thickness: int) -> None:
    """Anti-aliased thick segment from pixel p to pixel q, in place.

    Each pixel centre within the segment's bounding box takes coverage
    clip(thickness / 2 + 0.5 - d, 0, 1), d its distance to the segment, and
    blends towards ``color`` by it (the blend cv2's LINE_AA uses)."""
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
    if len2 > 0:
        s = np.clip(((xs - px) * dx + (ys - py) * dy) / len2, 0.0, 1.0)
    else:
        s = np.zeros((1, 1), np.float32)
    dist = np.hypot(xs - (px + s * dx), ys - (py + s * dy))
    cover = np.clip(reach - dist, 0.0, 1.0).astype(np.float32)
    patch = img[y0 : y1 + 1, x0 : x1 + 1]
    patch += (np.float32(color) - patch) * cover


def _splat(img: np.ndarray, cx: float, cy: float, sigma: float, amp: float) -> None:
    """Subtract ``amp`` times a Gaussian of ``sigma`` centred at (cx, cy),
    over the pixels within 3 sigma + 2 of it, in place."""
    H, W = img.shape
    r = int(3 * sigma) + 2
    x0, x1 = int(np.floor(cx)) - r, int(np.floor(cx)) + r + 1
    y0, y1 = int(np.floor(cy)) - r, int(np.floor(cy)) + r + 1
    x0c, x1c = max(x0, 0), min(x1, W)
    y0c, y1c = max(y0, 0), min(y1, H)
    if x0c >= x1c or y0c >= y1c:
        return
    xs = np.arange(x0c, x1c, dtype=np.float32) - cx
    ys = np.arange(y0c, y1c, dtype=np.float32) - cy
    g = np.exp(-(ys[:, None] ** 2 + xs[None, :] ** 2) / (2.0 * sigma * sigma))
    img[y0c:y1c, x0c:x1c] -= amp * g


@functools.lru_cache(maxsize=None)
def _satellites(q: int):
    """Point q's satellite splat offsets (px): up to three draws in [-9, 9]^2
    from RandomState(1000 + q), those at least 4 px off the centre."""
    offs = np.random.RandomState(1000 + q).randint(-9, 10, (3, 2))
    return tuple((float(o[0]), float(o[1])) for o in offs if np.max(np.abs(o)) >= 4)


def render_wireframe_image(
    scene: SyntheticScene,
    frame: int,
    bg: float = 200.0,
    fg: float = 40.0,
    thickness: int = 2,
    noise: float = 2.0,
    rng: np.random.Generator | None = None,
    draw_points: bool = False,
    dot_radius: int = 2,
) -> np.ndarray:
    """Grayscale uint8 image of the wireframe: anti-aliased lines of
    ``thickness`` px between the rounded projected endpoints of every visible
    segment, plus Gaussian noise of std ``noise`` when ``rng`` is given.

    With ``draw_points`` each visible scene point is a dark Gaussian splat
    (sigma 0.5 ``dot_radius`` + 0.5) at its exact projection, with up to
    three smaller satellite splats at fixed per-point offsets, so FAST fires
    at the projection and BRIEF sees a distinctive pattern around it."""
    cam = scene.cam
    obs = observe_frame(scene, frame)
    img = np.full((cam.height, cam.width), bg, np.float32)
    for s in np.nonzero(obs.seg_visible)[0]:
        p = np.round(obs.seg_uv[s, 0]).astype(int)
        q = np.round(obs.seg_uv[s, 1]).astype(int)
        _draw_line_aa(img, p, q, fg, thickness)
    if draw_points:
        amp = float(bg - fg)
        for q_ in np.nonzero(obs.pt_visible)[0]:
            cx, cy = float(obs.pt_uv[q_, 0]), float(obs.pt_uv[q_, 1])
            _splat(img, cx, cy, 0.5 * dot_radius + 0.5, amp)
            for ox, oy in _satellites(int(q_)):
                _splat(img, cx + ox, cy + oy, 0.8, amp)
        np.clip(img, 0, 255, out=img)
    if noise > 0 and rng is not None:
        img = img + rng.normal(size=img.shape) * noise
    return np.clip(img, 0, 255).astype(np.uint8)
