"""Shared inputs for the tests that hold tpuslam_torch to tpuslam.

Everything is made with numpy from a seed and handed to both packages as
numpy arrays. Images are QVGA (320x240) or smaller.
"""

import os
import sys

import numpy as np
import torch

from tpuslam_torch import Intrinsics
from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

# The suite runs several pytest workers on a few cores; PyTorch's default of
# one thread per core oversubscribes them.
torch.set_num_threads(2)

QVGA = Intrinsics(fx=229.0, fy=228.5, cx=160.0, cy=120.0, width=320, height=240, baseline=0.11)


def stereo_scene(n_frames: int, cam: Intrinsics = QVGA, seed: int = 0):
    """The bench's wireframe scene at ``cam``'s size and its rendered
    (left, right) uint8 frames (noise std 1)."""
    rng = np.random.default_rng(seed)
    scene = make_wireframe_scene(rng, n_segments=140, n_frames=n_frames, cam=cam, motion_scale=0.02)
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    frames = [
        (render_wireframe_image(scene, f, noise=1.0, rng=rng), render_wireframe_image(scene_r, f, noise=1.0, rng=rng))
        for f in range(n_frames)
    ]
    return scene, frames


def image01(frame_u8: np.ndarray) -> np.ndarray:
    """uint8 frame -> float32 in [0, 1], as both trackers convert it."""
    return frame_u8.astype(np.float32) / 255.0


def np_of(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# tests/test_hybrid.py's rig: QVGA at fx 200, baseline 0.1 m
DOTS = Intrinsics(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240, baseline=0.1)


def dot_scene(n_frames: int, cam: Intrinsics = DOTS, seed: int = 0, n_segments: int = 40, n_points: int = 150, motion_scale: float = 0.012):
    """A wireframe scene with its 3D points drawn as dots (tests/test_hybrid.py's
    fixture) and its rendered (left, right) uint8 frames (noise std 1)."""
    rng = np.random.default_rng(seed)
    scene = make_wireframe_scene(rng, n_segments=n_segments, n_points=n_points, n_frames=n_frames, cam=cam, motion_scale=motion_scale)
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    frames = [
        (
            render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=True),
            render_wireframe_image(scene_r, f, noise=1.0, rng=rng, draw_points=True),
        )
        for f in range(n_frames)
    ]
    return scene, frames


class JaxAsOnTheCard:
    """The JAX package as the port's parity runs take it: cv2 hidden (the
    card's machine has none, so host_prescale takes its numpy form),
    keyframes finished at the next event (TPUSLAM_KF_DEFER_MS=0) and the
    native map mirror off (TPUSLAM_NATIVE_MAP=0)."""

    ENV = {"TPUSLAM_KF_DEFER_MS": "0", "TPUSLAM_NATIVE_MAP": "0"}

    def __enter__(self):
        self._env = {k: os.environ.get(k) for k in self.ENV}
        self._cv2 = sys.modules.get("cv2", False)
        os.environ.update(self.ENV)
        sys.modules["cv2"] = None
        return self

    def __exit__(self, *exc):
        for k, v in self._env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if self._cv2 is False:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = self._cv2
