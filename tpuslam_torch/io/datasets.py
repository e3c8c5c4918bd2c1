"""Dataset loaders: TUM RGB-D (mono), EuRoC (stereo), KITTI odometry (stereo).

Counterpart of ``tpuslam.io.datasets``: the same layouts, calibrations and
``Sequence`` items. Loaders list (timestamp, image paths); images decode
lazily to grayscale float32 in [0, 1]. ``write_synthetic_dataset`` writes a
rendered wireframe sequence in a TUM-like layout of ``.npy`` images (this
package's numpy renderer, so its images differ from the JAX package's cv2
drawing; the index, ground truth and calibration files are the same), and
``load_synthetic`` reads it.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tpuslam_torch.geometry.camera import Intrinsics


def load_image_gray(path: str) -> np.ndarray:
    """Decode to grayscale f32 in [0, 1]: ``.npy`` directly, any other file
    through cv2, else PIL; raises ImportError when neither imports."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img.astype(np.float32)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: decoding it needs cv2 or PIL, and neither imports") from e
    return np.asarray(Image.open(path).convert("L"), np.float32) / 255.0


@dataclass
class SequenceItem:
    timestamp: float
    left: str
    right: Optional[str] = None


@dataclass
class Sequence:
    items: List[SequenceItem]
    cam: Intrinsics
    name: str = ""
    gt_timestamps: Optional[np.ndarray] = None  # (N,)
    gt_positions: Optional[np.ndarray] = None  # (N, 3)
    gt_poses: Optional[np.ndarray] = None  # (N, 4, 4) T_wc if available

    def __len__(self):
        return len(self.items)

    def frames(self) -> Iterator[Tuple[float, np.ndarray, Optional[np.ndarray]]]:
        for it in self.items:
            right = load_image_gray(it.right) if it.right else None
            yield it.timestamp, load_image_gray(it.left), right


# ---------------------------------------------------------------- TUM RGB-D
TUM_INTRINSICS = {
    # freiburg1 / freiburg2 / freiburg3 defaults (ROS-default calibration)
    "fr1": Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480),
    "fr2": Intrinsics(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480),
    "fr3": Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480),
}


def load_tum(root: str, cam: Intrinsics | None = None) -> Sequence:
    """TUM layout: rgb.txt ('timestamp path'), groundtruth.txt (tx ty tz q)."""
    if cam is None:
        low = root.lower()
        key = "fr1" if "freiburg1" in low else "fr2" if "freiburg2" in low else "fr3"
        cam = TUM_INTRINSICS[key]
    items = []
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            items.append(SequenceItem(float(ts), os.path.join(root, rel)))
    seq = Sequence(items=items, cam=cam, name=os.path.basename(root.rstrip("/")))
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        ts, pos = [], []
        with open(gt_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = line.split()
                ts.append(float(vals[0]))
                pos.append([float(v) for v in vals[1:4]])
        seq.gt_timestamps = np.asarray(ts)
        seq.gt_positions = np.asarray(pos, np.float32)
    return seq


# ------------------------------------------------------------------- EuRoC
EUROC_CAM = Intrinsics(
    fx=435.2046959714599,
    fy=435.2046959714599,
    cx=367.4517211914062,
    cy=252.2008514404297,
    width=752,
    height=480,
    baseline=0.110073808127187,
)  # rectified cam0/cam1 (the standard stereo-rectified EuRoC calibration)


def load_euroc(root: str, cam: Intrinsics | None = None) -> Sequence:
    """EuRoC ASL layout: mav0/cam{0,1}/data.csv + data/<stamp>.png."""
    cam = cam or EUROC_CAM
    base = os.path.join(root, "mav0")

    def read_cam(c):
        out = {}
        with open(os.path.join(base, c, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                out[int(row[0])] = os.path.join(base, c, "data", row[1].strip())
        return out

    left = read_cam("cam0")
    right = read_cam("cam1")
    items = [SequenceItem(ns * 1e-9, left[ns], right[ns]) for ns in sorted(set(left) & set(right))]
    seq = Sequence(items=items, cam=cam, name=os.path.basename(root.rstrip("/")))
    gt_csv = os.path.join(base, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        ts, pos = [], []
        with open(gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                pos.append([float(v) for v in row[1:4]])
        seq.gt_timestamps = np.asarray(ts)
        seq.gt_positions = np.asarray(pos, np.float32)
    return seq


# ------------------------------------------------------------------- KITTI
KITTI_CAM_00_02 = Intrinsics(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376, baseline=0.5371657
)


def load_kitti(root: str, seq_id: str = "00", cam: Intrinsics | None = None) -> Sequence:
    """KITTI odometry layout: sequences/<id>/image_{0,1}/*.png + times.txt."""
    cam = cam or KITTI_CAM_00_02
    base = os.path.join(root, "sequences", seq_id)
    with open(os.path.join(base, "times.txt")) as f:
        times = [float(t) for t in f.read().split()]
    items = [
        SequenceItem(t, os.path.join(base, "image_0", f"{i:06d}.png"), os.path.join(base, "image_1", f"{i:06d}.png"))
        for i, t in enumerate(times)
    ]
    seq = Sequence(items=items, cam=cam, name=f"kitti-{seq_id}")
    poses_file = os.path.join(root, "poses", f"{seq_id}.txt")
    if os.path.exists(poses_file):
        mats = np.loadtxt(poses_file).reshape(-1, 3, 4)
        poses = np.tile(np.eye(4, dtype=np.float32), (len(mats), 1, 1))
        poses[:, :3, :4] = mats
        seq.gt_poses = poses  # T_wc (cam0-to-world)
        seq.gt_positions = poses[:, :3, 3]
        seq.gt_timestamps = np.asarray(times[: len(mats)])
    return seq


# -------------------------------------------------------- synthetic on-disk
def write_synthetic_dataset(
    root: str,
    n_frames: int = 40,
    seed: int = 0,
    stereo: bool = True,
    cam: Intrinsics | None = None,
    n_segments: int = 120,
    motion_scale: float = 0.03,
):
    """Materialize a rendered wireframe sequence in a TUM-like layout
    (npy images) so dataset-path code can be exercised without real data."""
    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    cam = cam or Intrinsics(
        fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11 if stereo else 0.0
    )
    rng = np.random.default_rng(seed)
    scene = make_wireframe_scene(rng, n_segments=n_segments, n_frames=n_frames, cam=cam, motion_scale=motion_scale)
    os.makedirs(os.path.join(root, "left"), exist_ok=True)
    if stereo:
        os.makedirs(os.path.join(root, "right"), exist_ok=True)
        Tb = np.eye(4, dtype=np.float32)
        Tb[0, 3] = -cam.baseline
        scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    lines = []
    gt_ts, gt_pos = [], []
    for f in range(n_frames):
        t = f * 0.05
        lp = os.path.join(root, "left", f"{f:06d}.npy")
        np.save(lp, render_wireframe_image(scene, f, noise=1.0, rng=rng))
        rp = ""
        if stereo:
            rp = os.path.join(root, "right", f"{f:06d}.npy")
            np.save(rp, render_wireframe_image(scene_r, f, noise=1.0, rng=rng))
        lines.append((t, lp, rp))
        Twc = np.linalg.inv(scene.poses[f])
        gt_ts.append(t)
        gt_pos.append(Twc[:3, 3])
    with open(os.path.join(root, "index.txt"), "w") as f:
        for t, lp, rp in lines:
            f.write(f"{t} {lp} {rp}\n")
    np.savetxt(
        os.path.join(root, "groundtruth.txt"),
        np.concatenate([np.asarray(gt_ts)[:, None], np.asarray(gt_pos)], axis=1),
    )
    np.save(os.path.join(root, "gt_poses.npy"), np.stack([np.linalg.inv(T) for T in scene.poses]))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height} {cam.baseline}\n")
    return scene


def load_synthetic(root: str) -> Sequence:
    with open(os.path.join(root, "calib.txt")) as f:
        fx, fy, cx, cy, w, h, b = [float(v) for v in f.read().split()]
    cam = Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=int(w), height=int(h), baseline=b)
    items = []
    with open(os.path.join(root, "index.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                items.append(
                    SequenceItem(float(parts[0]), parts[1], parts[2] if len(parts) > 2 and parts[2] else None)
                )
    gt = np.loadtxt(os.path.join(root, "groundtruth.txt"))
    seq = Sequence(
        items=items,
        cam=cam,
        name=os.path.basename(root.rstrip("/")),
        gt_timestamps=gt[:, 0],
        gt_positions=gt[:, 1:4].astype(np.float32),
    )
    gp = os.path.join(root, "gt_poses.npy")
    if os.path.exists(gp):
        seq.gt_poses = np.load(gp)
    return seq
