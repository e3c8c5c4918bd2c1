"""Dataset readers, RPE, trajectory files and plots: tpuslam_torch.io.datasets,
eval.rpe, io.trajectory and viz against the JAX package's on layouts the
test writes (no dataset is in the repository), as tests/test_datasets.py
does."""

import os
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two torch threads per worker)
from tpuslam.eval.rpe import relative_pose_error as j_rpe
from tpuslam.io import datasets as jds
from tpuslam.io.trajectory import load_trajectory_tum as j_load_tum
from tpuslam_torch import Intrinsics
from tpuslam_torch.eval import relative_pose_error
from tpuslam_torch.eval.rpe import RPEResult
from tpuslam_torch.io import datasets as tds
from tpuslam_torch.io.trajectory import load_trajectory_tum, save_trajectory_tum

QVGA = Intrinsics(fx=229.0, fy=228.5, cx=160.0, cy=120.0, width=320, height=240, baseline=0.11)


def _write_img(path, value=0):
    np.save(path, np.full((8, 8), value, np.uint8))


def _tum(root):
    root = root / "rgbd_dataset_freiburg1_xyz"
    (root / "rgb").mkdir(parents=True)
    lines = ["# comment"]
    for i in range(4):
        _write_img(root / "rgb" / f"{i}.npy", 10 * i)
        lines.append(f"13050314{i}.5 rgb/{i}.npy")
    (root / "rgb.txt").write_text("\n".join(lines))
    (root / "groundtruth.txt").write_text(
        "# ts tx ty tz qx qy qz qw\n" + "\n".join(f"13050314{i}.5 {i*0.1} 0 0.25 0 0 0 1" for i in range(4))
    )
    return [str(root)], {}


def _euroc(root):
    root = root / "MH_01_easy"
    for c in ("cam0", "cam1"):
        (root / "mav0" / c / "data").mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for i in range(3 if c == "cam0" else 4):  # cam1 has a frame cam0 lacks
            ns = 1403636579763555584 + i * 50000000
            _write_img(root / "mav0" / c / "data" / f"{ns}.npy", i)
            rows.append(f"{ns},{ns}.npy")
        (root / "mav0" / c / "data.csv").write_text("\n".join(rows))
    gdir = root / "mav0" / "state_groundtruth_estimate0"
    gdir.mkdir(parents=True)
    rows = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]"]
    for i in range(3):
        rows.append(f"{1403636579763555584 + i * 50000000},{i*0.1},0.5,-0.25")
    (gdir / "data.csv").write_text("\n".join(rows))
    return [str(root)], {}


def _kitti(root):
    base = root / "sequences" / "00"
    for c in ("image_0", "image_1"):
        (base / c).mkdir(parents=True)
    (base / "times.txt").write_text("0.0\n0.1\n0.2\n")
    (root / "poses").mkdir()
    mats = np.tile(np.eye(4)[:3].reshape(1, 12), (3, 1))
    mats[:, 3] = [0.0, 0.5, 1.0]
    np.savetxt(root / "poses" / "00.txt", mats)
    return [str(root), "00"], {}


def _synthetic(root):
    tds.write_synthetic_dataset(str(root / "ds"), n_frames=3, n_segments=30, cam=QVGA)
    return [str(root / "ds")], {}


LAYOUTS = {
    "tum": (_tum, "load_tum"),
    "euroc": (_euroc, "load_euroc"),
    "kitti": (_kitti, "load_kitti"),
    "synthetic": (_synthetic, "load_synthetic"),
}


def _same_array(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sequences_match_jax(tmp_path, layout):
    """The same items, camera, name and ground truth from both packages'
    readers; the decoded .npy frames equal (the KITTI layout lists .png
    files, which the test does not write)."""
    write, loader = LAYOUTS[layout]
    args, kw = write(tmp_path)
    t, j = getattr(tds, loader)(*args, **kw), getattr(jds, loader)(*args, **kw)
    assert len(t) == len(j) > 0
    assert [(i.timestamp, i.left, i.right) for i in t.items] == [(i.timestamp, i.left, i.right) for i in j.items]
    assert tuple(t.cam) == tuple(j.cam) and t.name == j.name
    for f in ("gt_timestamps", "gt_positions", "gt_poses"):
        _same_array(getattr(t, f), getattr(j, f))
    if layout != "kitti":
        for (ts, l, r), (jts, jl, jr) in zip(t.frames(), j.frames()):
            assert ts == jts
            _same_array(l, jl)
            _same_array(r, jr)


def test_camera_constants_match_jax():
    assert tuple(tds.EUROC_CAM) == tuple(jds.EUROC_CAM)
    assert tuple(tds.KITTI_CAM_00_02) == tuple(jds.KITTI_CAM_00_02)
    assert {k: tuple(v) for k, v in tds.TUM_INTRINSICS.items()} == {k: tuple(v) for k, v in jds.TUM_INTRINSICS.items()}


@pytest.mark.parametrize("stereo", [True, False], ids=["stereo", "mono"])
def test_synthetic_writers_agree_but_for_images(tmp_path, stereo):
    """Both writers (this package's numpy renderer, the JAX package's cv2
    drawing) write the same index, ground truth, poses and calibration;
    the images differ only in how the lines are drawn."""
    kw = dict(n_frames=3, seed=5, stereo=stereo, n_segments=30, cam=None if stereo else QVGA._replace(baseline=0.0))
    roots = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    jds.write_synthetic_dataset(roots["jax"], **kw)
    tds.write_synthetic_dataset(roots["torch"], **kw)
    read = lambda pkg, name: open(os.path.join(roots[pkg], name)).read()  # noqa: E731
    assert read("jax", "index.txt").replace(roots["jax"], "<root>") == read("torch", "index.txt").replace(roots["torch"], "<root>")
    for name in ("groundtruth.txt", "calib.txt"):
        assert read("jax", name) == read("torch", name), name
    _same_array(np.load(os.path.join(roots["jax"], "gt_poses.npy")), np.load(os.path.join(roots["torch"], "gt_poses.npy")))
    assert sorted(os.listdir(roots["jax"])) == sorted(os.listdir(roots["torch"]))
    img_t = np.load(os.path.join(roots["torch"], "left", "000000.npy"))
    img_j = np.load(os.path.join(roots["jax"], "left", "000000.npy"))
    assert img_t.dtype == img_j.dtype == np.uint8 and img_t.shape == img_j.shape


def test_load_image_gray_decoders(tmp_path, monkeypatch):
    """A PNG decodes through cv2, else PIL, to what the JAX reader gives;
    with neither importable the reader raises ImportError naming the file."""
    cv2 = pytest.importorskip("cv2")
    img = (np.arange(48, dtype=np.uint8).reshape(6, 8) * 5).astype(np.uint8)
    p = str(tmp_path / "frame.png")
    cv2.imwrite(p, img)
    want = img.astype(np.float32) / 255.0
    _same_array(tds.load_image_gray(p), want)
    _same_array(jds.load_image_gray(p), want)
    with pytest.raises(FileNotFoundError):
        tds.load_image_gray(str(tmp_path / "missing.png"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    pytest.importorskip("PIL")
    _same_array(tds.load_image_gray(p), want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="frame.png"):
        tds.load_image_gray(p)
    np.save(str(tmp_path / "frame.npy"), img)
    _same_array(tds.load_image_gray(str(tmp_path / "frame.npy")), want)


def _poses(rng, n, scale=0.3):
    from scipy.spatial.transform import Rotation

    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = Rotation.from_rotvec(rng.normal(size=(n, 3)) * scale).as_matrix()
    out[:, :3, 3] = rng.normal(size=(n, 3))
    return out


@pytest.mark.parametrize("delta", [1, 3, 20])
def test_rpe_matches_jax(delta):
    rng = np.random.default_rng(delta)
    gt = _poses(rng, 12)
    est = gt @ _poses(rng, 12, scale=0.01)
    r, jr = relative_pose_error(est, gt, delta), j_rpe(est, gt, delta)
    assert isinstance(r, RPEResult) and r.n == jr.n
    if jr.n == 0:
        assert r == (float("inf"), float("inf"), 0) and tuple(jr) == tuple(r)
        return
    np.testing.assert_allclose([r.trans_rmse, r.rot_rmse_deg], [jr.trans_rmse, jr.rot_rmse_deg], rtol=0, atol=1e-12)
    assert r.trans_rmse > 0 and relative_pose_error(gt, gt, delta).trans_rmse < 1e-12


def test_load_trajectory_tum_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    T_cw = [np.linalg.inv(T) for T in _poses(rng, 10)]
    p = str(tmp_path / "traj.txt")
    save_trajectory_tum(p, [0.1 * i for i in range(10)], T_cw)
    (t, pos), (jt, jpos) = load_trajectory_tum(p), j_load_tum(p)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pos, np.stack([np.linalg.inv(T)[:3, 3] for T in T_cw]), atol=1e-6)


def test_plots(tmp_path):
    """The three plots, features as tensors (tests/test_datasets.py's
    TestViz on this package)."""
    pytest.importorskip("matplotlib")
    from tpuslam_torch.io.synthetic import make_wireframe_scene, synthetic_frame_features
    from tpuslam_torch.slammap.map import SlamMap
    from tpuslam_torch.viz import draw_frame_overlay, plot_map, plot_trajectory

    rng = np.random.default_rng(0)
    pos = rng.normal(size=(20, 3)).cumsum(axis=0)
    assert os.path.getsize(plot_trajectory(pos, pos + 0.01, str(tmp_path / "t.png"))) > 1000
    cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, baseline=0.11)
    scene = make_wireframe_scene(rng, n_segments=40, n_frames=2, cam=cam)
    m = SlamMap()
    feats, _ = synthetic_frame_features(scene, 0, with_depth=True, device="cpu")
    kf = m.new_keyframe(0, 0.0, scene.poses[0], feats)
    for s in range(5):
        lid = m.lines.allocate(np.zeros(6), scene.segments[s], np.zeros(8, np.uint32), 0)
        m.lines.add_observation(lid, kf, s)
    m.points.allocate(np.ones(3), np.zeros(8, np.uint32), 0)
    assert os.path.getsize(plot_map(m, str(tmp_path / "m.png"))) > 1000
    p3 = draw_frame_overlay(np.zeros((480, 640), np.float32), feats, np.arange(3), str(tmp_path / "f.png"))
    assert os.path.getsize(p3) > 1000
