"""Map files: tpuslam_torch.slammap.serialize against
tpuslam.slammap.serialize. Both packages build the same map from one seed
(keyframes with line and, in the hybrid case, corner features, landmarks
with observations, a free list, covisibility, the spanning tree and a loop
edge); a file written by either loads in the other to an equal
``convert.map_state`` (arrays bit-equal), and both write the same keys,
dtypes and graph JSON. Then a port System saves its map, a fresh System
loads it and relocalizes a LOST frame against it, as tests/test_system.py
checks for the JAX package."""

import json

import numpy as np
import pytest

import torch_parity  # noqa: F401  (two torch threads per worker)
from tpuslam_torch import Intrinsics
from tpuslam_torch.convert import features_from, map_state
from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState
from tpuslam_torch.io.synthetic import make_wireframe_scene, synthetic_frame_features
from tpuslam_torch.slammap import serialize
from tpuslam_torch.system import System

K, KP, N_KF, N_LINES, N_POINTS = 24, 16, 5, 60, 40
CAM = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)


def _package(pkg):
    """(SlamMap factory, FrameFeatures, PointFeatures, save_map, load_map) of
    ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        from tpuslam.frontend.frame import FrameFeatures
        from tpuslam.kernels.fast import PointFeatures
        from tpuslam.slammap import serialize as jser
        from tpuslam.slammap.map import SlamMap

        return (lambda **kw: SlamMap(native=False, **kw)), FrameFeatures, PointFeatures, jser.save_map, jser.load_map
    from tpuslam_torch.frontend.frame import FrameFeatures
    from tpuslam_torch.kernels.fast import PointFeatures
    from tpuslam_torch.slammap.map import SlamMap

    # the python graph as on the JAX side: the native mirror orders covisibility ties its own way
    return (lambda **kw: SlamMap(native=False, **kw)), FrameFeatures, PointFeatures, serialize.save_map, serialize.load_map


def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _line_features(rng):
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(
        endpoints=rng.uniform(0, 600, (K, 2, 2)).astype(np.float32),
        valid=(rng.uniform(size=K) < 0.85).astype(np.float32),
        angle=f32(K), length=f32(K), midpoint=f32(K, 2), response=f32(K),
        level=rng.integers(0, 2, K).astype(np.int32), sigma=f32(K), desc=f32(K, 72),
        desc_bits=_words(rng, K, 8), depth=f32(K, 2), has_depth=(rng.uniform(size=K) < 0.7).astype(np.float32),
    )


def _point_features(rng):
    return dict(
        uv=rng.uniform(0, 600, (KP, 2)).astype(np.float32), valid=(rng.uniform(size=KP) < 0.9).astype(np.float32),
        response=rng.uniform(0, 50, KP).astype(np.float32), desc_bits=_words(rng, KP, 8),
        depth=rng.uniform(1, 5, KP).astype(np.float32), has_depth=np.ones(KP, np.float32),
    )


def build_map(pkg, points: bool, seed: int = 0, line_capacity: int = 16384):
    """The same map in either package, from ``seed``."""
    SlamMap, FrameFeatures, PointFeatures, _, _ = _package(pkg)
    rng = np.random.default_rng(seed)
    m = SlamMap(line_capacity=line_capacity)
    kfs = []
    for k in range(N_KF):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(size=3) * 0.1
        pf = PointFeatures(**_point_features(rng)) if points else None
        kfs.append(m.new_keyframe(10 * k, 0.5 * k, T, FrameFeatures(**_line_features(rng)), point_features=pf))
    free_line = {kf.kid: list(rng.permutation(K)) for kf in kfs}
    free_corner = {kf.kid: list(rng.permutation(KP)) for kf in kfs}
    for i in range(N_LINES):
        lid = m.lines.allocate(
            rng.normal(size=6).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32), _words(rng, 8), kfs[i % N_KF].kid
        )
        for j in rng.choice(N_KF, size=2, replace=False):
            if free_line[kfs[j].kid]:
                m.lines.add_observation(lid, kfs[j], int(free_line[kfs[j].kid].pop()))
    for lid in (3, 17, 41):
        m.lines.kill(lid, m.keyframes)
    if points:
        for i in range(N_POINTS):
            pid = m.points.allocate(rng.normal(size=3).astype(np.float32), _words(rng, 8), kfs[i % N_KF].kid)
            for j in rng.choice(N_KF, size=2, replace=False):
                if free_corner[kfs[j].kid]:
                    m.points.add_observation(pid, kfs[j], int(free_corner[kfs[j].kid].pop()))
        m.points.kill(5, m.keyframes)
    for kf in kfs:
        m.update_connections(kf)
    kfs[-1].loop_edges.add(0)
    kfs[0].loop_edges.add(kfs[-1].kid)
    return m


def assert_same_state(a, b, where="map"):
    """Equal map_state snapshots: the same keys, lists and scalars, and
    arrays with the same dtype and bits."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same_state(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_state(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("points", [False, True], ids=["lines", "hybrid"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_map_file_crosses_packages(tmp_path, writer, points):
    """A map written by ``writer`` loads in both packages to the state of the
    map that was saved (the two packages' maps from one seed are equal to
    begin with)."""
    jmap, tmap = build_map("jax", points), build_map("torch", points)
    want = map_state(tmap)
    assert_same_state(map_state(jmap), want)
    assert (len(want["points"]["obs"]) > 0) == points
    p = str(tmp_path / "map.npz")
    _package(writer)[3](jmap if writer == "jax" else tmap, p)
    for reader in ("jax", "torch"):
        assert_same_state(map_state(_package(reader)[4](p)), want, f"{writer}->{reader}")


@pytest.mark.parametrize("points", [False, True], ids=["lines", "hybrid"])
def test_same_file_format(tmp_path, points):
    """Both packages write the same array names, dtypes, shapes and bits and
    the same graph JSON for the same map."""
    files = {}
    for pkg in ("jax", "torch"):
        p = str(tmp_path / f"{pkg}.npz")
        _package(pkg)[3](build_map(pkg, points), p)
        files[pkg] = np.load(p, allow_pickle=False)
    j, t = files["jax"], files["torch"]
    assert sorted(j.files) == sorted(t.files)
    assert json.loads(str(j["meta"])) == json.loads(str(t["meta"]))
    for name in j.files:
        assert j[name].dtype == t[name].dtype and j[name].tobytes() == t[name].tobytes(), name
    assert t["kf0_f_desc_bits"].dtype == np.uint32 and t["lines_desc"].dtype == np.uint32
    assert ("points_xyz" in t.files) == points and ("kf0_point_ids" in t.files) == points


def test_load_grows_a_store_only_past_its_capacity(tmp_path):
    """load_map makes a larger line store only when the file holds more rows
    than the default capacity, as the JAX load_map does."""
    p = str(tmp_path / "big.npz")
    serialize.save_map(build_map("torch", False, line_capacity=20000), p)
    small = str(tmp_path / "small.npz")
    serialize.save_map(build_map("torch", False, line_capacity=100), small)
    for load in (serialize.load_map, _package("jax")[4]):
        assert load(p).lines.capacity == 20000
        m = load(small)
        assert m.lines.capacity == 16384 and m.lines.plucker.shape == (16384, 6)
        assert m.lines._next == N_LINES and np.array_equal(m.lines.alive[:100], build_map("torch", False).lines.alive[:100])


@pytest.fixture(scope="module")
def saved_system(tmp_path_factory):
    """tests/test_system.py's run on this package: 14 frames of exact
    synthetic features through a System (mapping on, a keyframe at least
    every 4 frames), its map saved."""
    rng = np.random.default_rng(0)
    scene = make_wireframe_scene(rng, n_segments=160, n_frames=16, cam=CAM, motion_scale=0.02)
    sys_ = System(CAM, sensor="stereo", loop_closing=False, tracker_cfg=TrackerConfig(max_frames_between_kf=4), device="cpu")
    for f in range(14):
        feats, _ = synthetic_frame_features(scene, f, noise_px=0.3, rng=rng, with_depth=True, device="cpu")
        sys_.tracker.frame_idx = f
        sys_.trajectory.append(sys_.tracker._track(feats, f * 0.05))
    sys_.shutdown()
    p = str(tmp_path_factory.mktemp("map") / "map.npz")
    sys_.save_map(p)
    return scene, rng, sys_, p


def test_loaded_system_relocalizes(saved_system):
    """A fresh System loads the map (the same state, the relocalization
    database rebuilt) and a LOST tracker relocalizes frame 6 against it,
    its camera centre within 5 cm of the ground truth."""
    scene, rng, sys_, p = saved_system
    n_lines = len(sys_.map.lines.live_ids())
    assert n_lines > 20 and len(sys_.map.keyframes) >= 3
    sys2 = System(CAM, sensor="stereo", loop_closing=False, device="cpu")
    sys2.load_map(p)
    assert_same_state(map_state(sys2.map), map_state(sys_.map))
    assert sys2.tracker.map is sys2.map and sys2.mapper.map is sys2.map
    assert np.array_equal(sys2.map_lines()["ids"], sys_.map_lines()["ids"])
    assert len(sys2.kf_db) == len(sys2.map.keyframes)
    assert sys2.map.on_keyframe_erased == sys2.kf_db.remove
    sys2.tracker.state = TrackingState.LOST
    feats, _ = synthetic_frame_features(scene, 6, noise_px=0.3, rng=rng, with_depth=True, device="cpu")
    sys2.tracker.frame_idx = 100
    r = sys2.tracker._track(feats, 5.0)
    assert r.state == TrackingState.OK
    assert sys2.tracker.n_relocalizations == 1
    err = np.linalg.norm(np.linalg.inv(r.T_cw)[:3, 3] - np.linalg.inv(scene.poses[6])[:3, 3])
    assert err < 0.05, err
    sys2.shutdown()


def test_loaded_system_with_loop_closer(saved_system):
    """With loop closing on, load_map rebinds the loop closer too, and the
    JAX load_map reads the same file to the same state."""
    _, _, sys_, p = saved_system
    sys3 = System(CAM, sensor="stereo", device="cpu")
    sys3.load_map(p)
    assert sys3.loop_closer.map is sys3.map and sys3.loop_closer.db is sys3.kf_db
    assert sorted(k for k in sys3.kf_db.kids if k is not None) == sorted(sys3.map.keyframes)
    assert_same_state(map_state(_package("jax")[4](p)), map_state(sys_.map))
