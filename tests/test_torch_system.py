"""The whole slice: tpuslam_torch's System against tpuslam's on the same
rendered stereo frames, plus the port's numpy helpers."""

import numpy as np
import pytest

from torch_parity import QVGA, stereo_scene
from tpuslam.eval.ate import absolute_trajectory_error as j_ate
from tpuslam.frontend.frame import FrontendParams as JFrontendParams
from tpuslam.frontend.tracking import TrackerConfig as JTrackerConfig
from tpuslam.geometry.camera import Intrinsics as JIntrinsics
from tpuslam.io import synthetic as jsyn
from tpuslam.io.trajectory import save_trajectory_tum as j_save_tum
from tpuslam.kernels.lsd import LSDParams as JLSDParams
from tpuslam.system import System as JSystem
from tpuslam_torch.eval.ate import absolute_trajectory_error
from tpuslam_torch.frontend.frame import FrontendParams
from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState
from tpuslam_torch.io import synthetic as tsyn
from tpuslam_torch.kernels.lsd import LSDParams
from tpuslam_torch.system import System

N_FRAMES = 8


def _centers(trajectory):
    return np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in trajectory])


@pytest.fixture(scope="module")
def runs():
    """Both Systems over the same 8 rendered QVGA stereo frames (128 lines,
    32 propagation rounds)."""
    scene, frames = stereo_scene(N_FRAMES)
    js = JSystem(
        JIntrinsics(*QVGA), sensor="stereo", mapping=False, loop_closing=False,
        tracker_cfg=JTrackerConfig(frontend=JFrontendParams(max_lines=128, lsd=JLSDParams(ccl_rounds=32))),
    )
    ts = System(
        QVGA, sensor="stereo", mapping=False, loop_closing=False,
        tracker_cfg=TrackerConfig(frontend=FrontendParams(max_lines=128, lsd=LSDParams(ccl_rounds=32))),
        device="cpu",
    )
    for f, (il, ir) in enumerate(frames):
        js.track_stereo(il, ir, 0.05 * f)
        ts.track_stereo(il, ir, 0.05 * f)
    js.shutdown()
    ts.shutdown()
    return scene, js, ts


def test_slice_tracks_like_jax(runs):
    """Same states every frame, keyframe count within one, camera centres
    within 5 cm of the JAX package's and ATE within 1 cm of it. The segment
    sets of the two detectors differ slightly (float rounding against the
    support threshold), which moves each pose estimate by up to a few cm on
    these QVGA frames."""
    scene, js, ts = runs
    assert [r.state.name for r in ts.trajectory] == [r.state.name for r in js.trajectory]
    assert all(r.state == TrackingState.OK for r in ts.trajectory)
    assert abs(len(ts.map.keyframes) - len(js.map.keyframes)) <= 1
    assert len(ts.map.keyframes) >= 2
    d = np.linalg.norm(_centers(ts.trajectory) - _centers(js.trajectory), axis=1)
    assert d.max() < 0.05, d
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in scene.poses])
    ate_t = absolute_trajectory_error(_centers(ts.trajectory), gt).rmse
    ate_j = j_ate(_centers(js.trajectory), gt).rmse
    assert ate_t < ate_j + 0.01, (ate_t, ate_j)
    matches = [r.n_matches for r in ts.trajectory[1:]]
    assert min(matches) > 30
    assert np.all(np.abs(np.array(matches) - [r.n_matches for r in js.trajectory[1:]]) <= 0.5 * np.array(matches))


def test_map_and_trajectory_outputs(runs, tmp_path):
    _, js, ts = runs
    lines = ts.map_lines()
    assert lines["plucker"].shape[1] == 6 and len(lines["ids"]) > 20
    assert abs(len(lines["ids"]) - len(js.map_lines()["ids"])) <= 0.2 * len(lines["ids"])
    kfs, edges = ts.keyframe_graph()
    assert len(kfs) >= 2 and all(w > 0 for _, _, w in edges)
    ts.save_trajectory_tum(str(tmp_path / "t.txt"))
    ts.save_trajectory_kitti(str(tmp_path / "k.txt"))
    j_save_tum(str(tmp_path / "ref.txt"), [r.timestamp for r in ts.trajectory], [r.T_cw for r in ts.trajectory])
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert len((tmp_path / "k.txt").read_text().splitlines()) == N_FRAMES


def test_unported_configurations_raise():
    s = System(QVGA, sensor="stereo", loop_closing=False, device="cpu")  # mapping=True is ported
    assert s.mapper is not None and s.tracker.kf_db is s.kf_db
    s = System(QVGA, sensor="stereo", device="cpu")  # loop_closing=True is ported: the defaults build
    assert s.loop_closer is not None and s.loop_closer.db is s.kf_db and not s.loop_closer.mono
    s = System(QVGA, sensor="mono", device="cpu")  # mono is ported: its defaults build, the closer on its Sim(3) branch
    assert s.mapper is not None and s.mapper.mono and s.loop_closer is not None and s.loop_closer.mono
    with pytest.raises(NotImplementedError, match="base_scale"):  # the in-program resize; prescaled=True is ported
        s = System(
            QVGA, mapping=False, loop_closing=False,
            tracker_cfg=TrackerConfig(frontend=FrontendParams(base_scale=0.5, prescaled=False)),
            device="cpu",
        )
        s.track_stereo(np.zeros((240, 320), np.uint8), np.zeros((240, 320), np.uint8), 0.0)


def _entry_points():
    from tpuslam_torch.backend import local_ba
    from tpuslam_torch.backend.loop_closing import KeyFrameDatabase
    from tpuslam_torch.backend.mapping import LocalMapper
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    return {
        "System": lambda **kw: System(QVGA, sensor="stereo", loop_closing=False, **kw),
        "mono System": lambda **kw: System(QVGA, sensor="mono", **kw),
        "Tracker": lambda **kw: Tracker(QVGA, SlamMap(), **kw),
        "LocalMapper": lambda **kw: LocalMapper(SlamMap(), QVGA, **kw),
        "mono LocalMapper": lambda **kw: LocalMapper(SlamMap(), QVGA, mono=True, **kw),
        "KeyFrameDatabase": lambda **kw: KeyFrameDatabase(**kw),
        "build_problem": lambda **kw: local_ba.build_problem(SlamMap(), [0], [], [], (8, 8, 8), **kw),
        "assemble_problem": lambda **kw: local_ba.assemble_problem(SlamMap(), 0, QVGA, **kw),
        "local_bundle_adjustment": lambda **kw: local_ba.local_bundle_adjustment(SlamMap(), 0, QVGA, **kw),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without device=..., each entry point asks for the card; without one it
    raises instead of running on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make()
    if name in ("System", "mono System", "Tracker", "LocalMapper", "mono LocalMapper", "KeyFrameDatabase"):  # objects: build on the CPU when asked
        obj = make(device="cpu")
        assert getattr(obj, "tracker", obj).device.type == "cpu"


def test_scene_generator_matches_jax():
    a = tsyn.make_wireframe_scene(np.random.default_rng(5), n_segments=30, n_frames=6, cam=QVGA)
    b = jsyn.make_wireframe_scene(np.random.default_rng(5), n_segments=30, n_frames=6, cam=JIntrinsics(*QVGA))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)


def test_renderer_draws_antialiased_lines():
    scene = tsyn.make_wireframe_scene(np.random.default_rng(0), n_segments=40, n_frames=2, cam=QVGA)
    img = tsyn.render_wireframe_image(scene, 1, noise=0.0)
    again = tsyn.render_wireframe_image(scene, 1, noise=0.0)
    assert img.dtype == np.uint8 and img.shape == (240, 320)
    np.testing.assert_array_equal(img, again)
    obs = tsyn.observe_frame(scene, 1)
    s = np.nonzero(obs.seg_visible)[0][0]
    mid = np.round(obs.seg_uv[s].mean(axis=0)).astype(int)
    assert img[mid[1], mid[0]] < 100  # on the line: near fg = 40
    values = np.unique(img)
    assert 200 in values and len(values) > 10  # background plus anti-aliased shades
    noisy = tsyn.render_wireframe_image(scene, 1, noise=2.0, rng=np.random.default_rng(0))
    assert 0 < np.abs(noisy.astype(int) - img).mean() < 3
