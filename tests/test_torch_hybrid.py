"""Hybrid points on the bench path: one hybrid semi-direct chunk of
tpuslam_torch against tpuslam's `_fused_chunk_semidirect_hybrid`, component
by component, and whole System runs of the hybrid bench configuration
(`bench_configs(points=True)`) on VGA dot frames halved on the host.

Run as a script, it prints the JAX package's ATE for the hybrid bench
configuration on chip_smoke.py's 40 VGA dot frames (the constant
``JAX_HYBRID_BENCH_ATE_M`` there):

    python tests/test_torch_hybrid.py
"""

import functools
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from test_torch_semidirect import ANCHOR_TOL_M, ANCHOR_TOL_RAD, VGA, _ate, _pose_gap, jax_bench_config
from torch_parity import JaxAsOnTheCard, dot_scene, np_of, python_graph
from tpuslam_torch.convert import chunk_inputs_from, point_local_from, tracker_config_from
from tpuslam_torch.frontend import pipeline as tpipe
from tpuslam_torch.frontend.frame import FrontendParams, host_prescale
from tpuslam_torch.frontend.tracking import TrackingState
from tpuslam_torch.system import System, bench_configs

C = 6  # the bench's chunk: the chunk case and the System runs share one JAX compile
HALF = FrontendParams(base_scale=0.5, prescaled=True)


def jax_hybrid_bench_config(chunk: int = C):
    """The JAX package's hybrid bench configuration (``tpuslam/bench.py``
    with TPUSLAM_BENCH_POINTS=1, fusion applied at the keyframe)."""
    from tpuslam.frontend.points import PointFrontendParams

    tcfg, mcfg = jax_bench_config(chunk)
    tcfg.points = PointFrontendParams()
    return tcfg, mcfg


def bench_dot_scene(n_frames: int, seed: int = 0):
    """chip_smoke.py's scene (140 segments, motion 0.02, VGA) with its 200
    points drawn as dots."""
    return dot_scene(n_frames, VGA, seed=seed, n_segments=140, n_points=200, motion_scale=0.02)


def run_jax(frames, tcfg, mcfg):
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.system import System as JSystem

    with JaxAsOnTheCard():
        js = JSystem(JIntrinsics(*VGA), sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg)
        for f, (il, ir) in enumerate(frames):
            js.track_stereo(il, ir, f * 0.05)
        js.shutdown()
    return js, sorted(js.trajectory, key=lambda r: r.frame_idx)


# ---- one hybrid chunk ------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_case():
    """The JAX tracker initialized on frame 0, its local line and point maps
    and pose chain, the stack of the next C frames halved on the host, and
    the JAX package's hybrid chunk program on them."""
    import jax.numpy as jnp

    from tpuslam.frontend import pipeline as jpipe
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.slammap.map import SlamMap as JSlamMap

    _, frames = bench_dot_scene(C + 1)
    half = [tuple(host_prescale(x, HALF) for x in pair) for pair in frames]
    jcfg, _ = jax_hybrid_bench_config()
    with JaxAsOnTheCard():
        jt = JTracker(JIntrinsics(*VGA), JSlamMap(), jcfg)
        jt.track_stereo(*frames[0], 0.0)
        assert jt.state.name == "OK"
        local = {k: np.asarray(v) for k, v in jt._local_map_arrays().items()}
        plocal = {k: np.asarray(v) for k, v in jt._point_local_arrays().items()}
    T_last = np.asarray(jt.T_cw, np.float32)
    T_prev = (np.linalg.inv(jt.velocity).astype(np.float32) @ T_last).astype(np.float32)
    stack = np.stack([half[1][0], half[1][1]] + [p[0] for p in half[2:]])
    ref = jpipe.fused_stereo_semidirect_hybrid(
        jnp.asarray(stack), jnp.asarray(T_last), jnp.asarray(T_prev), {k: jnp.asarray(v) for k, v in local.items()},
        {k: jnp.asarray(v) for k, v in plocal.items()}, float(VGA.fx * VGA.baseline), JIntrinsics(*VGA), jcfg.frontend,
        jcfg.search_coarse, jcfg.search_fine, jcfg.pose_opt, jcfg.min_track_inliers, jt._direct_lines(), jt._direct_points(),
        jcfg.points, jt._align_params(),
    )
    return dict(stack=stack, T_last=T_last, T_prev=T_prev, local=local, plocal=plocal, jcfg=jcfg, ref=ref)


@pytest.fixture(scope="module")
def port_chunk(chunk_case):
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    case = chunk_case
    frames, T_last, T_prev, local = chunk_inputs_from(case["stack"], case["T_last"], case["T_prev"], case["local"])
    with python_graph():
        tr = Tracker(VGA, SlamMap(), tracker_config_from(case["jcfg"]), device="cpu")
    c = tr.cfg
    return tpipe.fused_stereo_semidirect_hybrid(
        frames, T_last, T_prev, local, point_local_from(case["plocal"]), tr._fxb, VGA, c.frontend, c.search_coarse,
        c.search_fine, c.pose_opt, c.min_track_inliers, tr._direct_lines(), tr._direct_points(), c.points, tr._align_params(),
    )


def test_chunk_rows_match_jax(chunk_case, port_chunk):
    """The same accept flags; the anchor's pose within 1e-4 rad and 3e-4 m,
    the followers' within 1e-3; the counts of lines and points together
    close; the chain's end equal to the last row."""
    ref = chunk_case["ref"]
    packed, packed_ref = np_of(port_chunk.packed), np.asarray(ref.packed)
    assert packed.shape == packed_ref.shape == (C, 20)
    np.testing.assert_array_equal(packed[:, 19], packed_ref[:, 19])
    assert np.all(packed[:, 19] == 1.0)
    for i in range(C):
        ang, dc = _pose_gap(packed[i, :16].reshape(4, 4), packed_ref[i, :16].reshape(4, 4))
        tol_rad, tol_m = (ANCHOR_TOL_RAD, ANCHOR_TOL_M) if i == 0 else (1e-3, 1e-3)
        assert ang <= tol_rad and dc <= tol_m, (i, ang, dc)
    np.testing.assert_array_equal(np_of(port_chunk.T_last), packed[-1, :16].reshape(4, 4))
    assert np.all(np.abs(packed[0, 16:19] - packed_ref[0, 16:19]) <= 0.05 * packed_ref[0, 16:19] + 2)
    assert np.all(np.abs(packed[1:, 17] - packed_ref[1:, 17]) <= 4)
    assert np.all(packed_ref[1:, 17] > packed_ref[1:, 16] / 20)  # followers count aligned points as units


def test_chunk_anchor_corners_match_jax(chunk_case, port_chunk):
    """The anchor's corners as sets (uv within 1e-3 full-resolution px, BRIEF
    words exact) and their direct-stereo depths (the same gates,
    disparities within 1e-3 px)."""
    ref, got = chunk_case["ref"].pfeats, port_chunk.pfeats
    v, rv = np_of(got.valid) > 0.5, np.asarray(ref.valid) > 0.5
    assert v.sum() == rv.sum() >= 100
    uv, ruv = np_of(got.uv), np.asarray(ref.uv)
    d = np.linalg.norm(uv[v][:, None] - ruv[rv][None], axis=-1)
    j = np.argmin(d, axis=1)
    assert np.all(d[np.arange(len(j)), j] <= 1e-3)
    np.testing.assert_array_equal(np_of(got.desc_bits)[v].astype(np.uint32), np.asarray(ref.desc_bits)[rv][j])
    hd, rhd = np_of(got.has_depth)[v], np.asarray(ref.has_depth)[rv][j]
    np.testing.assert_array_equal(hd, rhd)
    assert hd.sum() >= 60
    fxb = np.float32(VGA.fx * VGA.baseline)
    ok = hd > 0.5
    np.testing.assert_allclose(fxb / np_of(got.depth)[v][ok], fxb / np.asarray(ref.depth)[rv][j][ok], atol=1e-3)


def test_chunk_anchor_matches_match_jax(chunk_case, port_chunk):
    """The anchor's matches: each point landmark matched to the same corner
    (by position, the slot order following the scores) and the same line
    slots, 98% or more; the inlier masks likewise."""
    ref = chunk_case["ref"]
    pidx, ridx = np_of(port_chunk.p_match_idx), np.asarray(ref.p_match_idx)
    assert (ridx >= 0).sum() >= 50
    uv, ruv = np_of(port_chunk.pfeats.uv), np.asarray(ref.pfeats.uv)
    same = (pidx >= 0) == (ridx >= 0)
    both = (pidx >= 0) & (ridx >= 0)
    same[both] = np.linalg.norm(uv[pidx[both]] - ruv[ridx[both]], axis=-1) <= 1e-3
    assert same.mean() >= 0.98
    assert np.mean(np_of(port_chunk.p_inlier) == np.asarray(ref.p_inlier)) >= 0.98
    assert np.mean(np_of(port_chunk.match_idx) == np.asarray(ref.match_idx)) >= 0.98
    assert np.mean(np_of(port_chunk.inlier) == np.asarray(ref.inlier)) >= 0.98


# ---- whole System runs -------------------------------------------------------

N_FRAMES = 13  # the initialization, then two chunks of 6 (the second resolved by the final flush)
# The scene seeds of the runs. On seed 0 the packages' frame-0 maps differ by
# float rounding only (1e-5 m), yet the fourth follower of the first chunk
# (frame 5) lands 1.6 cm apart: a point template there fits a neighbouring
# dot of the same pattern about as well as its own, and the next keyframe's
# two-view BA carries the gap on (6 cm at frame 7). Given the same inputs
# that follower agrees to 1e-6 (test_chunk_rows_match_jax is seed 0). So
# both seeds are held to the ATE bound, seed 1 to the per-frame bound on
# every frame, seed 0 on the frames before that follower.
SEEDS = (0, 1)
PER_FRAME_UNTIL = {0: 5, 1: N_FRAMES}


@functools.lru_cache(maxsize=None)
def _bench_runs(seed: int):
    scene, frames = bench_dot_scene(N_FRAMES, seed=seed)
    js, jax_traj = run_jax(frames, *jax_hybrid_bench_config())
    tcfg, mcfg = bench_configs(points=True)
    with python_graph():
        ts = System(VGA, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cpu")
    for f, (il, ir) in enumerate(frames):
        ts.track_stereo(il, ir, f * 0.05)
    ts.shutdown()
    return scene, js, jax_traj, ts


@pytest.fixture(scope="module", params=SEEDS)
def bench_runs(request):
    return (request.param, *_bench_runs(request.param))


def test_bench_system_tracks_every_frame(bench_runs):
    """One trajectory entry per frame, in order, all OK; anchors every C
    frames after the initialization; keyframes from anchors only."""
    _, _, _, _, ts = bench_runs
    assert [r.frame_idx for r in ts.trajectory] == list(range(N_FRAMES))
    assert all(r.state == TrackingState.OK for r in ts.trajectory)
    assert ts.tracker.anchor_frames == list(range(1, N_FRAMES, C)) and ts.tracker.sync_frames == [0]
    kfs = [r.frame_idx for r in ts.trajectory if r.made_keyframe]
    assert kfs[0] == 0 and set(kfs) <= {0} | set(ts.tracker.anchor_frames)


def test_bench_system_poses_and_ate_within_jax(bench_runs):
    """ATE within the JAX ATE + 0.01 m; every frame's camera within 5 cm of
    the JAX package's, up to the chaotic follower on seed 0."""
    seed, scene, _, jax_traj, ts = bench_runs
    for r, rj in zip(ts.trajectory[: PER_FRAME_UNTIL[seed]], jax_traj):
        assert _pose_gap(r.T_cw, rj.T_cw)[1] <= 0.05, r.frame_idx
    assert _ate(ts.trajectory, scene) <= _ate(jax_traj, scene) + 0.01


def test_bench_system_builds_point_landmarks(bench_runs):
    """Live point landmarks, some of them seen from two keyframes or more;
    the keyframes hold corners; counts near the JAX package's."""
    _, _, js, _, ts = bench_runs
    pts, jpts = ts.map_points(), js.map_points()
    assert len(pts["ids"]) >= 100 and (pts["n_obs"] >= 2).sum() >= 50
    assert all(kf.point_features is not None for kf in ts.map.keyframes.values())
    assert abs(len(pts["ids"]) - len(jpts["ids"])) <= 0.1 * len(jpts["ids"]) + 10


def test_hybrid_tracker_config_converts():
    """The JAX hybrid bench TrackerConfig carries into bench_configs(points=True)."""
    jcfg, _ = jax_hybrid_bench_config()
    assert tracker_config_from(jcfg) == bench_configs(points=True)[0]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import make_frames

    cam, scene, frames = make_frames(draw_points=True)
    _, traj = run_jax(frames, *jax_hybrid_bench_config())
    assert [r.frame_idx for r in traj] == list(range(len(frames)))
    print(f"JAX hybrid bench run: keyframes at frames {[r.frame_idx for r in traj if r.made_keyframe]}", flush=True)
    print(f"JAX_HYBRID_BENCH_ATE_M = {_ate(traj, scene)!r}", flush=True)
