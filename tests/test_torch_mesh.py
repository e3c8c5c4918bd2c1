"""Config #5 split over a mesh (tpuslam_torch.parallel): batched_ba and
MultiTracker over DeviceMesh((cpu,) * k), k = 2 and 4, on the CPU.

The split cuts the sequence axis into k contiguous shards, each driven by a
host thread of its own on its device, as the JAX package shards the same
axis over its 1-D mesh (tests/test_parallel.py holds that on 8 virtual CPU
devices). Here:

- ``batched_ba`` split against unsplit, float64 (each problem within 1e-8
  plus 1e-6 relative), and against the JAX package's 8-device mesh in
  float32 (both converge: median cost below 1e-2, poses within 0.15,
  tests/test_parallel.py's bounds);
- a batch the mesh size does not divide raises ValueError;
- ``MultiTracker`` with a mapper per sequence over 4 sequences x 8 frames
  of tests/test_parallel.py's synthetic features: split against unsplit
  (the same keyframes; bit-equal poses over 2 entries, within 1e-5 rad and
  1e-4 m over 4), and over 4 entries against the JAX
  MultiTracker over ``make_mesh(4)`` (each sequence's ATE within the JAX
  value x 1.05 + 0.01 m; one batched dispatch per shard per steady frame);
- a shard's exception reaches the caller; a mesh of one entry starts no
  thread.
"""

import threading

import numpy as np
import pytest
import torch

from torch_parity import JaxAsOnTheCard, np_of
from tpuslam_torch import Intrinsics
from tpuslam_torch.backend.lm import BAProblem, LMConfig
from tpuslam_torch.convert import features_from, mapper_config_from
from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.parallel import multi_seq as tms
from tpuslam_torch.parallel import sharded_ba as tsba

CAM = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
CPU = torch.device("cpu")


def cpu_mesh(k: int) -> tsba.DeviceMesh:
    return tsba.DeviceMesh((CPU,) * k)


def _jax_cam(c):
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    return JIntrinsics(*c)


# ---- batched BA ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ba_problems():
    """tests/test_parallel.py's 8 toy problems (rng seed 0, 3 poses, 8
    lines, 32 observations), built by this package's ``_toy_problem``."""
    rng = np.random.default_rng(0)
    return [tsba._toy_problem(rng, 3, 8, 32, CAM, device="cpu") for _ in range(8)]


@pytest.mark.parametrize("k", [2, 4])
def test_batched_ba_split_matches_unsplit(ba_problems, k):
    """The 8 problems in float64 over k entries against the unsplit call, 4
    LM iterations (short of convergence, where accept tests tie on
    rounding): every field of every problem within 1e-8 plus 1e-6 relative,
    on the mesh's first device and in sequence order."""
    probs = tsba.stack_problems([BAProblem(*(x.double() if x.is_floating_point() else x for x in p)) for p in ba_problems])
    cfg = LMConfig(max_iters=4)
    ref = tsba.batched_ba(probs, CAM, cfg)
    out = tsba.batched_ba(probs, CAM, cfg, mesh=cpu_mesh(k))
    for name, a, b in zip(ref._fields, out, ref):
        assert a.shape == b.shape and a.device == CPU, name
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-6, atol=1e-8, err_msg=name)


@pytest.fixture(scope="module")
def jax_mesh_ba(ba_problems):
    """The JAX package's batched_ba of the same 8 problems over its 8
    virtual CPU devices (tests/conftest.py), 15 iterations."""
    import jax
    import jax.numpy as jnp

    from tpuslam.backend.lm import BAProblem as JBAProblem
    from tpuslam.backend.lm import LMConfig as JLMConfig
    from tpuslam.parallel.sharded_ba import batched_ba as jbatched
    from tpuslam.parallel.sharded_ba import make_mesh as jmake_mesh

    assert len(jax.devices()) == 8
    jprobs = [JBAProblem(*(jnp.asarray(np_of(x)) for x in p)) for p in ba_problems]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *jprobs)
    return jbatched(batch, _jax_cam(CAM), JLMConfig(max_iters=15), mesh=jmake_mesh(8))


@pytest.mark.parametrize("k", [2, 4])
def test_batched_ba_split_matches_jax_mesh(ba_problems, jax_mesh_ba, k):
    """float32, 15 iterations, over k entries against the JAX package's
    8-device mesh, held as tests/test_parallel.py holds its mesh against its
    single device: finite costs, both converge (median cost below 1e-2),
    poses within 0.15 (line-only BA leaves weakly constrained directions on
    a near-zero-cost manifold). The float32 costs of one slow problem (the
    sixth) are rounding chaos: 1.9 unsplit and over 2 entries, 0.05 over 4,
    9e-8 in the JAX package's mesh and 5e-6 on its single device."""
    out = tsba.batched_ba(tsba.stack_problems(ba_problems), CAM, LMConfig(max_iters=15), mesh=cpu_mesh(k))
    cost, cost_ref = np_of(out.cost), np.asarray(jax_mesh_ba.cost)
    assert np.all(np.isfinite(cost))
    assert np.median(cost) < 1e-2 and np.median(cost_ref) < 1e-2
    np.testing.assert_allclose(np_of(out.poses), np.asarray(jax_mesh_ba.poses), atol=0.15)


def test_split_needs_a_dividing_mesh(ba_problems):
    """A batch of 3 over 2 entries, or 3 sequences over 2, raises ValueError
    (as the JAX package's NamedSharding refuses it)."""
    with pytest.raises(ValueError, match="does not split"):
        tsba.batched_ba(tsba.stack_problems(ba_problems[:3]), CAM, LMConfig(max_iters=1), mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="does not split"):
        tms.MultiTracker([CAM] * 3, mesh=cpu_mesh(2))
    assert tsba.shard_slices(8, cpu_mesh(4)) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]


# ---- MultiTracker ----------------------------------------------------------------

N_SEQ, N_FRAMES = 4, 8


def _scenes():
    """tests/test_parallel.py's 4 sequences (seeds 100 + s)."""
    from tpuslam.io.synthetic import make_wireframe_scene

    return [
        make_wireframe_scene(
            np.random.default_rng(100 + s), n_segments=120, n_frames=N_FRAMES, cam=_jax_cam(CAM), motion_scale=0.02
        )
        for s in range(N_SEQ)
    ]


def _frame_features(scenes, f):
    """Frame f's synthetic features of every sequence (JAX FrameFeatures,
    numpy leaves), tests/test_parallel.py's noise and draws."""
    from tpuslam.io.synthetic import synthetic_frame_features

    return [
        synthetic_frame_features(sc, f, noise_px=0.3, rng=np.random.default_rng(f * 31 + s), with_depth=True)[0]
        for s, sc in enumerate(scenes)
    ]


class _Counted:
    """``module.batched_track_step`` counting its calls (from any thread)."""

    def __init__(self, mod):
        self.mod, self.real, self.calls = mod, mod.batched_track_step, []

    def __enter__(self):
        def counting(*a, **k):
            self.calls.append(threading.current_thread().name)
            return self.real(*a, **k)

        self.mod.batched_track_step = counting
        return self

    def __exit__(self, *exc):
        self.mod.batched_track_step = self.real


def port_multi_run(scenes, feats, mesh):
    """This package's MultiTracker (a LocalMapper per sequence on its
    tracker's device) over the frames' features: (results per frame, the
    threads that made the batched dispatches, the tracker)."""
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig
    from tpuslam_torch.backend.mapping import LocalMapper

    mt = tms.MultiTracker([CAM] * N_SEQ, mesh=mesh, device="cpu")
    for tr in mt.trackers:
        m = LocalMapper(tr.map, CAM, mapper_config_from(JMapperConfig()), device=tr.device)
        tr.on_new_keyframe, m.on_map_changed = m.process, tr.invalidate_local_map
    res = []
    with _Counted(tms) as counted:
        for f in range(N_FRAMES):
            batch = FrameFeatures(*(torch.stack(xs) for xs in zip(*(features_from(x) for x in feats[f]))))
            res.append(mt.track_features(batch, [f * 0.05] * N_SEQ))
    return res, counted.calls, mt


@pytest.fixture(scope="module")
def multi_runs():
    """The 4 sequences x 8 frames through this package's MultiTracker
    unsplit and over 2 and 4 CPU entries, and through the JAX package's
    over ``make_mesh(4)`` (mappers on, its native mirror off, as the port's
    CPU parity runs take it)."""
    import jax
    import jax.numpy as jnp

    from tpuslam.backend.mapping import LocalMapper as JLocalMapper
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig
    from tpuslam.parallel import multi_seq as jms
    from tpuslam.parallel.sharded_ba import make_mesh as jmake_mesh

    scenes = _scenes()
    feats = [_frame_features(scenes, f) for f in range(N_FRAMES)]
    runs = {k: port_multi_run(scenes, feats, None if k == 1 else cpu_mesh(k)) for k in (1, 2, 4)}
    with JaxAsOnTheCard():
        jm = jms.MultiTracker([_jax_cam(CAM)] * N_SEQ, mesh=jmake_mesh(4))
        for tr in jm.trackers:
            m = JLocalMapper(tr.map, _jax_cam(CAM), JMapperConfig())
            tr.on_new_keyframe, m.on_map_changed = m.process, tr.invalidate_local_map
        jres = []
        with _Counted(jms) as counted:
            for f in range(N_FRAMES):
                jres.append(jm.track_features(jax.tree.map(lambda *xs: jnp.stack(xs), *feats[f]), [f * 0.05] * N_SEQ))
        for tr in jm.trackers:
            tr.close()
    runs["jax"] = (jres, counted.calls, jm)
    return scenes, runs


@pytest.mark.parametrize("k", [2, 4])
def test_multi_tracker_split_matches_unsplit(multi_runs, k):
    """Over k entries against the unsplit MultiTracker on identical
    features: one batched dispatch per shard per steady frame, each from its
    shard's thread; every sequence's states and keyframes equal every frame.
    Over 2 entries (shards of 2 rows) the poses are bit-equal to the
    unsplit batch of 4; over 4 entries each shard's batched pose LM runs on
    one row, whose products the CPU's batched kernels round apart from the
    same row of 4 (up to 2.5e-6 rad and 2.0e-5 m over these 8 frames), so
    there the poses are held within 1e-5 rad and 1e-4 m."""
    from test_torch_semidirect import _pose_gap

    _, runs = multi_runs
    ref, _, _ = runs[1]
    res, calls, mt = runs[k]
    assert len(calls) == k * (N_FRAMES - 1), calls
    assert sorted(set(calls)) == [f"shard-{s}" for s in range(k)]
    assert [tr.device for tr in mt.trackers] == [CPU] * N_SEQ
    for f, (a, b) in enumerate(zip(res, ref)):
        for s in range(N_SEQ):
            assert (a[s].state, a[s].made_keyframe) == (b[s].state, b[s].made_keyframe), (f, s)
            if k == 2:
                np.testing.assert_array_equal(a[s].T_cw, b[s].T_cw, err_msg=f"frame {f}, sequence {s}")
            else:
                ang, dist = _pose_gap(a[s].T_cw, b[s].T_cw)
                assert ang <= 1e-5 and dist <= 1e-4, (f, s, ang, dist)


def test_multi_tracker_split_matches_jax_mesh(multi_runs):
    """Over 4 entries against the JAX MultiTracker over its 4-device mesh,
    a mapper per sequence each: every later frame OK in both, one dispatch
    per shard per steady frame (the JAX package's one sharded program per
    frame), each sequence's ATE within the JAX value x 1.05 + 0.01 m and
    within tests/test_parallel.py's 0.08 m of the last ground-truth pose."""
    from test_torch_semidirect import _ate

    scenes, runs = multi_runs
    (res, calls, mt), (jres, jcalls, _) = runs[4], runs["jax"]
    assert len(calls) == 4 * (N_FRAMES - 1) and len(jcalls) == N_FRAMES - 1
    assert all(r.state.name == "OK" for rs in res[1:] + jres[1:] for r in rs)
    for s in range(N_SEQ):
        ate, jate = _ate([r[s] for r in res], scenes[s]), _ate([r[s] for r in jres], scenes[s])
        assert ate <= jate * 1.05 + 0.01, (s, ate, jate)
        d = np.linalg.norm(np.linalg.inv(mt.trackers[s].T_cw)[:3, 3] - np.linalg.inv(scenes[s].poses[N_FRAMES - 1])[:3, 3])
        assert d < 0.08, (s, d)


def test_shard_exception_reaches_caller():
    """A shard whose work raises: the caller gets that exception, noting
    the shard, after every shard's thread has ended; the first failing
    shard's is raised when several fail."""
    done = []

    def work(s, dev):
        if s in (1, 3):
            raise RuntimeError(f"shard {s} failed")
        done.append(s)
        return s

    with pytest.raises(RuntimeError, match="shard 1 failed") as info:
        tsba.run_sharded(cpu_mesh(4), work)
    assert "in shard 1 of 4" in "".join(getattr(info.value, "__notes__", []))
    assert sorted(done) == [0, 2] and not [t for t in threading.enumerate() if t.name.startswith("shard-")]

    # through MultiTracker: shard 1's tracker fails on its frame
    scenes = _scenes()
    mt = tms.MultiTracker([CAM] * N_SEQ, mesh=cpu_mesh(2), device="cpu")

    def broken(*a, **k):
        raise ValueError("sequence 2 cannot track")

    mt.trackers[2]._track = broken
    feats = FrameFeatures(*(torch.stack(xs) for xs in zip(*(features_from(x) for x in _frame_features(scenes, 0)))))
    with pytest.raises(ValueError, match="sequence 2 cannot track"):
        mt.track_features(feats, [0.0] * N_SEQ)


def test_one_entry_mesh_starts_no_thread(ba_problems, monkeypatch):
    """A mesh of one entry runs on the calling thread, as with no mesh."""

    def no_thread(*a, **k):
        raise AssertionError("a thread was started")

    monkeypatch.setattr(tsba.threading, "Thread", no_thread)
    one = cpu_mesh(1)
    out = tsba.batched_ba(tsba.stack_problems(ba_problems[:2]), CAM, LMConfig(max_iters=1), mesh=one)
    assert tuple(out.cost.shape) == (2,)
    mt = tms.MultiTracker([CAM] * 2, mesh=one, device="cpu")
    scenes = _scenes()[:2]
    feats = FrameFeatures(*(torch.stack(xs) for xs in zip(*(features_from(x) for x in _frame_features(scenes, 0)))))
    assert len(mt.track_features(feats, [0.0, 0.0])) == 2
