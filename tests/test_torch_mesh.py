"""Config #5 split over a mesh (tpuslam_torch.parallel): batched_ba and
MultiTracker over DeviceMesh((cpu,) * k), k = 2 and 4, on the CPU.

The split cuts the sequence axis into k contiguous shards, each run in a
process of its own on its device (``parallel.shard_pool``), as the JAX
package shards the same axis over its 1-D mesh (tests/test_parallel.py
holds that on 8 virtual CPU devices). The two meshes' processes start once
in a module fixture and serve every test here; they end with the module.
Here:

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
- a shard's exception reaches the caller from its process; a mesh of one
  entry starts no process; a killed or hung shard process raises in the
  caller within the pool's timeout; after ``close()`` no shard process is
  left.
"""

import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import JaxAsOnTheCard, np_of
from tpuslam_torch import Intrinsics
from tpuslam_torch.backend.lm import BAProblem, LMConfig
from tpuslam_torch.convert import features_from, mapper_config_from
from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.parallel import multi_seq as tms
from tpuslam_torch.parallel import shard_pool as tsp
from tpuslam_torch.parallel import sharded_ba as tsba

CAM = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
CPU = torch.device("cpu")


def cpu_mesh(k: int) -> tsba.DeviceMesh:
    return tsba.DeviceMesh((CPU,) * k)


@pytest.fixture(scope="module", autouse=True)
def pools():
    """The shard processes of the 2- and 4-entry CPU meshes, started once
    and shared by this module's tests; every one ends with the module."""
    started = {k: tsp.pool_of(cpu_mesh(k)) for k in (2, 4)}
    yield started
    for k in started:
        cpu_mesh(k).close()
    assert not any(p.is_alive() for pool in started.values() for p in pool._procs)


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


def _pid(ctx) -> int:
    return os.getpid()


@pytest.mark.parametrize("k", [2, 4])
def test_batched_ba_split_matches_unsplit(ba_problems, pools, k):
    """The 8 problems in float64 over k entries, each shard solved in its
    own process, against the unsplit call, 4 LM iterations (short of
    convergence, where accept tests tie on rounding): every field of every
    problem within 1e-8 plus 1e-6 relative, on the mesh's first device and
    in sequence order."""
    probs = tsba.stack_problems([BAProblem(*(x.double() if x.is_floating_point() else x for x in p)) for p in ba_problems])
    cfg = LMConfig(max_iters=4)
    ref = tsba.batched_ba(probs, CAM, cfg)
    out = tsba.batched_ba(probs, CAM, cfg, mesh=cpu_mesh(k))
    assert tsp.pool_of(cpu_mesh(k)) is pools[k]  # the module's processes, not new ones
    pids = pools[k].run(_pid, [()] * k)
    assert pids == pools[k].pids and os.getpid() not in pids and len(set(pids)) == k
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
    """The JAX package's ``batched_track_step`` counting its calls."""

    def __init__(self, mod):
        self.mod, self.real, self.calls = mod, mod.batched_track_step, []

    def __enter__(self):
        def counting(*a, **k):
            self.calls.append(a[0].shape[0])
            return self.real(*a, **k)

        self.mod.batched_track_step = counting
        return self

    def __exit__(self, *exc):
        self.mod.batched_track_step = self.real


def port_multi_run(scenes, feats, mesh):
    """This package's MultiTracker (a LocalMapper per sequence on its
    tracker's device, asked for through ``mapper_cfg``) over the frames'
    features: (results per frame, its ``stats()`` after the last frame,
    read from the shard processes over a mesh). The shards' trackers are
    dropped from their processes before it returns."""
    from tpuslam.backend.mapping import MapperConfig as JMapperConfig

    mt = tms.MultiTracker([CAM] * N_SEQ, mesh=mesh, device="cpu", mapper_cfg=mapper_config_from(JMapperConfig()))
    res = []
    for f in range(N_FRAMES):
        batch = FrameFeatures(*(torch.stack(xs) for xs in zip(*(features_from(x) for x in feats[f]))))
        res.append(mt.track_features(batch, [f * 0.05] * N_SEQ))
    stats = mt.stats()
    mt.close()
    return res, stats


@pytest.fixture(scope="module")
def multi_runs():
    """The 4 sequences x 8 frames through this package's MultiTracker
    unsplit and over 2 and 4 CPU entries (the module's shard processes),
    and through the JAX package's
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
    runs["jax"] = (jres, counted.calls)
    return scenes, runs


@pytest.mark.parametrize("k", [2, 4])
def test_multi_tracker_split_matches_unsplit(multi_runs, pools, k):
    """Over k entries against the unsplit MultiTracker on identical
    features: one batched dispatch per shard per steady frame, each in its
    shard's process; every sequence's states and keyframes equal every frame.
    Over 2 entries (shards of 2 rows) the poses are bit-equal to the
    unsplit batch of 4; over 4 entries each shard's batched pose LM runs on
    one row, whose products the CPU's batched kernels round apart from the
    same row of 4 (up to 2.5e-6 rad and 2.0e-5 m over these 8 frames), so
    there the poses are held within 1e-5 rad and 1e-4 m."""
    from test_torch_semidirect import _pose_gap

    _, runs = multi_runs
    ref, ref_stats = runs[1]
    res, stats = runs[k]
    assert [sh["batched_dispatches"] for sh in ref_stats["shards"]] == [N_FRAMES - 1]
    assert [sh["batched_dispatches"] for sh in stats["shards"]] == [N_FRAMES - 1] * k, stats["shards"]
    assert [sh["pid"] for sh in stats["shards"]] == pools[k].pids
    assert [q["device"] for q in stats["sequences"]] == ["cpu"] * N_SEQ
    assert [q["keyframes"] for q in stats["sequences"]] == [q["keyframes"] for q in ref_stats["sequences"]]
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
    (res, stats), (jres, jcalls) = runs[4], runs["jax"]
    assert [sh["batched_dispatches"] for sh in stats["shards"]] == [N_FRAMES - 1] * 4 and len(jcalls) == N_FRAMES - 1
    assert all(r.state.name == "OK" for rs in res[1:] + jres[1:] for r in rs)
    for s in range(N_SEQ):
        ate, jate = _ate([r[s] for r in res], scenes[s]), _ate([r[s] for r in jres], scenes[s])
        assert ate <= jate * 1.05 + 0.01, (s, ate, jate)
        T = stats["sequences"][s]["T_cw"]
        d = np.linalg.norm(np.linalg.inv(T)[:3, 3] - np.linalg.inv(scenes[s].poses[N_FRAMES - 1])[:3, 3])
        assert d < 0.08, (s, d)


def _work(ctx, failing: tuple):
    """A shard request: raises in the shards ``failing``, else its index."""
    if ctx.index in failing:
        raise RuntimeError(f"shard {ctx.index} failed")
    return ctx.index


def _cannot_track(*a, **k):
    raise ValueError("sequence 2 cannot track")


def _break_sequence(mt, s: int, seq: int) -> None:
    """In shard s's process: sequence ``seq``'s tracker fails on its frame."""
    n = len(mt.trackers)
    if s * n <= seq < (s + 1) * n:
        mt.trackers[seq - s * n]._track = _cannot_track


def test_shard_exception_reaches_caller(pools):
    """A shard whose work raises in its process: the caller gets that
    exception, noting the shard, its device and the shard's traceback,
    after every shard has answered (the processes serve the next request);
    the first failing shard's is raised when several fail."""
    with pytest.raises(RuntimeError, match="shard 1 failed") as info:
        pools[4].run(_work, [((1, 3),)] * 4)
    notes = "".join(getattr(info.value, "__notes__", []))
    assert "in shard 1 of 4, on cpu" in notes and "_work" in notes and "Traceback" in notes
    assert pools[4].run(_work, [((),)] * 4) == [0, 1, 2, 3]

    # through MultiTracker: shard 1's tracker of sequence 2 fails on its frame
    scenes = _scenes()
    mt = tms.MultiTracker([CAM] * N_SEQ, mesh=cpu_mesh(2), device="cpu")
    mt.in_shards(_break_sequence, 2)
    feats = FrameFeatures(*(torch.stack(xs) for xs in zip(*(features_from(x) for x in _frame_features(scenes, 0)))))
    with pytest.raises(ValueError, match="sequence 2 cannot track") as info:
        mt.track_features(feats, [0.0] * N_SEQ)
    assert "in shard 1 of 2, on cpu" in "".join(getattr(info.value, "__notes__", []))
    mt.close()
    with pytest.raises(RuntimeError, match="live in its shard processes"):
        mt.trackers


def test_one_entry_mesh_starts_no_process(ba_problems, monkeypatch):
    """A mesh of one entry runs in the calling process, as with no mesh."""

    def no_process(*a, **k):
        raise AssertionError("a shard process was started")

    monkeypatch.setattr(tsp, "ShardPool", no_process)
    before = multiprocessing.active_children()
    one = cpu_mesh(1)
    out = tsba.batched_ba(tsba.stack_problems(ba_problems[:2]), CAM, LMConfig(max_iters=1), mesh=one)
    assert tuple(out.cost.shape) == (2,)
    mt = tms.MultiTracker([CAM] * 2, mesh=one, device="cpu")
    scenes = _scenes()[:2]
    feats = FrameFeatures(*(torch.stack(xs) for xs in zip(*(features_from(x) for x in _frame_features(scenes, 0)))))
    assert len(mt.track_features(feats, [0.0, 0.0])) == 2
    assert mt.stats()["shards"][0]["pid"] == os.getpid()
    assert multiprocessing.active_children() == before


def _sleep(ctx, seconds: float) -> None:
    time.sleep(seconds)


@pytest.mark.parametrize("how", ["killed", "hung"])
def test_dead_or_hung_shard_raises(how):
    """A shard process killed during a request, or one that does not answer
    within the pool's timeout (here 8 s): the caller gets ShardFailed,
    naming the shard and its device, well before the request would have
    ended, and the pool ends its other process and refuses further
    requests."""
    pool = tsp.ShardPool((CPU, CPU), timeout=8.0)
    try:
        if how == "killed":
            threading.Timer(1.0, os.kill, (pool.pids[1], signal.SIGKILL)).start()
        t0 = time.monotonic()
        with pytest.raises(tsp.ShardFailed, match="shard 1" if how == "killed" else "shard 0") as info:
            pool.run(_sleep, [(0.0 if how == "killed" else 60.0,), (60.0,)])
        assert time.monotonic() - t0 < 20.0
        assert ("exited" if how == "killed" else "no answer") in str(info.value) and "on cpu" in str(info.value)
        assert pool.closed and not any(p.is_alive() for p in pool._procs)
        with pytest.raises(tsp.ShardFailed, match="closed"):
            pool.run(_sleep, [(0.0,), (0.0,)])
    finally:
        pool.close()


def test_close_leaves_no_process():
    """``DeviceMesh.close()`` ends the mesh's shard processes: none is left
    alive or unreaped, and the mesh's next use starts new ones."""
    mesh = tsba.DeviceMesh((CPU, CPU), axis="close")
    pool = tsp.pool_of(mesh)
    pids = pool.pids
    assert pool.run(_work, [((),)] * 2) == [0, 1]
    mesh.close()
    assert pool.closed and not any(p.is_alive() for p in pool._procs)
    assert not {p.pid for p in multiprocessing.active_children()} & set(pids)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
