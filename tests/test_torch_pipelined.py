"""The fused pipelined tracker forms of tpuslam_torch against tpuslam's.

- The programs on identical inputs (the bench scene at VGA halved on the
  host, as chip_smoke.py's phases run them; the JAX tracker initialized on
  frame 0 gives the local map and the pose chain): the single-frame program
  with direct and with descriptor stereo, the single-frame hybrid program
  and the full-detection chunk of 6. The same accept flags and counts
  (matched, inliers, depths), poses within 1e-4 rad and 3e-4 m (PR 5's
  anchor tolerances), 98% of the matches the same.
- The Tracker (no mapper) over 12 QVGA frames of the bench scene (the
  hybrid run over tests/test_hybrid.py's dot scene) in each form: the same
  frames out, in order; the same keyframes and poses within 2e-3 (rad and
  m) up to the first keyframe decision that differs (the decisions are
  chaotic at the threshold: ROADMAP.md section 3), the ATE within the JAX
  package's + 0.01 m, and, per dispatch, the same last frame resolved
  before it (the same keyframes in the map at its snapshot up to that
  split): each frame matches against the map the JAX package's does.

Run as a script, it prints the JAX package's numbers for chip_smoke.py's
pipelined phases on its VGA frames, run on the CPU with cv2 hidden,
TPUSLAM_KF_DEFER_MS=0 and TPUSLAM_NATIVE_MAP=0 (the JAX_* constants there):

    python tests/test_torch_pipelined.py fullchunk frame hybrid descriptor hostscale classic
    python tests/test_torch_pipelined.py mono 0 11   # pipelined lines-only mono, RANSAC draws k = 0..10
    python tests/test_torch_pipelined.py seeds frame 1 5   # the single-frame program, image-noise seeds 1..4
    python tests/test_torch_pipelined.py portseeds bench 0 5   # the port's bench path on the CPU, seeds 0..4
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from torch_parity import DOTS, QVGA, JaxAsOnTheCard, dot_scene, np_of, python_graph, stereo_scene
from torch_pipelined_parity import ate, effective_dispatches, keyframe_split, pose_gap, run_jax_tracker, run_port_tracker
from tpuslam_torch.convert import chunk_inputs_from, point_local_from, tracker_config_from
from tpuslam_torch.frontend import pipeline as tpipe
from tpuslam_torch.frontend.frame import FrontendParams, host_prescale


def jax_switch_config(chunk=6, points=False, pipelined=True, direct=True, halfres=True, hostscale=True, semidirect=True):
    """The JAX package's bench configuration under its switches
    (``tpuslam/bench.py``: TPUSLAM_BENCH_CHUNK, _POINTS, _PIPELINED,
    _DIRECT, _HALFRES, _HOSTSCALE, _SEMIDIRECT), fusion applied at the
    keyframe: (TrackerConfig, MapperConfig)."""
    from tpuslam.backend.local_ba import LocalBAConfig
    from tpuslam.backend.mapping import MapperConfig
    from tpuslam.frontend.frame import FrontendParams
    from tpuslam.frontend.points import PointFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.kernels.align_direct import DirectAlignParams
    from tpuslam.kernels.stereo_direct import DirectStereoParams

    tcfg = TrackerConfig(pipelined=pipelined)
    if direct:
        tcfg.direct_stereo = DirectStereoParams()
    if halfres:
        tcfg.frontend = FrontendParams(base_scale=0.5, prescaled=hostscale)
    tcfg.chunk = chunk
    if chunk > 1 and direct and semidirect:
        tcfg.semidirect = DirectAlignParams()
    if points:
        tcfg.points = PointFrontendParams()
    mcfg = MapperConfig(ba=LocalBAConfig(pose_buckets=(8, 16), line_buckets=(128, 256), obs_buckets=(512, 1024)))
    return tcfg, mcfg


# chip_smoke.py's pipelined stereo phases: name -> (bench switches, frames with dots)
BENCH_PHASES = {
    "bench": (dict(), False),  # the bench path itself (phase 8): semi-direct chunks of 6
    "fullchunk": (dict(semidirect=False), False),
    "frame": (dict(chunk=1), False),
    "hybrid": (dict(chunk=1, points=True), True),
    "descriptor": (dict(chunk=1, direct=False), False),
    "hostscale": (dict(hostscale=False), False),
}


def run_jax_system(cam, frames, tcfg, mcfg=None, mapping=True, sensor="stereo"):
    """tpuslam.system.System(cam, sensor, mapping, loop_closing=False) over
    uint8 frames (pairs in stereo), as the port's parity runs take the JAX
    package (cv2 hidden, TPUSLAM_KF_DEFER_MS=0, TPUSLAM_NATIVE_MAP=0). Returns
    (system, trajectory in frame order)."""
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.system import System as JSystem

    with JaxAsOnTheCard():
        js = JSystem(JIntrinsics(*cam), sensor=sensor, mapping=mapping, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg)
        for f, fr in enumerate(frames):
            if sensor == "stereo":
                js.track_stereo(fr[0], fr[1], f * 0.05)
            else:
                js.track_monocular(fr, f * 0.05)
        js.shutdown()
    return js, sorted(js.trajectory, key=lambda r: r.frame_idx)


# ---- the programs on identical inputs --------------------------------------

VGA_CAM = (458.0, 457.0, 320.0, 240.0, 640, 480, 0.11)
HALF = FrontendParams(base_scale=0.5, prescaled=True)
C = 6
# tests/test_torch_semidirect.py's anchor tolerances (PR 5). The fused
# programs take the JAX package's IRLS formula (one Huber weight per residual
# family): with one weight per observation, as the synchronous stereo path
# keeps, the direct program's pose lands 6.4e-4 m from the JAX one on these
# inputs (2.3e-3 m on the chunk's second frame), with it 8.3e-5 m
ANCHOR_TOL_RAD, ANCHOR_TOL_M = 1e-4, 3e-4
PROGRAMS = {
    # name: (bench switches, frames with the scene's points as dots)
    "direct": (dict(chunk=1), False),
    "descriptor": (dict(chunk=1, direct=False), False),
    "hybrid": (dict(chunk=1, points=True), True),
    "chunk": (dict(semidirect=False), False),
}


def _bench_frames(n_frames: int, dots: bool):
    """chip_smoke.py's bench scene and VGA camera over ``n_frames`` frames."""
    from tpuslam_torch import Intrinsics
    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    cam = Intrinsics(*VGA_CAM)
    rng = np.random.default_rng(0)
    scene = make_wireframe_scene(rng, n_segments=140, n_points=200 if dots else 0, n_frames=n_frames, cam=cam, motion_scale=0.02)
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    frames = [
        tuple(render_wireframe_image(sc, f, noise=1.0, rng=rng, draw_points=dots) for sc in (scene, scene_r))
        for f in range(n_frames)
    ]
    return cam, frames


def make_program_case(name):
    """The JAX tracker in the form's bench configuration initialized on
    frame 0, and the form's JAX program on the next frame (the next C frames
    for the chunk), halved on the host. Returns (inputs, the JAX output, the
    JAX TrackerConfig)."""
    import jax.numpy as jnp

    from tpuslam.frontend import pipeline as jpipe
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.slammap.map import SlamMap as JSlamMap

    switches, dots = PROGRAMS[name]
    cam, frames = _bench_frames(C + 1, dots)
    c, _ = jax_switch_config(**switches)
    with JaxAsOnTheCard():
        jt = JTracker(JIntrinsics(*cam), JSlamMap(), c)
        jt.track_stereo(*frames[0], 0.0)
        assert jt.state.name == "OK"
        local = {k: np.asarray(v) for k, v in jt._local_map_arrays().items()}
        plocal = {k: np.asarray(v) for k, v in jt._point_local_arrays().items()} if c.points is not None else None
        T_last = np.asarray(jt.T_cw, np.float32)
        T_prev = (np.linalg.inv(jt.velocity).astype(np.float32) @ T_last).astype(np.float32)
        half = [np.stack([host_prescale(x, HALF) for x in pair]) for pair in frames[1:]]
        pairs = np.stack(half) if name == "chunk" else half[0]
        args = (jnp.asarray(pairs), jnp.asarray(T_last), jnp.asarray(T_prev), {k: jnp.asarray(v) for k, v in local.items()})
        fxb, jcam = float(cam.fx * cam.baseline), JIntrinsics(*cam)
        if name == "hybrid":
            ref = jpipe.fused_stereo_frame_hybrid(
                *args, {k: jnp.asarray(v) for k, v in plocal.items()}, fxb, jcam, c.frontend, jt._direct_lines(),
                jt._direct_points(), c.points, c.search_coarse, c.search_fine, c.pose_opt, c.min_track_inliers,
            )
        elif name == "chunk":
            ref = jpipe.fused_stereo_chunk(
                *args, fxb, jcam, c.frontend, c.search_coarse, c.search_fine, c.pose_opt, c.min_track_inliers, jt._direct_lines(),
            )
        else:
            ref = jpipe.fused_stereo_frame(
                *args, fxb, jcam, c.frontend, c.stereo, c.search_coarse, c.search_fine, c.pose_opt, c.min_track_inliers,
                sd=jt._direct_lines(),
            )
        jt.close()
    return dict(cam=cam, pairs=pairs, T_last=T_last, T_prev=T_prev, local=local, plocal=plocal), ref, c


def run_port_program(name, case, jcfg, device="cpu"):
    """The port's program of form ``name`` on the case's inputs, on
    ``device``, with the settings the port's Tracker passes it."""
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap

    cam = case["cam"]
    pairs, T_last, T_prev, local = chunk_inputs_from(case["pairs"], case["T_last"], case["T_prev"], case["local"], device)
    with python_graph():
        tr = Tracker(cam, SlamMap(), tracker_config_from(jcfg), device=device)
    c = tr.cfg
    if name == "hybrid":
        return tpipe.fused_stereo_frame_hybrid(
            pairs, T_last, T_prev, local, point_local_from(case["plocal"], device), tr._fxb, cam, c.frontend, tr._direct_lines(),
            tr._direct_points(), c.points, c.search_coarse, c.search_fine, c.pose_opt, c.min_track_inliers,
        )
    if name == "chunk":
        return tpipe.fused_stereo_chunk(
            pairs, T_last, T_prev, local, tr._fxb, cam, c.frontend, c.search_coarse, c.search_fine, c.pose_opt,
            c.min_track_inliers, tr._direct_lines(),
        )
    return tpipe.fused_stereo_frame(
        pairs, T_last, T_prev, local, tr._fxb, cam, c.frontend, c.stereo, c.search_coarse, c.search_fine, c.pose_opt,
        c.min_track_inliers, sd=tr._direct_lines(),
    )


@pytest.fixture(scope="module", params=list(PROGRAMS))
def program_case(request):
    return (request.param,) + make_program_case(request.param)


def test_program_matches_jax(program_case):
    """Each fused program on the same frames, chain and local map(s): the
    same accept flags and counts (matched, inliers, depths), poses within
    1e-4 rad and 3e-4 m, at least 98% of the matches the same, the chain's
    end equal to the last row."""
    name, case, ref, jcfg = program_case
    got = run_port_program(name, case, jcfg)
    packed, packed_ref = np_of(got.packed), np.asarray(ref.packed)
    assert packed.shape == packed_ref.shape == ((C, 20) if name == "chunk" else (20,))
    packed, packed_ref = packed.reshape(-1, 20), packed_ref.reshape(-1, 20)
    np.testing.assert_array_equal(packed[:, 19], packed_ref[:, 19])
    assert np.all(packed[:, 19] == 1.0)
    np.testing.assert_array_equal(packed[:, 16:19], packed_ref[:, 16:19])
    for i in range(len(packed)):
        ang, dc = pose_gap(packed[i, :16].reshape(4, 4), packed_ref[i, :16].reshape(4, 4))
        assert ang <= ANCHOR_TOL_RAD and dc <= ANCHOR_TOL_M, (i, ang, dc)
    np.testing.assert_array_equal(np_of(got.T_last), packed[-1, :16].reshape(4, 4))
    assert np.mean(np_of(got.match_idx) == np.asarray(ref.match_idx)) >= 0.98
    assert np.mean(np_of(got.inlier) == np.asarray(ref.inlier)) >= 0.98
    if name == "chunk":  # one feature set per frame
        assert np_of(got.feats.endpoints).shape == np.asarray(ref.feats.endpoints).shape == (C, 256, 2, 2)


# ---- the configurations -------------------------------------------------------

SWITCHES = [
    dict(), dict(semidirect=False), dict(chunk=1), dict(chunk=1, points=True), dict(chunk=1, direct=False),
    dict(hostscale=False), dict(pipelined=False, halfres=False), dict(direct=False, chunk=6),
]


@pytest.mark.parametrize("switches", SWITCHES, ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()) or "default")
def test_bench_switches_match_jax(switches):
    """bench_configs under each switch equals the JAX bench's configuration
    carried over (semidirect only with chunk > 1 and direct stereo), and the
    tracker picks the form the JAX tracker picks."""
    from tpuslam.frontend.tracking import Tracker as JTracker
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam.slammap.map import SlamMap as JSlamMap
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap
    from tpuslam_torch.system import bench_configs

    jcfg, jmcfg = jax_switch_config(**switches)
    tcfg, _ = bench_configs(**switches)
    assert tracker_config_from(jcfg) == tcfg
    with JaxAsOnTheCard():
        jt = JTracker(JIntrinsics(*QVGA), JSlamMap(), jcfg)
        want = (jt._use_fused(), jt._chunk_size(), jt._use_semidirect())
        jt.close()
    tt = Tracker(QVGA, SlamMap(), tcfg, device="cpu")
    assert (tt._use_fused(), tt._chunk_size(), tt._use_semidirect()) == want


def test_tracker_config_carries_radtan_and_pipelined_fields():
    """The JAX TrackerConfig's radtan front end (dist, and cam as this
    package's Intrinsics) and its pipelined fields carry over."""
    from tpuslam.frontend.frame import FrontendParams as JFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.geometry.camera import Distortion as JDistortion
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics
    from tpuslam_torch import Intrinsics
    from tpuslam_torch.geometry.camera import Distortion

    jcfg = TrackerConfig(
        pipelined=True, fused=False, fuse_lag=3,
        frontend=JFrontendParams(dist=JDistortion(0.1, -0.2, 0.001, 0.002), cam=JIntrinsics(*QVGA)),
    )
    got = tracker_config_from(jcfg)
    assert (got.pipelined, got.fused, got.fuse_lag) == (True, False, 3)
    assert got.frontend.dist == Distortion(0.1, -0.2, 0.001, 0.002) and isinstance(got.frontend.dist, Distortion)
    assert got.frontend.cam == QVGA and isinstance(got.frontend.cam, Intrinsics)


# ---- the Tracker in each fused form ----------------------------------------

N_FRAMES = 12
POSE_TOL = 2e-3


def _form_configs():
    from tpuslam.frontend.points import PointFrontendParams
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.kernels.stereo_direct import DirectStereoParams

    d = DirectStereoParams(max_disp=64.0)  # tests/test_semidirect.py's full-resolution QVGA setting
    return {
        "frame": (QVGA, TrackerConfig(pipelined=True, direct_stereo=d)),
        "descriptor": (QVGA, TrackerConfig(pipelined=True)),
        "hybrid": (DOTS, TrackerConfig(pipelined=True, direct_stereo=DirectStereoParams(), points=PointFrontendParams())),
        # chunks of 6, the bench's: 1-6, then 7-11 padded at the flush
        "fullchunk": (QVGA, TrackerConfig(pipelined=True, chunk=C, direct_stereo=d)),
    }


def run_form(name: str, forms: dict):
    """The JAX and the port Tracker in the form over N_FRAMES frames:
    (scene, (JAX results, log), (port results, log, port tracker))."""
    cam, jcfg = forms[name]
    scene, frames = (dot_scene if cam is DOTS else stereo_scene)(N_FRAMES)
    return scene, run_jax_tracker(cam, frames, jcfg), run_port_tracker(cam, frames, jcfg)


@pytest.fixture(scope="module", params=list(_form_configs()))
def form_run(request):
    return (request.param,) + run_form(request.param, _form_configs())


def test_form_tracks_like_jax(form_run):
    """One result per frame in order, every frame OK and tracked by the fused
    programs (the first by the synchronous initialization); the same
    keyframes and poses within POSE_TOL up to the first keyframe decision
    that differs, which comes after frame 6; the ATE within the JAX
    package's + 0.01 m."""
    name, scene, (jres, _), (tres, _, tr) = form_run
    assert [r.frame_idx for r in tres] == [r.frame_idx for r in jres] == list(range(N_FRAMES))
    assert all(r.state.name == "OK" for r in tres)
    assert tr.sync_frames == [0]
    want = list(range(1, N_FRAMES)) + ([-1] if name == "fullchunk" else [])  # the padded partial chunk
    assert tr.anchor_frames == want
    split = keyframe_split(jres, tres)
    assert split > 6, split
    for a, b in zip(jres[:split], tres[:split]):
        ang, dc = pose_gap(b.T_cw, a.T_cw)
        assert ang <= POSE_TOL and dc <= POSE_TOL, (a.frame_idx, ang, dc)
    assert ate(tres, scene) <= ate(jres, scene) + 0.01


def test_form_snapshot_order_matches_jax(form_run):
    """Per dispatch: the same frames, the same last frame resolved before it,
    and (up to the first keyframe decision that differs) the same keyframes
    in the map at its snapshot. A single frame k is dispatched when frame
    k + 1 arrives and matches against the map after frame k - 3's resolve;
    the last frame at the flush, after every other frame's."""
    name, _, (jres, jlog), (tres, tlog, _) = form_run
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    split = keyframe_split(jres, tres)
    first = lambda e: e[0] if isinstance(e[0], int) else e[0][0]  # noqa: E731
    assert [e for e in tlog if first(e) <= split] == [e for e in jlog if first(e) <= split]
    if name != "fullchunk":
        assert [e[:2] for e in tlog][3:] == [(k, k - 3) for k in range(4, N_FRAMES - 1)] + [(N_FRAMES - 1, N_FRAMES - 2)]


FLUSH_FRAMES = 18  # chunks 1-6 and 7-12 full, 13-17 padded: chunk 7-12 waits at the JAX flush


def test_flush_order_matches_jax():
    """The final flush with a full chunk waiting (semi-direct chunks of 6 over
    18 QVGA frames, a keyframe at every anchor so the previous chunk's
    resolve changes the map): per effective dispatch the same frames, last
    frame resolved before it and keyframes in the map at its snapshot as the
    JAX package's. The port dispatched chunk 7-12 when it filled, before
    chunk 1-6's resolve and keyframe, and dispatches it again at the flush
    after them (``flush_frames``); every frame OK, up to the first keyframe
    decision that differs the anchors' poses within POSE_TOL and the
    followers' within 5e-3 (their template alignment lands 1e-3 apart even
    on identical inputs, test_torch_semidirect.py, and here from maps and
    seeds that differ by float rounding: 4.0e-3 m at frame 8)."""
    from tpuslam.frontend.tracking import TrackerConfig
    from tpuslam.kernels.align_direct import DirectAlignParams
    from tpuslam.kernels.stereo_direct import DirectStereoParams

    jcfg = TrackerConfig(
        pipelined=True, chunk=C, direct_stereo=DirectStereoParams(max_disp=64.0), semidirect=DirectAlignParams(),
        max_frames_between_kf=1,
    )
    scene, frames = stereo_scene(FLUSH_FRAMES)
    jres, jlog = run_jax_tracker(QVGA, frames, jcfg)
    tres, tlog, tr = run_port_tracker(QVGA, frames, jcfg)
    assert [r.frame_idx for r in tres] == [r.frame_idx for r in jres] == list(range(FLUSH_FRAMES))
    assert all(r.state.name == "OK" for r in tres)
    assert tr.anchor_frames == [1, 7, 13] and tr.flush_frames == [7]
    assert [e[0] for e in jlog] == [list(range(1, 7)), list(range(7, 13)), list(range(13, 18)) + [-1]]
    assert effective_dispatches(tlog) == jlog
    split = keyframe_split(jres, tres)
    for a, b in zip(jres[:split], tres[:split]):
        ang, dc = pose_gap(b.T_cw, a.T_cw)
        tol = POSE_TOL if a.frame_idx in tr.anchor_frames else 5e-3
        assert ang <= tol and dc <= tol, (a.frame_idx, ang, dc)
    assert ate(tres, scene) <= ate(jres, scene) + 0.01


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from tpuslam.frontend.tracking import TrackerConfig

    args = sys.argv[1:]
    if args and args[0] == "mono":
        # pipelined lines-only mono over RANSAC draws PRNGKey(frame_idx + 1000 k)
        import jax.random
        from test_torch_mono import mono_tracker_cfg, run_jax_mono

        cam, scene, frames = chip_smoke.make_mono_frames()
        key = jax.random.PRNGKey
        k0, k1 = (int(a) for a in args[1:3])
        ates = []
        for k in range(k0, k1):
            jax.random.PRNGKey = lambda i, k=k: key(i + 1000 * k)
            tcfg = mono_tracker_cfg(False)
            tcfg.pipelined = True
            try:
                s, _ = run_jax_mono(cam, frames, tcfg)
            finally:
                jax.random.PRNGKey = key
            ates.append(chip_smoke.sim3_ate(s.trajectory, scene))
            states = [r.state.name for r in s.trajectory]
            kfs = [r.frame_idx for r in s.trajectory if r.made_keyframe]
            print(f"JAX pipelined mono lines, draws k = {k}: states {states}, keyframes {kfs}, Sim(3) ATE {ates[-1]!r}", flush=True)
        print(f"JAX_PIPELINED_MONO_DRAW_ATES_M[{k0}:{k1}] = {ates!r}", flush=True)
        sys.exit(0)
    if args and args[0] in ("seeds", "portseeds"):
        # a phase over other image-noise seeds of the same scene: the JAX
        # package's (seeds), or the port's System on the CPU (portseeds)
        name, k0, k1 = args[1], int(args[2]), int(args[3])
        switches, dots = BENCH_PHASES[name]
        ates = []
        for k in range(k0, k1):
            cam, scene, frames = chip_smoke.make_frames(draw_points=dots, noise_seed=k)
            if args[0] == "seeds":
                js, traj = run_jax_system(cam, frames, *jax_switch_config(**switches))
            else:
                from tpuslam_torch.system import System, bench_configs

                tcfg, mcfg = bench_configs(**switches)
                with python_graph():
                    ts = System(cam, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cpu")
                for f, (il, ir) in enumerate(frames):
                    ts.track_stereo(il, ir, f * 0.05)
                ts.shutdown()
                traj = sorted(ts.trajectory, key=lambda r: r.frame_idx)
            who = "JAX" if args[0] == "seeds" else "port"
            ates.append(chip_smoke.ate_of(traj, scene))
            print(f"{who} {name}, noise seed {k}: keyframes {[r.frame_idx for r in traj if r.made_keyframe]}, ATE {ates[-1]!r}", flush=True)
        print(f"{'JAX' if args[0] == 'seeds' else 'PORT'}_{name.upper()}_SEED_ATES_M[{k0}:{k1}] = {ates!r}", flush=True)
        sys.exit(0)
    for name in args:
        if name == "classic":
            cam, scene, frames = chip_smoke.make_frames()
            for mapping in (False, True):
                js, traj = run_jax_system(cam, frames, TrackerConfig(pipelined=True, fused=False), mapping=mapping)
                kfs = [r.frame_idx for r in traj if r.made_keyframe]
                tag = "MAPPING_" if mapping else ""
                print(f"JAX classic pipeline, mapping={mapping}: keyframes {kfs}, states {[r.state.name[0] for r in traj]}", flush=True)
                print(f"JAX_CLASSIC_{tag}ATE_M = {chip_smoke.ate_of(traj, scene)!r}", flush=True)
            continue
        switches, dots = BENCH_PHASES[name]
        cam, scene, frames = chip_smoke.make_frames(draw_points=dots)
        js, traj = run_jax_system(cam, frames, *jax_switch_config(**switches))
        assert [r.frame_idx for r in traj] == list(range(len(frames)))
        kfs = [r.frame_idx for r in traj if r.made_keyframe]
        print(f"JAX {name} ({switches}): keyframes {kfs}, states {[r.state.name[0] for r in traj]}", flush=True)
        print(f"JAX_{name.upper()}_ATE_M = {chip_smoke.ate_of(traj, scene)!r}", flush=True)
