"""The bench: tpuslam_torch.bench against tpuslam.bench, at QVGA on the CPU.

The scene and the switch parsing against the JAX bench's; a 12-frame
``run_benchmark`` (6 warmup, 6 timed) whose JSON lines, fields and ATE are
checked and whose System is held to the JAX package's System in the bench
configuration on the same frames, both with their native map mirror on
(each package's default); the toy local-BA solves of ``run_ba_benchmark``
against the JAX package's ``_run_lm_jit``.

The 12-frame run is at the bench's VGA, which takes no longer on a CPU
than QVGA here (12 frames make one keyframe, so no local BA runs). Under
TPUSLAM_BENCH_CAM=qvga the bench detects on 160x120 images, and there the
chunk followers of the two packages part by up to 2.3e-2 m (frame 9; frame
5, inside the first chunk, 3.2e-3 m), where at VGA every frame stays
within 1.2e-3 m: a threshold crossing (a template's uniqueness ratio at
0.89998 against 0.9) downstream of the detector's float32 sums, while on
identical inputs each QVGA follower agrees within 1.0e-6 m
(test_torch_align_direct.py; ROADMAP.md section 3).

Run as a script, it prints chip_smoke.py's phase-22 references: the JAX
System with the bench configuration (lines only, or hybrid points over
frames with dots) over the bench's 106 VGA frames, on the CPU, with cv2
hidden, TPUSLAM_KF_DEFER_MS=0 and the native mirror on; ``seeds`` runs the
same over image-noise seeds k0..k1-1 (~1 min per lines run, ~1.5 per
hybrid run); ``portseeds`` this package's bench on the CPU over the same
seeds; ``gaps`` the 12-frame comparison of the tests frame by frame, at
VGA or at the QVGA camera; ``crossing`` why the first QVGA chunk's
followers part (frame 0's feature gaps, the map, anchor-pose and template
gaps, and each follower's samples whose uniqueness decision differs):

    python tests/test_torch_bench.py lines|hybrid [seeds K0 K1]
    python tests/test_torch_bench.py portseeds lines|hybrid K0 K1
    python tests/test_torch_bench.py gaps vga|qvga
    python tests/test_torch_bench.py crossing
"""

import contextlib
import io
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from test_torch_semidirect import _ate, _pose_gap, jax_bench_config
from torch_parity import QVGA, JaxWithMirror, jax_native_library, np_of
from tpuslam_torch import bench, system as tsystem
from tpuslam_torch.system import bench_configs

N_TIMED, N_WARM = 6, 6
POSE_TOL = 2e-3  # rad and m, per frame


def _jax_cam(cam):
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    return JIntrinsics(*cam)


@contextlib.contextmanager
def bench_env(**switches):
    """os.environ without any TPUSLAM_BENCH_* switch but ``switches``."""
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TPUSLAM_BENCH_")]:
            mp.delenv(k)
        for k, v in switches.items():
            mp.setenv(f"TPUSLAM_BENCH_{k}", v)
        yield mp


def test_bench_scene_matches_jax():
    """The bench's scene: segments and poses equal to the JAX generator's
    under the same seed and arguments."""
    from tpuslam.io.synthetic import make_wireframe_scene

    scene, imgs = bench.bench_scene(10, QVGA)
    ref = make_wireframe_scene(np.random.default_rng(0), n_segments=140, n_frames=10, cam=_jax_cam(QVGA), motion_scale=0.02)
    np.testing.assert_array_equal(scene.segments, ref.segments)
    np.testing.assert_array_equal(scene.poses, ref.poses)
    assert len(imgs) == 10 and imgs[0][0].shape == (240, 320) and imgs[0][0].dtype == np.uint8
    _, other = bench.bench_scene(10, QVGA, noise_seed=3)
    assert not np.array_equal(other[0][0], imgs[0][0])


DEFAULT = dict(mapping=True, chunk=6, points=False, pipelined=True, direct=True, halfres=True, hostscale=True, semidirect=True)
SWITCHES = [
    ({}, {}),
    ({"NOMAP": "1"}, {"mapping": False}),
    ({"FORCE_NOMAP": "1"}, {"mapping": False}),
    ({"PIPELINED": "0"}, {"pipelined": False}),
    ({"DIRECT": "0"}, {"direct": False}),
    ({"HALFRES": "0"}, {"halfres": False}),
    ({"HOSTSCALE": "0"}, {"hostscale": False}),
    ({"CHUNK": "4"}, {"chunk": 4}),
    ({"SEMIDIRECT": "0"}, {"semidirect": False}),
    ({"POINTS": "1"}, {"points": True}),
    ({"FUSEDEFER": "0", "WARMUP": "0"}, {}),  # read only by the JAX bench
]


@pytest.mark.parametrize("env,changed", SWITCHES, ids=[",".join(e) or "defaults" for e, _ in SWITCHES])
def test_bench_switches(env, changed):
    """Each JAX bench switch sets the bench_configs argument the JAX bench's
    rule gives (tpuslam/bench.py:83-138)."""
    with bench_env(**env):
        got = bench.bench_switches()
    assert got == {**DEFAULT, **changed}
    kw = dict(got)
    kw.pop("mapping")
    tcfg, _ = bench_configs(**kw)
    assert tcfg.pipelined == kw["pipelined"] and tcfg.chunk == kw["chunk"]
    assert (tcfg.direct_stereo is not None) == kw["direct"]
    assert (tcfg.points is not None) == kw["points"]
    assert tcfg.frontend.base_scale == (0.5 if kw["halfres"] else 1.0)
    assert tcfg.frontend.prescaled == (kw["halfres"] and kw["hostscale"])
    assert (tcfg.semidirect is not None) == (kw["chunk"] > 1 and kw["direct"] and kw["semidirect"])


@pytest.fixture(scope="module")
def port_run():
    """run_benchmark(6, 6) at VGA on the CPU, mirror on: (result, its
    System, its printed lines, the lines printed when device feed began)."""
    made, at_feed = [], []

    class Recorded(tsystem.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    feed = bench._device_feed_fps
    buf = io.StringIO()

    def recorded_feed(*a, **kw):
        at_feed.append(buf.getvalue().splitlines())
        return feed(*a, **kw)

    with bench_env() as mp:
        mp.setenv("TPUSLAM_NATIVE_MAP", "1")
        mp.setattr(tsystem, "System", Recorded)
        mp.setattr(bench, "_device_feed_fps", recorded_feed)
        with contextlib.redirect_stdout(buf):
            out = bench.run_benchmark(frames=N_TIMED, warmup=N_WARM, device="cpu")
    assert len(made) == 1 and len(at_feed) == 1
    return out, made[0], buf.getvalue().splitlines(), at_feed[0]


@pytest.fixture(scope="module")
def jax_run(port_run, tmp_path_factory):
    """The JAX System in the bench configuration over the same 12 frames,
    its native mirror on; its trajectory in frame order."""
    from tpuslam.system import System as JSystem

    _, imgs = bench.bench_scene(N_TIMED + N_WARM, bench.VGA)
    with jax_native_library(tmp_path_factory.mktemp("jax_native")), JaxWithMirror():
        tcfg, mcfg = jax_bench_config()
        js = JSystem(_jax_cam(bench.VGA), sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg)
        assert js.map.lines.mirror is not None
        for f, (il, ir) in enumerate(imgs):
            js.track_stereo(il, ir, f * 0.05)
        js.shutdown()
        assert js.map.lines.mirror is not None
    return sorted(js.trajectory, key=lambda r: r.frame_idx)


def test_run_benchmark_lines(port_run):
    """A complete JSON line is printed before device feed runs, one more
    after it and a last one after the accuracy and BA fields; each parses,
    the last is the result returned."""
    out, _, lines, at_feed = port_run
    rows = [json.loads(line) for line in lines]
    assert len(rows) == 3 and len(at_feed) == 1
    first = json.loads(at_feed[0])
    assert first["frames"] == N_TIMED and "fps_wall" in first and "fps_device_feed" not in first
    assert "fps_device_feed" in rows[1] and "ate_rmse" not in rows[1]
    assert rows[-1] == json.loads(json.dumps(out, default=float))


def test_run_benchmark_fields(port_run):
    """The JAX bench's fields and the port's, with the values of this run:
    ATE that of the returned trajectory, one OK entry per frame, the mirror
    in use, a toy solve per rung, the detector's runs counted."""
    out, sys_, _, _ = port_run
    for key in (
        "device", "frames", "fps_median", "fps_mean", "fps_wall", "track_ms_median", "local_ba_ms", "keyframes", "lines",
        "warmup_s", "pretouch_s", "pretouch_total_s", "stage_ms", "track_sum_ms", "flush_ms", "wire_mbps",
        "fps_device_feed", "ate_rmse", "ate_ok", "ba_submitted",
        "power_limit_w", "keyframe_frames", "native_map", "tracked_ok", "extractions",
    ):
        assert key in out, key
    for key in ("ba_skipped", "ba_resubmitted", "ba_stale", "local_ba_cold", "local_ba_stage_ms"):
        assert key not in out, key
    scene, _ = bench.bench_scene(N_TIMED + N_WARM, bench.VGA)
    traj = sorted(sys_.trajectory, key=lambda r: r.frame_idx)
    assert [r.frame_idx for r in traj] == list(range(N_TIMED + N_WARM))
    assert out["tracked_ok"] == N_TIMED + N_WARM == sum(r.state.name == "OK" for r in traj)
    assert out["ate_rmse"] == _ate(traj, scene)
    assert out["device"] == "cpu" and out["power_limit_w"] is None and out["native_map"] is True
    assert out["keyframe_frames"] == [r.frame_idx for r in traj if r.made_keyframe] and out["keyframes"] == len(out["keyframe_frames"])
    assert set(out["pretouch_s"]) == {"8x128x512", "16x256x1024"}
    # one keyframe in 12 frames: no local BA, so no per-rung medians (as the JAX bench)
    assert out["ba_submitted"] == len(out["keyframe_frames"]) - 1 == 0 and "local_ba_ms_by_rung" not in out
    tr = sys_.tracker
    assert out["extractions"] == dict(
        anchors=len(tr.anchor_frames), flush=len(tr.flush_frames), synchronous=tr.n_sync_extractions, device_feed=7
    )  # device feed: a first chunk, then max(4, 40 // 6) timed ones
    assert out["fps_device_feed"] > 0 and out["fps_wall"] > 0


def test_run_benchmark_matches_jax(port_run, jax_run):
    """The same 12 frames through the JAX System in the bench
    configuration, both packages' native mirror on: the same keyframes,
    each pose within 2e-3 (rad and m)."""
    _, sys_, _, _ = port_run
    mine = sorted(sys_.trajectory, key=lambda r: r.frame_idx)
    assert [r.frame_idx for r in mine if r.made_keyframe] == [r.frame_idx for r in jax_run if r.made_keyframe]
    for a, b in zip(mine, jax_run):
        ang, dist = _pose_gap(a.T_cw, np.asarray(b.T_cw))
        assert ang <= POSE_TOL and dist <= POSE_TOL, (a.frame_idx, ang, dist)


def test_run_ba_benchmark_matches_jax():
    """run_ba_benchmark's toy problems are the JAX package's (carried across
    by convert.ba_problem_from) with the same initial cost (1e-5 relative),
    and on each rung both packages' 8 LM iterations reach the float32 floor
    of these noiseless problems: final cost at most 1e-8 of the initial
    (~1e-10 in both; the final costs themselves are rounding, 2-3e-6 against
    7,796 and 18,024 at the start, and the solutions differ along the
    problems' free scale, so neither is compared to the other)."""
    from tpuslam.backend.lm import LMConfig as JLMConfig
    from tpuslam.backend.local_ba import _run_lm_jit
    from tpuslam.parallel.sharded_ba import _toy_problem as jtoy
    from tpuslam_torch.backend.lm import LMConfig, run_lm
    from tpuslam_torch.convert import ba_problem_from
    from tpuslam_torch.parallel.sharded_ba import _toy_problem

    out = bench.run_ba_benchmark(quiet=True, device="cpu")
    assert out["device"] == "cpu" and out["local_ba_ms"] == out["ba_ms_P8_L128"]
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    jcam = _jax_cam(bench.VGA)
    for P_, L_, OL_ in bench.BA_RUNGS:
        jprob = jtoy(jrng, P_=P_, L=L_, OL=OL_, cam=jcam)
        mine = _toy_problem(rng, P_=P_, L=L_, OL=OL_, cam=bench.VGA, device="cpu")
        for name, a, b in zip(mine._fields, mine, ba_problem_from(jprob)):
            # test_torch_parallel's tolerance; pixel endpoints of up to ~420 px
            # land up to two float32 spacings (6.1e-5 px) apart
            atol = 1e-4 if name == "l_endpoints" else 1e-5
            np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-6, atol=atol, err_msg=name)
        cost0 = float(run_lm(mine, bench.VGA, LMConfig(max_iters=0)).cost)
        ref0 = float(_run_lm_jit(jprob, jcam, JLMConfig(max_iters=0)).cost)
        ref = float(_run_lm_jit(jprob, jcam, JLMConfig(max_iters=8)).cost)
        got = out[f"ba_cost_P{P_}_L{L_}"]
        assert abs(cost0 - ref0) <= 1e-5 * ref0, (P_, cost0, ref0)
        assert got == float(run_lm(mine, bench.VGA, LMConfig(max_iters=8)).cost)
        assert got <= 1e-8 * cost0 and ref <= 1e-8 * ref0, (P_, got, ref, cost0)
        assert out[f"ba_ms_P{P_}_L{L_}"] > 0


def jax_bench100(points: bool, noise_seed=None):
    """(ATE, keyframe frames) of the JAX System in the bench configuration
    over the bench's 106 VGA frames (``run_benchmark(100, 6)``'s), on the
    CPU with its native mirror on."""
    import tempfile

    from test_torch_hybrid import jax_hybrid_bench_config
    from tpuslam.system import System as JSystem

    with bench_env(**({"POINTS": "1"} if points else {})):
        scene, imgs = bench.bench_scene(106, bench.VGA, noise_seed)
    tcfg, mcfg = jax_hybrid_bench_config() if points else jax_bench_config()
    with tempfile.TemporaryDirectory() as d, jax_native_library(d), JaxWithMirror():
        js = JSystem(_jax_cam(bench.VGA), sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg)
        for f, (il, ir) in enumerate(imgs):
            js.track_stereo(il, ir, f * 0.05)
        js.shutdown()
        assert js.map.lines.mirror is not None
    traj = sorted(js.trajectory, key=lambda r: r.frame_idx)
    assert [r.frame_idx for r in traj] == list(range(106)) and all(r.state.name == "OK" for r in traj)
    return _ate(traj, scene), [r.frame_idx for r in traj if r.made_keyframe]


def pose_gaps(cam, n: int = N_TIMED + N_WARM):
    """(frame, rad, m) between this package's System and the JAX package's
    in the bench configuration over the bench's first n frames at ``cam``,
    both mirrors on, on the CPU; and both keyframe lists."""
    import tempfile

    from tpuslam.system import System as JSystem

    _, imgs = bench.bench_scene(n, cam)
    tcfg, mcfg = bench_configs()
    ts = tsystem.System(cam, sensor="stereo", loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cpu")
    with tempfile.TemporaryDirectory() as d, jax_native_library(d), JaxWithMirror():
        jt, jm = jax_bench_config()
        js = JSystem(_jax_cam(cam), sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=jt, mapper_cfg=jm)
        for f, (il, ir) in enumerate(imgs):
            ts.track_stereo(il, ir, f * 0.05)
            js.track_stereo(il, ir, f * 0.05)
        ts.shutdown()
        js.shutdown()
    a, b = (sorted(s.trajectory, key=lambda r: r.frame_idx) for s in (ts, js))
    kfs = [[r.frame_idx for r in t if r.made_keyframe] for t in (a, b)]
    return [(x.frame_idx, *_pose_gap(x.T_cw, np.asarray(y.T_cw))) for x, y in zip(a, b)], kfs


def crossing_report(n: int = N_TIMED + N_WARM) -> None:
    """Both packages' bench Systems over the first 8 of the bench's n QVGA
    frames (mirrors on, as ``gaps``), each first semi-direct chunk's inputs
    and packed rows recorded. Prints frame 0's keyframe feature gaps (valid
    segments), the map lines' and anchor poses' gaps, the anchor templates'
    gap, and for each follower the pose gap and every template sample whose
    uniqueness or acceptance differs between the two packages' inputs: this
    package's ``_slide_zsad`` run on each package's map, anchor pose and
    motion-model chain (which reproduce each package's follower poses)."""
    import tempfile

    import torch

    import jax.numpy as jnp

    import tpuslam.frontend.pipeline as jpipe
    import tpuslam.kernels.align_direct as jad
    from tpuslam.system import System as JSystem
    from tpuslam_torch.frontend import pipeline as tpipe
    from tpuslam_torch.kernels import align_direct as tad
    from tpuslam_torch.kernels.stereo_direct import moving_mean, subpixel_argmin

    cam = bench.QVGA
    _, imgs = bench.bench_scene(n, cam)
    rec = {}

    def recording(name, real):
        def call(*a):
            out = real(*a)
            rec.setdefault(name, ([np_of(x) if hasattr(x, "shape") else x for x in a[:7]], np_of(out[5])))
            return out

        return call

    tcfg, mcfg = bench_configs()
    ts = tsystem.System(cam, sensor="stereo", loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device="cpu")
    real_t, real_j = tpipe._fused_chunk_semidirect, jpipe._fused_chunk_semidirect
    tpipe._fused_chunk_semidirect = recording("port", real_t)
    jpipe._fused_chunk_semidirect = recording("jax", real_j)
    try:
        with tempfile.TemporaryDirectory() as d, jax_native_library(d), JaxWithMirror():
            jt, jm = jax_bench_config()
            js = JSystem(_jax_cam(cam), sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=jt, mapper_cfg=jm)
            for f, (il, ir) in enumerate(imgs[:8]):
                ts.track_stereo(il, ir, f * 0.05)
                js.track_stereo(il, ir, f * 0.05)
            ts.shutdown()
            js.shutdown()
    finally:
        tpipe._fused_chunk_semidirect, jpipe._fused_chunk_semidirect = real_t, real_j
    a, b = ts.map.keyframes[0].features, js.map.keyframes[0].features
    v = np.asarray(b.valid) > 0.5
    gap = lambda name: np.abs(np_of(getattr(a, name)) - np.asarray(getattr(b, name)))[v]  # noqa: E731
    ep = gap("endpoints").reshape(int(v.sum()), -1).max(axis=1)
    print(f"frame 0: {int(v.sum())} segments; endpoints up to {ep.max():.3g} px apart (segment {int(np.nonzero(v)[0][ep.argmax()])}), "
          f"angles up to {gap('angle').max():.3g} rad", flush=True)
    (P, prow), (J, jrow) = rec["port"], rec["jax"]
    ap = tad.inject_coord_scale_align(tad.DirectAlignParams(), tcfg.frontend.base_scale, tcfg.frontend.prescaled)
    A = ap.align_cap
    valid = P[6][:A] > 0.5
    print(f"map lines (first {A}): endpoints up to {np.abs(P[4][:A] - J[4][:A])[valid].max():.3g} m apart; anchor poses "
          f"{_pose_gap(prow[0, :16].reshape(4, 4), jrow[0, :16].reshape(4, 4))} (rad, m)", flush=True)
    frames = tpipe._frames01(torch.from_numpy(P[0]))

    def side(args, rows):
        pl, ep3d, val = (torch.from_numpy(np.asarray(args[i][:A], np.float32).copy()) for i in (3, 4, 6))
        return pl, tad.anchor_templates_body(frames[0], torch.from_numpy(rows[0, :16].reshape(4, 4).copy()), ep3d, val, cam, ap)

    def rounds(pl, tm, T, img):
        out, img255 = [], img * 255.0
        for _ in range(ap.rounds):
            _, uv = tad._project(T, tm.p3d, cam)
            uv = uv * ap.coord_scale
            M, Wt = 2 * ap.search + 1, ap.template
            win, inb = tad._axis_window(img255, uv[..., 0], uv[..., 1], tm.vert[:, None], M - 1 + Wt, -(ap.search + Wt // 2))
            mwin, mt = moving_mean(win, Wt), tm.tmpl.mean(-1, keepdim=True)
            cost = sum(torch.abs((win[..., w : w + M] - mwin) - (tm.tmpl[..., w : w + 1] - mt)) for w in range(Wt)) / float(Wt)
            cost = cost + (1.0 - (moving_mean(inb.float(), Wt) > 0.999).float()) * 1e6
            best, cbest, uniq, _ = subpixel_argmin(cost, ap.ratio)
            near = (torch.arange(M)[None, None, :] - best[..., None]).abs() <= 2
            second = torch.min(cost + near * 1e6, dim=-1).values
            m, ok = tad._search_templates(img255, T, tm, cam, ap)
            out.append((cbest / second, uniq, ok))
            T, _ = tad._gn_pose(T, pl, m, ok, cam, ap)
        return out, T

    (tpl, ttm), (jpl, jtm) = side(P, prow), side(J, jrow)
    print(f"anchor templates: up to {float((ttm.tmpl - jtm.tmpl).abs().max()):.3g} apart (0..255)", flush=True)
    for k in range(1, len(prow)):
        pred = lambda rows, Tl0: torch.from_numpy(  # noqa: E731
            (rows[k - 1, :16].reshape(4, 4) @ np.linalg.inv(rows[k - 2, :16].reshape(4, 4) if k > 1 else Tl0)
             @ rows[k - 1, :16].reshape(4, 4)).astype(np.float32)
        )
        tr, Tt = rounds(tpl, ttm, pred(prow, P[2]), frames[k + 1])
        jr, Tj = rounds(jpl, jtm, pred(jrow, J[2]), frames[k + 1])
        # both packages' follower on this package's inputs (test_torch_align_direct's comparison)
        same = [x.numpy() for x in (frames[k + 1], pred(prow, P[2]), tpl)]
        T_ref = jad.align_frame(*map(jnp.asarray, same), jad.AlignTemplates(*(jnp.asarray(x.numpy()) for x in ttm)),
                                _jax_cam(cam), jad.DirectAlignParams(**ap._asdict()))[0]
        print(f"frame {k + 1}: pose gap {_pose_gap(prow[k, :16].reshape(4, 4), jrow[k, :16].reshape(4, 4))} (rad, m); "
              f"on identical inputs {_pose_gap(Tt.numpy(), np.asarray(T_ref))}; reconstructed within "
              f"{_pose_gap(Tt.numpy(), prow[k, :16].reshape(4, 4))[1]:.2g} / {_pose_gap(Tj.numpy(), jrow[k, :16].reshape(4, 4))[1]:.2g} m",
              flush=True)
        for r, ((rt, ut, okt), (rj, uj, okj)) in enumerate(zip(tr, jr)):
            for line, sample in (ut != uj).nonzero().tolist():
                print(f"  round {r + 1}: line {line} sample {sample}: ratio {float(rj[line, sample]):.5f} from the JAX "
                      f"package's inputs, {float(rt[line, sample]):.5f} from this package's (gate {ap.ratio}); accepted "
                      f"{bool(okj[line, sample])} / {bool(okt[line, sample])}", flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    if args[0] == "crossing":
        crossing_report()
        sys.exit(0)
    if args[0] == "gaps":
        # the 12-frame comparison of test_run_benchmark_matches_jax, frame by
        # frame, at the bench's VGA or under TPUSLAM_BENCH_CAM=qvga's camera
        gaps, kfs = pose_gaps(bench.QVGA if args[1] == "qvga" else bench.VGA)
        print(f"{args[1]}: keyframes at frames {kfs[0]} (port), {kfs[1]} (JAX)", flush=True)
        for f, ang, dist in gaps:
            print(f"frame {f}: {ang:.2e} rad, {dist:.2e} m", flush=True)
        sys.exit(0)
    if args[0] == "portseeds":
        # this package's run_benchmark(100, 6) on the CPU over noise seeds
        # k0..k1-1 (lines or hybrid), mirror on
        ates = []
        with bench_env(**({"POINTS": "1"} if args[1] == "hybrid" else {})):
            for k in range(int(args[2]), int(args[3])):
                out = bench.run_benchmark(frames=100, warmup=6, device="cpu", noise_seed=k, quiet=True)
                ates.append(out["ate_rmse"])
                print(f"port {args[1]}, noise seed {k}: keyframes at frames {out['keyframe_frames']}, ATE {ates[-1]!r}", flush=True)
        print(f"PORT_{args[1].upper()}_SEED_ATES_M[{args[2]}:{args[3]}] = {ates!r}", flush=True)
        sys.exit(0)
    points = args[0] == "hybrid"
    name = "JAX_HYBRID_BENCH100" if points else "JAX_BENCH100"
    if args[1:2] == ["seeds"]:
        ates = []
        for k in range(int(args[2]), int(args[3])):
            ate, kfs = jax_bench100(points, noise_seed=k)
            ates.append(ate)
            print(f"{args[0]}, noise seed {k}: keyframes at frames {kfs}, ATE {ate!r}", flush=True)
        print(f"{name}_SEED_ATES_M[{args[2]}:{args[3]}] = {ates!r}", flush=True)
    else:
        ate, kfs = jax_bench100(points)
        print(f"{args[0]}: keyframes at frames {kfs}", flush=True)
        print(f"{name}_ATE_M = {ate!r}", flush=True)
