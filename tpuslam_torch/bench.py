"""Tracking benchmark (counterpart of ``tpuslam/bench.py``).

    python -m tpuslam_torch.bench [--device {cuda,cpu}]     # 100 frames after 6 warmup frames
    python -m tpuslam_torch.bench --ba [--device {cuda,cpu}] # local-BA solves on two toy rungs
    python -m tpuslam_torch.cli bench --frames 100 --warmup 6

:func:`run_benchmark` renders the JAX bench's scene (640x480, fx 458,
baseline 0.11 m, 140 segments, image noise 1, seed 0) with this package's
numpy renderer, runs ``System(cam, sensor="stereo", loop_closing=False)``
in the JAX bench's configuration (``system.bench_configs``: pipelined
semi-direct chunks of 6 frames, direct stereo on host-halved frames, local
BA on the two-rung ladder) and prints one JSON line per finished stage: the
first right after the timed loop, each later one with more fields. The
last line holds ``fps_wall`` (frames over the wall time of the steady
frames, the final flush included), ``ate_rmse`` and ``local_ba_ms`` (the
median local-BA solve), BASELINE.json's three metrics.

The JAX bench's switches are read under their JAX names:
``TPUSLAM_BENCH_FRAMES``, ``_CAM`` (``qvga``), ``_NOMAP``, ``_FORCE_NOMAP``,
``_PIPELINED``, ``_DIRECT``, ``_HALFRES``, ``_HOSTSCALE``, ``_CHUNK``,
``_SEMIDIRECT``, ``_POINTS``, ``_FUSEDEFER`` (default 1: the fusion's apply
deferred to the mapper's tick), ``_PRETOUCH_OVERLAP``, ``_DEVFEED``,
``_PROFILE`` and ``_ATE_REF``, and ``TPUSLAM_BA_WARM_CAPS`` (the local-BA
rungs, default :data:`BA_RUNGS`). On the card ``System`` solves local BA in
its solver process (``backend.ba_worker``; TPUSLAM_BA_SUBPROCESS=0 solves
in this process), as the JAX bench runs on its chip: the solver's
pretouches (a toy solve per rung) are enqueued before the kernel library
is built and collected before the timed loop. With
TPUSLAM_BA_SUBPROCESS=0 TPUSLAM_BENCH_FUSEDEFER=0 the bench runs the
synchronous configuration, the toy solves in this process. Not read,
because what they steer is not in this package: the JAX package's compile
warmup and the repo-root ``bench.py``'s time budget (``_WARMUP``,
``_WARMUP_S``, ``_BA_WARM_S``, ``_SUB_BUDGET``, ``_FAKE_HANG``).

Entry points run on the card unless ``device="cpu"`` is passed; without a
card the default raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from tpuslam_torch.device import resolve_device
from tpuslam_torch.geometry.camera import Intrinsics

VGA = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
QVGA = Intrinsics(fx=229.0, fy=228.5, cx=160.0, cy=120.0, width=320, height=240, baseline=0.11)
# the local-BA rungs bench_configs gives the mapper, (P, L, OL)
BA_RUNGS = ((8, 128, 512), (16, 256, 1024))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_switches(env=None) -> dict:
    """The JAX bench's switches read from ``env`` (default ``os.environ``):
    ``mapping`` and the keyword arguments of ``system.bench_configs``."""
    env = os.environ if env is None else env

    def on(name: str, default: str = "1") -> bool:
        return env.get(f"TPUSLAM_BENCH_{name}", default) == "1"

    return dict(
        mapping=not (on("NOMAP", "0") or on("FORCE_NOMAP", "0")),
        chunk=int(env.get("TPUSLAM_BENCH_CHUNK", "6")),
        points=on("POINTS", "0"),
        pipelined=on("PIPELINED"),
        direct=on("DIRECT"),
        halfres=on("HALFRES"),
        hostscale=on("HOSTSCALE"),
        semidirect=on("SEMIDIRECT"),
        fuse_defer=on("FUSEDEFER"),
    )


def ba_rungs(env=None) -> tuple:
    """The local-BA (P, L, OL) rungs: TPUSLAM_BA_WARM_CAPS
    ("P,L,OL;P,L,OL;..."), as the JAX bench reads them, else BA_RUNGS."""
    from tpuslam_torch.backend.ba_worker import parse_caps

    env = os.environ if env is None else env
    text = env.get("TPUSLAM_BA_WARM_CAPS")
    return BA_RUNGS if text is None else parse_caps(text)


@contextlib.contextmanager
def _env_defaults(**values):
    """os.environ with ``values`` set where unset, restored on exit."""
    added = [k for k in values if k not in os.environ]
    for k in added:
        os.environ[k] = values[k]
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def bench_scene(n_frames: int, cam: Intrinsics, noise_seed: Optional[int] = None):
    """The JAX bench's scene (seed 0) and its rendered (left, right) uint8
    frames, its points drawn as dots under TPUSLAM_BENCH_POINTS=1; with
    ``noise_seed`` the image noise is drawn from that seed instead of the
    scene's generator (the same scene and trajectory)."""
    from tpuslam_torch.io.synthetic import make_wireframe_scene, render_wireframe_image

    rng = np.random.default_rng(0)
    scene = make_wireframe_scene(rng, n_segments=140, n_frames=n_frames, cam=cam, motion_scale=0.02)
    Tb = np.eye(4, dtype=np.float32)
    Tb[0, 3] = -cam.baseline
    scene_r = scene._replace(poses=np.stack([Tb @ T for T in scene.poses]))
    # hybrid points (TPUSLAM_BENCH_POINTS=1) track the scene's points drawn
    # as dots; the JAX bench draws none (its corners are line junctions)
    draw_points = os.environ.get("TPUSLAM_BENCH_POINTS", "0") == "1"
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
    imgs = [
        (
            render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=draw_points),
            render_wireframe_image(scene_r, f, noise=1.0, rng=rng, draw_points=draw_points),
        )
        for f in range(n_frames)
    ]
    return scene, imgs


def _card(dev: torch.device):
    """(device name, power limit in W or None)."""
    if dev.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(dev)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[dev.index or 0]
        return name, float(line.rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return name, None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _toy_solve_s(cam: Intrinsics, rung, cfg, dev: torch.device) -> float:
    """Seconds to build and solve ``parallel.sharded_ba._toy_problem`` at
    ``rung`` with ``run_lm``, ending in a host read of the cost."""
    from tpuslam_torch.backend.lm import run_lm
    from tpuslam_torch.parallel.sharded_ba import _toy_problem

    t0 = time.perf_counter()
    P_, L_, OL_ = rung
    float(run_lm(_toy_problem(np.random.default_rng(0), P_=P_, L=L_, OL=OL_, cam=cam, device=dev), cam, cfg).cost)
    return time.perf_counter() - t0


def run_benchmark(frames: int = 100, warmup: int = 5, quiet: bool = False, device="cuda", noise_seed=None) -> Dict:
    """Track ``frames`` timed frames after ``warmup`` untimed ones (the JAX
    bench's ``run_benchmark``); returns the result dict, printed as a JSON
    line after each stage unless ``quiet``. ``noise_seed`` draws the image
    noise from its own seed (None: the JAX bench's stream).

    Warmup, before the timed loop: with the solver process, one pretouch
    per rung is enqueued there (``pretouch_s``, keyed like the JAX
    bench's: each rung's first toy solve), then the kernel library is built
    and loaded (on the card), then the pretouches are collected (with
    TPUSLAM_BENCH_PRETOUCH_OVERLAP=0 they are enqueued only then);
    without it, one toy problem per rung is solved here. Then the 1 MiB
    upload probe (``wire_mbps``). Besides the JAX bench's fields the result
    holds ``power_limit_w``, ``keyframe_frames`` (frame indices),
    ``keyframe_call_ms`` (the timed calls that ran a keyframe event),
    ``ba_worker`` and ``fuse_defer`` (the configuration), ``ba_failed``,
    ``native_map`` (the map's native graph mirror in use), ``tracked_ok``
    (trajectory entries, one per frame in order, that tracked OK) and
    ``extractions`` (the detector's runs: chunk anchors, anchors dispatched
    again at the flush, synchronous frames, device-feed programs)."""
    from tpuslam_torch.system import System, bench_configs

    frames = int(os.environ.get("TPUSLAM_BENCH_FRAMES", frames))
    dev = resolve_device(device)
    cam = QVGA if os.environ.get("TPUSLAM_BENCH_CAM", "vga") == "qvga" else VGA
    n_scene_frames = max(frames + warmup, 8)
    scene, imgs = bench_scene(n_scene_frames, cam, noise_seed)
    _log(f"bench: {n_scene_frames} frames rendered; warming up...")

    sw = bench_switches()
    mapping = sw.pop("mapping")
    tcfg, mcfg = bench_configs(**sw)
    rungs = ba_rungs()
    mcfg.ba = mcfg.ba._replace(
        pose_buckets=tuple(r[0] for r in rungs), line_buckets=tuple(r[1] for r in rungs), obs_buckets=tuple(r[2] for r in rungs)
    )
    # the solver's warm rungs are the ladder's; the bench's pretouches warm them
    with _env_defaults(TPUSLAM_BA_WARM_CAPS=";".join(",".join(map(str, r)) for r in rungs), TPUSLAM_BA_WORKER_WARMUP="0"):
        sys_ = System(cam, sensor="stereo", loop_closing=False, mapping=mapping, tracker_cfg=tcfg, mapper_cfg=mcfg, device=dev)
    worker = sys_._ba_worker
    ba = mcfg.ba
    pt_reqs = {}
    if worker is not None and os.environ.get("TPUSLAM_BENCH_PRETOUCH_OVERLAP", "1") == "1":
        pt_reqs = {r: worker.pretouch_async(r, ba.lm, ba.chi2_line, ba.chi2_point) for r in worker.warm_caps}
        _log(f"bench: {len(pt_reqs)} BA solver pretouches enqueued")
    t_wu = time.perf_counter()
    if dev.type == "cuda":
        from tpuslam_torch.kernels import cuda_lib

        cuda_lib.build()
        cuda_lib.library()
    warmup_s = time.perf_counter() - t_wu
    _log(f"bench: kernel library built and loaded in {warmup_s:.3f} s")
    pretouch_s: Dict[str, float] = {}
    if worker is not None:
        for rung in worker.warm_caps:
            rid = pt_reqs[rung] if rung in pt_reqs else worker.pretouch_async(rung, ba.lm, ba.chi2_line, ba.chi2_point)
            out_pt = worker.pretouch_wait(rid, timeout=300.0)
            if out_pt is None:
                raise RuntimeError(f"bench: the BA solver's pretouch of {rung} gave no result in 300 s")
            pretouch_s["x".join(map(str, rung))] = out_pt[0] / 1e3
            _log(f"bench: solver pretouch {rung}: {out_pt[0]:.1f} ms (a second toy solve {out_pt[1]:.1f} ms)")
    elif mapping:
        for rung in rungs:
            pretouch_s["x".join(map(str, rung))] = s = _toy_solve_s(cam, rung, ba.lm, dev)
            _log(f"bench: toy local-BA solve {rung}: {s:.3f} s")
    probe = torch.zeros(1 << 20, dtype=torch.uint8)
    wire_mbps = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        probe.to(dev, copy=True)
        _sync(dev)
        wire_mbps = max(wire_mbps, 1.0 / max(time.perf_counter() - t0, 1e-9))
    _log(f"bench: host to device {wire_mbps:.1f} MB/s; tracking...")

    profiler = None
    if os.environ.get("TPUSLAM_BENCH_PROFILE"):  # the timed loop alone
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    times = []
    kf_call_ms = []
    t_wall0 = None
    for f in range(n_scene_frames):
        il, ir = imgs[f]
        n_events = sys_.timer.counts.get("local_mapping", 0)
        t0 = time.perf_counter()
        if f == warmup:
            _sync(dev)
            t_wall0 = t0 = time.perf_counter()
        sys_.track_stereo(il, ir, f * 0.05)
        dt = time.perf_counter() - t0
        if f >= warmup:
            times.append(dt)
            if sys_.timer.counts.get("local_mapping", 0) > n_events:
                kf_call_ms.append(dt * 1e3)
        if f < warmup or f % 25 == 0:
            _log(f"bench: frame {f} {dt * 1e3:.1f} ms")
    # the frames still buffered or in flight are tracked inside the timed window
    t_flush0 = time.perf_counter()
    sys_.trajectory.extend(sys_.tracker.flush_all())
    _sync(dev)
    flush_ms = (time.perf_counter() - t_flush0) * 1e3
    wall = time.perf_counter() - t_wall0
    if profiler is not None:
        profiler.disable()
        profiler.dump_stats(os.environ["TPUSLAM_BENCH_PROFILE"])
        _log(f"bench: host profile -> {os.environ['TPUSLAM_BENCH_PROFILE']}")

    summary = sys_.timer.summary()
    med = float(np.median(times))
    name, power = _card(dev)
    tr = sys_.tracker
    out = dict(
        device=name,
        power_limit_w=power,
        frames=len(times),
        fps_median=1.0 / med,
        fps_mean=float(1.0 / np.mean(times)),
        fps_wall=float(len(times) / wall),
        track_ms_median=med * 1e3,
        local_ba_ms=summary.get("local_mapping", {}).get("median_ms", 0.0),
        keyframes=len(sys_.map.keyframes),
        keyframe_frames=sorted(r.frame_idx for r in sys_.trajectory if r.made_keyframe),
        keyframe_call_ms=kf_call_ms,
        ba_worker=worker is not None,
        fuse_defer=mcfg.fuse_defer,
        lines=len(sys_.map.lines.live_ids()),
        native_map=sys_.map.lines.mirror is not None,
        warmup_s=warmup_s,
        pretouch_s=pretouch_s,
        pretouch_total_s=sum(pretouch_s.values()),
        stage_ms={k: (v["median_ms"], v["mean_ms"] * v["n"], v["n"]) for k, v in summary.items()},
        track_sum_ms=float(np.sum(times)) * 1e3,
        flush_ms=flush_ms,
        wire_mbps=wire_mbps,
    )

    def emit():
        # every line is a whole result; a reader takes the last
        if not quiet:
            print(json.dumps(out, default=float), flush=True)

    emit()
    n_feed = 0
    if os.environ.get("TPUSLAM_BENCH_DEVFEED", "1") == "1":
        out["fps_device_feed"], n_feed = _device_feed_fps(sys_, imgs)
        emit()

    sys_.shutdown()
    from tpuslam_torch.eval.ate import absolute_trajectory_error

    traj = sorted(sys_.trajectory, key=lambda r: r.frame_idx)
    in_order = [r.frame_idx for r in traj] == list(range(n_scene_frames))
    out["tracked_ok"] = sum(r.state.name == "OK" for r in traj) if in_order else 0
    out["extractions"] = dict(
        anchors=len(tr.anchor_frames), flush=len(tr.flush_frames), synchronous=tr.n_sync_extractions, device_feed=n_feed
    )
    if traj:
        est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in traj])
        gt = np.stack([np.linalg.inv(scene.poses[r.frame_idx])[:3, 3] for r in traj])
        out["ate_rmse"] = float(absolute_trajectory_error(est, gt).rmse)
        ref = float(os.environ.get("TPUSLAM_BENCH_ATE_REF", "0.024"))
        out["ate_ok"] = bool(out["ate_rmse"] <= 1.5 * ref)
        if not out["ate_ok"]:
            _log(f"bench: ACCURACY REGRESSION: ate {out['ate_rmse']:.4f} > 1.5 x ref {ref:.4f}")
    if sys_.mapper is not None:
        # the solver's own solve times (warm ones), as the JAX bench reports them
        mp_ = sys_.mapper
        if mp_.solve_ms:
            out["local_ba_ms"] = float(np.median(mp_.solve_ms))
            out["local_ba_ms_by_rung"] = {"x".join(map(str, k)): float(np.median(v)) for k, v in mp_.solve_ms_by_rung.items()}
        elif mp_.cold_solve_ms:
            out["local_ba_ms"] = float(np.min(mp_.cold_solve_ms))
            out["local_ba_cold"] = True
        # in this process every solve is counted as submitted
        out["ba_submitted"] = mp_.ba_submitted if worker is not None else len(mp_.solve_ms)
        out.update(ba_skipped=mp_.ba_skipped, ba_resubmitted=mp_.ba_resubmitted, ba_stale=mp_.ba_stale, ba_failed=mp_.ba_failed)
        if mp_.last_stage_ms:
            out["local_ba_stage_ms"] = dict(mp_.last_stage_ms)
    emit()
    return out


def _device_feed_fps(sys_, imgs, n: int = 40):
    """Frames per second of the tracking program on frames already on the
    device: the chunk program (the single-frame program when the tracker
    is not in chunks) dispatched over the uploaded frames from the
    tracker's last pose chain and local map, each program's packed rows
    read back two programs behind. It isolates the program from the
    host's uploads, the resolve and mapping. Returns (frames/s, programs
    dispatched)."""
    from tpuslam_torch.frontend.frame import host_prescale
    from tpuslam_torch.frontend.pipeline import fused_stereo_frame, fused_stereo_semidirect, fused_stereo_semidirect_hybrid

    tr = sys_.tracker
    if tr.state.name != "OK":
        return 0.0, 0
    c = tr.cfg
    fe = c.frontend
    dev = tr.device
    chain = tr._dev_chain
    if chain is None:  # a flushed tracker: from the host pose
        T_last = np.asarray(tr.T_cw, np.float32)
        vel_inv = np.linalg.inv(tr.velocity).astype(np.float32)
        chain = (tr._pose_tensor(T_last), tr._pose_tensor(vel_inv @ T_last))
    local = tr._local_map_arrays()
    pend = deque()
    if tr._use_semidirect():
        C = tr._chunk_size()

        def stack(i):
            fr = [host_prescale(imgs[i % len(imgs)][0], fe), host_prescale(imgs[i % len(imgs)][1], fe)]
            fr += [host_prescale(imgs[(i + j) % len(imgs)][0], fe) for j in range(1, C)]
            return torch.from_numpy(np.ascontiguousarray(np.stack(fr))).to(dev)

        stacks = [stack(i * C) for i in range(6)]
        if c.points is not None:
            plocal = tr._point_local_arrays()

            def program(frames, T0, T1):
                return fused_stereo_semidirect_hybrid(
                    frames, T0, T1, local, plocal, tr._fxb, tr.cam, fe, c.search_coarse, c.search_fine, c.pose_opt,
                    c.min_track_inliers, tr._direct_lines(), tr._direct_points(), c.points, tr._align_params(),
                )
        else:

            def program(frames, T0, T1):
                return fused_stereo_semidirect(
                    frames, T0, T1, local, tr._fxb, tr.cam, fe, c.search_coarse, c.search_fine, c.pose_opt,
                    c.min_track_inliers, tr._direct_lines(), tr._align_params(),
                )

        inputs, per_program, n_programs = stacks, C, max(4, n // C)
    else:
        inputs = [
            torch.from_numpy(np.ascontiguousarray(np.stack([host_prescale(im, fe) for im in imgs[i % len(imgs)]]))).to(dev)
            for i in range(8)
        ]

        def program(pair, T0, T1):
            return fused_stereo_frame(
                pair, T0, T1, local, tr._fxb, tr.cam, fe, c.stereo, c.search_coarse, c.search_fine, c.pose_opt,
                c.min_track_inliers, sd=tr._direct_lines(),
            )

        per_program, n_programs = 1, n
    out = program(inputs[0], *chain)  # first dispatch, untimed
    out.packed.cpu()
    t0 = time.perf_counter()
    for i in range(n_programs):
        out = program(inputs[i % len(inputs)], *chain)
        chain = (out.T_last, out.T_prevlast)
        pend.append(out)
        if len(pend) > 2:
            pend.popleft().packed.cpu()  # the host's resolve, two programs behind
    while pend:
        pend.popleft().packed.cpu()
    dt = (time.perf_counter() - t0) / (n_programs * per_program)
    _log(f"bench: device feed {1.0 / dt:.2f} frames/s ({dt * 1e3:.2f} ms/frame, {per_program} frames per program)")
    return 1.0 / dt, n_programs + 1


def run_ba_benchmark(quiet: bool = False, device="cuda") -> Dict:
    """Local-BA solve times on ``parallel.sharded_ba._toy_problem`` at the
    two rungs (the JAX bench's ``run_ba_benchmark``): per rung the first
    solve (``ba_first_s_...``) and the mean of 5 more (``ba_ms_...``), each
    ``run_lm`` with 8 iterations ending in a host read of its cost
    (``ba_cost_...``, the final robust cost)."""
    from tpuslam_torch.backend.lm import LMConfig, run_lm
    from tpuslam_torch.parallel.sharded_ba import _toy_problem

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out: Dict = {"device": _card(dev)[0]}
    for P_, L_, OL_ in BA_RUNGS:
        prob = _toy_problem(rng, P_=P_, L=L_, OL=OL_, cam=VGA, device=dev)
        t0 = time.perf_counter()
        cost = float(run_lm(prob, VGA, LMConfig(max_iters=8)).cost)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(5):
            float(run_lm(prob, VGA, LMConfig(max_iters=8)).cost)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        out[f"ba_ms_P{P_}_L{L_}"] = ms
        out[f"ba_first_s_P{P_}_L{L_}"] = first_s
        out[f"ba_cost_P{P_}_L{L_}"] = cost
        _log(f"ba bench {(P_, L_, OL_)}: first solve {first_s:.3f} s, then {ms:.2f} ms per solve")
    out["local_ba_ms"] = out["ba_ms_P8_L128"]
    if not quiet:
        print(json.dumps(out, default=float), flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m tpuslam_torch.bench")
    p.add_argument("--ba", action="store_true", help="time local-BA solves on two toy rungs instead")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (the card unless cpu is asked for)")
    args = p.parse_args(argv)
    if args.ba:
        run_ba_benchmark(device=args.device)
    else:
        run_benchmark(frames=int(os.environ.get("TPUSLAM_BENCH_FRAMES", "100")), warmup=6, device=args.device)


if __name__ == "__main__":
    main()
