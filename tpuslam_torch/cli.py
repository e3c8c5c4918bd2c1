"""Command-line interface (counterpart of ``tpuslam.cli``).

    python -m tpuslam_torch.cli run --dataset euroc --root <dir> --out traj.txt
    python -m tpuslam_torch.cli run --device cpu --dataset synthetic --root <dir>
    python -m tpuslam_torch.cli make-synthetic --root <dir> --frames 60
    python -m tpuslam_torch.cli eval --est traj.txt --gt groundtruth.txt

``run --device`` picks the torch device (it replaces the JAX CLI's
``--platform``), the card by default; without a card ``cuda`` raises and
``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_sequence(args):
    from tpuslam_torch.io import datasets

    if args.dataset == "tum":
        return datasets.load_tum(args.root)
    if args.dataset == "euroc":
        return datasets.load_euroc(args.root)
    if args.dataset == "kitti":
        return datasets.load_kitti(args.root, args.kitti_seq)
    if args.dataset == "synthetic":
        return datasets.load_synthetic(args.root)
    raise SystemExit(f"unknown dataset {args.dataset}")


def cmd_run(args):
    from tpuslam_torch.device import resolve_device
    from tpuslam_torch.eval.ate import absolute_trajectory_error
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.system import System

    device = resolve_device(args.device)
    seq = _load_sequence(args)
    stereo = seq.cam.baseline > 0 and not args.mono
    tracker_cfg = None
    if args.fast and stereo:
        # the bench fast path: prescaled half-res ingest, direct epipolar
        # stereo (left-only detection), semi-direct chunks (full detection
        # on anchors only, photometric alignment between)
        from tpuslam_torch.frontend.frame import FrontendParams
        from tpuslam_torch.kernels.align_direct import DirectAlignParams
        from tpuslam_torch.kernels.stereo_direct import DirectStereoParams

        tracker_cfg = TrackerConfig(
            pipelined=True,
            chunk=max(2, args.chunk),
            frontend=FrontendParams(base_scale=0.5, prescaled=True),
            direct_stereo=DirectStereoParams(),
            semidirect=DirectAlignParams(),
        )
    elif args.pipelined:
        tracker_cfg = TrackerConfig(pipelined=True)
    sys_ = System(
        seq.cam,
        sensor="stereo" if stereo else "mono",
        loop_closing=not args.no_loop,
        log_path=args.log,
        tracker_cfg=tracker_cfg,
        device=device,
    )
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    prof = None
    if args.profile:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    for i, (ts, left, right) in enumerate(seq.frames()):
        if i >= n:
            break
        if stereo:
            sys_.track_frame((left, right), ts)
        else:
            sys_.track_frame(left, ts)
        if args.verbose and i % 20 == 0 and sys_.trajectory:
            r = sys_.trajectory[-1]
            print(
                f"[{i}/{n}] state={r.state.name} inliers={r.n_inliers} "
                f"kfs={len(sys_.map.keyframes)} lines={len(sys_.map.lines.live_ids())}",
                file=sys.stderr,
            )
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    # resolve the frames still in flight before writing outputs, so the
    # saved trajectory and the evaluation cover every frame
    sys_.shutdown()
    if args.plots:
        from tpuslam_torch.viz import plot_map, plot_trajectory

        os.makedirs(args.plots, exist_ok=True)
        est = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in sys_.trajectory])
        plot_trajectory(est, seq.gt_positions, os.path.join(args.plots, "trajectory.png"), seq.name)
        plot_map(sys_.map, os.path.join(args.plots, "map.png"))
    if args.out:
        if args.dataset == "kitti":
            sys_.save_trajectory_kitti(args.out)
        else:
            sys_.save_trajectory_tum(args.out)
    if args.save_map:
        sys_.save_map(args.save_map)
    summary = dict(
        frames=n,
        fps=n / wall,
        wall_s=wall,
        keyframes=len(sys_.map.keyframes),
        lines=len(sys_.map.lines.live_ids()),
        loops=len(sys_.loop_closer.closed_loops) if sys_.loop_closer else 0,
        timing=sys_.timing_summary(),
    )
    if seq.gt_positions is not None:
        est_pos = np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in sys_.trajectory])
        ts = np.asarray([r.timestamp for r in sys_.trajectory])
        ate = absolute_trajectory_error(est_pos, seq.gt_positions, ts, seq.gt_timestamps, with_scale=not stereo)
        summary["ate_rmse"] = ate.rmse
        summary["ate_n"] = ate.n
    print(json.dumps(summary, default=float))


def cmd_make_synthetic(args):
    from tpuslam_torch.io.datasets import write_synthetic_dataset

    write_synthetic_dataset(args.root, n_frames=args.frames, seed=args.seed, stereo=not args.mono, n_segments=args.segments)
    print(f"wrote synthetic dataset to {args.root}")


def cmd_eval(args):
    from tpuslam_torch.eval.ate import absolute_trajectory_error
    from tpuslam_torch.io.trajectory import load_trajectory_tum

    t_e, p_e = load_trajectory_tum(args.est)
    t_g, p_g = load_trajectory_tum(args.gt)
    ate = absolute_trajectory_error(p_e, p_g, t_e, t_g, with_scale=args.scale)
    print(json.dumps(ate._asdict()))


def cmd_bench(args):
    from tpuslam_torch.bench import run_benchmark

    run_benchmark(frames=args.frames, warmup=args.warmup, device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpuslam-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run SLAM on a sequence")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (the card unless cpu is asked for)")
    r.add_argument("--dataset", choices=["tum", "euroc", "kitti", "synthetic"], required=True)
    r.add_argument("--root", required=True)
    r.add_argument("--kitti-seq", default="00")
    r.add_argument("--out", default="")
    r.add_argument("--log", default=None)
    r.add_argument("--save-map", default="")
    r.add_argument("--max-frames", type=int, default=0)
    r.add_argument("--mono", action="store_true")
    r.add_argument("--no-loop", action="store_true")
    r.add_argument("--verbose", action="store_true")
    r.add_argument("--plots", default="", help="write trajectory/map PNGs here")
    r.add_argument(
        "--profile",
        default="",
        help="write a torch.profiler Chrome trace (trace.json) of the tracking loop here, "
        "with the program's spans of its host stages (track, tick, local_mapping, mp.*, tracking.*, local_ba.*)",
    )
    r.add_argument("--pipelined", action="store_true", help="one-frame-lagged latency-hiding tracking")
    r.add_argument(
        "--fast",
        action="store_true",
        help="bench fast path (stereo): half-res prescaled ingest, direct epipolar stereo, semi-direct chunks",
    )
    r.add_argument("--chunk", type=int, default=6, help="frames per chunk for --fast")
    r.set_defaults(fn=cmd_run)

    m = sub.add_parser("make-synthetic", help="write a synthetic dataset")
    m.add_argument("--root", required=True)
    m.add_argument("--frames", type=int, default=60)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--segments", type=int, default=120)
    m.add_argument("--mono", action="store_true")
    m.set_defaults(fn=cmd_make_synthetic)

    e = sub.add_parser("eval", help="ATE between two TUM trajectories")
    e.add_argument("--est", required=True)
    e.add_argument("--gt", required=True)
    e.add_argument("--scale", action="store_true")
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("bench", help="tracking FPS benchmark")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (the card unless cpu is asked for)")
    b.add_argument("--frames", type=int, default=100)
    b.add_argument("--warmup", type=int, default=5)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
