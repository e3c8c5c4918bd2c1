"""The loop-closure warm-up at System start (torch).

Counterpart of ``tpuslam.warmup.warm_loop_programs``, the one function of
that module the port carries: the others fill XLA compile caches, which
have no counterpart here. On the card the first essential-graph solve and
the first post-RANSAC refinement of a process pay a one-time set-up (the
batched solvers' library handles, the caching allocator's first blocks,
lazily loaded kernels), which otherwise lands on the first loop closure.
:func:`warm_loop_programs` pays it at toy size when the System starts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpuslam_torch.device import resolve_device


def warm_loop_programs(cam, mono: bool = False, refine_cap: int = 256, device="cuda") -> dict:
    """One essential-graph solve at the loop closer's smallest padding
    bucket (``loop_closing.GRAPH_BUCKET``; SE(3), or Sim(3) for ``mono``)
    and one pose-LM refinement at ``refine_cap`` with both landmark
    families, as the loop closer's refinement passes them; inputs drawn
    from ``np.random.default_rng(0)`` as the JAX package draws them. Each
    solve ends in a host read of its result. It touches no map, database or
    global generator. Returns the seconds of each, {"pose_graph_s": s,
    "loop_refine_s": s}."""
    from tpuslam_torch.backend import pose_graph, pose_opt
    from tpuslam_torch.backend.loop_closing import GRAPH_BUCKET

    P, E = GRAPH_BUCKET
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    free = np.ones(P, np.float32)
    free[0] = 0.0
    e_i = rng.integers(0, P, E).astype(np.int32)
    e_j = ((e_i + 1) % P).astype(np.int32)
    args = (
        f32(np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))), f32(free),
        torch.as_tensor(e_i, device=dev), torch.as_tensor(e_j, device=dev),
        f32(np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))), f32(np.ones(E)), f32(np.ones(E)),
    )
    t0 = time.perf_counter()
    if mono:
        out, _ = pose_graph.optimize_pose_graph_sim3(pose_graph.Sim3GraphProblem(*args), pose_graph.PoseGraphConfig())
    else:
        out, _ = pose_graph.optimize_pose_graph(pose_graph.PoseGraphProblem(*args), pose_graph.PoseGraphConfig())
    out.cpu()
    graph_s = time.perf_counter() - t0

    C = refine_cap
    lines = f32(rng.standard_normal((C, 6)))
    endpoints = f32(rng.uniform(0, cam.height, (C, 2, 2)))
    points = f32(rng.standard_normal((C, 3)) + [0, 0, 6.0])
    uv = f32(rng.uniform(0, cam.height, (C, 2)))
    ones = f32(np.ones(C))
    t0 = time.perf_counter()
    res = pose_opt.pose_optimize(
        f32(np.eye(4)), lines, endpoints, ones, cam, pose_opt.PoseOptConfig(), l_sigma=ones,
        points=points, p_uv=uv, p_valid=ones,
    )
    res.pose.cpu()
    return {"pose_graph_s": graph_s, "loop_refine_s": time.perf_counter() - t0}
