"""Local bundle adjustment: window assembly, LM+Schur solve, write-back (torch).

Counterpart of ``tpuslam.backend.local_ba``: the window is the current
keyframe and its best covisible keyframes, the landmarks are their lines,
and the keyframes outside the window that observe those lines are held fixed
(as is the oldest window keyframe, the gauge). The host gathers the window
into padded buffers, ``backend.lm.run_lm`` solves it on the device, and the
result is written back with the chi2 prune and the divergence guard.

The problem is padded to a rung of the diagonal bucket ladder, as in the JAX
package: PyTorch needs no fixed shapes to avoid recompiles, but the rungs
keep the port's problems field for field equal to the JAX package's and the
shapes few enough for a captured CUDA graph later. The solve runs in this
process; the JAX package's subprocess worker is not carried over.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from tpuslam_torch.backend.lm import BAProblem, BAState, LMConfig, chi2_outlier_mask, run_lm
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.geometry.plucker import plucker_normalize
from tpuslam_torch.slammap.map import SlamMap


class LocalBAConfig(NamedTuple):
    window_size: int = 10
    max_fixed: int = 10
    pose_buckets: Tuple[int, ...] = (8, 16, 24)
    line_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    obs_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096)
    # the point and point-observation buckets come with hybrid points
    lm: LMConfig = LMConfig(max_iters=8)
    chi2_line: float = 7.378
    chi2_point: float = 5.991
    prune_outliers: bool = True
    min_obs_keep: int = 2
    # divergence guard: a solve whose final robust cost per observation
    # exceeds this is rejected (writing it back would poison the window);
    # the map keeps its state and loses only the observations that were
    # chi2 outliers at the initial state (the entries that blew it up)
    reject_cost_per_obs: float = 500.0


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_ladder(*bucket_lists: Tuple[int, ...]):
    """The diagonal of the per-axis bucket lists: rung i takes element i of
    each list (the last element repeated for shorter lists)."""
    n = max(len(b) for b in bucket_lists)
    return [tuple(b[min(i, len(b) - 1)] for b in bucket_lists) for i in range(n)]


def ladder_bucket(ns: Tuple[int, ...], *bucket_lists: Tuple[int, ...]):
    """Smallest diagonal rung covering every requested size (the last rung
    on overflow; callers truncate to capacity)."""
    rungs = bucket_ladder(*bucket_lists)
    for rung in rungs:
        if all(n <= c for n, c in zip(ns, rung)):
            return rung
    return rungs[-1]


class LocalBAStats(NamedTuple):
    n_poses: int
    n_fixed: int
    n_lines: int
    n_obs: int
    cost: float
    n_pruned: int


def build_problem(
    slam_map: SlamMap,
    window: List[int],
    fixed: List[int],
    line_ids: List[int],
    caps: Tuple[int, int, int],
    device="cpu",
) -> Tuple[BAProblem, List[int], List[int], np.ndarray, np.ndarray]:
    """Gather a padded BAProblem. Returns (problem, kf_order, line_order,
    obs_table (n_obs, 3) of [kf_pos, line_pos, feature_slot], p_obs_table
    (0, 3)). Observation rows follow the insertion order of the line store's
    observation dicts, as in the JAX package. The point blocks are the empty
    M = OP = 1 stubs of a line-only map (the point gather comes with hybrid
    points)."""
    P, L, OL = caps
    M, OP = 1, 1
    kf_order = window + fixed
    kf_pos = {k: i for i, k in enumerate(kf_order)}
    line_pos = {l: i for i, l in enumerate(line_ids)}
    st = slam_map.lines

    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    pose_free = np.zeros(P, np.float32)
    for k, i in kf_pos.items():
        poses[i] = slam_map.keyframes[k].T_cw
    # optimize window poses except the gauge anchor (oldest window KF)
    anchor = min(window)
    for k in window:
        if k != anchor:
            pose_free[kf_pos[k]] = 1.0

    lines = np.zeros((L, 6), np.float32)
    line_valid = np.zeros(L, np.float32)
    for l, i in line_pos.items():
        lines[i] = st.plucker[l]
        line_valid[i] = 1.0

    rows = []
    for l in line_ids:
        for kid, slot in st.obs.get(l, {}).items():
            if kid in kf_pos:
                rows.append((kf_pos[kid], line_pos[l], kid, slot))
    rows = rows[:OL]
    l_pose = np.zeros(OL, np.int32)
    l_line = np.zeros(OL, np.int32)
    l_ep = np.zeros((OL, 2, 2), np.float32)
    l_sigma = np.ones(OL, np.float32)
    l_valid = np.zeros(OL, np.float32)
    obs_table = np.zeros((len(rows), 3), np.int32)
    for r, (pi, li, kid, slot) in enumerate(rows):
        kf = slam_map.keyframes[kid]
        l_pose[r] = pi
        l_line[r] = li
        l_ep[r] = kf.features.endpoints[slot]
        l_sigma[r] = kf.features.sigma[slot]
        l_valid[r] = 1.0
        obs_table[r] = (pi, li, slot)

    def dev(a):
        return torch.from_numpy(a).to(device)

    prob = BAProblem(
        poses=dev(poses),
        pose_free=dev(pose_free),
        lines=dev(lines),
        line_valid=dev(line_valid),
        points=dev(np.zeros((M, 3), np.float32)),
        point_valid=dev(np.zeros(M, np.float32)),
        l_pose=dev(l_pose),
        l_line=dev(l_line),
        l_endpoints=dev(l_ep),
        l_valid=dev(l_valid),
        l_sigma=dev(l_sigma),
        p_pose=dev(np.zeros(OP, np.int32)),
        p_point=dev(np.zeros(OP, np.int32)),
        p_uv=dev(np.zeros((OP, 2), np.float32)),
        p_valid=dev(np.zeros(OP, np.float32)),
        p_sigma=dev(np.ones(OP, np.float32)),
    )
    return prob, kf_order, line_ids, obs_table, np.zeros((0, 3), np.int32)


def _project_endpoints_to_line(ep: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Move stored 3D endpoints onto the optimized Pluecker line (orthogonal
    projection) so matching stays consistent with the BA output."""
    n, v = L[:3], L[3:]
    vn = np.linalg.norm(v)
    if vn < 1e-9:
        return ep
    u = v / vn
    p0 = np.cross(v, n) / (vn * vn)
    t = (ep - p0) @ u
    return p0[None, :] + t[:, None] * u[None, :]


def assemble_problem(
    slam_map: SlamMap,
    center_kid: int,
    cam: Intrinsics,
    cfg: LocalBAConfig = LocalBAConfig(),
    device="cpu",
):
    """Gather the padded window problem on ``device``. Returns (BAProblem,
    ctx), ctx carrying what `apply_result` needs for the write-back."""
    window, line_ids = slam_map.local_window(center_kid, cfg.window_size)
    window = sorted(window)
    st = slam_map.lines
    # fixed KFs observe window lines but are not in the window; over
    # capacity, keep the most-observing ones
    window_set = set(window)
    fixed_counts: dict = {}
    for l in line_ids:
        for kid in st.obs.get(l, {}):
            if kid not in window_set and kid in slam_map.keyframes:
                fixed_counts[kid] = fixed_counts.get(kid, 0) + 1
    fixed = sorted(fixed_counts, key=lambda k: (-fixed_counts[k], k))[: cfg.max_fixed]
    fixed_kept = set(fixed)

    n_obs_est = sum(sum(1 for k in st.obs.get(l, {}) if k in window_set or k in fixed_kept) for l in line_ids)
    P, L, OL = ladder_bucket(
        (len(window) + len(fixed), len(line_ids), n_obs_est),
        cfg.pose_buckets, cfg.line_buckets, cfg.obs_buckets,
    )
    line_ids = line_ids[:L]

    prob, kf_order, line_order, obs_table, p_obs_table = build_problem(
        slam_map, window, fixed, line_ids, (P, L, OL), device=device
    )
    ctx = dict(
        window=window,
        fixed=fixed,
        kf_order=kf_order,
        line_order=line_order,
        point_ids=[],
        obs_table=obs_table,
        p_obs_table=p_obs_table,
        pose_free=prob.pose_free.cpu().numpy(),
    )
    return prob, ctx


def _prune_lines(slam_map: SlamMap, cfg: LocalBAConfig, ctx: dict, inl_l) -> int:
    """Erase the observations whose mask entry is 0, then kill the landmarks
    that lost one here and fell below ``min_obs_keep``. Only those: a fresh
    single-observation inlier line must survive to be re-observed (the
    recent-landmark cull in the mapper judges never-confirmed lines)."""
    st = slam_map.lines
    kf_order, line_order, obs_table = ctx["kf_order"], ctx["line_order"], ctx["obs_table"]
    touched: set = set()
    n_pruned = 0
    for r in range(obs_table.shape[0]):
        if inl_l[r] < 0.5:
            pi, li, _ = obs_table[r]
            kid = kf_order[pi]
            if kid not in slam_map.keyframes:
                continue
            lid = int(line_order[li])
            st.erase_observation(lid, slam_map.keyframes[kid])
            touched.add(lid)
            n_pruned += 1
    for lid in touched:
        if st.alive[lid] and st.n_obs[lid] < cfg.min_obs_keep:
            st.kill(lid, slam_map.keyframes)
    return n_pruned


def apply_result(slam_map: SlamMap, cfg: LocalBAConfig, ctx: dict, res: dict) -> LocalBAStats:
    """Write an LM+Schur result (numpy ``res``) back into the map, with the
    chi2 prune; a diverged solve (see LocalBAConfig.reject_cost_per_obs) is
    not written back and prunes only the initial-state outliers."""
    st = slam_map.lines
    window, fixed, kf_order, line_order = ctx["window"], ctx["fixed"], ctx["kf_order"], ctx["line_order"]
    n_obs_total = int(ctx["obs_table"].shape[0]) + int(ctx["p_obs_table"].shape[0])
    stats = dict(n_poses=len(window), n_fixed=len(fixed), n_lines=len(line_order), n_obs=n_obs_total, cost=res["cost"])

    if cfg.reject_cost_per_obs > 0 and res.get("cost", 0.0) > cfg.reject_cost_per_obs * max(1, n_obs_total):
        import sys

        print(
            f"local BA diverged (cost {res['cost']:.3g} over {n_obs_total} obs)"
            " — write-back rejected; pruning initial-state outliers only",
            file=sys.stderr,
        )
        n_pruned = 0
        if cfg.prune_outliers and "inl_l0" in res:
            n_pruned = _prune_lines(slam_map, cfg, ctx, np.asarray(res["inl_l0"]))
        return LocalBAStats(n_pruned=n_pruned, **stats)

    new_poses = res["poses"]
    for i, kid in enumerate(kf_order):
        if i < len(window) + len(fixed) and float(ctx["pose_free"][i]) > 0.5 and kid in slam_map.keyframes:
            slam_map.keyframes[kid].T_cw = new_poses[i]
    new_lines = res["lines"]
    for i, lid in enumerate(line_order):
        if st.alive[lid]:
            st.plucker[lid] = new_lines[i]
            st.endpoints[lid] = _project_endpoints_to_line(st.endpoints[lid], new_lines[i])

    n_pruned = 0
    if cfg.prune_outliers and "inl_l" in res:
        n_pruned = _prune_lines(slam_map, cfg, ctx, np.asarray(res["inl_l"]))
    return LocalBAStats(n_pruned=n_pruned, **stats)


def initial_chi2_masks(prob: BAProblem, cam: Intrinsics, chi2_line, chi2_point):
    """Chi2 inlier masks at the linearization point (pre-solve state): the
    divergence guard prunes against these."""
    state0 = BAState(
        poses=prob.poses,
        lines=plucker_normalize(prob.lines),
        points=prob.points,
        lam=torch.ones((), dtype=prob.poses.dtype, device=prob.poses.device),
        cost=torch.zeros((), dtype=prob.poses.dtype, device=prob.poses.device),
    )
    return chi2_outlier_mask(state0, prob, cam, chi2_line, chi2_point)


def solve_in_process(prob: BAProblem, cam: Intrinsics, cfg: LocalBAConfig) -> dict:
    """The LM+Schur solve and the chi2 masks on the problem's device, read
    back to numpy in one transfer."""
    state = run_lm(prob, cam, cfg.lm)
    parts = [state.poses, state.lines, state.points, state.cost]
    if cfg.prune_outliers:
        parts += [*chi2_outlier_mask(state, prob, cam, cfg.chi2_line, cfg.chi2_point)]
        parts += [*initial_chi2_masks(prob, cam, cfg.chi2_line, cfg.chi2_point)]
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out = []
    for p in parts:
        out.append(flat[: p.numel()].reshape(p.shape))
        flat = flat[p.numel():]
    res = dict(poses=out[0], lines=out[1], points=out[2], cost=float(out[3]))
    if cfg.prune_outliers:
        res["inl_l"], res["inl_p"], res["inl_l0"], res["inl_p0"] = out[4:]
    return res


def local_bundle_adjustment(
    slam_map: SlamMap,
    center_kid: int,
    cam: Intrinsics,
    cfg: LocalBAConfig = LocalBAConfig(),
    device="cpu",
    solve_ms_by_rung: Dict[tuple, List[float]] | None = None,
) -> LocalBAStats:
    """Synchronous windowed BA around `center_kid`: assemble, solve on
    ``device``, apply. Given ``solve_ms_by_rung``, the solve's wall ms
    (assembly excluded, read back included) is appended under the problem's
    (P, L, OL) rung."""
    prob, ctx = assemble_problem(slam_map, center_kid, cam, cfg, device=device)
    t0 = time.perf_counter()
    res = solve_in_process(prob, cam, cfg)  # ends in a read back
    if solve_ms_by_rung is not None:
        rung = (prob.poses.shape[0], prob.lines.shape[0], prob.l_pose.shape[0])
        solve_ms_by_rung.setdefault(rung, []).append((time.perf_counter() - t0) * 1e3)
    return apply_result(slam_map, cfg, ctx, res)
