"""Local bundle adjustment: window assembly, LM+Schur solve, write-back (torch).

Counterpart of ``tpuslam.backend.local_ba``: the window is the current
keyframe and its best covisible keyframes, the landmarks are their lines
and (hybrid maps) their points, and the keyframes outside the window that
observe those lines are held fixed (as is the oldest window keyframe, the
gauge). The host gathers the window
into padded buffers, ``backend.lm.run_lm`` solves it on the device, and the
result is written back with the chi2 prune and the divergence guard.

The problem is padded to a rung of the diagonal bucket ladder, as in the JAX
package: PyTorch needs no fixed shapes to avoid recompiles, but the rungs
keep the port's problems field for field equal to the JAX package's and the
shapes few enough for a captured CUDA graph later.

:func:`local_bundle_adjustment` solves in this process. The mapper's
asynchronous path hands the solve to the solver process
(``backend.ba_worker``): it assembles on the host (``device="cpu"``),
ships :func:`problem_arrays` and writes back the dict that
:func:`solve_arrays` returns there.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from tpuslam_torch.backend.lm import BAProblem, BAState, LMConfig, chi2_outlier_mask, run_lm
from tpuslam_torch.device import resolve_device
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.geometry.plucker import plucker_normalize
from tpuslam_torch.slammap.map import SlamMap


class LocalBAConfig(NamedTuple):
    window_size: int = 10
    max_fixed: int = 10
    pose_buckets: Tuple[int, ...] = (8, 16, 24)
    line_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    obs_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096)
    point_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    p_obs_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096)
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
    point_ids: List[int] | None = None,
    point_caps: Tuple[int, int] = (1, 1),
    device="cuda",
) -> Tuple[BAProblem, List[int], List[int], np.ndarray, np.ndarray]:
    """Gather a padded BAProblem. Returns (problem, kf_order, line_order,
    obs_table (n_obs, 3) of [kf_pos, line_pos, feature_slot], p_obs_table
    (n_p_obs, 3) of [kf_pos, point_pos, corner_slot]). Observation rows
    follow the insertion order of the stores' observation dicts, as in the
    JAX package. A line-only map has empty M = OP = 1 point blocks."""
    device = resolve_device(device)
    P, L, OL = caps
    point_ids = point_ids or []
    M, OP = point_caps
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
    pst = slam_map.points
    point_pos = {q: i for i, q in enumerate(point_ids)}
    points = np.zeros((M, 3), np.float32)
    point_valid = np.zeros(M, np.float32)
    for q, i in point_pos.items():
        points[i] = pst.xyz[q]
        point_valid[i] = 1.0
    prows = []
    for q in point_ids:
        for kid, slot in pst.obs.get(q, {}).items():
            if kid in kf_pos:
                prows.append((kf_pos[kid], point_pos[q], kid, slot))
    prows = prows[:OP]
    p_pose = np.zeros(OP, np.int32)
    p_point = np.zeros(OP, np.int32)
    p_uv = np.zeros((OP, 2), np.float32)
    p_valid = np.zeros(OP, np.float32)
    p_obs_table = np.zeros((len(prows), 3), np.int32)
    for r, (pi, qi, kid, slot) in enumerate(prows):
        p_pose[r] = pi
        p_point[r] = qi
        p_uv[r] = slam_map.keyframes[kid].point_features.uv[slot]
        p_valid[r] = 1.0
        p_obs_table[r] = (pi, qi, slot)
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
        points=dev(points),
        point_valid=dev(point_valid),
        l_pose=dev(l_pose),
        l_line=dev(l_line),
        l_endpoints=dev(l_ep),
        l_valid=dev(l_valid),
        l_sigma=dev(l_sigma),
        p_pose=dev(p_pose),
        p_point=dev(p_point),
        p_uv=dev(p_uv),
        p_valid=dev(p_valid),
        p_sigma=dev(np.ones(OP, np.float32)),
    )
    return prob, kf_order, line_ids, obs_table, p_obs_table


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
    device="cuda",
):
    """Gather the padded window problem on ``device``. Returns (BAProblem,
    ctx), ctx carrying what `apply_result` needs for the write-back."""
    device = resolve_device(device)
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

    # hybrid point blocks (M = OP = 1 stubs on a line-only map)
    pst = slam_map.points
    point_ids = [q for q in slam_map.window_point_ids(window) if pst.alive[q]]
    if point_ids:
        point_ids = point_ids[: _bucket(len(point_ids), cfg.point_buckets)]
        n_p_obs = sum(sum(1 for k in pst.obs.get(q, {}) if k in window_set or k in fixed_kept) for q in point_ids)
        M, OP = ladder_bucket((len(point_ids), n_p_obs), cfg.point_buckets, cfg.p_obs_buckets)
    else:
        M, OP = 1, 1

    prob, kf_order, line_order, obs_table, p_obs_table = build_problem(
        slam_map, window, fixed, line_ids, (P, L, OL), point_ids, (M, OP), device=device
    )
    ctx = dict(
        window=window,
        fixed=fixed,
        kf_order=kf_order,
        line_order=line_order,
        point_ids=point_ids,
        obs_table=obs_table,
        p_obs_table=p_obs_table,
        pose_free=prob.pose_free.cpu().numpy(),
    )
    return prob, ctx


def _prune(slam_map: SlamMap, store, cfg: LocalBAConfig, kf_order, order, table: np.ndarray, inl) -> int:
    """Erase the observations (rows of ``table``) whose mask entry is 0, then
    kill the landmarks of ``store`` that lost one here and fell below
    ``min_obs_keep``. Only those: a fresh single-observation inlier landmark
    must survive to be re-observed (the recent-landmark cull in the mapper
    judges never-confirmed ones)."""
    touched: set = set()
    n_pruned = 0
    for r in range(table.shape[0]):
        if inl[r] < 0.5:
            pi, li, _ = table[r]
            kid = kf_order[pi]
            if kid not in slam_map.keyframes:
                continue
            lm = int(order[li])
            store.erase_observation(lm, slam_map.keyframes[kid])
            touched.add(lm)
            n_pruned += 1
    for lm in touched:
        if store.alive[lm] and store.n_obs[lm] < cfg.min_obs_keep:
            store.kill(lm, slam_map.keyframes)
    return n_pruned


def _prune_both(slam_map: SlamMap, cfg: LocalBAConfig, ctx: dict, inl_l, inl_p) -> int:
    """The line prune, then the point prune (hybrid maps)."""
    n = _prune(slam_map, slam_map.lines, cfg, ctx["kf_order"], ctx["line_order"], ctx["obs_table"], np.asarray(inl_l))
    if ctx["point_ids"]:
        n += _prune(slam_map, slam_map.points, cfg, ctx["kf_order"], ctx["point_ids"], ctx["p_obs_table"], np.asarray(inl_p))
    return n


def apply_result(slam_map: SlamMap, cfg: LocalBAConfig, ctx: dict, res: dict) -> LocalBAStats:
    """Write an LM+Schur result (numpy ``res``) back into the map, with the
    chi2 prune; a diverged solve (see LocalBAConfig.reject_cost_per_obs) is
    not written back and prunes only the initial-state outliers."""
    st = slam_map.lines
    window, fixed, kf_order, line_order = ctx["window"], ctx["fixed"], ctx["kf_order"], ctx["line_order"]
    n_obs_total = int(ctx["obs_table"].shape[0]) + int(ctx["p_obs_table"].shape[0])
    # n_obs counts both families on a rejected solve and the lines on a
    # written-back one, as in the JAX package
    stats = dict(n_poses=len(window), n_fixed=len(fixed), n_lines=len(line_order), cost=res["cost"])

    if cfg.reject_cost_per_obs > 0 and res.get("cost", 0.0) > cfg.reject_cost_per_obs * max(1, n_obs_total):
        import sys

        print(
            f"local BA diverged (cost {res['cost']:.3g} over {n_obs_total} obs)"
            " — write-back rejected; pruning initial-state outliers only",
            file=sys.stderr,
        )
        n_pruned = 0
        if cfg.prune_outliers and "inl_l0" in res:
            n_pruned = _prune_both(slam_map, cfg, ctx, res["inl_l0"], res["inl_p0"])
        return LocalBAStats(n_obs=n_obs_total, n_pruned=n_pruned, **stats)

    new_poses = res["poses"]
    for i, kid in enumerate(kf_order):
        if i < len(window) + len(fixed) and float(ctx["pose_free"][i]) > 0.5 and kid in slam_map.keyframes:
            slam_map.keyframes[kid].T_cw = new_poses[i]
    new_lines = res["lines"]
    for i, lid in enumerate(line_order):
        if st.alive[lid]:
            st.plucker[lid] = new_lines[i]
            st.endpoints[lid] = _project_endpoints_to_line(st.endpoints[lid], new_lines[i])
    pst = slam_map.points
    for i, qid in enumerate(ctx["point_ids"]):
        if pst.alive[qid]:
            pst.xyz[qid] = res["points"][i]

    n_pruned = 0
    if cfg.prune_outliers and "inl_l" in res:
        n_pruned = _prune_both(slam_map, cfg, ctx, res["inl_l"], res["inl_p"])
    return LocalBAStats(n_obs=int(ctx["obs_table"].shape[0]), n_pruned=n_pruned, **stats)


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


def problem_arrays(prob: BAProblem) -> Dict[str, np.ndarray]:
    """The problem as host numpy arrays, field by field, dtypes kept: what
    the solver process receives."""
    return {f: getattr(prob, f).detach().cpu().numpy() for f in prob._fields}


def _solve(prob: BAProblem, cam: Intrinsics, lm: LMConfig, chi2_line, chi2_point, masks: bool, marks=None) -> dict:
    """run_lm and, with ``masks``, the chi2 masks after and before the
    solve, read back in one transfer. ``marks`` (a list) receives the host
    clock after the LM's and after the masks' enqueue."""
    state = run_lm(prob, cam, lm)
    parts = [state.poses, state.lines, state.points, state.cost]
    if marks is not None:
        marks.append(time.perf_counter())
    if masks:
        parts += [*chi2_outlier_mask(state, prob, cam, chi2_line, chi2_point)]
        parts += [*initial_chi2_masks(prob, cam, chi2_line, chi2_point)]
    if marks is not None:
        marks.append(time.perf_counter())
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out = []
    for p in parts:
        out.append(flat[: p.numel()].reshape(p.shape))
        flat = flat[p.numel():]
    res = dict(poses=out[0], lines=out[1], points=out[2], cost=float(out[3]))
    if masks:
        res["inl_l"], res["inl_p"], res["inl_l0"], res["inl_p0"] = out[4:]
    return res


def solve_in_process(prob: BAProblem, cam: Intrinsics, cfg: LocalBAConfig) -> dict:
    """The LM+Schur solve and the chi2 masks on the problem's device, read
    back to numpy in one transfer."""
    return _solve(prob, cam, cfg.lm, cfg.chi2_line, cfg.chi2_point, cfg.prune_outliers)


def solve_arrays(arrays: Dict[str, np.ndarray], cam: Intrinsics, lm: LMConfig, chi2_line: float, chi2_point: float,
                 device) -> dict:
    """Solve a problem received as :func:`problem_arrays` on ``device``, in
    the dtype its arrays have (global BA sends float64): the solver
    process's solve. Returns :func:`solve_in_process`'s dict with the masks
    always, plus ``solve_ms`` (wall ms from the upload to the read back) and
    ``stage_ms``, the JAX worker's split: ``lm_enqueue`` (the LM's
    launches), ``chi2_enqueue`` (the masks') and ``exec_d2h`` (the wait for
    the device and the read back)."""
    t0 = time.perf_counter()
    prob = BAProblem(**{f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(device) for f in BAProblem._fields})
    marks = [t0]
    res = _solve(prob, cam, lm, chi2_line, chi2_point, True, marks)
    t1 = time.perf_counter()
    res["solve_ms"] = (t1 - t0) * 1e3
    res["stage_ms"] = {
        "lm_enqueue": (marks[1] - marks[0]) * 1e3, "chi2_enqueue": (marks[2] - marks[1]) * 1e3, "exec_d2h": (t1 - marks[2]) * 1e3,
    }
    return res


def local_bundle_adjustment(
    slam_map: SlamMap,
    center_kid: int,
    cam: Intrinsics,
    cfg: LocalBAConfig = LocalBAConfig(),
    device="cuda",
    solve_ms_by_rung: Dict[tuple, List[float]] | None = None,
) -> LocalBAStats:
    """Synchronous windowed BA around `center_kid`: assemble, solve on
    ``device``, apply. Given ``solve_ms_by_rung``, the solve's wall ms
    (assembly excluded, read back included) is appended under the problem's
    (P, L, OL) rung."""
    device = resolve_device(device)
    prob, ctx = assemble_problem(slam_map, center_kid, cam, cfg, device=device)
    t0 = time.perf_counter()
    res = solve_in_process(prob, cam, cfg)  # ends in a read back
    if solve_ms_by_rung is not None:
        rung = (prob.poses.shape[0], prob.lines.shape[0], prob.l_pose.shape[0])
        solve_ms_by_rung.setdefault(rung, []).append((time.perf_counter() - t0) * 1e3)
    return apply_result(slam_map, cfg, ctx, res)
