"""Global bundle adjustment: full-map LM+Schur after a loop closure (torch).

Counterpart of ``tpuslam.backend.global_ba``: the same solver as local BA
(``backend.lm.run_lm``) over every keyframe and every line (and, on hybrid
maps, point) landmark seen from two or more keyframes, padded to a rung of
the diagonal bucket ladder. A map with more keyframes than the top rung
raises ``ValueError`` (the loop closer then keeps the essential-graph
result); beyond the line or point capacity the most-observed landmarks are
kept. ``outlier_rounds`` chi2 rounds re-solve with the outliers masked, and
a solve whose cost per observation exceeds ``reject_cost_per_obs`` is not
written back.

Both solves run on the device one after the other, in float64 (the JAX
package's float32 solve is ill-conditioned here: :func:`solve_global`), the
second warm-started from the first without a read back; the result comes
back to the host in one transfer, as float32. The JAX package's subprocess
solver is not carried over.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpuslam_torch.backend.lm import BAProblem, LMConfig, chi2_outlier_mask, run_lm
from tpuslam_torch.backend.local_ba import _project_endpoints_to_line, ladder_bucket
from tpuslam_torch.device import resolve_device
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.slammap.map import SlamMap


class GlobalBAConfig(NamedTuple):
    pose_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048)
    line_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)
    obs_buckets: Tuple[int, ...] = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
    # hybrid maps: global BA sees the point observations too (a line-only
    # solve re-optimizes the poses against the weaker family alone)
    point_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)
    p_obs_buckets: Tuple[int, ...] = (512, 1024, 2048, 4096, 8192, 16384)
    lm: LMConfig = LMConfig(max_iters=12)
    # divergence guard: a blown-up full-map solve must not overwrite the
    # essential-graph result
    reject_cost_per_obs: float = 500.0
    # chi2 rounds: re-solve with the observations that are chi2 outliers at
    # the previous solution masked
    outlier_rounds: int = 1
    chi2_line: float = 7.378
    chi2_point: float = 5.991


class GlobalBAStats(NamedTuple):
    n_poses: int
    n_lines: int
    n_obs: int
    cost: float
    applied: bool = True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_global_problem(slam_map: SlamMap, cfg: GlobalBAConfig = GlobalBAConfig(), device="cuda"):
    """The padded full-map problem on ``device`` and what the write-back
    needs: (BAProblem, ctx)."""
    device = resolve_device(device)
    kids = slam_map.all_keyframe_ids()
    st = slam_map.lines
    live = [int(l) for l in st.live_ids() if st.n_obs[l] >= 2]
    kid_set = set(kids)
    n_obs_est = sum(sum(1 for k in st.obs.get(l, {}) if k in kid_set) for l in live)
    P, L, OL = ladder_bucket((len(kids), len(live), n_obs_est), cfg.pose_buckets, cfg.line_buckets, cfg.obs_buckets)
    if len(kids) > P:
        raise ValueError(f"map too large for global BA buckets: {len(kids)} KFs")
    if len(live) > L:
        live = sorted(live, key=lambda l: -int(st.n_obs[l]))[:L]

    kf_pos = {k: i for i, k in enumerate(kids)}
    line_pos = {l: i for i, l in enumerate(live)}
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    pose_free = np.zeros(P, np.float32)
    for k, i in kf_pos.items():
        poses[i] = slam_map.keyframes[k].T_cw
        pose_free[i] = 0.0 if k == kids[0] else 1.0  # gauge: the first keyframe
    lines = np.zeros((L, 6), np.float32)
    line_valid = np.zeros(L, np.float32)
    for l, i in line_pos.items():
        lines[i] = st.plucker[l]
        line_valid[i] = 1.0

    rows = [(kf_pos[kid], line_pos[l], kid, slot) for l in live for kid, slot in st.obs.get(l, {}).items() if kid in kf_pos]
    rows = rows[:OL]
    l_pose = np.zeros(OL, np.int32)
    l_line = np.zeros(OL, np.int32)
    l_ep = np.zeros((OL, 2, 2), np.float32)
    l_sigma = np.ones(OL, np.float32)
    l_valid = np.zeros(OL, np.float32)
    for r, (pi, li, kid, slot) in enumerate(rows):
        kf = slam_map.keyframes[kid]
        l_pose[r], l_line[r] = pi, li
        l_ep[r] = kf.features.endpoints[slot]
        l_sigma[r] = kf.features.sigma[slot]
        l_valid[r] = 1.0

    # hybrid point blocks (M = OP = 1 stubs on a line-only map)
    pst = slam_map.points
    live_p = [int(q) for q in pst.live_ids() if pst.n_obs[q] >= 2]
    if live_p:
        n_p_obs = sum(sum(1 for k in pst.obs.get(q, {}) if k in kid_set) for q in live_p)
        M, OP = ladder_bucket((len(live_p), n_p_obs), cfg.point_buckets, cfg.p_obs_buckets)
        if len(live_p) > M:
            live_p = sorted(live_p, key=lambda q: -int(pst.n_obs[q]))[:M]
    else:
        M, OP = 1, 1
    point_pos = {q: i for i, q in enumerate(live_p)}
    points = np.zeros((M, 3), np.float32)
    point_valid = np.zeros(M, np.float32)
    for q, i in point_pos.items():
        points[i] = pst.xyz[q]
        point_valid[i] = 1.0
    prows = [(kf_pos[kid], point_pos[q], kid, slot) for q in live_p for kid, slot in pst.obs.get(q, {}).items() if kid in kf_pos]
    prows = prows[:OP]
    p_pose = np.zeros(OP, np.int32)
    p_point = np.zeros(OP, np.int32)
    p_uv = np.zeros((OP, 2), np.float32)
    p_valid = np.zeros(OP, np.float32)
    for r, (pi, qi, kid, slot) in enumerate(prows):
        p_pose[r], p_point[r] = pi, qi
        p_uv[r] = slam_map.keyframes[kid].point_features.uv[slot]
        p_valid[r] = 1.0

    def dev(a):
        return torch.from_numpy(a).to(device)

    prob = BAProblem(
        poses=dev(poses), pose_free=dev(pose_free), lines=dev(lines), line_valid=dev(line_valid),
        points=dev(points), point_valid=dev(point_valid), l_pose=dev(l_pose), l_line=dev(l_line),
        l_endpoints=dev(l_ep), l_valid=dev(l_valid), l_sigma=dev(l_sigma), p_pose=dev(p_pose),
        p_point=dev(p_point), p_uv=dev(p_uv), p_valid=dev(p_valid), p_sigma=dev(np.ones(OP, np.float32)),
    )
    ctx = dict(kids=kids, live=live, live_p=live_p, kf_pos=kf_pos, line_pos=line_pos, point_pos=point_pos,
               pose_free=pose_free, n_obs=len(rows) + len(prows))
    return prob, ctx


def solve_global(prob: BAProblem, cam: Intrinsics, cfg: GlobalBAConfig = GlobalBAConfig(), solves=None):
    """The LM solve and ``cfg.outlier_rounds`` chi2 rounds, each warm-started
    from the last with its outliers masked, all on the problem's device, in
    float64. Returns the final BAState in float64. Given a list ``solves``,
    each round appends (its problem, its state, its wall ms ending in a
    device synchronize).

    float64, where the JAX package solves in float32: with only the first
    keyframe fixed and reprojection residuals alone, the map's scale is
    free and the reduced camera system is ill-conditioned, so float32
    rounding steers the solve. From one bit-identical problem (a closure of
    chip_smoke's loop sequence), one float32 LM iteration leaves the two
    packages' poses half a metre apart (``python
    tests/test_torch_loop_closing.py --replay``)."""
    device = prob.poses.device
    prob = BAProblem(*[x.double() if x.is_floating_point() else x for x in prob])
    for r in range(1 + max(0, int(cfg.outlier_rounds))):
        if r:
            inl_l, inl_p = chi2_outlier_mask(state, prob, cam, cfg.chi2_line, cfg.chi2_point)
            prob = prob._replace(poses=state.poses, lines=state.lines, points=state.points,
                                 l_valid=prob.l_valid * inl_l, p_valid=prob.p_valid * inl_p)
        if solves is not None:
            _sync(device)
            t0 = time.perf_counter()
        state = run_lm(prob, cam, cfg.lm)
        if solves is not None:
            _sync(device)
            solves.append((prob, state, (time.perf_counter() - t0) * 1e3))
    return state


def global_bundle_adjustment(
    slam_map: SlamMap,
    cam: Intrinsics,
    cfg: GlobalBAConfig = GlobalBAConfig(),
    device="cuda",
    record: dict | None = None,
) -> GlobalBAStats:
    """Full-map BA on ``device``, written back into ``slam_map`` unless it
    diverged. Given ``record``, it receives the problem's rungs and the
    solves (problem, state, ms) of :func:`solve_global`."""
    prob, ctx = build_global_problem(slam_map, cfg, device)
    solves = None
    if record is not None:
        solves = []
        record.update(rung=tuple(int(x) for x in (prob.poses.shape[0], prob.lines.shape[0], prob.l_pose.shape[0])),
                      point_rung=(int(prob.points.shape[0]), int(prob.p_pose.shape[0])), solves=solves)
    state = solve_global(prob, cam, cfg, solves)
    parts = [state.poses, state.lines, state.points, state.cost]
    flat = torch.cat([p.reshape(-1) for p in parts]).float().cpu().numpy()  # one read back
    out = []
    for p in parts:
        out.append(flat[: p.numel()].reshape(p.shape))
        flat = flat[p.numel():]
    new_poses, new_lines, new_points, cost = out[0], out[1], out[2], float(out[3])

    n_obs_total = ctx["n_obs"]
    stats = dict(n_poses=len(ctx["kids"]), n_lines=len(ctx["live"]), n_obs=n_obs_total, cost=cost)
    if cfg.reject_cost_per_obs > 0 and cost > cfg.reject_cost_per_obs * max(1, n_obs_total):
        import sys

        print(
            f"global BA diverged (cost {cost:.3g} over {n_obs_total} obs) — write-back rejected, essential-graph result kept",
            file=sys.stderr,
        )
        return GlobalBAStats(applied=False, **stats)

    for k, i in ctx["kf_pos"].items():
        if ctx["pose_free"][i] > 0.5:
            slam_map.keyframes[k].T_cw = new_poses[i]
    st = slam_map.lines
    for l, i in ctx["line_pos"].items():
        if st.alive[l]:
            st.plucker[l] = new_lines[i]
            st.endpoints[l] = _project_endpoints_to_line(st.endpoints[l], new_lines[i])
    pst = slam_map.points
    for q, i in ctx["point_pos"].items():
        if pst.alive[q]:
            pst.xyz[q] = new_points[i]
    return GlobalBAStats(**stats)
