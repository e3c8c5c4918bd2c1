"""The loop configuration with the solver process, call by call: the JAX
System's mapper and loop closer recorded on a scheduled stand-in solver, and
each call replayed by this package's mapper and loop closer from the same
map, with the same solver answers.

The JAX side (:func:`record_calls`): every mapper call (``process``,
``tick``, ``finish``) and every ``LoopCloser.process`` is recorded with the
map before and after it (``convert.map_state``), the mapper's and the loop
closer's state after it, and the keyframe-map ATE after each write-back in
it (:class:`WritebackTrace`). A :class:`ScheduledSolver` stands in for the
solver process: a local-BA request answers at the first poll ``lags[id]``
frames or more after its submit (or at once when the poll waits: a drain),
and global BA's blocking ``solve`` answers at once, each with the JAX
package's own solve (``solve_in_process``, float32).

The port's side (:func:`replay`): before each call the map is the JAX map
before it (``slam_map_from``; a pending fusion's keyframe rebound into it),
and a :class:`ScheduledSolver` in replay mode answers each request with the
JAX answer of the same request id, and each global-BA round with the JAX
package's float32 answer of the same round, so that neither the local-BA
solve nor global BA's precision enters. :func:`compare` holds the result to
the JAX map after the call.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from tpuslam_torch.convert import map_state, slam_map_from

POSE_TOL = 2e-4  # keyframe poses after a mapper call (test_torch_ba_worker's lockstep)
LINE_TOL = 1e-2  # endpoints of lines seen from 4+ keyframes (m)
LINE_PX = 1.0  # every observed line in the JAX images (px)
CLOSE_POSE_TOL = 1e-3  # after a closure: test_close_matches_jax's bounds
CLOSE_LANDMARK_TOL = 2e-3
CLOSE_PLUCKER_TOL = 1e-3
MAPPER_COUNTERS = ("ba_submitted", "ba_skipped", "ba_resubmitted", "ba_stale", "_kf_count")


def _numpy(res: dict) -> dict:
    return {k: (np.array(v) if not isinstance(v, float) else v) for k, v in res.items()}


class ScheduledSolver:
    """The solver process's submit / poll / solve on a fixed schedule, in
    this process. ``lags``: frames a request waits, by request id (cycled;
    ``frame`` is set by the caller). Recording (``solve`` given: the
    package's own solve of (arrays, lm, chi2_line, chi2_point)) keeps each
    answer by request id and each global-BA answer in order; replay
    (``answers`` and ``global_answers`` given) answers with those instead.
    Both keep what was submitted, and at each submit, by request id, the
    value of ``n_obs`` (a callable: the map's line n_obs) and of
    ``closures`` (a callable: the loops closed so far), where given."""

    def __init__(self, lags, solve=None, answers=None, global_answers=None, n_obs=None, closures=None):
        self.lags, self.solve_fn, self.n_obs, self.n_obs_at = tuple(lags), solve, n_obs, {}
        self.closures, self.closures_at = closures, {}
        self.replaying = answers is not None
        self.answers = {} if answers is None else answers
        self.global_answers = [] if global_answers is None else global_answers
        self.frame, self.next_id, self.pending = 0, 0, {}
        self.submitted, self.global_submitted, self.answered = {}, [], []

    def submit(self, arrays, lm, chi2_line, chi2_point):
        self.next_id += 1
        self.submitted[self.next_id] = arrays
        if self.n_obs is not None:
            self.n_obs_at[self.next_id] = self.n_obs()
        if self.closures is not None:
            self.closures_at[self.next_id] = self.closures()
        self.pending[self.next_id] = (self.frame, (arrays, lm, chi2_line, chi2_point))
        return self.next_id

    def poll(self, req_id, timeout=0.0):
        at, args = self.pending[req_id]
        if timeout <= 0 and self.frame - at < self.lags[(req_id - 1) % len(self.lags)]:
            return None
        del self.pending[req_id]
        self.answered.append(req_id)
        if not self.replaying:
            self.answers[req_id] = _numpy(self.solve_fn(*args))
        return dict(self.answers[req_id], solve_ms=1.0, warm=True), None

    def solve(self, arrays, lm, chi2_line, chi2_point, timeout=None):
        i = len(self.global_submitted)
        self.global_submitted.append(arrays)
        if not self.replaying:
            self.global_answers.append(_numpy(self.solve_fn(arrays, lm, chi2_line, chi2_point)))
        return dict(self.global_answers[i], solve_ms=1.0), None

    def restart(self):
        self.pending.clear()


def jax_solve(cam):
    """The JAX solver process's solve (``tpuslam/backend/ba_worker.py``):
    ``solve_in_process`` of the arrays as they arrive."""
    from tpuslam.backend import local_ba as jlba
    from tpuslam.backend.lm import BAProblem as JBAProblem

    def solve(arrays, lm, chi2_line, chi2_point):
        cfg = jlba.LocalBAConfig(lm=lm, chi2_line=chi2_line, chi2_point=chi2_point)
        return jlba.solve_in_process(JBAProblem(**arrays), cam, cfg)

    return solve


def kf_map_ate(slam_map, gt_pose) -> float:
    """Rigid ATE (m) of the keyframes' camera centres; ``gt_pose(frame_idx)``
    is the true T_cw."""
    from tpuslam_torch.eval.ate import absolute_trajectory_error

    kfs = [slam_map.keyframes[k] for k in sorted(slam_map.keyframes)]
    if len(kfs) < 3:
        return 0.0
    est = np.stack([np.linalg.inv(np.asarray(k.T_cw, np.float64))[:3, 3] for k in kfs])
    gt = np.stack([np.linalg.inv(np.asarray(gt_pose(k.frame_idx), np.float64))[:3, 3] for k in kfs])
    return float(absolute_trajectory_error(est, gt, with_scale=False).rmse)


class WritebackTrace:
    """The keyframe-map ATE after each write-back of one package, in
    ``events`` (label, ATE): a new keyframe (as the mapper takes it up), a
    local-BA write-back (``apply_result`` as the mapper calls it), a
    closure's correction (its map as global BA starts, or as ``_close``
    returns without global BA), global BA, a fusion (``_fuse_all``, a
    pending ``_apply_pending_fuse``) and a keyframe cull that erased one.
    ``writes`` keeps each local-BA write-back's request id (the mapper's
    solver is a :class:`ScheduledSolver`) and the loops closed by then.
    ``install(mapper, closer, mapping_module, gba_owner)`` wraps them:
    ``mapping_module`` is the module whose ``apply_result`` the mapper
    calls, ``gba_owner`` the one whose ``global_bundle_adjustment`` the
    closer calls."""

    def __init__(self, gt_pose):
        self.gt_pose, self.events, self._undo = gt_pose, [], []
        self.writes = []  # per local-BA write-back: (request id, loops closed by then)

    def stale_writes(self, solver) -> list:
        """The request ids written back after a closure that came after
        their submit (``solver.closures_at``): the invariant is none."""
        return [rid for rid, n in self.writes if n > solver.closures_at[rid]]

    def note(self, label, slam_map):
        self.events.append((label, kf_map_ate(slam_map, self.gt_pose)))

    def _wrap(self, owner, name, make):
        inner = getattr(owner, name)
        setattr(owner, name, make(inner))
        self._undo.append((owner, name, inner))

    def install(self, mapper, closer, mapping_module, gba_owner):
        def apply(inner):
            def call(slam_map, *a, **kw):
                out = inner(slam_map, *a, **kw)
                self.writes.append((mapper.solver.answered[-1], len(closer.closed_loops)))
                self.note("local BA", slam_map)
                return out
            return call

        def gba(inner):
            def call(slam_map, *a, **kw):
                self.note("closure", slam_map)
                out = inner(slam_map, *a, **kw)
                self.note("global BA", slam_map)
                return out
            return call

        def fuse(inner):
            def call(*a, **kw):
                if not a and getattr(mapper, "_fuse_pending", None) is None:
                    return inner(*a, **kw)  # no deferred fusion pending
                out = inner(*a, **kw)
                self.note("fusion", mapper.map)
                return out
            return call

        def new_keyframe(inner):
            def call(*a, **kw):
                self.note("keyframe", mapper.map)
                return inner(*a, **kw)
            return call

        def cull(inner):
            def call(*a, **kw):
                n = len(mapper.map.keyframes)
                out = inner(*a, **kw)
                if len(mapper.map.keyframes) < n:
                    self.note("keyframe cull", mapper.map)
                return out
            return call

        def close(inner):
            def call(*a, **kw):
                n = len(self.events)
                ok = inner(*a, **kw)
                if ok and not any(label == "closure" for label, _ in self.events[n:]):
                    self.note("closure", closer.map)
                return ok
            return call

        self._wrap(mapping_module, "apply_result", apply)
        self._wrap(gba_owner, "global_bundle_adjustment", gba)
        self._wrap(mapper, "_fuse_all", fuse)
        self._wrap(mapper, "_apply_pending_fuse", fuse)
        self._wrap(mapper, "_register_recent", new_keyframe)
        self._wrap(mapper, "_cull_keyframes", cull)
        self._wrap(closer, "_close", close)
        return self

    def uninstall(self):
        for owner, name, inner in reversed(self._undo):
            if isinstance(owner, types.ModuleType) or not hasattr(type(owner), name):
                setattr(owner, name, inner)
            else:
                delattr(owner, name)  # an instance attribute over the class's method
        self._undo.clear()


def mapper_state(mp_) -> dict:
    return dict({k: getattr(mp_, k) for k in MAPPER_COUNTERS}, recent=dict(mp_._recent), recent_pts=dict(mp_._recent_pts),
                in_flight=mp_._ba_ctx is not None, want_resubmit=mp_._ba_want_resubmit,
                pending_fuse=getattr(mp_, "_fuse_pending", None) is not None)


def closer_state(cl) -> dict:
    return dict(closed_loops=list(cl.closed_loops), consistent=list(cl._consistent), gba_skipped=cl.gba_skipped,
                db=[k for k in cl.db.kids if k is not None])


def record_calls(js, stub, gt_pose):
    """Wrap the JAX System ``js``'s mapper (``process``, ``tick``,
    ``finish``) and loop closer (``process``, and ``_detect`` for the
    candidate) so that each call appends to the returned list: name, the
    keyframe's kid, the frame (``stub.frame``), the map before and after, the
    mapper's and closer's state after, the request ids answered in it, the
    candidate and closure of a closer call, and the keyframe-map ATE after
    each write-back in it. Returns (calls, the WritebackTrace)."""
    import tpuslam.backend.global_ba as jgba
    import tpuslam.backend.mapping as jmapping

    jm, jlc = js.mapper, js.loop_closer
    calls = []
    wt = WritebackTrace(gt_pose).install(jm, jlc, jmapping, jgba)
    detected = []
    inner_detect = jlc._detect

    def detect(kf):
        detected.append(inner_detect(kf))
        return detected[-1]

    jlc._detect = detect

    def recorded(owner, name, tag):
        inner = getattr(owner, name)

        def call(*args, **kw):
            before, n0, w0, d0 = map_state(js.map), len(stub.answered), len(wt.events), len(detected)
            out = inner(*args, **kw)
            calls.append(dict(
                name=tag, kid=args[0].kid if args else None, frame=stub.frame, before=before, after=map_state(js.map),
                mapper=mapper_state(jm), closer=closer_state(jlc), answered=stub.answered[n0:],
                candidate=detected[d0] if len(detected) > d0 else None, closed=bool(out) if tag == "close" else None,
                n_global=len(stub.global_submitted), writebacks=list(wt.events[w0:]),
            ))
            return out

        setattr(owner, name, call)

    for name in ("process", "tick", "finish"):
        recorded(jm, name, name)
    recorded(jlc, "process", "close")
    return calls, wt


def rebind_pending_fuse(mapper, m):
    """The pending fusion's keyframe, in the map the replay swapped in."""
    p = mapper._fuse_pending
    if p is not None and p[0].kid in m.keyframes:
        mapper._fuse_pending = (m.keyframes[p[0].kid],) + p[1:]


def line_residuals_px(got, want, cam) -> float:
    """Each live line's JAX endpoints, in front of each keyframe that
    observes it (JAX pose), against this package's line and the JAX line in
    that image: the largest difference of the two distances in px (a JAX
    line need not pass through its own stored endpoints: fusion keeps the
    survivor's endpoints)."""
    from tpuslam_torch.backend.residuals import line_residuals
    from tpuslam_torch.geometry import project_points, se3_apply

    poses = {k["kid"]: k["T_cw"] for k in want["keyframes"]}
    alive = want["lines"]["alive"]
    rows = [(l, k) for l in np.nonzero(alive)[0] for k in want["lines"]["obs"][int(l)] if k in poses]
    if not rows:
        return 0.0
    T = torch.from_numpy(np.stack([poses[k] for _, k in rows]))
    X = se3_apply(T[:, None], torch.from_numpy(np.stack([want["lines"]["endpoints"][l] for l, _ in rows])))
    front = (X[..., 2] > 0.1).all(dim=-1)
    uv = project_points(cam, X[front])

    def res(state):
        L = torch.from_numpy(np.stack([state["lines"]["plucker"][l] for l, _ in rows]))
        return line_residuals(T[front], L[front], uv, cam)

    return float((res(got) - res(want)).abs().max()) if bool(front.any()) else 0.0


def _unit(L):
    return L / np.maximum(np.linalg.norm(L, axis=-1, keepdims=True), 1e-12)


def compare(c, got_state, mapper, closer, cand, ok, cam, n_obs_at, answered) -> list:
    """What parts between this package's call and the JAX call ``c``
    beyond the bounds: a list of (what, detail), empty when it holds.
    Exact: counters, recent landmarks, the in-flight solve and pending
    fusion, the closer's closures, consistency evidence, skips and database
    rows, the candidate and the closure, map.generation, observations,
    live landmarks, free lists, keyframes, line ids, loop edges, the
    spanning tree and covisibility, and the request ids answered. Poses
    within POSE_TOL (CLOSE_POSE_TOL after a closure), lines seen from 4+
    keyframes (now and when each solve written back was assembled) within
    LINE_TOL, every observed line within LINE_PX in the JAX images; after a
    closure landmarks within CLOSE_LANDMARK_TOL and unit Pluecker lines
    within CLOSE_PLUCKER_TOL."""
    out = []
    want = c["after"]
    got = got_state

    def check(what, cond, detail=""):
        if not cond:
            out.append((what, detail))

    check("mapper state", mapper_state(mapper) == c["mapper"], f"{mapper_state(mapper)} != {c['mapper']}")
    check("closer state", closer_state(closer) == c["closer"], f"{closer_state(closer)} != {c['closer']}")
    if c["name"] == "close":
        check("candidate", cand == c["candidate"], f"{cand} != {c['candidate']}")
        check("closure", ok == c["closed"], f"{ok} != {c['closed']}")
    check("generation", got["generation"] == want["generation"], f"{got['generation']} != {want['generation']}")
    check("answered", answered == c["answered"], f"{answered} != {c['answered']}")
    for fam in ("lines", "points"):
        check(f"{fam} observations", got[fam]["obs"] == want[fam]["obs"])
        check(f"{fam} alive", np.array_equal(got[fam]["alive"], want[fam]["alive"]))
        check(f"{fam} free", got[fam]["free"] == want[fam]["free"])
    check("keyframes", [k["kid"] for k in got["keyframes"]] == [k["kid"] for k in want["keyframes"]])
    check("covisibility", got["covis"] == want["covis"])
    closure = c["name"] == "close" and c["closed"]
    ptol = CLOSE_POSE_TOL if closure else POSE_TOL
    worst = 0.0
    for a, b in zip(got["keyframes"], want["keyframes"]):
        check(f"keyframe {b['kid']} line ids", np.array_equal(a["line_ids"], b["line_ids"]))
        check(f"keyframe {b['kid']} graph", (a["parent"], a["children"], a["loop_edges"]) == (b["parent"], b["children"], b["loop_edges"]))
        if a["kid"] == b["kid"]:
            worst = max(worst, float(np.abs(a["T_cw"] - b["T_cw"]).max()))
    check("poses", worst <= ptol, f"{worst!r} > {ptol}")
    alive = want["lines"]["alive"] & got["lines"]["alive"]
    if closure:
        d = float(np.abs(got["lines"]["endpoints"][alive] - want["lines"]["endpoints"][alive]).max(initial=0.0))
        check("closure endpoints", d <= CLOSE_LANDMARK_TOL, f"{d!r}")
        d = float(np.abs(_unit(got["lines"]["plucker"][alive]) - _unit(want["lines"]["plucker"][alive])).max(initial=0.0))
        check("closure lines", d <= CLOSE_PLUCKER_TOL, f"{d!r}")
        palive = want["points"]["alive"] & got["points"]["alive"]
        d = float(np.abs(got["points"]["xyz"][palive] - want["points"]["xyz"][palive]).max(initial=0.0))
        check("closure points", d <= CLOSE_LANDMARK_TOL, f"{d!r}")
    firm = alive & (want["lines"]["n_obs"] >= 4)
    for rid in c["answered"]:
        if rid in n_obs_at:
            firm &= n_obs_at[rid] >= 4
    d = float(np.abs(got["lines"]["endpoints"][firm] - want["lines"]["endpoints"][firm]).max(initial=0.0))
    check("firm lines", d <= LINE_TOL, f"{d!r}")
    px = line_residuals_px(got, want, cam)
    check("line images", px < LINE_PX, f"{px!r} px")
    return out


def replay(calls, jax_stub, lags, cam, mapper_cfg, loop_cfg, gt_pose, point_slots=0, n_obs_at=None, on_call=None):
    """Each recorded JAX call run by this package's mapper and loop closer
    from the JAX map before it, on the CPU, with the JAX answers
    (``jax_stub``'s); ``gt_pose(frame_idx)`` is the true T_cw of a frame.
    Returns (the per-call lists of :func:`compare`, the port's
    ScheduledSolver, its write-back ATEs per call, its WritebackTrace).
    ``on_call(i, c, parts, writebacks)`` is called after each call."""
    import tpuslam_torch.backend.loop_closing as tlc
    import tpuslam_torch.backend.mapping as tmapping
    from tpuslam_torch.backend.mapping import LocalMapper
    from tpuslam_torch.slammap.map import SlamMap

    stub = ScheduledSolver(lags, answers=jax_stub.answers, global_answers=jax_stub.global_answers)
    mapper = LocalMapper(SlamMap(), cam, mapper_cfg, solver=stub, device="cpu")
    closer = tlc.LoopCloser(SlamMap(), cam, loop_cfg, db=tlc.KeyFrameDatabase(point_slots=point_slots, device="cpu"),
                            solver=stub, device="cpu")
    stub.closures = lambda: len(closer.closed_loops)
    wt = WritebackTrace(gt_pose).install(mapper, closer, tmapping, tlc)
    parts, traces = [], []
    try:
        for i, c in enumerate(calls):
            m = slam_map_from(c["before"])
            m.on_keyframe_erased = closer.db.remove
            mapper.map = closer.map = m
            rebind_pending_fuse(mapper, m)
            stub.frame = c["frame"]
            w0, n0 = len(wt.events), len(stub.answered)
            cand, ok = None, None
            if c["name"] == "process":
                mapper.process(m.keyframes[c["kid"]])
            elif c["name"] == "close":
                n = len(closer.timings)
                ok = closer.process(m.keyframes[c["kid"]])
                cand = closer.timings[n]["candidate"]
            else:
                getattr(mapper, c["name"])()
            p = compare(c, map_state(m), mapper, closer, cand, ok, cam, n_obs_at or {}, stub.answered[n0:])
            parts.append(p)
            traces.append(list(wt.events[w0:]))
            if on_call is not None:
                on_call(i, c, p, traces[-1])
    finally:
        wt.uninstall()
    return parts, stub, traces, wt


def compare_problems(mine: dict, theirs: dict, pose_tol: float) -> list:
    """A problem this package submitted against the JAX one of the same id:
    the same keys, shapes and (float32 / int32) dtypes, indices and masks
    exact, poses within ``pose_tol``. Returns what parts."""
    out = []
    if mine.keys() != theirs.keys():
        return [("keys", f"{sorted(mine)} != {sorted(theirs)}")]
    for k, a in mine.items():
        b = np.asarray(theirs[k])
        if a.shape != b.shape:
            out.append((k, f"shape {a.shape} != {b.shape}"))
            continue
        if a.dtype.kind == "i" or k.endswith("valid") or k == "pose_free":
            if not np.array_equal(a, b):
                out.append((k, "differs"))
    if not out:
        d = float(np.abs(np.asarray(mine["poses"], np.float64) - np.asarray(theirs["poses"], np.float64)).max())
        if d > pose_tol:
            out.append(("poses", f"{d!r}"))
    return out

