"""Batched local BA (BASELINE config #5) (torch).

Counterpart of ``tpuslam.parallel.sharded_ba``. N sequences tracked
concurrently give N independent local-BA problems per round;
:func:`batched_ba` solves a (B, ...) batch of them with ``backend.lm``'s
``run_lm`` mapped over the leading axis by ``torch.func.vmap``, so one LM
iteration is one set of launches for the whole batch (the solver is
branch-free: accept and reject are ``torch.where``, and its sums are the
fixed-order one-hot products, batched).

The JAX package shards that axis over a 1-D device mesh. Here a
:class:`DeviceMesh` is a tuple of devices: :func:`shard_slices` cuts a
leading axis into one contiguous equal shard per entry, in order, and
:func:`run_sharded` runs one function per shard, each on a host thread of
its own with its card as the current device (the port is host-bound: one
thread enqueueing k shards would pay k times the launches). An entry may
repeat a card: ``DeviceMesh((cuda:0, cuda:0))`` drives the shard code and the
threads on one card, and shards on one card share its current stream. A mesh
of one entry runs on the calling thread with no copy. The shards are
independent, as in the JAX package: no collective runs between them.
"""

from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.backend.lm import BAProblem, BAState, LMConfig, run_lm
from tpuslam_torch.device import resolve_device
from tpuslam_torch.geometry.camera import Intrinsics, line_projection_matrix
from tpuslam_torch.geometry.plucker import plucker_from_points, plucker_transform
from tpuslam_torch.geometry.se3 import se3_exp


class DeviceMesh(NamedTuple):
    """The devices a batch is solved on, along one named axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "seq"


def make_mesh(n_devices: Optional[int] = None, axis: str = "seq", device="cuda") -> DeviceMesh:
    """A mesh of ``n_devices`` cards (all of them by default); raises for
    more than ``torch.cuda.device_count()``. ``device="cpu"`` gives the
    one-device CPU mesh."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} devices, have 1 CPU")
        return DeviceMesh((dev,), axis)
    have = torch.cuda.device_count()
    n = n_devices or have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return DeviceMesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def shard_slices(n: int, mesh: DeviceMesh) -> List[slice]:
    """Contiguous equal shards of a leading axis of ``n``, one per mesh
    entry in order; raises ValueError when the mesh size does not divide
    ``n`` (as the JAX package's ``NamedSharding`` does)."""
    k = len(mesh.devices)
    if n % k:
        raise ValueError(f"a leading axis of {n} does not split over a mesh of {k}")
    step = n // k
    return [slice(s * step, (s + 1) * step) for s in range(k)]


def run_sharded(mesh: DeviceMesh, fn: Callable[[int, torch.device], object]) -> list:
    """``[fn(s, device) for s, device in enumerate(mesh.devices)]``. With more
    than one entry each call runs on a thread of its own, its card the
    thread's current device; every thread is joined, and the first shard's
    exception (in shard order) is raised here."""
    if len(mesh.devices) == 1:
        return [fn(0, mesh.devices[0])]
    out: list = [None] * len(mesh.devices)
    errors: list = [None] * len(mesh.devices)

    def shard(s: int, dev: torch.device) -> None:
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out[s] = fn(s, dev)
            else:
                out[s] = fn(s, dev)
        except BaseException as e:  # noqa: BLE001 -- handed to the caller below
            errors[s] = e

    threads = [threading.Thread(target=shard, args=(s, d), name=f"shard-{s}") for s, d in enumerate(mesh.devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s, e in enumerate(errors):
        if e is not None:
            e.add_note(f"in shard {s} of {len(errors)}, on {mesh.devices[s]}")
            raise e
    return out


def batched_ba(probs: BAProblem, cam: Intrinsics, cfg: LMConfig = LMConfig(), mesh: Optional[DeviceMesh] = None) -> BAState:
    """Solve a leading-axis batch of BA problems: ``probs`` fields (B, ...)
    -> BAState fields (B, ...), each problem as ``run_lm`` solves it alone,
    in one set of launches per LM iteration. With a mesh of several entries
    each shard (:func:`shard_slices`) is solved on its own device by its own
    thread, every shard enqueued before any result is read; the states come
    back in sequence order on the mesh's first device."""
    solve = torch.func.vmap(lambda p: run_lm(p, cam, cfg))
    if mesh is None:
        return solve(probs)
    if len(mesh.devices) == 1:
        return solve(BAProblem(*(x.to(mesh.devices[0]) for x in probs)))
    parts = shard_slices(probs.poses.shape[0], mesh)
    states = run_sharded(mesh, lambda s, dev: solve(BAProblem(*(x[parts[s]].to(dev) for x in probs))))
    first = mesh.devices[0]
    return BAState(*(torch.cat([st[i].to(first) for st in states]) for i in range(len(BAState._fields))))


def _toy_problem(rng: np.random.Generator, P_: int, L: int, OL: int, cam: Intrinsics, device="cuda") -> BAProblem:
    """A consistent small synthetic BA problem (noiseless observations), the
    JAX package's draw for draw: P_ poses near the origin, the first held
    fixed and the others perturbed, L random world lines, OL observations
    (two pixels on each projected line)."""
    dev = resolve_device(device)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    xi = (rng.normal(size=(P_, 6)) * 0.05).astype(np.float32)
    poses = se3_exp(t(xi)).numpy()
    p = rng.normal(size=(L, 3)) * 2 + [0, 0, 8.0]
    q = p + rng.normal(size=(L, 3))
    Lw = plucker_from_points(t(p), t(q)).numpy()
    KL = line_projection_matrix(cam).numpy()
    l_pose = rng.integers(0, P_, OL).astype(np.int32)
    l_line = rng.integers(0, L, OL).astype(np.int32)
    Lc = plucker_transform(t(poses[l_pose]), t(Lw[l_line])).numpy()  # (OL, 6)
    l = Lc[:, :3] @ KL.T  # (OL, 3) projected image lines
    # two pixel points on each projected line
    d = np.stack([-l[:, 1], l[:, 0]], axis=1)
    d = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)
    x0 = np.array([320.0, 240.0])
    off = (l[:, 0] * x0[0] + l[:, 1] * x0[1] + l[:, 2]) / (l[:, 0] ** 2 + l[:, 1] ** 2 + 1e-9)
    base = x0[None, :] - off[:, None] * l[:, :2]
    eps = np.stack([base + 30 * d, base - 25 * d], axis=1).astype(np.float32)
    dxi = np.zeros((P_, 6), np.float32)
    dxi[1:] = (rng.normal(size=(P_ - 1, 6)) * 0.01).astype(np.float32)
    dT = se3_exp(t(dxi)).numpy()  # dT[0] = I: the anchor unperturbed
    perturbed = np.einsum("pij,pjk->pik", dT, poses).astype(np.float32)
    f32 = lambda a: t(a).to(dev)  # noqa: E731
    i32 = lambda a: t(a, torch.int32).to(dev)  # noqa: E731
    return BAProblem(
        poses=f32(perturbed),
        pose_free=f32((np.arange(P_) > 0).astype(np.float32)),
        lines=f32(Lw),
        line_valid=f32(np.ones(L, np.float32)),
        points=f32(np.zeros((1, 3), np.float32)),
        point_valid=f32(np.zeros(1, np.float32)),
        l_pose=i32(l_pose),
        l_line=i32(l_line),
        l_endpoints=f32(eps),
        l_valid=f32(np.ones(OL, np.float32)),
        l_sigma=f32(np.ones(OL, np.float32)),
        p_pose=i32(np.zeros(1, np.int32)),
        p_point=i32(np.zeros(1, np.int32)),
        p_uv=f32(np.zeros((1, 2), np.float32)),
        p_valid=f32(np.zeros(1, np.float32)),
        p_sigma=f32(np.ones(1, np.float32)),
    )


def stack_problems(probs) -> BAProblem:
    """A list of same-shape BAProblems -> one with a leading batch axis."""
    return BAProblem(*(torch.stack(xs) for xs in zip(*probs)))


def dryrun(n_devices: int = 1, device="cuda") -> None:
    """Run the whole config-#5 step on tiny shapes over an ``n_devices``
    mesh (:func:`make_mesh`) with one sequence per entry, as the JAX
    package's hook does: (1) batched multi-sequence tracking (one coarse and
    fine projection search and pose LM dispatch per shard) over
    detector-bypassing features and (2) the split batched local-BA solve."""
    from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState
    from tpuslam_torch.io.synthetic import make_wireframe_scene, synthetic_frame_features
    from tpuslam_torch.parallel.multi_seq import MultiTracker

    cam = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0)
    rng = np.random.default_rng(0)
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    B = len(mesh.devices)

    scenes = [
        make_wireframe_scene(np.random.default_rng(100 + s), n_segments=80, n_frames=3, cam=cam, motion_scale=0.01)
        for s in range(B)
    ]
    mt = MultiTracker([cam] * B, TrackerConfig(local_capacity=256), mesh=mesh)
    for f in range(3):
        per = [synthetic_frame_features(scenes[s], f, with_depth=True, device=dev)[0] for s in range(B)]
        feats = type(per[0])(*(torch.stack(xs) for xs in zip(*per)))
        rs = mt.track_features(feats, [f * 0.05] * B)
    if not all(r.state == TrackingState.OK for r in rs):
        raise RuntimeError(f"dryrun: tracking states {[r.state for r in rs]}")

    probs = stack_problems([_toy_problem(rng, P_=3, L=8, OL=32, cam=cam, device=dev) for _ in range(B)])
    state = batched_ba(probs, cam, LMConfig(max_iters=3), mesh=mesh)
    if tuple(state.poses.shape) != (B, 3, 4, 4) or not bool(torch.all(torch.isfinite(state.cost))):
        raise RuntimeError("dryrun: batched BA gave no finite solution")
