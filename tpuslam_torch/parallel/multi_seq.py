"""Batched multi-sequence tracking (BASELINE config #5: N sequences tracked
concurrently) (torch).

Counterpart of ``tpuslam.parallel.multi_seq``. The JAX package vmaps its
per-frame programs over a leading sequence axis; here the same stages take
that axis directly, so N sequences cost one set of kernel launches per
stage instead of N:

- :func:`batched_extract`: ``extract_features`` of a (N, H, W) batch. Every
  hand kernel runs once for the batch (the batched entry points of
  ``csrc/``: grid z, or y, over the images) and the detector's eager steps
  carry the axis; each sequence's features are bit for bit its own call's.
- :func:`batched_stereo`: descriptor stereo with a per-sequence
  ``fx * baseline`` (N,).
- :func:`batched_track_step`: the coarse and fine projection search and
  pose LM for all N sequences, per-sequence calibrations included
  (:func:`cam_batch`), through ``torch.func.vmap`` (these stages are plain
  PyTorch, no kernel inside).

Host control flow (keyframe policy, map bookkeeping) stays per sequence:
:class:`MultiTracker` owns N port ``Tracker``s and feeds them the batched
results through their own resolve (one host read of the batch's packed
rows per frame). Sequences that are initializing or LOST take their own
synchronous path, as in the reference. Over a mesh of several entries the
sequences split into shards, one per entry, each driven by a process of its
own on its device (``shard_pool``; the JAX package shards the same axis
with a ``NamedSharding``).
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tpuslam_torch.backend.mapping import LocalMapper, MapperConfig
from tpuslam_torch.backend.pose_opt import PoseOptConfig
from tpuslam_torch.device import resolve_device
from tpuslam_torch.frontend.frame import FrameFeatures, FrontendParams, StereoParams, extract_features, stereo_line_depths
from tpuslam_torch.frontend.matcher import ProjectionSearchParams, TrackStepResult, tracked_pose_step
from tpuslam_torch.frontend.tracking import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.kernels import cuda_lib
from tpuslam_torch.parallel.sharded_ba import DeviceMesh, shard_slices
from tpuslam_torch.slammap.map import SlamMap
from tpuslam_torch.spans import span


def batched_extract(imgs: torch.Tensor, params: FrontendParams) -> FrameFeatures:
    """(N, H, W) float32 images in [0, 1] -> FrameFeatures with a leading N
    axis, one set of kernel launches for the batch."""
    if imgs.dim() != 3:
        raise ValueError(f"batched_extract: expected (N, H, W) images, got {tuple(imgs.shape)}")
    return extract_features(imgs, params)


def batched_stereo(left: FrameFeatures, right: FrameFeatures, fxb: torch.Tensor, params: StereoParams) -> FrameFeatures:
    """Batched stereo association; ``fxb`` (N,) per-sequence fx * baseline."""
    return torch.func.vmap(lambda l, r, f: stereo_line_depths(l, r, f, params))(left, right, fxb)


def cam_batch(cams: Sequence[Intrinsics], device="cuda") -> Intrinsics:
    """N Intrinsics as one Intrinsics of (N,) float32 tensors on ``device``,
    which :func:`batched_track_step` maps over: each sequence keeps its own
    calibration within one batched dispatch."""
    dev = resolve_device(device)
    return Intrinsics(
        *[torch.tensor([float(getattr(c, f)) for c in cams], dtype=torch.float32, device=dev) for f in Intrinsics._fields]
    )


def batched_track_step(
    T_pred: torch.Tensor,  # (N, 4, 4)
    map_plucker: torch.Tensor,  # (N, L, 6)
    map_ep3d: torch.Tensor,  # (N, L, 2, 3)
    map_bits: torch.Tensor,  # (N, L, W)
    map_validf: torch.Tensor,  # (N, L)
    feats: FrameFeatures,  # batched
    cams: Intrinsics,  # (N,) fields, from cam_batch
    search: ProjectionSearchParams,
    search_fine: Optional[ProjectionSearchParams] = None,
    opt: PoseOptConfig = PoseOptConfig(),
):
    """The coarse and fine tracking stage (``tracked_pose_step``, as
    ``Tracker._track_frame_sync`` runs it) for all N sequences in one set of
    launches. Returns (pose, match_idx, inlier, n_matched, n_inliers,
    packed), each with a leading N axis; ``packed`` rows hold pose (16),
    n_matched, n_inliers and the frame's depth count, the layout
    ``Tracker._resolve_pending`` reads."""

    def one(T, lines, ep3d, bits, validf, f, cam):
        out = tracked_pose_step(T, lines, ep3d, bits, validf, f, cam, search, opt)
        if search_fine is not None:
            out = tracked_pose_step(out.pose, lines, ep3d, bits, validf, f, cam, search_fine, opt)
        packed = torch.cat([
            out.pose.reshape(-1),
            torch.stack([out.num_matched.to(torch.float32), out.num_inliers.to(torch.float32), f.has_depth.sum()]),
        ])
        return out.pose, out.match_idx, out.inlier, out.num_matched, out.num_inliers, packed

    return torch.func.vmap(one)(T_pred, map_plucker, map_ep3d, map_bits, map_validf, feats, cams)


class _Shard(NamedTuple):
    """The sequences of a MultiTracker that run in this process, on one
    device, with their calibrations batched there."""

    device: torch.device
    fxb: torch.Tensor  # (n,) fx * baseline
    cam_b: Intrinsics  # (n,) fields


_HANDLES = itertools.count()


class MultiTracker:
    """Track N stereo sequences concurrently with batched device stages.

    ``mapper_cfg`` gives each sequence a ``LocalMapper`` with that config on
    its tracker's device, wired to the tracker (None: tracking alone).

    With a mesh (``parallel.sharded_ba.DeviceMesh``) of k > 1 entries the N
    sequences split into k contiguous shards (``shard_slices``: k must
    divide N), each in the mesh's shard process for its entry
    (``shard_pool``), where its trackers and mappers live: each frame sends
    every shard its rows as numpy before any result is read, and the
    results come back in sequence order. This process holds no tracker of
    such a shard: :meth:`stats` reads them, :meth:`reset_counts` zeroes
    their counters and :meth:`in_shards` runs a module-level function on
    each shard's own (one-entry) MultiTracker. A mesh of one entry, or none,
    runs in this process, and ``trackers`` holds its trackers."""

    def __init__(
        self,
        cams: Sequence[Intrinsics],
        cfg: Optional[TrackerConfig] = None,
        mesh=None,
        device="cuda",
        mapper_cfg: Optional[MapperConfig] = None,
    ):
        if len({(c.width, c.height) for c in cams}) != 1:
            raise ValueError("all sequences must share an image shape")
        self.mesh = mesh if mesh is not None else DeviceMesh((resolve_device(device),))
        devices = [resolve_device(d) for d in self.mesh.devices]
        self.device = devices[0]
        self.cams = list(cams)
        self.cfg = cfg if cfg is not None else TrackerConfig()
        self.slices = shard_slices(len(cams), self.mesh)
        self.batched_dispatches = 0  # batched_track_step calls made in this process
        self._pool = None
        if len(devices) > 1:
            from tpuslam_torch.parallel.shard_pool import pool_of

            self._pool = pool_of(self.mesh)
            self._handle = next(_HANDLES)
            self._pool.run(_shard_open, [
                (self._handle, [tuple(c) for c in self.cams[sl]], self.cfg, mapper_cfg) for sl in self.slices
            ])
            return
        dev = devices[0]
        fxb = torch.tensor([float(np.float32(c.fx * c.baseline)) for c in self.cams], dtype=torch.float32, device=dev)
        self._shard = _Shard(dev, fxb, cam_batch(self.cams, dev))
        self._trackers = [Tracker(c, SlamMap(), self.cfg, device=dev) for c in self.cams]
        if mapper_cfg is not None:
            for cam, tr in zip(self.cams, self._trackers):
                m = LocalMapper(tr.map, cam, mapper_cfg, device=tr.device)
                tr.on_new_keyframe, m.on_map_changed = m.process, tr.invalidate_local_map

    @property
    def trackers(self) -> List[Tracker]:
        """The sequences' trackers, where they run in this process."""
        if self._pool is not None:
            raise RuntimeError("the trackers of a split MultiTracker live in its shard processes: read them through stats()")
        return self._trackers

    def _run(self, fn: Callable, per_shard: Sequence[tuple]) -> list:
        return self._pool.run(fn, [(self._handle, *a) for a in per_shard])

    def track_stereo(self, lefts: np.ndarray, rights: np.ndarray, timestamps: Sequence[float]):
        """lefts / rights: (N, H, W) frames. Returns one FrameResult per
        sequence. Each shard uploads its own frames to its device (a process
        shard receives its rows as numpy, uint8 staying uint8)."""
        with span("facade.track_stereo"):
            if self._pool is not None:
                rows = [
                    (np.ascontiguousarray(np.stack(lefts[sl])), np.ascontiguousarray(np.stack(rights[sl])),
                     [float(t) for t in timestamps[sl]])
                    for sl in self.slices
                ]
                return [r for rs in self._run(_shard_track_stereo, rows) for r in rs]
            up = self._trackers[0]._image  # (N, H, W) frames, u8 or f32, as one sequence's
            fe = []
            for frames in (lefts, rights):
                with span("frontend.upload"):
                    imgs = up(np.stack(frames))
                with span("frontend.extract"):
                    fe.append(batched_extract(imgs, self.cfg.frontend))
            with span("frontend.stereo"):
                feats = batched_stereo(fe[0], fe[1], self._shard.fxb, self.cfg.stereo)
            return self._track_shard(feats, timestamps)

    def track_features(self, feats, timestamps: Sequence[float]):
        """Track one batched-feature frame per sequence: ``feats`` with a
        leading N axis (each shard takes its rows to its device: a process
        shard receives them as numpy), or one FrameFeatures per shard.

        Every sequence of a shard in steady tracking is solved by ONE batched
        coarse and fine dispatch (:func:`batched_track_step`), per-sequence
        calibrations included; all of the shard's rows are always dispatched
        (a row not in steady tracking carries its tracker's local map,
        zero-valid before initialization), so the shapes never change.
        Keyframe policy and map bookkeeping stay per sequence through
        ``Tracker._resolve_pending``; sequences that are initializing or
        LOST take their own synchronous path."""
        k = len(self.slices)
        if isinstance(feats, FrameFeatures):
            per = [feats] if k == 1 else [FrameFeatures(*(x[sl] for x in feats)) for sl in self.slices]
        else:
            per = list(feats)
            if len(per) != k:
                raise ValueError(f"track_features: {len(per)} feature batches for {k} shards")
        if self._pool is not None:
            rows = [(tuple(x.cpu().numpy() for x in f), [float(t) for t in timestamps[sl]]) for f, sl in zip(per, self.slices)]
            return [r for rs in self._run(_shard_track_features, rows) for r in rs]
        return self._track_shard(FrameFeatures(*(x.to(self.device) for x in per[0])), timestamps)

    def stats(self) -> dict:
        """What the caller reads of the sequences and shards, wherever they
        run: ``sequences`` (per sequence: device, keyframes' frame indices,
        live map lines and points, T_cw) and ``shards`` (per shard: device,
        process id, batched dispatches, the hand kernels'
        ``cuda_lib.kernel_counts``)."""
        parts = self.in_shards(_stats_of)
        return {"sequences": [q for p in parts for q in p["sequences"]], "shards": [p["shard"] for p in parts]}

    def reset_counts(self) -> None:
        """The batched dispatches and the hand-kernel counters of every shard
        (this process's for a one-entry mesh) to 0."""
        self.in_shards(_reset_of)

    def in_shards(self, fn: Callable, *args) -> list:
        """``[fn(shard's MultiTracker, s, *args) for each shard s]``, each in
        the shard's process (``fn`` module-level, ``args`` picklable); with
        one entry ``fn(self, 0, *args)`` here."""
        if self._pool is not None:
            return self._run(_shard_call, [(fn, s, args) for s in range(len(self.slices))])
        return [fn(self, 0, *args)]

    def close(self) -> None:
        """Drop the shards' trackers and mappers from their processes (the
        processes stay, for the mesh's other users)."""
        if self._pool is not None and not self._pool.closed:
            self._run(_shard_close, [()] * len(self.slices))

    def _track_shard(self, feats: FrameFeatures, timestamps: Sequence[float]) -> list:
        """One frame of this process's sequences (``feats`` on its device)."""
        sh, trackers = self._shard, self._trackers
        results: List = [None] * len(trackers)
        steady = [i for i, tr in enumerate(trackers) if tr.state == TrackingState.OK and tr.last_T_cw is not None]
        for tr in trackers:
            tr.frame_idx += 1
        feat_i = lambda i: FrameFeatures(*(x[i] for x in feats))  # noqa: E731

        if steady:
            with span("tracking.track_step"):  # the step's inputs (local maps rebuilt where stale) and its enqueue
                T_pred = np.stack([
                    (tr.velocity @ tr.last_T_cw).astype(np.float32) if tr.last_T_cw is not None else np.eye(4, dtype=np.float32)
                    for tr in trackers
                ])
                locs = [tr._local_map_arrays() for tr in trackers]
                stackk = lambda k: torch.stack([loc[k] for loc in locs])  # noqa: E731
                self.batched_dispatches += 1
                pose_b, midx_b, inl_b, nm_b, ni_b, packed_b = batched_track_step(
                    trackers[0]._to_device(T_pred), stackk("plucker"), stackk("ep3d"), stackk("bits"),
                    stackk("valid"), feats, sh.cam_b, self.cfg.search_coarse, self.cfg.search_fine, self.cfg.pose_opt,
                )
            with span("tracking.read_packed"):
                packed = packed_b.cpu().numpy()  # one host read for the shard's batch
            for i in steady:
                tr = trackers[i]
                fine_i = TrackStepResult(pose_b[i], midx_b[i], inl_b[i], nm_b[i], ni_b[i])
                results[i] = tr._resolve_pending(
                    tr.frame_idx, timestamps[i], feat_i(i), fine_i, True, tr._local_ids.copy(), tr._local_valid.copy(),
                    packed[i],
                )

        for i, tr in enumerate(trackers):
            if results[i] is None:
                results[i] = tr._track(feat_i(i), timestamps[i], stereo=True)
        return results


# ---- the requests a shard process serves (shard_pool) ----------------------------


def _stats_of(mt: MultiTracker, s: int) -> dict:
    seqs = [
        {
            "device": str(tr.device),
            "keyframes": sorted(kf.frame_idx for kf in tr.map.keyframes.values()),
            "map_lines": int(tr.map.lines.alive.sum()),
            "map_points": int(tr.map.points.alive.sum()),
            "T_cw": np.array(tr.T_cw),
        }
        for tr in mt._trackers
    ]
    shard = {"device": str(mt.device), "pid": os.getpid(), "batched_dispatches": mt.batched_dispatches}
    shard.update(cuda_lib.kernel_counts())
    return {"sequences": seqs, "shard": shard}


def _reset_of(mt: MultiTracker, s: int) -> None:
    mt.batched_dispatches = 0
    cuda_lib.reset_kernel_counts()


def _shard_open(ctx, handle: int, cams: list, cfg: TrackerConfig, mapper_cfg: Optional[MapperConfig]) -> None:
    ctx.objects[handle] = MultiTracker(
        [Intrinsics(*c) for c in cams], cfg, mesh=DeviceMesh((ctx.device,)), mapper_cfg=mapper_cfg
    )


def _shard_track_stereo(ctx, handle: int, lefts: np.ndarray, rights: np.ndarray, timestamps: list) -> list:
    return ctx.objects[handle].track_stereo(lefts, rights, timestamps)


def _shard_track_features(ctx, handle: int, fields: tuple, timestamps: list) -> list:
    feats = FrameFeatures(*(torch.from_numpy(a).to(ctx.device) for a in fields))
    return ctx.objects[handle].track_features(feats, timestamps)


def _shard_call(ctx, handle: int, fn: Callable, s: int, args: tuple):
    return fn(ctx.objects[handle], s, *args)


def _shard_close(ctx, handle: int) -> None:
    ctx.objects.pop(handle, None)
