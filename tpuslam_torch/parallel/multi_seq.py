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
sequences split into shards, one per entry, each driven by a host thread of
its own on its device (the JAX package shards the same axis with a
``NamedSharding``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tpuslam_torch.backend.pose_opt import PoseOptConfig
from tpuslam_torch.device import resolve_device
from tpuslam_torch.frontend.frame import FrameFeatures, FrontendParams, StereoParams, extract_features, stereo_line_depths
from tpuslam_torch.frontend.matcher import ProjectionSearchParams, TrackStepResult, tracked_pose_step
from tpuslam_torch.frontend.tracking import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.geometry.camera import Intrinsics
from tpuslam_torch.kernels import cuda_lib
from tpuslam_torch.parallel.sharded_ba import DeviceMesh, run_sharded, shard_slices
from tpuslam_torch.slammap.map import SlamMap


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
    """The sequences ``seqs`` of a MultiTracker on one device, with their
    calibrations batched there."""

    seqs: slice
    device: torch.device
    fxb: torch.Tensor  # (n,) fx * baseline
    cam_b: Intrinsics  # (n,) fields


class MultiTracker:
    """Track N stereo sequences concurrently with batched device stages.

    With a mesh (``parallel.sharded_ba.DeviceMesh``) of k entries the N
    sequences split into k contiguous shards (``shard_slices``: k must
    divide N); sequence i's ``Tracker`` lives on its shard's device, and
    each frame runs every shard's batched stages on that shard's own host
    thread (``run_sharded``). Attach a sequence's ``LocalMapper`` on its
    tracker's ``device``: the mapper runs on the shard's thread too. A mesh
    of one entry, or none, is one shard on the calling thread."""

    def __init__(self, cams: Sequence[Intrinsics], cfg: Optional[TrackerConfig] = None, mesh=None, device="cuda"):
        if len({(c.width, c.height) for c in cams}) != 1:
            raise ValueError("all sequences must share an image shape")
        self.mesh = mesh if mesh is not None else DeviceMesh((resolve_device(device),))
        devices = [resolve_device(d) for d in self.mesh.devices]
        self.device = devices[0]
        self.cams = list(cams)
        self.cfg = cfg if cfg is not None else TrackerConfig()
        self.shards: List[_Shard] = []
        self.trackers: List[Tracker] = []
        for seqs, dev in zip(shard_slices(len(cams), self.mesh), devices):
            cs = self.cams[seqs]
            fxb = torch.tensor([float(np.float32(c.fx * c.baseline)) for c in cs], dtype=torch.float32, device=dev)
            self.shards.append(_Shard(seqs, dev, fxb, cam_batch(cs, dev)))
            self.trackers += [Tracker(c, SlamMap(), self.cfg, device=dev) for c in cs]
        if len(self.shards) > 1 and any(d.type == "cuda" for d in devices):
            cuda_lib.library()  # built and loaded before any shard thread runs

    def track_stereo(self, lefts: np.ndarray, rights: np.ndarray, timestamps: Sequence[float]):
        """lefts / rights: (N, H, W) frames. Returns one FrameResult per
        sequence. Each shard uploads its own frames to its device."""

        def shard(s: int, _dev) -> list:
            sh = self.shards[s]
            up = self.trackers[sh.seqs.start]._image  # (n, H, W) frames, u8 or f32, as one sequence's
            fl = batched_extract(up(np.stack(lefts[sh.seqs])), self.cfg.frontend)
            fr = batched_extract(up(np.stack(rights[sh.seqs])), self.cfg.frontend)
            feats = batched_stereo(fl, fr, sh.fxb, self.cfg.stereo)
            return self._track_shard(sh, feats, timestamps[sh.seqs])

        return [r for rs in run_sharded(self.mesh, shard) for r in rs]

    def track_features(self, feats, timestamps: Sequence[float]):
        """Track one batched-feature frame per sequence: ``feats`` with a
        leading N axis (each shard takes its rows to its device), or one
        FrameFeatures per shard on its device.

        Every sequence of a shard in steady tracking is solved by ONE batched
        coarse and fine dispatch (:func:`batched_track_step`), per-sequence
        calibrations included; all of the shard's rows are always dispatched
        (a row not in steady tracking carries its tracker's local map,
        zero-valid before initialization), so the shapes never change.
        Keyframe policy and map bookkeeping stay per sequence through
        ``Tracker._resolve_pending``; sequences that are initializing or
        LOST take their own synchronous path."""
        if isinstance(feats, FrameFeatures):
            if len(self.shards) == 1:
                per = [feats]
            else:
                per = [FrameFeatures(*(x[sh.seqs].to(sh.device) for x in feats)) for sh in self.shards]
        else:
            per = list(feats)
            if len(per) != len(self.shards):
                raise ValueError(f"track_features: {len(per)} feature batches for {len(self.shards)} shards")
        def shard(s: int, _dev) -> list:
            return self._track_shard(self.shards[s], per[s], timestamps[self.shards[s].seqs])

        return [r for rs in run_sharded(self.mesh, shard) for r in rs]

    def _track_shard(self, sh: _Shard, feats: FrameFeatures, timestamps: Sequence[float]) -> list:
        """One frame of the shard's sequences (``feats`` on its device)."""
        trackers = self.trackers[sh.seqs]
        results: List = [None] * len(trackers)
        steady = [i for i, tr in enumerate(trackers) if tr.state == TrackingState.OK and tr.last_T_cw is not None]
        for tr in trackers:
            tr.frame_idx += 1
        feat_i = lambda i: FrameFeatures(*(x[i] for x in feats))  # noqa: E731

        if steady:
            T_pred = np.stack([
                (tr.velocity @ tr.last_T_cw).astype(np.float32) if tr.last_T_cw is not None else np.eye(4, dtype=np.float32)
                for tr in trackers
            ])
            locs = [tr._local_map_arrays() for tr in trackers]
            stackk = lambda k: torch.stack([loc[k] for loc in locs])  # noqa: E731
            pose_b, midx_b, inl_b, nm_b, ni_b, packed_b = batched_track_step(
                trackers[0]._to_device(T_pred), stackk("plucker"), stackk("ep3d"), stackk("bits"),
                stackk("valid"), feats, sh.cam_b, self.cfg.search_coarse, self.cfg.search_fine, self.cfg.pose_opt,
            )
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
