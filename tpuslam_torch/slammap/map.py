"""Map data model: keyframes, 3D line landmarks, covisibility (host side).

Counterpart of ``tpuslam.slammap.map``: fixed-capacity struct-of-arrays
line and point stores in numpy (LIFO free lists, so landmark ids follow the
JAX stores'), keyframes holding numpy copies of their line features and,
with the hybrid front end, their corner features, and the covisibility
graph as python dicts counting shared lines and points. As in the JAX map, the
line store keeps a native graph mirror (``slammap/native.py``) in lockstep
unless ``TPUSLAM_NATIVE_MAP=0``: ``update_connections`` takes its line
counts from it, sorted by count, so covisibility ties fall in its order,
the JAX package's default.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.kernels.fast import PointFeatures
from tpuslam_torch.slammap.points import MapPointStore


def features_to_numpy(f: FrameFeatures) -> FrameFeatures:
    """Host copy of a FrameFeatures; descriptor words as the JAX package's
    uint32."""
    arrs = [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in f]
    out = FrameFeatures(*arrs)
    return out._replace(desc_bits=out.desc_bits.astype(np.uint32))


def features_to_device(f: FrameFeatures, device) -> FrameFeatures:
    """FrameFeatures of numpy arrays -> tensors on ``device``: uint32
    descriptor words become int64 words, levels int32, the rest float32."""
    out = {}
    for name, a in zip(FrameFeatures._fields, f):
        a = np.asarray(a)
        if name == "desc_bits":
            a = a.astype(np.uint32).astype(np.int64)
        else:
            a = a.astype(np.int32 if name == "level" else np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FrameFeatures(**out)


def point_features_to_numpy(f: PointFeatures) -> PointFeatures:
    """Host copy of a PointFeatures; descriptor words as uint32."""
    arrs = [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in f]
    out = PointFeatures(*arrs)
    return out._replace(desc_bits=out.desc_bits.astype(np.uint32))


def point_features_to_device(f: PointFeatures, device) -> PointFeatures:
    """PointFeatures of numpy arrays -> tensors on ``device``: uint32
    descriptor words become int64 words, the rest float32."""
    out = {}
    for name, a in zip(PointFeatures._fields, f):
        a = np.asarray(a)
        a = a.astype(np.uint32).astype(np.int64) if name == "desc_bits" else a.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PointFeatures(**out)


@dataclass
class KeyFrame:
    """A persistent frame promoted into the map."""

    kid: int
    frame_idx: int
    timestamp: float
    T_cw: np.ndarray  # (4, 4)
    features: FrameFeatures  # numpy copies, capacity K
    line_ids: np.ndarray  # (K,) int32: feature slot -> MapLine id (-1 = none)
    is_bad: bool = False
    parent: Optional[int] = None  # spanning tree: best covisible keyframe
    children: set = field(default_factory=set)
    loop_edges: set = field(default_factory=set)  # kids of the keyframes a loop closure joined
    # hybrid point landmarks: present only with the point front end
    point_features: Optional[PointFeatures] = None  # numpy copies, capacity KP
    point_ids: Optional[np.ndarray] = None  # (KP,) int32: corner slot -> MapPoint id (-1 = none)

    @property
    def T_wc(self) -> np.ndarray:
        R = self.T_cw[:3, :3]
        Ti = np.eye(4, dtype=self.T_cw.dtype)
        Ti[:3, :3] = R.T
        Ti[:3, 3] = -R.T @ self.T_cw[:3, 3]
        return Ti

    @property
    def center(self) -> np.ndarray:
        """Camera center in world coordinates."""
        return self.T_wc[:3, 3]


class MapLineStore:
    """Fixed-capacity SoA store of 3D line landmarks (Pluecker, world frame)."""

    def __init__(self, capacity: int = 16384, desc_words: int = 8):
        self.capacity = capacity
        # the native graph mirror (NativeMapStore) or None; every mutation
        # below is mirrored, and both free lists are LIFO, so ids agree
        self.mirror = None
        self.plucker = np.zeros((capacity, 6), np.float32)
        self.endpoints = np.zeros((capacity, 2, 3), np.float32)  # world 3D
        self.alive = np.zeros(capacity, bool)
        self.desc_bits = np.zeros((capacity, desc_words), np.uint32)
        self.n_obs = np.zeros(capacity, np.int32)
        self.first_kf = np.full(capacity, -1, np.int32)
        self.obs: Dict[int, Dict[int, int]] = {}  # line id -> {kf id: slot}
        self._next = 0
        self._free: List[int] = []

    def allocate(self, plucker, endpoints, desc_bits, first_kf: int) -> int:
        if self._free:
            lid = self._free.pop()
        else:
            lid = self._next
            if lid >= self.capacity:
                raise RuntimeError("MapLineStore capacity exceeded")
            self._next += 1
        self.plucker[lid] = plucker
        self.endpoints[lid] = endpoints
        self.desc_bits[lid] = desc_bits
        self.alive[lid] = True
        self.n_obs[lid] = 0
        self.first_kf[lid] = first_kf
        self.obs[lid] = {}
        if self.mirror is not None and self.mirror.allocate(first_kf) != lid:
            self.mirror = None  # lockstep broken (a capacity mismatch): drop it, as the JAX store does
        return lid

    def add_observation(self, lid: int, kf: KeyFrame, slot: int):
        if not self.alive[lid]:
            return
        self.obs[lid][kf.kid] = slot
        self.n_obs[lid] = len(self.obs[lid])
        kf.line_ids[slot] = lid
        if self.mirror is not None:
            self.mirror.add_observation(lid, kf.kid, slot)

    def erase_observation(self, lid: int, kf: KeyFrame):
        o = self.obs.get(lid)
        if o is None or kf.kid not in o:
            return
        slot = o.pop(kf.kid)
        if kf.line_ids[slot] == lid:
            kf.line_ids[slot] = -1
        self.n_obs[lid] = len(o)
        if self.mirror is not None:
            self.mirror.erase_observation(lid, kf.kid)

    def kill(self, lid: int, keyframes: Dict[int, KeyFrame]):
        """Remove the landmark and all its observations."""
        if not self.alive[lid]:
            return
        for kid, slot in list(self.obs.get(lid, {}).items()):
            kf = keyframes.get(kid)
            if kf is not None and kf.line_ids[slot] == lid:
                kf.line_ids[slot] = -1
        self.obs.pop(lid, None)
        self.alive[lid] = False
        self._free.append(lid)
        if self.mirror is not None:
            self.mirror.kill(lid)

    def replace(self, old: int, new: int, keyframes: Dict[int, KeyFrame]):
        """Fuse duplicate landmarks: move old's observations onto new."""
        if old == new or not self.alive[old]:
            return
        for kid, slot in list(self.obs.get(old, {}).items()):
            kf = keyframes.get(kid)
            if kf is None:
                continue
            if kid not in self.obs.setdefault(new, {}):
                self.obs[new][kid] = slot
                kf.line_ids[slot] = new
            elif kf.line_ids[slot] == old:
                kf.line_ids[slot] = -1
        self.n_obs[new] = len(self.obs[new])
        self.obs.pop(old, None)
        self.alive[old] = False
        self._free.append(old)
        if self.mirror is not None:
            self.mirror.replace(old, new)

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]


class SlamMap:
    """Global map: keyframes + line and point landmarks + covisibility graph."""

    def __init__(self, line_capacity: int = 16384, point_capacity: int = 16384, native: bool | None = None):
        """``native``: keep the line store's native graph mirror; None reads
        TPUSLAM_NATIVE_MAP (default "1", as the JAX map). A mirror that is
        asked for but cannot be built or loaded raises (the JAX map falls
        back to python silently)."""
        self.keyframes: Dict[int, KeyFrame] = {}
        self.lines = MapLineStore(line_capacity)
        self.points = MapPointStore(point_capacity)
        if native is None:
            native = os.environ.get("TPUSLAM_NATIVE_MAP", "1") == "1"
        if native:
            from tpuslam_torch.slammap.native import NativeMapStore

            self.lines.mirror = NativeMapStore(line_capacity=line_capacity)
        self._next_kid = 0
        self.covis: Dict[int, Dict[int, int]] = {}  # kf id -> {kf id: shared landmarks}
        # bumped on every global correction (a loop closure)
        self.generation = 0
        # callback(kid) when a keyframe is culled (System hooks the keyframe
        # database here so culled keyframes leave the scoring set)
        self.on_keyframe_erased = None

    def new_keyframe(
        self, frame_idx: int, timestamp: float, T_cw: np.ndarray, features: FrameFeatures, point_features=None
    ) -> KeyFrame:
        f = features_to_numpy(features)
        kf = KeyFrame(
            kid=self._next_kid,
            frame_idx=frame_idx,
            timestamp=timestamp,
            T_cw=np.asarray(T_cw, np.float32).copy(),
            features=f,
            line_ids=np.full(f.valid.shape[0], -1, np.int32),
        )
        if point_features is not None:
            kf.point_features = point_features_to_numpy(point_features)
            kf.point_ids = np.full(kf.point_features.valid.shape[0], -1, np.int32)
        self._next_kid += 1
        self.keyframes[kf.kid] = kf
        self.covis[kf.kid] = {}
        m = self.lines.mirror
        if m is not None:
            if kf.kid < m.kf_capacity and f.valid.shape[0] <= m.feat_capacity:
                m.add_keyframe(kf.kid)
            else:  # beyond the native capacities: python from here on, as the JAX map
                self.lines.mirror = None
        return kf

    def erase_keyframe(self, kid: int):
        """Keyframe culling: drop its observations and covisibility edges and
        re-parent its spanning-tree children to its parent."""
        kf = self.keyframes.get(kid)
        if kf is None:
            return
        for lid in np.unique(kf.line_ids):
            if lid >= 0:
                self.lines.erase_observation(int(lid), kf)
        if kf.point_ids is not None:
            for pid in np.unique(kf.point_ids):
                if pid >= 0:
                    self.points.erase_observation(int(pid), kf)
        for other in list(self.covis.get(kid, {})):
            self.covis.get(other, {}).pop(kid, None)
        self.covis.pop(kid, None)
        for child in kf.children:
            ckf = self.keyframes.get(child)
            if ckf is not None:
                ckf.parent = kf.parent
                if kf.parent is not None:
                    self.keyframes[kf.parent].children.add(child)
        if kf.parent is not None:
            self.keyframes[kf.parent].children.discard(kid)
        kf.is_bad = True
        del self.keyframes[kid]
        if self.lines.mirror is not None:
            self.lines.mirror.remove_keyframe(kid)
        if self.on_keyframe_erased is not None:
            self.on_keyframe_erased(kid)

    def update_connections(self, kf: KeyFrame):
        """Recount shared landmarks (lines, then points) between kf and every
        keyframe observing them; refresh both adjacency rows and the
        spanning tree. The line counts come from the native mirror where
        there is one (in its order: by count, descending)."""
        m = self.lines.mirror
        if m is not None:
            kids, ws = m.covisibility(kf.kid)
            counts: Dict[int, int] = {int(k): int(w) for k, w in zip(kids, ws) if int(k) != kf.kid}
            families = ((kf.point_ids, self.points),)
        else:
            counts = {}
            families = ((kf.line_ids, self.lines), (kf.point_ids, self.points))
        for ids, store in families:
            for lm in () if ids is None else ids:
                if lm < 0:
                    continue
                for kid in store.obs.get(int(lm), {}):
                    if kid != kf.kid:
                        counts[kid] = counts.get(kid, 0) + 1
        old = self.covis.get(kf.kid, {})
        for other in list(old):
            if other not in counts:
                self.covis.get(other, {}).pop(kf.kid, None)
        self.covis[kf.kid] = counts
        for other, c in counts.items():
            if other in self.covis:
                self.covis[other][kf.kid] = c
        if kf.parent is None and counts and kf.kid != min(self.keyframes):
            best = max(counts, key=counts.get)
            kf.parent = best
            self.keyframes[best].children.add(kf.kid)

    def covisible_keyframes(self, kid: int, n: int | None = None, min_weight: int = 1) -> List[int]:
        """Neighbours sorted by covisibility weight, descending."""
        row = self.covis.get(kid, {})
        ids = sorted(
            (k for k, w in row.items() if w >= min_weight and k in self.keyframes),
            key=lambda k: -row[k],
        )
        return ids if n is None else ids[:n]

    def all_keyframe_ids(self) -> List[int]:
        return sorted(self.keyframes)

    def local_window(self, kid: int, size: int) -> Tuple[List[int], List[int]]:
        """(window KF ids, their landmark ids): the KF + its best covisible KFs."""
        window = [kid] + self.covisible_keyframes(kid, n=size - 1)
        lids = set()
        for k in window:
            lids.update(int(l) for l in self.keyframes[k].line_ids if l >= 0)
        return window, sorted(lids)

    def window_point_ids(self, window: List[int]) -> List[int]:
        """Point landmarks observed by a keyframe window (the companion of
        :meth:`local_window`'s line ids)."""
        pids = set()
        for k in window:
            kf = self.keyframes.get(k)
            if kf is None or kf.point_ids is None:
                continue
            pids.update(int(p) for p in kf.point_ids if p >= 0)
        return sorted(pids)
