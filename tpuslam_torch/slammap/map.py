"""Map data model: keyframes, 3D line landmarks, covisibility (host side).

Counterpart of ``tpuslam.slammap.map`` for what the tracking path uses:
a fixed-capacity struct-of-arrays line store in numpy, keyframes holding
numpy copies of their features, and the covisibility graph as python dicts.
Culling, fusion and the native C++ graph mirror come with local mapping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.frontend.frame import FrameFeatures


def features_to_numpy(f: FrameFeatures) -> FrameFeatures:
    """Host copy of a FrameFeatures; descriptor words as the JAX package's
    uint32."""
    arrs = [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in f]
    out = FrameFeatures(*arrs)
    return out._replace(desc_bits=out.desc_bits.astype(np.uint32))


@dataclass
class KeyFrame:
    """A persistent frame promoted into the map."""

    kid: int
    frame_idx: int
    timestamp: float
    T_cw: np.ndarray  # (4, 4)
    features: FrameFeatures  # numpy copies, capacity K
    line_ids: np.ndarray  # (K,) int32: feature slot -> MapLine id (-1 = none)
    parent: Optional[int] = None  # spanning tree: best covisible keyframe
    children: set = field(default_factory=set)


class MapLineStore:
    """Fixed-capacity SoA store of 3D line landmarks (Pluecker, world frame)."""

    def __init__(self, capacity: int = 16384, desc_words: int = 8):
        self.capacity = capacity
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
        return lid

    def add_observation(self, lid: int, kf: KeyFrame, slot: int):
        if not self.alive[lid]:
            return
        self.obs[lid][kf.kid] = slot
        self.n_obs[lid] = len(self.obs[lid])
        kf.line_ids[slot] = lid

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]


class SlamMap:
    """Global map: keyframes + line landmarks + covisibility graph."""

    def __init__(self, line_capacity: int = 16384):
        self.keyframes: Dict[int, KeyFrame] = {}
        self.lines = MapLineStore(line_capacity)
        self._next_kid = 0
        self.covis: Dict[int, Dict[int, int]] = {}  # kf id -> {kf id: shared lines}

    def new_keyframe(self, frame_idx: int, timestamp: float, T_cw: np.ndarray, features: FrameFeatures) -> KeyFrame:
        f = features_to_numpy(features)
        kf = KeyFrame(
            kid=self._next_kid,
            frame_idx=frame_idx,
            timestamp=timestamp,
            T_cw=np.asarray(T_cw, np.float32).copy(),
            features=f,
            line_ids=np.full(f.valid.shape[0], -1, np.int32),
        )
        self._next_kid += 1
        self.keyframes[kf.kid] = kf
        self.covis[kf.kid] = {}
        return kf

    def update_connections(self, kf: KeyFrame):
        """Recount shared landmarks between kf and every keyframe observing
        its landmarks; refresh both adjacency rows and the spanning tree."""
        counts: Dict[int, int] = {}
        for lid in kf.line_ids:
            if lid < 0:
                continue
            for kid in self.lines.obs.get(int(lid), {}):
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

    def local_window(self, kid: int, size: int) -> Tuple[List[int], List[int]]:
        """(window KF ids, their landmark ids): the KF + its best covisible KFs."""
        window = [kid] + self.covisible_keyframes(kid, n=size - 1)
        lids = set()
        for k in window:
            lids.update(int(l) for l in self.keyframes[k].line_ids if l >= 0)
        return window, sorted(lids)
