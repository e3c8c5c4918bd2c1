"""Point landmark store (host side, numpy).

Counterpart of ``tpuslam.slammap.points``: a fixed-capacity struct-of-arrays
store of 3D point landmarks beside the line store, with per-landmark
observation dicts and a LIFO free list, so landmark ids follow the JAX
store's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class MapPointStore:
    """Fixed-capacity SoA store of 3D point landmarks (world frame)."""

    def __init__(self, capacity: int = 16384, desc_words: int = 8):
        self.capacity = capacity
        self.xyz = np.zeros((capacity, 3), np.float32)
        self.alive = np.zeros(capacity, bool)
        self.desc_bits = np.zeros((capacity, desc_words), np.uint32)
        self.n_obs = np.zeros(capacity, np.int32)
        self.first_kf = np.full(capacity, -1, np.int32)
        self.obs: Dict[int, Dict[int, int]] = {}  # point id -> {kf id: corner slot}
        self._next = 0
        self._free: List[int] = []

    def allocate(self, xyz, desc_bits, first_kf: int) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            pid = self._next
            if pid >= self.capacity:
                raise RuntimeError("MapPointStore capacity exceeded")
            self._next += 1
        self.xyz[pid] = xyz
        self.desc_bits[pid] = desc_bits
        self.alive[pid] = True
        self.n_obs[pid] = 0
        self.first_kf[pid] = first_kf
        self.obs[pid] = {}
        return pid

    def add_observation(self, pid: int, kf, slot: int):
        if not self.alive[pid]:
            return
        self.obs[pid][kf.kid] = slot
        self.n_obs[pid] = len(self.obs[pid])
        kf.point_ids[slot] = pid

    def erase_observation(self, pid: int, kf):
        o = self.obs.get(pid)
        if o is None or kf.kid not in o:
            return
        slot = o.pop(kf.kid)
        if kf.point_ids[slot] == pid:
            kf.point_ids[slot] = -1
        self.n_obs[pid] = len(o)

    def kill(self, pid: int, keyframes: dict):
        """Remove the landmark and all its observations."""
        if not self.alive[pid]:
            return
        for kid, slot in list(self.obs.get(pid, {}).items()):
            kf = keyframes.get(kid)
            if kf is not None and kf.point_ids[slot] == pid:
                kf.point_ids[slot] = -1
        self.obs.pop(pid, None)
        self.alive[pid] = False
        self._free.append(pid)

    def replace(self, old: int, new: int, keyframes: dict):
        """Fuse duplicate landmarks: move old's observations onto new."""
        if old == new or not self.alive[old]:
            return
        for kid, slot in list(self.obs.get(old, {}).items()):
            kf = keyframes.get(kid)
            if kf is None:
                continue
            if kid not in self.obs.setdefault(new, {}):
                self.obs[new][kid] = slot
                kf.point_ids[slot] = new
            elif kf.point_ids[slot] == old:
                kf.point_ids[slot] = -1
        self.n_obs[new] = len(self.obs[new])
        self.obs.pop(old, None)
        self.alive[old] = False
        self._free.append(old)

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]
