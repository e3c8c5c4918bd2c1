"""The keyframe database: place recognition for relocalization (torch).

Counterpart of ``tpuslam.backend.loop_closing``'s ``KeyFrameDatabase`` and
``_db_scores``: vocabulary-free brute-force scoring of the current frame's
binary line descriptors against every stored keyframe. The JAX package
computes the Hamming distances as a +-1 matmul on the MXU; here they are
XOR + popcount on int64 words, as in ``kernels.match``. Both are exact
integers, so the scores are equal. With ``point_slots`` (the hybrid front
end) each row carries the keyframe's BRIEF corner descriptors after its
line descriptors, and a query scores both families. ``LoopCloser``
(detection, Sim(3) correction, the essential graph) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tpuslam_torch.device import resolve_device
from tpuslam_torch.kernels.match import hamming_distance_matrix
from tpuslam_torch.slammap.map import KeyFrame


def _db_scores(
    cur_bits: torch.Tensor,  # (K, W) int64 words
    cur_valid: torch.Tensor,  # (K,)
    db_bits: torch.Tensor,  # (N, K, W) int64 words
    db_valid: torch.Tensor,  # (N, K) f32; all-zero rows are empty slots
    tau: float = 60.0,
    chunk: int = 8,
) -> torch.Tensor:
    """Per-keyframe similarity: the number of valid current descriptors whose
    nearest valid neighbour in that keyframe lies within Hamming distance
    tau - 1. (N,) int32. Keyframes go ``chunk`` at a time, which bounds the
    (K, chunk * K, W) XOR intermediate."""
    N, K, W = db_bits.shape
    cur_on = cur_valid > 0.5
    scores = []
    for s in range(0, N, chunk):
        bits = db_bits[s : s + chunk]
        n = bits.shape[0]
        D = hamming_distance_matrix(cur_bits, bits.reshape(n * K, W))  # (K, n*K)
        D = D + ((db_valid[s : s + chunk].reshape(-1) < 0.5).to(D.dtype) * 10_000)[None, :]
        best = torch.min(D.reshape(K, n, K), dim=-1).values  # (K, n)
        scores.append(torch.sum((best <= tau - 1) & cur_on[:, None], dim=0))
    return torch.cat(scores).to(torch.int32)


def _words(bits) -> np.ndarray:
    """uint32 descriptor words as numpy, from numpy or an int64 tensor."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return np.asarray(bits).astype(np.uint32)


def _flags(valid) -> np.ndarray:
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    return np.asarray(valid, np.float32)


class KeyFrameDatabase:
    """Per-keyframe binary descriptors in a device tensor, scored densely.

    Storage is a fixed-capacity tensor that doubles when full; culled
    keyframes leave tombstone rows, compacted once they outnumber the live
    rows."""

    def __init__(self, capacity_hint: int = 64, point_slots: int = 0, device="cuda"):
        self._cap0 = max(8, int(capacity_hint))
        self.point_slots = int(point_slots)
        self.device = resolve_device(device)
        self.clear()

    def clear(self):
        self.kids: List[Optional[int]] = []  # row -> kid; None = tombstone
        self._bits = None  # (C, K, W) int64 words
        self._valid = None  # (C, K) f32

    def __len__(self):
        return sum(1 for k in self.kids if k is not None)

    def _ensure_capacity(self, K: int, W: int):
        if self._bits is None:
            C = self._cap0
            self._bits = torch.zeros((C, K, W), dtype=torch.int64, device=self.device)
            self._valid = torch.zeros((C, K), dtype=torch.float32, device=self.device)
        elif len(self.kids) >= self._bits.shape[0]:
            self._bits = torch.cat([self._bits, torch.zeros_like(self._bits)])
            self._valid = torch.cat([self._valid, torch.zeros_like(self._valid)])

    def _with_points(self, bits, valid, p_bits, p_valid):
        """Line rows (K, W) uint32 and (K,) -> with ``point_slots`` corner
        rows appended (padded or cut to point_slots), as int64 words."""
        bits, valid = _words(bits), _flags(valid)
        S = self.point_slots
        if S:
            pb = np.zeros((S, bits.shape[1]), np.uint32)
            pv = np.zeros(S, np.float32)
            if p_bits is not None:
                p_bits = _words(p_bits)[:S]
                pb[: p_bits.shape[0]] = p_bits
                pv[: p_bits.shape[0]] = _flags(p_valid)[:S]
            bits, valid = np.concatenate([bits, pb]), np.concatenate([valid, pv])
        return bits.astype(np.int64), valid

    def add(self, kf: KeyFrame):
        pf = getattr(kf, "point_features", None)
        bits, valid = self._with_points(
            kf.features.desc_bits, kf.features.valid, None if pf is None else pf.desc_bits, None if pf is None else pf.valid
        )
        K, W = bits.shape
        self._ensure_capacity(K, W)
        idx = len(self.kids)
        self.kids.append(kf.kid)
        self._bits[idx] = torch.from_numpy(bits).to(self.device)
        self._valid[idx] = torch.from_numpy(valid).to(self.device)

    def remove(self, kid: int):
        if kid in self.kids:
            i = self.kids.index(kid)
            self.kids[i] = None
            self._valid[i] = 0.0
            self._maybe_compact()

    def _maybe_compact(self):
        """Compact tombstoned rows once they outnumber live rows (and the
        dead weight exceeds a bucket's worth): dead rows still cost work in
        every query."""
        dead = sum(1 for k in self.kids if k is None)
        live = len(self.kids) - dead
        if dead <= max(live, self._cap0 - 1):
            return
        keep = [i for i, k in enumerate(self.kids) if k is not None]
        self.kids = [self.kids[i] for i in keep]
        C = self._cap0
        while C < len(keep) + self._cap0:  # headroom: adds must not regrow at once
            C *= 2
        keep_t = torch.tensor(keep, dtype=torch.int64, device=self.device)
        bits = torch.zeros((C,) + self._bits.shape[1:], dtype=self._bits.dtype, device=self.device)
        valid = torch.zeros((C,) + self._valid.shape[1:], dtype=self._valid.dtype, device=self.device)
        bits[: len(keep)] = self._bits[keep_t]
        valid[: len(keep)] = self._valid[keep_t]
        self._bits, self._valid = bits, valid

    def query_bits(self, bits, valid, p_bits=None, p_valid=None) -> Dict[int, int]:
        """Scores of every stored keyframe against line descriptors ``bits``
        (K, W) (uint32 words as numpy, or int64 words as a tensor) and
        ``valid`` (K,), and with point_slots the corner descriptors
        ``p_bits``, ``p_valid``."""
        if len(self) == 0:
            return {}
        bits, valid = self._with_points(bits, valid, p_bits, p_valid)
        cur_bits = torch.from_numpy(bits).to(self.device)
        cur_valid = torch.from_numpy(valid).to(self.device)
        scores = _db_scores(cur_bits, cur_valid, self._bits, self._valid).cpu().numpy()
        return {k: int(scores[i]) for i, k in enumerate(self.kids) if k is not None}

    def query(self, kf: KeyFrame) -> Dict[int, int]:
        pf = getattr(kf, "point_features", None)
        return self.query_bits(
            kf.features.desc_bits, kf.features.valid, None if pf is None else pf.desc_bits, None if pf is None else pf.valid
        )
