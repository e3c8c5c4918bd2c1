"""Binary descriptor matching with additive geometric gates (torch).

Counterpart of ``tpuslam.kernels.match``. Descriptors are int64 tensors of
uint32 words; the Hamming distance is XOR + popcount (exact integers, equal
to the JAX package's +-1 matmul distances). Gates are additive float32
penalty matrices, summed in the JAX package's order so that thresholds and
ties fall the same way.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

INF = 1e9
_PEN = 1e6  # generic gate penalty scale (>> any Hamming distance)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits of each int64 entry (SWAR)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """:func:`popcount32` as int32, the JAX package's result type."""
    return popcount32(x).to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(K, W) words -> (K, n_bits) float32 in {0, 1}: bit i is bit i % 32
    of word i // 32."""
    bit = torch.arange(n_bits, device=words.device)
    return ((words[:, bit // 32] >> (bit % 32)) & 1).to(torch.float32)


def hamming_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance, (KA, W) x (KB, W) int64 words -> (KA, KB) int64."""
    return popcount32(a[:, None, :] ^ b[None, :, :]).sum(dim=-1)


def hamming_distance_mxu(a: torch.Tensor, b: torch.Tensor, n_bits: int) -> torch.Tensor:
    """All-pairs Hamming distance as the JAX package's +-1 matmul (its TPU
    form), float32: the same distances as :func:`hamming_distance_matrix`
    (integers up to 2^24 are exact in float32)."""
    sa = unpack_bits(a, n_bits) * 2.0 - 1.0
    sb = unpack_bits(b, n_bits) * 2.0 - 1.0
    return 0.5 * (n_bits - sa @ sb.T)


def match_topk_database(query_bits: torch.Tensor, db_bits: torch.Tensor, db_valid: torch.Tensor, k: int, n_bits: int = 256):
    """The k nearest database descriptors of each query: (dist (Q, k)
    ascending, idx (Q, k)); invalid rows carry a 1e6 penalty. Ties keep the
    lower index first, as ``jax.lax.top_k`` does."""
    D = hamming_distance_mxu(query_bits, db_bits, n_bits)
    D = D + (1.0 - db_valid.to(torch.float32))[None, :] * _PEN
    dist, idx = torch.sort(D, dim=1, stable=True)
    return dist[:, :k], idx[:, :k]


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (KA,) int64 best match in B, -1 if none
    dist: torch.Tensor  # (KA,) float32 best distance (INF if none)
    valid: torch.Tensor  # (KA,) f32 {0, 1}


class MatchParams(NamedTuple):
    max_dist: float = 96.0  # absolute Hamming threshold (of n_bits)
    ratio: float = 0.85  # best/second-best Lowe ratio
    mutual: bool = True
    n_bits: int = 256


def _select_from_penalized(Dg: torch.Tensor, params: MatchParams) -> MatchResult:
    """Best + ratio (+ mutual) selection on an additively-penalized matrix.

    ``jax.lax.top_k(-Dg, 2)`` returns the lowest index among equal minima;
    ``torch.argmin`` returns the first minimum too, and the two smallest
    values do not depend on the order of ties."""
    KA = Dg.shape[0]
    two = torch.topk(Dg, 2, dim=1, largest=False).values  # ascending
    best, second = two[:, 0], two[:, 1]
    best_j = torch.argmin(Dg, dim=1)
    okf = (best <= params.max_dist).to(torch.float32) * (best <= params.ratio * second).to(torch.float32)
    if params.mutual:
        best_i = torch.argmin(Dg, dim=0)  # (KB,)
        okf = okf * (best_i[best_j] == torch.arange(KA, device=Dg.device)).to(torch.float32)
    oki = okf.to(torch.int64)
    return MatchResult(idx=best_j * oki - (1 - oki), dist=best + (1.0 - okf) * INF, valid=okf)


def match_descriptors(
    bits_a: torch.Tensor,
    valid_a: torch.Tensor,
    bits_b: torch.Tensor,
    valid_b: torch.Tensor,
    params: MatchParams = MatchParams(),
    gate_penalty: Optional[torch.Tensor] = None,
) -> MatchResult:
    """Mutual-best descriptor matching A->B with validity + optional gates.

    gate_penalty: optional (KA, KB) float32, 0 where the pair is
    geometrically admissible and >> max_dist where not."""
    D = hamming_distance_matrix(bits_a, bits_b).to(torch.float32)
    D = D + (1.0 - valid_a.to(torch.float32))[:, None] * _PEN + (1.0 - valid_b.to(torch.float32))[None, :] * _PEN
    if gate_penalty is not None:
        D = D + gate_penalty
    return _select_from_penalized(D, params)


def _fold_pi(d: torch.Tensor) -> torch.Tensor:
    """|difference| of two direction-ambiguous angles folded into [0, pi/2].

    ``fmod`` is exact; on the non-negative input it equals ``jnp.remainder``."""
    d = torch.fmod(d, math.pi)
    return torch.minimum(d, math.pi - d)


def angle_penalty(angles_a: torch.Tensor, angles_b: torch.Tensor, tol: float) -> torch.Tensor:
    """(KA,), (KB,) segment angles -> (KA, KB) penalty, 0 iff |diff| mod pi < tol."""
    d = _fold_pi(torch.abs(angles_a[:, None] - angles_b[None, :]))
    return torch.clamp(d - tol, min=0.0) * _PEN


def length_ratio_penalty(len_a: torch.Tensor, len_b: torch.Tensor, min_ratio: float) -> torch.Tensor:
    """(KA,), (KB,) -> (KA, KB), 0 iff min/max length ratio > threshold."""
    la = len_a[:, None]
    lb = len_b[None, :]
    r = torch.minimum(la, lb) / torch.clamp(torch.maximum(la, lb), min=1e-6)
    return torch.clamp(min_ratio - r, min=0.0) * _PEN


def midpoint_radius_penalty(mid_a: torch.Tensor, mid_b: torch.Tensor, radius: float) -> torch.Tensor:
    """(KA, 2), (KB, 2) midpoints -> (KA, KB), 0 iff within radius."""
    d2 = torch.sum((mid_a[:, None, :] - mid_b[None, :, :]) ** 2, dim=-1)
    return torch.clamp(d2 - radius * radius, min=0.0) * 1e3


def epipolar_penalty(uv_a: torch.Tensor, uv_b: torch.Tensor, F: torch.Tensor, tol_px: float) -> torch.Tensor:
    """(KA, 2), (KB, 2) pixels and the (3, 3) fundamental matrix F (A -> B
    lines) -> (KA, KB) penalty, 0 iff uv_b lies within tol_px of the
    epipolar line F [uv_a; 1]: the gate of two-view point matches."""
    ah = torch.cat([uv_a, torch.ones_like(uv_a[:, :1])], dim=-1)
    l = ah @ F.to(torch.float32).T  # (KA, 3) epipolar lines in image B
    den = torch.clamp(torch.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2), min=1e-9)
    bh = torch.cat([uv_b, torch.ones_like(uv_b[:, :1])], dim=-1)
    d = torch.abs(l @ bh.T) / den[:, None]
    return torch.clamp(d - tol_px, min=0.0) * _PEN


def stereo_row_penalty(mid_a, mid_b, max_dy: float, min_disp: float, max_disp: float) -> torch.Tensor:
    """Rectified-stereo gate: same row band, positive bounded disparity
    (a = left features, b = right features, disparity = x_left - x_right)."""
    dy = torch.abs(mid_a[:, None, 1] - mid_b[None, :, 1])
    disp = mid_a[:, None, 0] - mid_b[None, :, 0]
    return (
        torch.clamp(dy - max_dy, min=0.0)
        + torch.clamp(min_disp - disp, min=0.0)
        + torch.clamp(disp - max_disp, min=0.0)
    ) * _PEN



def angle_gate(angles_a: torch.Tensor, angles_b: torch.Tensor, tol: float) -> torch.Tensor:
    """(KA, KB) bool: the direction-folded angle difference below tol."""
    return _fold_pi(torch.abs(angles_a[:, None] - angles_b[None, :])) < tol


def length_ratio_gate(len_a: torch.Tensor, len_b: torch.Tensor, min_ratio: float) -> torch.Tensor:
    """(KA, KB) bool: the min/max length ratio above min_ratio."""
    la, lb = len_a[:, None], len_b[None, :]
    return torch.minimum(la, lb) / torch.clamp(torch.maximum(la, lb), min=1e-6) > min_ratio


def midpoint_radius_gate(mid_a: torch.Tensor, mid_b: torch.Tensor, radius: float) -> torch.Tensor:
    """(KA, KB) bool: midpoints within radius."""
    return torch.sum((mid_a[:, None, :] - mid_b[None, :, :]) ** 2, dim=-1) < radius * radius


def stereo_row_gate(mid_a, mid_b, max_dy: float, min_disp: float, max_disp: float) -> torch.Tensor:
    """(KA, KB) bool: the same row band and a disparity in (min_disp, max_disp)."""
    dy = torch.abs(mid_a[:, None, 1] - mid_b[None, :, 1])
    disp = mid_a[:, None, 0] - mid_b[None, :, 0]
    return (dy < max_dy) & (disp > min_disp) & (disp < max_disp)
