"""Peaks of the chip and the bytes each hand-kernel call must move.

The least time a call can take is its bytes over the chip's bandwidth: each
input byte read once and each output byte written once, scratch planes not
counted (the arithmetic of PERF.md's kernel table, from each call's shapes).
The hand kernels are bound by bandwidth; none does enough arithmetic per
byte for the FLOP bound to be the larger.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12

# device record names of the hand kernels (csrc/*.cu) on the main paths
HAND_KERNELS = (
    "blur_tile_kernel", "gradients_xy_kernel", "lsd_front_kernel", "ccl_tile_kernel",
    "component_moments_kernel", "component_extents_kernel", "segment_sums_kernel",
)


def _images(shape):
    """(B, H, W) of an (H, W) plane or a (B, H, W) batch."""
    return (1, *shape) if len(shape) == 2 else tuple(shape)


def call_bytes(entry: str, shape: tuple, ints: tuple) -> Optional[float]:
    """Bytes one call of C entry point ``entry`` must move, from the shape
    of its first tensor and its integer arguments (pointers first, then the
    sizes, as ``kernels.cuda_lib.launch`` passes them); None for an entry
    point this table does not know."""
    if entry == "tpuslam_blur_batch":  # f32 in, f32 out, the taps
        B, H, W = _images(shape)
        return B * H * W * 8 + ints[-1] * 4
    if entry == "tpuslam_gradients_xy_batch":  # f32 in; gx, gy out
        B, H, W = _images(shape)
        return B * H * W * 12
    if entry == "tpuslam_lsd_front_batch":  # f32 in; mag f32, support bool, labels0, maxlab0, compat int32 out
        B, H, W = _images(shape)
        return B * H * W * (4 + 4 + 1 + 4 + 4 + 4)
    if entry == "tpuslam_ccl_batch":  # labels, maxlab, compat in; labels, maxlab out (int32)
        B, H, W = _images(shape)
        return B * H * W * 20
    if entry == "tpuslam_component_moments_batch":  # labels, mag, support; roots int64 in; (7, K) f32 out
        B, H, W = _images(shape)
        K = ints[10]
        return B * (H * W * 9 + K * 8 + 7 * K * 4)
    if entry == "tpuslam_component_extents_batch":  # the same planes, roots, cx, cy, ev in; (3, K) out
        B, H, W = _images(shape)
        K = ints[14]
        return B * (H * W * 9 + K * (8 + 4 + 4 + 8) + 3 * K * 4)
    if entry == "tpuslam_segment_sums_batch":  # (V, N) f32 values, (N,) int32 slots in; (V, S) out
        B = shape[0] if len(shape) == 3 else 1
        V, N = shape[-2:]
        S = ints[6]
        return B * (V * N * 4 + N * 4 + V * S * 4)
    return None


def bound_seconds(calls) -> Optional[float]:
    """Summed least time of ``calls`` [(entry, shape, ints)], or None if any
    call is of an entry point without a byte count."""
    total = 0.0
    for entry, shape, ints in calls:
        b = call_bytes(entry, shape, ints)
        if b is None:
            return None
        total += b / HBM_BYTES_PER_S
    return total
