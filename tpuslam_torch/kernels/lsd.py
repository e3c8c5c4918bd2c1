"""LSD-style line segment detector by connected-component labelling (torch).

Counterpart of ``tpuslam.kernels.lsd``; see that module for the method. Two
steps are kernel wrappers, each launching a CUDA kernel on a CUDA tensor and
running its plain PyTorch version on a CPU tensor:

- :func:`ccl_inputs`, the detector's front (prefilter, gradients, support,
  compat plane, label seeds): one launch of ``csrc/lsd_front.cu``'s fused
  kernel per call; plain version :func:`ccl_inputs_torch`.
- :func:`ccl_propagate`, the label propagation (``csrc/ccl.cu``); plain
  version :func:`_ccl_torch`. Both are bit-equal to
  ``tpuslam.kernels.lsd._ccl_xla``. Each launch runs k rounds on
  shared-memory tiles (:data:`CCL_TILE`), so a call of R rounds is
  ceil(R / k) launches.

- :func:`component_moments` and :func:`component_extents`, the detector's
  per-component statistics (``csrc/moments.cu``): the seven weighted
  moments of the K chosen components, then their extents along the
  principal direction and their normal moment, each one launch over the
  label, magnitude and support planes that sums the members only, in a
  fixed order and without float atomics, so every run on the card adds in
  one order; plain versions :func:`component_moments_torch` and
  :func:`component_extents_torch`.
- :func:`segment_moments`, merge_collinear's sums over the segments: one
  launch of one block that sums each slot in item order; plain version
  :func:`segment_moments_torch`. The JAX package has no Pallas kernel for
  these three: XLA fuses them into its reductions.

Each wrapper has a batched form (``*_batch``) that takes B images of one
shape, (B, H, W) planes and (B, K) roots, in the same launches as one image
(the kernels' grid spans the batch; each image bit for bit its single
call); their plain versions run the single plain version per image.
:func:`detect_lines` and :func:`merge_collinear` take a (B, H, W) batch too:
the eager steps between the kernels carry the leading axis, so a batch of
sequences costs one set of launches (tpuslam/parallel/multi_seq.py vmaps
the JAX detector the same way).

``LAUNCHES`` counts the kernel calls made on the card, ``KERNEL_LAUNCHES``
the device launches of those calls, under "lsd_front", "ccl",
"component_moments", "component_extents" and "segment_moments", and the
batched forms under the same names with "_batch".

Three places differ in form from the JAX code, not in result:

- The top-K root selection must reproduce ``jax.lax.top_k``'s tie order:
  the unused slots take the lowest-index zero-key pixels (row 0, never in
  the support mask, so they collect no members). ``torch.topk`` promises no
  order among ties and can pick a non-root pixel that is still another
  pixel's label; :func:`topk_stable` is a stable descending sort instead.
- The per-component statistics: XLA fuses the (K, N) one-hot compare into
  its reductions, eager PyTorch would materialise it (315 MB per temporary
  at VGA). The plain versions instead map each label to its slot (other
  labels to a dump slot K) and sum with ``index_add_`` (extents by
  ``scatter_reduce``'s min and max); the kernels look the label up among the
  K roots. Float sums run in another order, so moments agree to float
  rounding, not bitwise.
- ``jnp.hypot`` is written out with JAX's own formula, so the root keys,
  and with them the slot order, are bit-equal.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.kernels import cuda_lib, image

SUMS = ("component_moments", "component_extents", "segment_moments")
_NAMES = ("lsd_front", "ccl", *SUMS)
LAUNCHES = dict.fromkeys((*_NAMES, *(f"{n}_batch" for n in _NAMES)), 0)
KERNEL_LAUNCHES = dict(LAUNCHES)

# Output tile side of the fused front kernel (csrc/lsd_front.cu): each block
# reads the edge-clamped (T + 2h) x (T + 2h) window around its T x T tile,
# h = front_halo(r) for a prefilter of radius r. The wrapper passes T and h
# to the C function, which refuses any other pair, and
# tests/test_torch_lsd_front.py models the same tiling in numpy.
FRONT_TILE = 32


def front_halo(radius: int) -> int:
    """The front kernel's halo: the blur's radius, 1 for the central
    differences and 1 for the compat neighbours."""
    return radius + 2

# (TY, TX, k) of the CUDA kernel: each launch runs k synchronous rounds on a
# TY x TX output tile inside a wrap-indexed (TY + 2k) x (TX + 2k) window in
# shared memory. The wrapper passes it to the C function, and
# tests/test_torch_ccl_tiles.py models the same schedule in numpy. The
# fastest of the tiles timed at 480x640 on an H100 (csrc/ccl.cu, PERF.md),
# and the only instance the library builds.
CCL_TILE = (32, 32, 8)

# The component kernels' launch shape (csrc/moments.cu): blocks of SUM_WARPS
# warps, at most SUM_MAX_BLOCKS of them, each warp a contiguous run of items
# (sum_partition); the last block of each group of SUM_GROUP blocks sums the
# group's rows, the last group the groups'. The wrapper passes the partition
# to the C function, which refuses one that does not cover the plane;
# tests/torch_sum_model.py models the same order in numpy. The replaced
# two-launch form sums partials in at most MOMENTS_BLOCKS blocks.
SUM_WARPS = 16
SUM_MAX_BLOCKS = 128
SUM_GROUP = 8
MOMENTS_BLOCKS = 132


def sum_partition(N: int):
    """(blocks, items per warp) of the component kernels for N items: about
    64 items per warp or more, at most SUM_MAX_BLOCKS blocks, whole 32-item
    steps, and no block without items. Depends on N alone."""
    blocks = min(SUM_MAX_BLOCKS, max(1, -(-N // (SUM_WARPS * 64))))
    ipw = -(-N // (blocks * SUM_WARPS))
    ipw = -(-ipw // 32) * 32
    return -(-N // (ipw * SUM_WARPS)), ipw


class LSDParams(NamedTuple):
    angle_tol: float = math.pi / 8  # 22.5 deg
    quant: float = 2.0  # gradient quantization error bound (on [0,255] scale)
    min_length: float = 15.0  # px, at detection level
    min_support: int = 20  # pixels in component
    min_density: float = 0.35  # support / (length * width)
    max_width: float = 8.0  # px, reject blobs
    ccl_rounds: int = 64  # min/max-propagation rounds = base geodesic reach
    ccl_jumps: int = 1  # pointer-jump rounds after propagation
    prefilter_sigma: float = 0.75  # pre-smoothing (0 = off)
    merge_fragments: bool = True  # collinear post-merge (junction splits)
    ccl: str = "auto"  # the JAX package's CCL backend switch; here the
    # tensor's device decides (CUDA kernel on the card, plain version on CPU)


class DetectedLines(NamedTuple):
    endpoints: torch.Tensor  # (K, 2, 2) [[x0,y0],[x1,y1]] in px
    valid: torch.Tensor  # (K,) f32 {0,1}
    response: torch.Tensor  # (K,) support pixel count
    angle: torch.Tensor  # (K,) segment direction angle
    width: torch.Tensor  # (K,) rectangle width
    midpoint: torch.Tensor  # (K, 2)
    length: torch.Tensor  # (K,)


_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift the last two axes of a tensor by (dy, dx) with wrap-around, as
    ``jnp.roll``."""
    return torch.roll(x, (dy, dx), dims=(-2, -1))


def _compat_masks(compat_bits: torch.Tensor):
    return [((compat_bits >> d) & 1) > 0 for d in range(len(_OFFSETS))]


def _ccl_torch(labels: torch.Tensor, maxlab: torch.Tensor, compat_bits: torch.Tensor, rounds: int):
    """Plain version: R synchronous rounds of masked 8-neighbour min-label and
    max-label propagation (the math of ``lsd._ccl_xla``)."""
    H, W = labels.shape
    big = torch.full_like(labels, H * W)
    neg = torch.full_like(maxlab, -1)
    oks = _compat_masks(compat_bits)
    lab, mx = labels, maxlab
    for _ in range(rounds):
        lm, mm = lab, mx
        for ok, (dy, dx) in zip(oks, _OFFSETS):
            lm = torch.minimum(lm, torch.where(ok, _shift(lab, dy, dx), big))
            mm = torch.maximum(mm, torch.where(ok, _shift(mx, dy, dx), neg))
        lab, mx = lm, mm
    return lab, mx


def _check_ccl_planes(labels, maxlab, compat_bits, batched: bool = False):
    """(B, H, W) of the planes (B = 1 for (H, W) planes) after the checks."""
    for t, name in ((labels, "labels"), (maxlab, "maxlab"), (compat_bits, "compat_bits")):
        shape = cuda_lib.image_batch(t, torch.int32, f"ccl_propagate {name}", batched)
    if not (labels.shape == maxlab.shape == compat_bits.shape):
        raise ValueError("ccl_propagate: planes differ in shape")
    if not (labels.device == maxlab.device == compat_bits.device):
        raise ValueError("ccl_propagate: planes on different devices")
    return shape


def _ccl_cuda(labels, maxlab, compat_bits, rounds: int, batched: bool = False):
    """ccl_propagate on the card (``batched``: a (B, H, W) batch of planes in
    the same launches), counted under "ccl" or "ccl_batch"."""
    B, H, W = _check_ccl_planes(labels, maxlab, compat_bits, batched)
    lab_out, mx_out, lab_tmp, mx_tmp = (torch.empty_like(labels) for _ in range(4))
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_ccl_batch", labels, "ccl_propagate",
        labels.data_ptr(), maxlab.data_ptr(), compat_bits.data_ptr(),
        lab_out.data_ptr(), mx_out.data_ptr(), lab_tmp.data_ptr(), mx_tmp.data_ptr(),
        B, H, W, int(rounds), *CCL_TILE, ctypes.byref(n),
    )
    key = "ccl_batch" if batched else "ccl"
    cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, key, n.value)
    return lab_out, mx_out


def _ccl_per_round_cuda(labels, maxlab, compat_bits, rounds: int):
    """The per-round form of the kernel (its first form): one launch per
    round, for timing and bit-equality checks beside :func:`_ccl_cuda` on
    the card. The detector never calls it, and it counts no launches."""
    _check_ccl_planes(labels, maxlab, compat_bits)
    H, W = labels.shape
    lab_out, mx_out, lab_tmp, mx_tmp = (torch.empty_like(labels) for _ in range(4))
    cuda_lib.launch(
        "tpuslam_ccl_per_round", labels, "ccl_propagate (per round)",
        labels.data_ptr(), maxlab.data_ptr(), compat_bits.data_ptr(),
        lab_out.data_ptr(), mx_out.data_ptr(), lab_tmp.data_ptr(), mx_tmp.data_ptr(),
        H, W, int(rounds),
    )
    return lab_out, mx_out


def ccl_propagate(labels: torch.Tensor, maxlab: torch.Tensor, compat_bits: torch.Tensor, rounds: int):
    """(H, W) int32 labels (H*W at non-support), max labels (-1 there) and
    compat bits -> the planes after ``rounds`` propagation rounds. Kernel on
    CUDA tensors, plain version on CPU tensors."""
    if cuda_lib.on_card(labels):
        return _ccl_cuda(labels, maxlab, compat_bits, rounds)
    return _ccl_torch(labels, maxlab, compat_bits, rounds)


def _ccl_batch_torch(labels, maxlab, compat_bits, rounds: int):
    """Plain version of :func:`ccl_propagate_batch`: each image's plain form."""
    lab, mx = zip(*(_ccl_torch(*p, rounds) for p in zip(labels, maxlab, compat_bits)))
    return torch.stack(lab), torch.stack(mx)


def ccl_propagate_batch(labels: torch.Tensor, maxlab: torch.Tensor, compat_bits: torch.Tensor, rounds: int):
    """:func:`ccl_propagate` of a (B, H, W) batch of planes: on CUDA tensors
    ceil(rounds / k) launches for the whole batch, each image bit for bit
    its single call; the plain version on CPU tensors."""
    if cuda_lib.on_card(labels):
        return _ccl_cuda(labels, maxlab, compat_bits, rounds, batched=True)
    return _ccl_batch_torch(labels, maxlab, compat_bits, rounds)


def segment_moments_torch(values: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version of :func:`segment_moments`: ``index_add_`` over the
    items in item order (the CPU adds them in that order)."""
    acc = torch.zeros((S, values.shape[0]), dtype=torch.float32, device=values.device)
    return acc.index_add_(0, slot.long(), values.t().contiguous()).t()


def _check_sum_inputs(values, slot, what, batched: bool = False):
    """(B, V, N) of the value columns (B = 1 for (V, N) ones) after the checks."""
    B, V, N = cuda_lib.image_batch(values, torch.float32, f"{what} values", batched)
    want = (B, N) if batched else (N,)
    if slot.device != values.device or slot.dtype != torch.int32 or not slot.is_contiguous():
        raise ValueError(f"{what}: slot must be a contiguous int32 tensor on the values' device")
    if tuple(slot.shape) != want:
        raise ValueError(f"{what}: slot of shape {tuple(slot.shape)} for values of shape {tuple(values.shape)}")
    return B, V, N


def _moments_two_launch_cuda(values: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """The replaced form of the sums (``csrc/moments.cu`` ``tpuslam_moments``:
    block partial sums, then a combine launch), for timing beside the
    kernels on the card. The detector never calls it, and it counts no
    launches."""
    _check_sum_inputs(values, slot, "segment_moments (two launches)")
    V, N = values.shape
    partial = torch.empty((MOMENTS_BLOCKS, V, S), dtype=torch.float32, device=values.device)
    out = torch.empty((V, S), dtype=torch.float32, device=values.device)
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_moments", values, "segment_moments (two launches)",
        values.data_ptr(), slot.data_ptr(), partial.data_ptr(), out.data_ptr(), N, V, S, ctypes.byref(n),
    )
    return out


def _segment_sums_cuda(values: torch.Tensor, slot: torch.Tensor, S: int, batched: bool = False):
    """((V, S) sums, device launches made); ``batched``, (B, V, S) sums of a
    (B, V, N) batch in the same launch."""
    B, V, N = _check_sum_inputs(values, slot, "segment_moments", batched)
    out = torch.empty((*values.shape[:-2], V, S), dtype=torch.float32, device=values.device)
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_segment_sums_batch", values, "segment_moments",
        values.data_ptr(), slot.data_ptr(), out.data_ptr(), B, N, V, S, ctypes.byref(n),
    )
    return out, n.value


def segment_moments(values: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """Sums of V value columns over N items by slot: ``values`` (V, N)
    float32, ``slot`` (N,) int32 in [0, S) -> (V, S), out[v, s] the sum of
    values[v, i] over the items i with slot[i] == s. On a CUDA tensor one
    block of ``csrc/moments.cu`` sums each slot in item order, as the plain
    version does on a CPU tensor (merge_collinear's size: 256 items)."""
    if cuda_lib.on_card(values):
        out, n = _segment_sums_cuda(values, slot, S)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "segment_moments", n)
        return out
    return segment_moments_torch(values, slot, S)


def segment_moments_batch_torch(values: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version of :func:`segment_moments_batch`: each entry's plain sum."""
    return torch.stack([segment_moments_torch(v, sl, S) for v, sl in zip(values, slot)])


def segment_moments_batch(values: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """:func:`segment_moments` of a batch: ``values`` (B, V, N), ``slot`` (B,
    N) -> (B, V, S), one launch of B blocks on CUDA tensors (each entry bit
    for bit its single call), the plain version on CPU tensors."""
    if cuda_lib.on_card(values):
        out, n = _segment_sums_cuda(values, slot, S, batched=True)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "segment_moments_batch", n)
        return out
    return segment_moments_batch_torch(values, slot, S)


def _member_slots(labels: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """(N,) int64: each pixel's component slot in [0, K), K for the rest."""
    N, K = labels.numel(), roots.numel()
    slot_of_label = torch.full((N + 1,), K, dtype=torch.long, device=labels.device)
    slot_of_label[roots.long()] = torch.arange(K, device=labels.device)
    return slot_of_label[labels.reshape(-1).long()]


def _pixel_xy(H: int, W: int, dev):
    pix = torch.arange(H * W, dtype=torch.int32, device=dev)
    return (pix % W).to(torch.float32), (pix // W).to(torch.float32)


def _weights(mag, support, like):
    return torch.where(support.reshape(-1), mag.reshape(-1), torch.zeros_like(like))


def _component_moments_chain(labels, mag, support, roots, sums):
    H, W = labels.shape
    K = roots.numel()
    member = _member_slots(labels, roots)
    xs, ys = _pixel_xy(H, W, labels.device)
    w = _weights(mag, support, xs)
    wx, wy = w * xs, w * ys
    cols = torch.stack([support.reshape(-1).to(torch.float32), w, wx, wy, wx * xs, wy * ys, wx * ys])
    return sums(cols, member.to(torch.int32), K + 1)[:, :K]


def _component_extents_chain(labels, mag, support, roots, cx, cy, ev, sums):
    H, W = labels.shape
    K = roots.numel()
    dev = labels.device
    member = _member_slots(labels, roots)
    xs, ys = _pixel_xy(H, W, dev)
    w = _weights(mag, support, xs)
    pad = torch.zeros(1, dtype=torch.float32, device=dev)
    cxm = torch.cat([cx, pad])[member]
    cym = torch.cat([cy, pad])[member]
    evm = torch.cat([ev, torch.zeros((1, 2), dtype=torch.float32, device=dev)])[member]
    relx = xs - cxm
    rely = ys - cym
    t = relx * evm[:, 0] + rely * evm[:, 1]
    tn = -relx * evm[:, 1] + rely * evm[:, 0]
    inf = torch.full((K + 1,), math.inf, dtype=torch.float32, device=dev)
    t_min = inf.scatter_reduce(0, member, t, "amin", include_self=False)[:K]
    t_max = (-inf).scatter_reduce(0, member, t, "amax", include_self=False)[:K]
    sn2 = sums((w * tn * tn)[None], member.to(torch.int32), K + 1)[0, :K]
    return torch.stack([t_min, t_max, sn2])


def component_moments_torch(labels, mag, support, roots) -> torch.Tensor:
    """Plain version of :func:`component_moments`: the seven columns of
    every pixel stacked, each label mapped to its slot (others to a dump
    slot K), summed by ``index_add_`` in item order."""
    return _component_moments_chain(labels, mag, support, roots, segment_moments_torch)


def component_extents_torch(labels, mag, support, roots, cx, cy, ev) -> torch.Tensor:
    """Plain version of :func:`component_extents`: per pixel its
    component's centroid and direction gathered, t and tn, then
    ``scatter_reduce``'s amin and amax (the first of equal values in item
    order is kept) and ``index_add_`` for sn2."""
    return _component_extents_chain(labels, mag, support, roots, cx, cy, ev, segment_moments_torch)


def _component_moments_replaced_cuda(labels, mag, support, roots) -> torch.Tensor:
    """What :func:`detect_lines` ran on the card before the component
    kernels: the plain version's eager chain around the two-launch sums.
    For timing beside the kernel; it counts no launches."""
    return _component_moments_chain(labels, mag, support, roots, _moments_two_launch_cuda)


def _component_extents_replaced_cuda(labels, mag, support, roots, cx, cy, ev) -> torch.Tensor:
    """The same for :func:`component_extents`."""
    return _component_extents_chain(labels, mag, support, roots, cx, cy, ev, _moments_two_launch_cuda)


_COUNTERS: dict = {}
COUNTERS_PER_IMAGE = 1 + SUM_MAX_BLOCKS // SUM_GROUP


def _ticket_counters(dev: torch.device, images: int = 1) -> torch.Tensor:
    """The device's counters of finished blocks, one set per image of a
    batch (the groups', then each group's), which the component kernels set
    back to 0 as they finish: every image's last-block combine counts its
    own blocks only. Calls on one stream run one after another, so every
    call may start from the same buffer (grown, zeroed, for a larger batch)."""
    key = (dev.type, dev.index)  # a tensor's device: never without its index
    if key not in _COUNTERS or _COUNTERS[key].numel() < images * COUNTERS_PER_IMAGE:
        _COUNTERS[key] = torch.zeros(images * COUNTERS_PER_IMAGE, dtype=torch.int32, device=dev)
    return _COUNTERS[key]


def _check_component_inputs(labels, mag, support, roots, what, batched: bool = False):
    """(B, H, W, K) of the planes and roots (B = 1 for (H, W) planes and (K,)
    roots) after the checks."""
    B, H, W = cuda_lib.image_batch(labels, torch.int32, f"{what} labels", batched)
    cuda_lib.image_batch(mag, torch.float32, f"{what} mag", batched)
    cuda_lib.image_batch(support, torch.bool, f"{what} support", batched)
    if not (labels.shape == mag.shape == support.shape):
        raise ValueError(f"{what}: planes differ in shape")
    if not (labels.device == mag.device == support.device == roots.device):
        raise ValueError(f"{what}: inputs on different devices")
    lead = labels.shape[:-2]
    if roots.dtype != torch.int64 or roots.shape[:-1] != lead or roots.dim() != len(lead) + 1 or roots.shape[-1] < 1 or not roots.is_contiguous():
        raise ValueError(f"{what}: roots must be a contiguous non-empty {'(B, K)' if batched else '(K,)'} int64 tensor")
    return B, H, W, roots.shape[-1]


def _component_scratch(labels, K, C):
    """(blocks, ipw, rows): the partition of one image and its blocks' and
    then its groups' (C, K) rows, (B, rows, C, K) for a (B, H, W) batch."""
    H, W = labels.shape[-2:]
    blocks, ipw = sum_partition(H * W)
    rows = blocks + -(-blocks // SUM_GROUP)
    return blocks, ipw, torch.empty((*labels.shape[:-2], rows, C, K), dtype=torch.float32, device=labels.device)


def _component_moments_cuda(labels, mag, support, roots, batched: bool = False):
    """((7, K) sums, device launches made); ``batched``, (B, 7, K) of a (B, H,
    W) batch with (B, K) roots in the same launch (grid y over the images,
    one set of ticket counters and scratch rows each)."""
    B, H, W, K = _check_component_inputs(labels, mag, support, roots, "component_moments", batched)
    blocks, ipw, partial = _component_scratch(labels, K, 7)
    out = torch.empty((*labels.shape[:-2], 7, K), dtype=torch.float32, device=labels.device)
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_component_moments_batch", labels, "component_moments",
        labels.data_ptr(), mag.data_ptr(), support.data_ptr(), roots.data_ptr(), partial.data_ptr(),
        _ticket_counters(labels.device, B).data_ptr(), out.data_ptr(), B, H, W, K, blocks, ipw, ctypes.byref(n),
    )
    return out, n.value


def _component_extents_cuda(labels, mag, support, roots, cx, cy, ev, batched: bool = False):
    """((3, K) t_min, t_max, sn2, device launches made); ``batched``, (B, 3,
    K) as :func:`_component_moments_cuda` batches."""
    B, H, W, K = _check_component_inputs(labels, mag, support, roots, "component_extents", batched)
    lead = labels.shape[:-2]
    for t, shape, name in ((cx, (*lead, K), "cx"), (cy, (*lead, K), "cy"), (ev, (*lead, K, 2), "ev")):
        if t.device != labels.device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"component_extents: {name} must be a contiguous {shape} float32 tensor on the planes' device")
    blocks, ipw, partial = _component_scratch(labels, K, 1)
    keys = torch.empty((*partial.shape[:-2], 2, K), dtype=torch.int64, device=labels.device)
    out = torch.empty((*lead, 3, K), dtype=torch.float32, device=labels.device)
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_component_extents_batch", labels, "component_extents",
        labels.data_ptr(), mag.data_ptr(), support.data_ptr(), roots.data_ptr(), cx.data_ptr(), cy.data_ptr(),
        ev.data_ptr(), partial.data_ptr(), keys.data_ptr(), _ticket_counters(labels.device, B).data_ptr(),
        out.data_ptr(), B, H, W, K, blocks, ipw, ctypes.byref(n),
    )
    return out, n.value


def component_moments_batch(labels, mag, support, roots) -> torch.Tensor:
    """:func:`component_moments` of a batch: (B, H, W) planes and (B, K)
    roots -> (B, 7, K), one launch on CUDA tensors (each image summed in its
    single call's order, its own ticket counters), the plain version per
    image on CPU tensors."""
    if cuda_lib.on_card(labels):
        out, n = _component_moments_cuda(labels, mag, support, roots, batched=True)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "component_moments_batch", n)
        return out
    return torch.stack([component_moments_torch(*a) for a in zip(labels, mag, support, roots)])


def component_extents_batch(labels, mag, support, roots, cx, cy, ev) -> torch.Tensor:
    """:func:`component_extents` of a batch: (B, H, W) planes, (B, K) roots,
    cx, cy and (B, K, 2) ev -> (B, 3, K), one launch on CUDA tensors, the
    plain version per image on CPU tensors."""
    if cuda_lib.on_card(labels):
        out, n = _component_extents_cuda(labels, mag, support, roots, cx, cy, ev, batched=True)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "component_extents_batch", n)
        return out
    return torch.stack([component_extents_torch(*a) for a in zip(labels, mag, support, roots, cx, cy, ev)])


def component_moments(labels: torch.Tensor, mag: torch.Tensor, support: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """The seven weighted moments of K components: ``labels`` (H, W) int32
    after the pointer jumps, ``mag`` (H, W) float32, ``support`` (H, W) bool,
    ``roots`` (K,) int64, distinct, in [0, H W) -> (7, K): per component k the
    sums over the pixels labelled roots[k] of 1 (if supported), w, w x, w y,
    w x x, w y y, w x y, with w = mag where supported and 0 elsewhere. One
    kernel launch on CUDA tensors (a fixed order, the same on every run),
    the plain version on CPU tensors."""
    if cuda_lib.on_card(labels):
        out, n = _component_moments_cuda(labels, mag, support, roots)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "component_moments", n)
        return out
    return component_moments_torch(labels, mag, support, roots)


def component_extents(labels, mag, support, roots, cx, cy, ev) -> torch.Tensor:
    """Extents and normal moment of the K components of
    :func:`component_moments` about their centroids (cx, cy) (K,) along
    their unit directions ev (K, 2) -> (3, K): t_min and t_max of t = (x -
    cx) ev.x + (y - cy) ev.y over each component's pixels (+inf and -inf
    where it has none), and the sum of w tn tn, tn = -(x - cx) ev.y + (y -
    cy) ev.x. One kernel launch on CUDA tensors, the plain version on CPU
    tensors; both keep the first of equal extremes in pixel order, so a
    -0.0 and a +0.0 settle alike."""
    if cuda_lib.on_card(labels):
        out, n = _component_extents_cuda(labels, mag, support, roots, cx, cy, ev)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "component_extents", n)
        return out
    return component_extents_torch(labels, mag, support, roots, cx, cy, ev)


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row (the last axis) of a
    tensor, ties broken towards the lower index — the order
    ``jax.lax.top_k`` gives."""
    return torch.sort(x, descending=True, stable=True).indices[..., :k]


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` step for step (bit-equal in float32)."""
    a, b = torch.abs(a), torch.abs(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * image.sqrt_rn(1 + torch.square(lo / safe)))


def _principal_direction(mxx, myy, mxy):
    """Unit eigenvector of the larger eigenvalue of [[mxx, mxy], [mxy, myy]]."""
    tr = mxx + myy
    det = mxx * myy - mxy * mxy
    lam1 = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    e1 = torch.stack([mxy, lam1 - mxx], dim=-1)
    e2 = torch.stack([lam1 - myy, mxy], dim=-1)
    use_e1 = torch.linalg.norm(e1, dim=-1) > torch.linalg.norm(e2, dim=-1)
    ev = torch.where(use_e1[..., None], e1, e2)
    return ev / torch.clamp(torch.linalg.norm(ev, dim=-1, keepdim=True), min=1e-9)


def _thresholds(params: LSDParams):
    """(rho, cos_tol): the support threshold on the 0..255 gradient scale
    and the cosine of the angle tolerance."""
    return params.quant / math.sin(params.angle_tol), math.cos(params.angle_tol)


def _front_planes(gx, gy, mag, params: LSDParams):
    """Support mask, bit-packed neighbour-compatibility plane (angle
    agreement through the gradient dot product, as in the JAX package) and
    label seeds from the gradients; returns what :func:`ccl_inputs` does."""
    H, W = mag.shape
    N = H * W
    rho, cos_tol = _thresholds(params)
    support = mag > rho
    compat_bits = torch.zeros((H, W), dtype=torch.int32, device=mag.device)
    for d, (dy, dx) in enumerate(_OFFSETS):
        dots = gx * _shift(gx, dy, dx) + gy * _shift(gy, dy, dx)
        ok = support & _shift(support, dy, dx) & (dots > cos_tol * mag * _shift(mag, dy, dx))
        compat_bits = compat_bits | (ok.to(torch.int32) << d)

    idx = torch.arange(N, dtype=torch.int32, device=mag.device).view(H, W)
    labels0 = torch.where(support, idx, torch.full_like(idx, N))
    maxlab0 = torch.where(support, idx, torch.full_like(idx, -1))
    return mag, support, labels0, maxlab0, compat_bits


def ccl_inputs_torch(img: torch.Tensor, params: LSDParams = LSDParams()):
    """Plain version of :func:`ccl_inputs`: prefilter, gradients of the
    image times 255, then :func:`_front_planes`, in eager PyTorch."""
    if params.prefilter_sigma > 0:
        img = image.gaussian_blur_torch(img, params.prefilter_sigma)
    gx, gy, mag, _ = image.image_gradients_torch(img * 255.0)  # thresholds on 0..255
    return _front_planes(gx, gy, mag, params)


def _front_radius(params: LSDParams) -> int:
    if not params.prefilter_sigma > 0:
        raise ValueError("ccl_inputs: the front kernel needs a prefilter (prefilter_sigma > 0)")
    r = image._blur_taps(params.prefilter_sigma).numel() // 2
    if r > 15:
        raise ValueError(f"ccl_inputs: prefilter radius {r} above the front kernel's 15")
    if not _thresholds(params)[0] >= 0:
        # a negative rho would put the mag-0 image border in the support,
        # where the plain version's compat plane wraps around
        raise ValueError("ccl_inputs: the support threshold rho = quant / sin(angle_tol) must be >= 0")
    return r


def _lsd_front_cuda(img: torch.Tensor, params: LSDParams, batched: bool = False):
    """(planes of :func:`ccl_inputs`, device launches made); ``batched``, the
    (B, H, W) planes of a (B, H, W) batch in the same launch."""
    B, H, W = cuda_lib.image_batch(img, torch.float32, "ccl_inputs", batched)
    r = _front_radius(params)
    taps = np.ascontiguousarray(image._blur_taps(params.prefilter_sigma).numpy())
    rho, cos_tol = _thresholds(params)
    mag = torch.empty_like(img)
    support = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    labels0, maxlab0, compat_bits = (torch.empty(img.shape, dtype=torch.int32, device=img.device) for _ in range(3))
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_lsd_front_batch", img, "ccl_inputs",
        img.data_ptr(), mag.data_ptr(), support.data_ptr(), labels0.data_ptr(), maxlab0.data_ptr(),
        compat_bits.data_ptr(), B, H, W, taps.ctypes.data, taps.size, rho, cos_tol,
        FRONT_TILE, front_halo(r), ctypes.byref(n),
    )
    return (mag, support, labels0, maxlab0, compat_bits), n.value


def _ccl_inputs_chain_cuda(img: torch.Tensor, params: LSDParams = LSDParams()):
    """The chain that the front kernel replaces on the card: the blur
    kernel, ``* 255``, the four-plane gradients kernel, then
    :func:`_front_planes` in eager PyTorch (162 launches on an H100, counted
    by torch.profiler). For timing and bit-equality checks beside the
    kernel; the detector never calls it, and it counts no launches."""
    cuda_lib.require_plane(img, torch.float32, "ccl_inputs (chain)")
    if params.prefilter_sigma > 0:
        img, _ = image._blur_cuda(img, params.prefilter_sigma)
    gx, gy, mag, _ = image._gradients_cuda(img * 255.0)
    return _front_planes(gx, gy, mag, params)


def ccl_inputs(img: torch.Tensor, params: LSDParams = LSDParams()):
    """The detector up to label propagation, from an (H, W) float32 level
    image in [0, 1]: prefilter, gradients on the 0..255 scale, support mask
    and the bit-packed neighbour-compatibility plane. Returns (mag, support,
    labels0, maxlab0, compat_bits); the last three are what
    :func:`ccl_propagate` takes. One kernel launch on a CUDA tensor, the
    plain version on a CPU tensor."""
    if cuda_lib.on_card(img):
        out, n = _lsd_front_cuda(img, params)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "lsd_front", n)
        return out
    return ccl_inputs_torch(img, params)


def ccl_inputs_batch(imgs: torch.Tensor, params: LSDParams = LSDParams()):
    """:func:`ccl_inputs` of each image of a (B, H, W) float32 batch -> the
    five planes, each (B, H, W) (labels are pixel indices within each
    image). One launch on a CUDA tensor (each image bit for bit its single
    call), the plain version per image on a CPU tensor."""
    if cuda_lib.on_card(imgs):
        out, n = _lsd_front_cuda(imgs, params, batched=True)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "lsd_front_batch", n)
        return out
    return tuple(torch.stack(p) for p in zip(*(ccl_inputs_torch(im, params) for im in imgs)))


def front_disagreements(got, ref, gx, gy, params: LSDParams = LSDParams(), tol: float = 1e-3):
    """Compare two results of :func:`ccl_inputs` for one image whose blur
    was rounded differently (the kernel's tap order against cuDNN's or
    XLA's). ``gx``, ``gy`` are the gradients behind ``ref``. A threshold
    decides a pixel's integer planes by less than ``tol`` when its magnitude
    lies within ``tol`` of rho, and a compat bit's when its dot product lies
    within ``tol`` relative of its threshold or either end is such a pixel.
    Returns (max |mag difference|, pixels that differ only where a threshold
    decides by less than ``tol``, pixels that differ elsewhere)."""
    mag = ref[0]
    rho, cos_tol = _thresholds(params)
    near = (mag - rho).abs() <= tol
    near_bits = torch.zeros_like(ref[4])
    for d, (dy, dx) in enumerate(_OFFSETS):
        dots = gx * _shift(gx, dy, dx) + gy * _shift(gy, dy, dx)
        thr = cos_tol * mag * _shift(mag, dy, dx)
        tie = ((dots - thr).abs() <= tol * thr.abs()) | near | _shift(near, dy, dx)
        near_bits = near_bits | (tie.to(torch.int32) << d)
    differs = (got[1] != ref[1]) | (got[2] != ref[2]) | (got[3] != ref[3])
    bit_diff = got[4] ^ ref[4]
    elsewhere = (differs & ~near) | ((bit_diff & ~near_bits) != 0)
    n_near = int(((differs | (bit_diff != 0)) & ~elsewhere).sum())
    return float((got[0].double() - mag.double()).abs().max()), n_near, int(elsewhere.sum())


def detect_lines(img: torch.Tensor, max_lines: int = 256, params: LSDParams = LSDParams()) -> DetectedLines:
    """Detect line segments in an (H, W) float32 image in [0, 1], or in each
    image of a (B, H, W) batch (the batched kernels, one set of launches for
    the batch; every field then carries the leading B axis, each image's
    equal to its own call's).

    Returns DetectedLines with capacity ``max_lines`` (mask-padded)."""
    batched = img.dim() == 3
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    N = H * W
    K = max_lines
    dev = img.device
    front, propagate, moments, extents = (
        (ccl_inputs_batch, ccl_propagate_batch, component_moments_batch, component_extents_batch)
        if batched else (ccl_inputs, ccl_propagate, component_moments, component_extents)
    )
    mag, support, labels0, maxlab0, compat_bits = front(img, params)

    # connected components: min/max-label propagation + pointer jumps
    jumps = params.ccl_jumps if W <= 768 else max(params.ccl_jumps, 3)
    labels, maxlab = propagate(labels0, maxlab0, compat_bits, params.ccl_rounds)
    if jumps:
        oks = _compat_masks(compat_bits)
        big = torch.full_like(labels, N)
    for _ in range(jumps):
        lf = labels.reshape(*lead, N)
        lut = torch.cat([lf, lf.new_full((*lead, 1), N)], dim=-1)
        labels = torch.minimum(torch.gather(lut, -1, torch.clamp(lf, max=N).long()), lf).view(*lead, H, W)
        m = labels
        for ok, (dy, dx) in zip(oks, _OFFSETS):
            m = torch.minimum(m, torch.where(ok, _shift(labels, dy, dx), big))
        labels = m

    flat_labels = labels.reshape(*lead, N)  # N marks non-support
    flat_support = support.reshape(*lead, N)

    # top-K roots by spanned diagonal, per image
    pix = torch.arange(N, dtype=torch.int32, device=dev)
    ys_i, xs_i = pix // W, pix % W
    far = torch.clamp(maxlab.reshape(*lead, N), min=0)
    span = _hypot((far % W - xs_i).to(torch.float32), (far // W - ys_i).to(torch.float32))
    is_root = (flat_labels == pix) & flat_support
    key = torch.where(is_root, span + 1.0, torch.zeros_like(span))
    comp_ids = topk_stable(key, K).contiguous()  # (..., K) root pixel indices (a batch's rows are strided views)

    # per-component moments of the pixels labelled with each chosen root
    count, sw, swx, swy, swxx, swyy, swxy = moments(labels, mag, support, comp_ids).unbind(-2)
    csw = torch.clamp(sw, min=1e-6)
    cx = swx / csw
    cy = swy / csw
    mxx = swxx / csw - cx * cx
    myy = swyy / csw - cy * cy
    mxy = swxy / csw - cx * cy
    resp = count
    ev = _principal_direction(mxx, myy, mxy)

    # extents along the principal direction, normal second moment
    t_min, t_max, sn2 = extents(labels, mag, support, comp_ids, cx, cy, ev).unbind(-2)
    width = 2.0 * torch.sqrt(3.0 * torch.clamp(sn2 / csw, min=1e-9))

    empty = count < 0.5
    t_min = torch.where(empty, torch.zeros_like(t_min), t_min)
    t_max = torch.where(empty, torch.zeros_like(t_max), t_max)
    length = t_max - t_min
    p0 = torch.stack([cx + t_min * ev[..., 0], cy + t_min * ev[..., 1]], dim=-1)
    p1 = torch.stack([cx + t_max * ev[..., 0], cy + t_max * ev[..., 1]], dim=-1)

    density = resp / torch.clamp(length * torch.clamp(width, min=1.0), min=1e-6)
    valid = (
        (resp >= params.min_support)
        & (length >= params.min_length)
        & (density >= params.min_density)
        & (width <= params.max_width)
    )
    det = DetectedLines(
        endpoints=torch.stack([p0, p1], dim=-2),
        valid=valid.to(torch.float32),
        response=resp,
        angle=torch.atan2(ev[..., 1], ev[..., 0]),
        width=width,
        midpoint=torch.stack([cx, cy], dim=-1),
        length=length,
    )
    if params.merge_fragments:
        det = merge_collinear(det)
    return det


def merge_collinear(
    det: DetectedLines,
    tol_angle: float = 0.06,
    tol_perp: float = 2.0,
    max_gap: float = 12.0,
    n_rounds: int = 6,
) -> DetectedLines:
    """Merge collinear, nearly-touching segments (junction/stair fragments):
    a K x K adjacency, min-label propagation over it, per-group moments.
    Fields may carry a leading batch axis: (B, K, K) adjacencies and the
    batched sum kernel, each entry equal to its own call's."""
    K = det.endpoints.shape[-3]
    batched = det.endpoints.dim() == 4
    dev = det.endpoints.device
    validb = det.valid > 0.5
    p0, p1 = det.endpoints[..., 0, :], det.endpoints[..., 1, :]
    d = p1 - p0
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)

    def rel_to_i(p):  # (K, 2) points -> (K, K, 2): p[j] relative to midpoint i
        return p[..., None, :, :] - det.midpoint[..., :, None, :]

    def perp_to_i(p):  # (K, K): distance of p[j] to line i
        rel = rel_to_i(p)
        return torch.abs(rel[..., 0] * (-dn[..., :, None, 1]) + rel[..., 1] * dn[..., :, None, 0])

    def proj_to_i(p):  # (K, K): coordinate of p[j] along line i
        rel = rel_to_i(p)
        return rel[..., 0] * dn[..., :, None, 0] + rel[..., 1] * dn[..., :, None, 1]

    perp_ok = (perp_to_i(p0) < tol_perp) & (perp_to_i(p1) < tol_perp)
    da = torch.fmod(torch.abs(det.angle[..., :, None] - det.angle[..., None, :]), math.pi)
    da = torch.minimum(da, math.pi - da)
    ang_ok = da < tol_angle

    tj0, tj1 = proj_to_i(p0), proj_to_i(p1)
    j_lo = torch.minimum(tj0, tj1)
    j_hi = torch.maximum(tj0, tj1)
    ti = torch.sum((det.endpoints - det.midpoint[..., :, None, :]) * dn[..., :, None, :], dim=-1)
    i_lo = torch.min(ti, dim=-1).values[..., :, None]
    i_hi = torch.max(ti, dim=-1).values[..., :, None]
    gap = torch.maximum(j_lo - i_hi, i_lo - j_hi)
    gap_ok = gap < max_gap

    vv = validb[..., :, None] & validb[..., None, :]
    adj = perp_ok & ang_ok & gap_ok & vv
    adj = adj & adj.transpose(-1, -2)
    adj = adj | torch.eye(K, dtype=torch.bool, device=dev)

    ar = torch.arange(K, device=dev)
    labels = ar.expand(validb.shape)
    for _ in range(n_rounds):
        labels = torch.min(torch.where(adj, labels[..., None, :], K), dim=-1).values
        labels = torch.gather(labels, -1, labels)  # pointer jump

    is_rep = (labels == ar) & validb
    w = det.response * det.valid

    epw = 0.5 * w[..., None]
    ep = det.endpoints
    # per-group sums of the weights and the endpoint moments, in one call
    cols = torch.stack([
        w,
        torch.sum(ep[..., 0] * epw, dim=-1),
        torch.sum(ep[..., 1] * epw, dim=-1),
        torch.sum(ep[..., 0] ** 2 * epw, dim=-1),
        torch.sum(ep[..., 1] ** 2 * epw, dim=-1),
        torch.sum(ep[..., 0] * ep[..., 1] * epw, dim=-1),
        w * det.width,
    ], dim=-2)
    sums = segment_moments_batch if batched else segment_moments
    new_resp, s_x, s_y, s_xx, s_yy, s_xy, s_wwidth = sums(cols, labels.to(torch.int32), K).unbind(-2)
    sw = torch.clamp(new_resp, min=1e-6)
    ex = s_x / sw
    ey = s_y / sw
    exx = s_xx / sw - ex * ex
    eyy = s_yy / sw - ey * ey
    exy = s_xy / sw - ex * ey
    ev = _principal_direction(exx, eyy, exy)

    at_label = labels[..., None].expand(*labels.shape, 2)
    gd = torch.gather(ev, -2, at_label)
    gc = torch.gather(torch.stack([ex, ey], dim=-1), -2, at_label)
    t_ep = torch.sum((ep - gc[..., :, None, :]) * gd[..., :, None, :], dim=-1)  # (K, 2)
    inf = torch.full_like(t_ep, math.inf)
    t_lo = torch.min(torch.where(validb[..., None], t_ep, inf), dim=-1).values
    t_hi = torch.max(torch.where(validb[..., None], t_ep, -inf), dim=-1).values
    kinf = torch.full(labels.shape, math.inf, dtype=t_lo.dtype, device=dev)
    g_lo = kinf.scatter_reduce(-1, labels, t_lo, "amin", include_self=False)
    g_hi = (-kinf).scatter_reduce(-1, labels, t_hi, "amax", include_self=False)
    g_lo = torch.where(torch.isfinite(g_lo), g_lo, torch.zeros_like(g_lo))
    g_hi = torch.where(torch.isfinite(g_hi), g_hi, torch.zeros_like(g_hi))

    c = torch.stack([ex, ey], dim=-1)
    return DetectedLines(
        endpoints=torch.stack([c + g_lo[..., None] * ev, c + g_hi[..., None] * ev], dim=-2),
        valid=is_rep.to(torch.float32),
        response=new_resp,
        angle=torch.atan2(ev[..., 1], ev[..., 0]),
        width=s_wwidth / sw,
        midpoint=c + 0.5 * (g_lo + g_hi)[..., None] * ev,
        length=g_hi - g_lo,
    )
