"""A numpy model of the order in which tpuslam_torch/csrc/moments.cu's
component kernels add their sums and settle their extremes, from the shapes
and the data alone. tests/test_torch_component_sums.py holds it to the plain
versions on the CPU, tests/test_torch_cuda.py holds the kernels to it bit for
bit on the card. Imports no JAX.

The kernels give block b's warp j the contiguous items [(8 b + j) ipw,
(8 b + j + 1) ipw), with (blocks, ipw) from ``lsd.sum_partition(N)``, and add
every sum as

    groups of 8 blocks in order <- blocks in order <- warps in order <-
    32-item steps in order <- a
    pairwise tree over the step's members of the component by their rank
    in item order (rank r takes rank r + d, d = 1, 2, 4, ..., r a multiple
    of 2 d),

each level but the tree from +0.0 in float32 (a block or warp without
members of a component adds +0.0, which changes nothing). The extents are
64-bit keys, (order bits of t with -0.0 as +0.0, item index), so the first
of equal extremes in item order wins.
"""

import numpy as np

from tpuslam_torch.kernels import lsd

f32 = np.float32


def ordered_sums(keys, vals):
    """(unique keys ascending, (C, U) float32 sums): each key's values added
    one after another from +0.0 in the order they come."""
    uk, inv = np.unique(keys, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.r_[0, np.flatnonzero(np.diff(inv[order])) + 1]
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - np.repeat(starts, np.diff(np.r_[starts, len(keys)]))
    out = np.zeros((vals.shape[0], len(uk)), f32)
    for r in range(int(rank.max()) + 1 if len(keys) else 0):
        sel = rank == r
        out[:, inv[sel]] += vals[:, sel]
    return uk, out


def tree_sums(keys, vals):
    """(unique keys ascending, (C, U) float32 sums): each key's values, in
    the order they come, summed by the kernels' pairwise tree over ranks."""
    uk, inv = np.unique(keys, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    starts = np.r_[0, np.flatnonzero(np.diff(inv[order])) + 1]
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - np.repeat(starts, np.diff(np.r_[starts, len(keys)]))
    pos = {(g, r): j for j, (g, r) in enumerate(zip(inv.tolist(), rank.tolist()))}
    v = vals.astype(f32).copy()
    d = 1
    while d < (int(rank.max()) + 1 if len(keys) else 0):
        take = [(j, pos[(g, r + d)]) for j, (g, r) in enumerate(zip(inv.tolist(), rank.tolist())) if r % (2 * d) == 0 and (g, r + d) in pos]
        if take:
            dst, src = np.array(take).T
            v[:, dst] = v[:, dst] + v[:, src]
        d *= 2
    out = np.zeros((vals.shape[0], len(uk)), f32)
    out[:, inv[rank == 0]] = v[:, rank == 0]
    return uk, out


def model_sums(slot, cols, K):
    """(C, K) sums of cols (C, N) float32 over the items with slot in [0, K)
    in the kernels' order: a tree within each 32-item step, then the warp's
    steps, the block's warps, the group's blocks and the groups, each in
    order."""
    N = len(slot)
    _, ipw = lsd.sum_partition(N)
    idx = np.flatnonzero(slot >= 0)
    s = slot[idx].astype(np.int64)
    keys, sums = tree_sums((idx // 32) * K + s, cols[:, idx])  # per step, a tree over the members
    step, s = keys // K, keys % K
    keys, sums = ordered_sums(((step * 32) // ipw) * K + s, sums)  # per warp, steps in order
    warp, s = keys // K, keys % K
    keys, sums = ordered_sums((warp // lsd.SUM_WARPS) * K + s, sums)  # per block, warps in order
    block, s = keys // K, keys % K
    keys, sums = ordered_sums((block // lsd.SUM_GROUP) * K + s, sums)  # per group of blocks, blocks in order
    keys, sums = ordered_sums(keys % K, sums)  # groups in order
    out = np.zeros((cols.shape[0], K), f32)
    out[:, keys] = sums
    return out


def member_slot(labels, roots):
    slot = np.full(labels.size, -1, np.int64)
    where = {int(r): k for k, r in enumerate(roots)}
    flat = labels.reshape(-1)
    for r, k in where.items():
        slot[flat == r] = k
    return slot


def order_bits(t):
    """csrc/moments.cu order_bits: an unsigned order of finite float32,
    -0.0 taken as +0.0."""
    b = np.where(t == 0, f32(0), t).view(np.int32).astype(np.int64)
    b = np.where(b >= 0, b, b ^ 0x7FFFFFFF) & 0xFFFFFFFF
    return (b ^ 0x80000000).astype(np.uint64)


def model_extremes(slot, t, K):
    """(t_min, t_max) (K,) as the extents kernel keeps them: the least and
    the greatest key (order bits, item index or its complement), then t of
    the winning item; +inf / -inf for a slot without items."""
    idx = np.flatnonzero(slot >= 0).astype(np.uint64)
    s = slot[idx.astype(np.int64)]
    hi = order_bits(t[idx.astype(np.int64)]) << np.uint64(32)
    kmin = np.full(K, np.iinfo(np.uint64).max, np.uint64)
    kmax = np.zeros(K, np.uint64)
    np.minimum.at(kmin, s, hi | idx)
    np.maximum.at(kmax, s, hi | (np.uint64(0xFFFFFFFF) - idx))
    full = np.zeros(K, bool)
    full[s] = True
    low = np.uint64(0xFFFFFFFF)
    t_min = np.where(full, t[(kmin & low).astype(np.int64) * full], f32(np.inf))
    t_max = np.where(full, t[((low - (kmax & low)) & low).astype(np.int64) * full], f32(-np.inf))
    return t_min.astype(f32), t_max.astype(f32)
