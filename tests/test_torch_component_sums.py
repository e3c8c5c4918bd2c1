"""The detector's component statistics (tpuslam_torch.kernels.lsd
component_moments and component_extents) on the CPU: their plain versions
against the JAX package's fused one-hot reductions, and the CUDA kernels'
order of summation (modelled in tests/torch_sum_model.py from the shapes
and the data alone) held to the plain versions; the card tests hold the
kernels to the model bit for bit.

Inputs are seeded numpy planes: a label per supported pixel drawn from more
components than the K chosen ones (so some supported pixels belong to none),
the non-support label N, magnitudes on the detector's scale.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_sum_model import member_slot, model_extremes, model_sums, order_bits
from tpuslam_torch.kernels import lsd

f32 = np.float32

# the bench path's two levels, a ragged shape smaller than K components, and
# one with fewer components than K (the rest of the roots from row 0)
CASES = [(240, 320, 256, 0), (192, 256, 256, 1), (37, 53, 256, 2), (16, 24, 64, 3)]


def _planes(H, W, K, seed):
    """(labels int32, mag float32, support bool, roots int64) as numpy."""
    rng = np.random.default_rng(seed)
    N = H * W
    support = rng.random((H, W)) < 0.2
    support[[0, -1], :] = False
    support[:, [0, -1]] = False
    mag = rng.uniform(0.0, 4.0, (H, W)).astype(f32)
    mag[support] = rng.uniform(8.0, 400.0, int(support.sum())).astype(f32)
    sup_idx = np.flatnonzero(support)
    comps = rng.choice(sup_idx, min(len(sup_idx), K + K // 2), replace=False)
    labels = np.full(N, N, np.int32)
    labels[sup_idx] = rng.choice(comps, len(sup_idx))
    labels[comps] = comps  # each component's root labels itself
    roots = comps[:K]
    if len(roots) < K:  # as topk_stable pads: the lowest-index pixels outside the support
        roots = np.concatenate([roots, np.arange(K - len(roots))])
    return labels.reshape(H, W), mag, support, roots.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _case(H, W, K, seed):
    """The planes, the plain versions' (7, K) moments and (3, K) extents,
    and the (cx, cy, ev) the detector derives from the moments."""
    labels, mag, support, roots = _planes(H, W, K, seed)
    t = [torch.from_numpy(x) for x in (labels, mag, support, roots)]
    mom = lsd.component_moments_torch(*t)
    csw = torch.clamp(mom[1], min=1e-6)
    cx, cy = mom[2] / csw, mom[3] / csw
    ev = lsd._principal_direction(mom[4] / csw - cx * cx, mom[5] / csw - cy * cy, mom[6] / csw - cx * cy)
    ext = lsd.component_extents_torch(*t, cx, cy, ev)
    return (labels, mag, support, roots), mom.numpy(), ext.numpy(), (cx.numpy(), cy.numpy(), ev.numpy())


@functools.partial(jax.jit, static_argnums=4)
def _jax_moments(flat_labels, comp_ids, support, mag, W):
    """tpuslam/kernels/lsd.py detect_lines' seven `red` sums."""
    N = flat_labels.shape[0]
    ys_i, xs_i = jnp.divmod(jnp.arange(N, dtype=jnp.int32), W)
    xs, ys = xs_i.astype(jnp.float32), ys_i.astype(jnp.float32)
    w = jnp.where(support, mag, 0.0)
    eqf = (flat_labels[None, :] == comp_ids[:, None]).astype(jnp.float32)

    def red(v):
        return jnp.sum(eqf * v[None, :], axis=1)

    return jnp.stack([red(support.astype(jnp.float32)), red(w), red(w * xs), red(w * ys), red(w * xs * xs), red(w * ys * ys), red(w * xs * ys)])


def _jax_extents(flat_labels, comp_ids, support, mag, cx, cy, ev, W, separate):
    """tpuslam/kernels/lsd.py detect_lines' t_min, t_max and sn2. XLA:CPU
    fuses t's `relx * ev.x + rely * ev.y` into a multiply-add; with
    ``separate`` both products come out of one jitted program and are added
    in another, so each is rounded first, as the port rounds them."""
    N = flat_labels.shape[0]

    @jax.jit
    def products(cx, cy, ev):
        ys_i, xs_i = jnp.divmod(jnp.arange(N, dtype=jnp.int32), W)
        relx = xs_i.astype(jnp.float32)[None, :] - cx[:, None]
        rely = ys_i.astype(jnp.float32)[None, :] - cy[:, None]
        return relx, rely, relx * ev[:, 0:1], rely * ev[:, 1:2]

    @jax.jit
    def reductions(relx, rely, px, py, t_kn):
        w = jnp.where(support, mag, 0.0)
        eq = flat_labels[None, :] == comp_ids[:, None]
        t_kn = px + py if t_kn is None else t_kn
        tn_kn = -relx * ev[:, 1:2] + rely * ev[:, 0:1]
        pen = jnp.where(eq, 0.0, jnp.float32(1e9))
        t_min = jnp.min(t_kn + pen, axis=1)
        t_max = jnp.max(t_kn - pen, axis=1)
        sn2 = jnp.sum(jnp.where(eq, w[None, :] * tn_kn * tn_kn, 0.0), axis=1)
        return jnp.stack([t_min, t_max, sn2])

    if separate:
        return reductions(*products(cx, cy, ev), None)

    @jax.jit
    def fused(cx, cy, ev):
        relx, rely, _, _ = products(cx, cy, ev)
        return reductions(relx, rely, None, None, relx * ev[:, 0:1] + rely * ev[:, 1:2])

    return fused(cx, cy, ev)


@pytest.mark.parametrize("H, W, K, seed", CASES)
def test_component_moments_match_jax(H, W, K, seed):
    """The seven moments of the plain version within 1e-5 relative of the
    JAX package's one-hot reductions (every column is a sum of terms >= 0,
    so relative to the sum itself)."""
    (labels, mag, support, roots), mom, _, _ = _case(H, W, K, seed)
    ref = np.asarray(_jax_moments(jnp.asarray(labels.reshape(-1)), jnp.asarray(roots.astype(np.int32)), jnp.asarray(support.reshape(-1)), jnp.asarray(mag.reshape(-1)), W))
    assert mom.shape == (7, K)
    assert mom[0].sum() > 0
    np.testing.assert_allclose(mom, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("H, W, K, seed", CASES)
def test_component_extents_match_jax(H, W, K, seed):
    """t_min and t_max of the plain version exactly equal to the JAX
    package's one-hot min and max on every component with members when t's
    two products are rounded as the port rounds them, and within one float32
    spacing of XLA's fused multiply-add; sn2 within 1e-5 relative. The
    components without members +inf / -inf (the JAX package's +-1e9
    penalty; detect_lines zeroes both)."""
    (labels, mag, support, roots), mom, ext, (cx, cy, ev) = _case(H, W, K, seed)
    args = [jnp.asarray(x) for x in (labels.reshape(-1), roots.astype(np.int32), support.reshape(-1), mag.reshape(-1), cx, cy, ev)]
    ref = np.asarray(_jax_extents(*args, W, True))
    fused = np.asarray(_jax_extents(*args, W, False))
    full = mom[0] > 0.5
    assert full.sum() >= min(K, 100) or 0 < full.sum() < K  # the small case has fewer components than K
    np.testing.assert_array_equal(ext[:2, full], ref[:2, full])
    assert np.all(np.abs(ext[:2, full] - fused[:2, full]) <= np.spacing(np.abs(fused[:2, full])))
    np.testing.assert_allclose(ext[2], ref[2], rtol=1e-5, atol=0)
    np.testing.assert_allclose(ext[2], fused[2], rtol=1e-5, atol=0)
    assert np.all(ext[0, ~full] == np.inf) and np.all(ext[1, ~full] == -np.inf) and np.all(ext[2, ~full] == 0)


def test_component_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors the wrappers return their plain versions' results bit
    for bit and count no launch."""
    planes, mom, ext, (cx, cy, ev) = _case(*CASES[0])
    t = [torch.from_numpy(x) for x in planes]
    before = dict(lsd.KERNEL_LAUNCHES)
    got_m = lsd.component_moments(*t)
    got_e = lsd.component_extents(*t, *(torch.from_numpy(x) for x in (cx, cy, ev)))
    assert np.array_equal(got_m.numpy().view(np.int32), mom.view(np.int32))
    assert np.array_equal(got_e.numpy().view(np.int32), ext.view(np.int32))
    assert lsd.KERNEL_LAUNCHES == before


# ---- the kernels' order, modelled ---------------------------------------------


@pytest.mark.parametrize("N", [480 * 640, 240 * 320, 192 * 256, 37 * 53, 16 * 24, 1, 33, 70000])
def test_sum_partition_covers_the_items_from_n_alone(N):
    """The partition the wrapper passes: at most SUM_MAX_BLOCKS blocks of
    SUM_WARPS warps, whole 32-item steps per warp, every item in exactly one
    warp's run, no block without items; a function of N alone."""
    blocks, ipw = lsd.sum_partition(N)
    assert 1 <= blocks <= lsd.SUM_MAX_BLOCKS and ipw >= 32 and ipw % 32 == 0
    runs = [(min(N, w * ipw), min(N, (w + 1) * ipw)) for w in range(blocks * lsd.SUM_WARPS)]
    assert runs[0][0] == 0 and all(a[1] == b[0] for a, b in zip(runs, runs[1:])) and runs[-1][1] == N
    assert (blocks - 1) * lsd.SUM_WARPS * ipw < N
    assert lsd.sum_partition(N) == (blocks, ipw)


@pytest.mark.parametrize("H, W, K, seed", CASES[:3])
def test_model_of_the_kernel_order_agrees_with_plain(H, W, K, seed):
    """The seven moment columns and the normal moment summed in the
    kernels' order (from the shapes and the data alone) agree with the plain
    versions' item order within 1e-5 relative."""
    (labels, mag, support, roots), mom, ext, (cx, cy, ev) = _case(H, W, K, seed)
    N = H * W
    slot = member_slot(labels, roots)
    xs = (np.arange(N) % W).astype(f32)
    ys = (np.arange(N) // W).astype(f32)
    sup = support.reshape(-1)
    w = np.where(sup, mag.reshape(-1), f32(0))
    wx, wy = w * xs, w * ys
    cols = np.stack([sup.astype(f32), w, wx, wy, wx * xs, wy * ys, wx * ys])
    got = model_sums(slot, cols, K)
    np.testing.assert_allclose(got, mom, rtol=1e-5, atol=0)
    k = np.maximum(slot, 0)
    relx, rely = xs - cx[k], ys - cy[k]
    tn = -relx * ev[k, 1] + rely * ev[k, 0]
    sn2 = model_sums(slot, (w * tn * tn)[None], K)[0]
    np.testing.assert_allclose(sn2, ext[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_extreme_keys_settle_ties_as_scatter_reduce(seed):
    """The extents kernel's keys against the plain version's scatter_reduce
    amin / amax on values full of ties, -0.0 against +0.0 among them: equal
    bit for bit (torch keeps the first of equal values in item order, and
    so do the keys). Also the order bits sort finite floats as their values."""
    rng = np.random.default_rng(seed)
    N, K = 76800, 257
    slot = rng.integers(-1, K - 1, N)
    # even slots: minima at a signed zero; odd slots: maxima at one
    t = np.where(slot % 2 == 0, rng.choice(np.array([-0.0, 0.0, 1.0, 3.0], f32), N), rng.choice(np.array([-2.5, -1.0, -0.0, 0.0], f32), N))
    t_min, t_max = model_extremes(slot, t, K)
    member = torch.from_numpy(np.where(slot >= 0, slot, K - 1))
    inf = torch.full((K,), math.inf)
    tt = torch.from_numpy(t)
    ref_min = inf.scatter_reduce(0, member, tt, "amin", include_self=False).numpy()
    ref_max = (-inf).scatter_reduce(0, member, tt, "amax", include_self=False).numpy()
    last = slot.max() + 1
    zeros = np.r_[t_min[:last:2], t_max[1:last:2]]
    assert np.all(zeros == 0) and np.signbit(zeros).any() and not np.signbit(zeros).all()
    assert np.array_equal(t_min[:last].view(np.int32), ref_min[:last].view(np.int32))
    assert np.array_equal(t_max[:last].view(np.int32), ref_max[:last].view(np.int32))
    x = rng.normal(0, 1e3, 4096).astype(f32)
    x[:4] = (-0.0, 0.0, np.finfo(f32).max, -np.finfo(f32).max)
    order = np.argsort(order_bits(x), kind="stable")
    assert np.all(np.diff(x[order]) >= 0)
