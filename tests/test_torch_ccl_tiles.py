"""The CUDA CCL kernel's tile schedule, modelled in numpy, against the plain
PyTorch version and the JAX package's ``_ccl_xla``.

The kernel (tpuslam_torch/csrc/ccl.cu, ccl_tile_kernel) runs ceil(R / k)
launches per call. Each block of a launch loads the wrap-indexed
(TY + 2k) x (TX + 2k) window around its TY x TX tile into two ping-pong
buffers, runs k synchronous rounds (round j writes only the live cells, with
compat bits set, at Chebyshev distance >= j from the window's edge), and
writes the centre tile; the last launch runs the remaining rounds. The
model below does the same on every tile at once, with (TY, TX, k) read
from ``tpuslam_torch.kernels.lsd.CCL_TILE``, the constant the wrapper
passes to the kernel. The card tests hold the kernel itself to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.kernels import lsd as jlsd
from tpuslam_torch.kernels import lsd as tlsd

TY, TX, K = tlsd.CCL_TILE


def tile_schedule(labels, maxlab, compat, rounds, tile):
    """The kernel's schedule: returns (labels, max labels, launches)."""
    ty, tx, k = tile
    H, W = labels.shape
    wh, ww = ty + 2 * k, tx + 2 * k
    nty, ntx = -(-H // ty), -(-W // tx)
    rows = (np.arange(nty)[:, None] * ty - k + np.arange(wh)[None, :]) % H  # (nty, wh)
    cols = (np.arange(ntx)[:, None] * tx - k + np.arange(ww)[None, :]) % W  # (ntx, ww)

    def windows(plane):  # (H, W) -> (nty, ntx, wh, ww), wrap-indexed
        return plane[rows[:, None, :, None], cols[None, :, None, :]]

    cb = windows((compat & 0xFF).astype(np.uint8))  # only bits 0-7 are read
    lab, mx = labels, maxlab
    n = -(-rounds // k)
    for t in range(n):
        kr = rounds - k * (n - 1) if t == n - 1 else k
        bufs = [[windows(lab), windows(mx)], [windows(lab), windows(mx)]]
        for j in range(1, kr + 1):
            (sl, sm), (dl, dm) = bufs[(j - 1) & 1], bufs[j & 1]
            rs, cs = slice(j, wh - j), slice(j, ww - j)
            lm, mm = sl[..., rs, cs].copy(), sm[..., rs, cs].copy()
            for d, (dy, dx) in enumerate(tlsd._OFFSETS):
                ok = ((cb[..., rs, cs] >> d) & 1) > 0
                src = (slice(j - dy, wh - j - dy), slice(j - dx, ww - j - dx))
                lm = np.where(ok, np.minimum(lm, sl[(...,) + src]), lm)
                mm = np.where(ok, np.maximum(mm, sm[(...,) + src]), mm)
            live = cb[..., rs, cs] != 0
            dl[..., rs, cs] = np.where(live, lm, dl[..., rs, cs])
            dm[..., rs, cs] = np.where(live, mm, dm[..., rs, cs])

        def centre(w):
            c = w[..., k : k + ty, k : k + tx]  # (nty, ntx, ty, tx)
            return c.transpose(0, 2, 1, 3).reshape(nty * ty, ntx * tx)[:H, :W]

        lab, mx = (centre(b) for b in bufs[kr & 1])
    return lab.copy(), mx.copy(), n


def _planes(H, W, seed):
    rs = np.random.RandomState(seed)
    support = rs.rand(H, W) < 0.6
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    labels = np.where(support, idx, H * W).astype(np.int32)
    maxlab = np.where(support, idx, -1).astype(np.int32)
    compat = rs.randint(0, 256, (H, W)).astype(np.int32)
    compat[0, :] = compat[-1, :] = 255  # every bit on the border: flow across the wrap
    compat[:, 0] = compat[:, -1] = 255
    return labels, maxlab, compat


def _check(shape, rounds, seed):
    labels, maxlab, compat = _planes(*shape, seed)
    lab, mx, n = tile_schedule(labels, maxlab, compat, rounds, tlsd.CCL_TILE)
    assert n == -(-rounds // K)
    plain = tlsd._ccl_torch(*map(torch.from_numpy, (labels, maxlab, compat)), rounds)
    xla = jlsd._ccl_xla(*map(jnp.asarray, (labels, maxlab, compat)), rounds)
    for got, p, x in zip((lab, mx), plain, xla):
        np.testing.assert_array_equal(got, p.numpy())
        np.testing.assert_array_equal(got, np.asarray(x))
    if rounds > 0:  # the planes really moved
        assert (lab != labels).any()


# (37, 53): a window larger than the image; (48, 64): several tiles, ragged;
# 2k + 3: two whole launches and a ragged third
@pytest.mark.parametrize("rounds", [0, 1, K - 1, K, K + 1, 2 * K + 3, 64])
@pytest.mark.parametrize("shape", [(37, 53), (48, 64)])
def test_tile_schedule_equals_plain_and_xla(shape, rounds):
    _check(shape, rounds, seed=rounds)


@pytest.mark.parametrize("rounds", [1, K + 1])
def test_tile_schedule_equals_plain_and_xla_at_vga(rounds):
    _check((480, 640), rounds, seed=rounds)
