"""The detector's fused front (``tpuslam_torch.kernels.lsd.ccl_inputs``) on
the CPU: the CUDA kernel's tiling modelled in numpy, the premise that lets
the kernel read no wrapped neighbour, the plain version against the JAX
package's chain, and the LBD gradients form's plain version.

The kernel (tpuslam_torch/csrc/lsd_front.cu) gives each block a T x T output
tile and the edge-clamped (T + 2h) x (T + 2h) window of the raw image around
it, h = r + 2 for a prefilter of radius r. In shared memory it runs the row
pass (window rows, tile columns plus a 2-px ring), the column pass, the
scale to 0..255, the gradients over the tile plus a 1-px ring, then the
support, the 8 compat bits and the label seeds of the tile. The model below
does the same on every tile at once, with T and h read from ``FRONT_TILE``
and ``front_halo``, the constants the wrapper passes, and is held bit-equal
to the same float32 arithmetic over the whole plane. The card tests hold the
kernel itself to the chain it replaces.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import image01, np_of, stereo_scene
from tpuslam.kernels import image as jimage
from tpuslam.kernels import lsd as jlsd
from tpuslam_torch.kernels import image as timage
from tpuslam_torch.kernels import lsd as tlsd

f32 = np.float32


def _consts(params):
    rho, cos_tol = tlsd._thresholds(params)
    taps = timage._blur_taps(params.prefilter_sigma).numpy()
    return taps, f32(rho), f32(cos_tol)


def _compat(gx, gy, mag, neighbours, rho, cos_tol):
    """The 8 compat bits in ``_OFFSETS`` order; neighbours(dy, dx) gives
    (gx, gy, mag) at (y - dy, x - dx), as torch.roll(x, (dy, dx)) reads."""
    sup = mag > rho
    bits = np.zeros(mag.shape, np.int32)
    for d, (dy, dx) in enumerate(tlsd._OFFSETS):
        ngx, ngy, nmag = neighbours(dy, dx)
        dot = gx * ngx + gy * ngy
        ok = sup & (nmag > rho) & (dot > (cos_tol * mag) * nmag)
        bits |= ok.astype(np.int32) << d
    return bits


def _zero_outside(planes):
    """neighbours(dy, dx) for ``_compat`` over whole planes, zero outside."""
    H, W = planes[0].shape
    padded = [np.pad(x, 1) for x in planes]
    return lambda dy, dx: tuple(p[1 - dy : 1 - dy + H, 1 - dx : 1 - dx + W] for p in padded)


def _seeds(sup):
    H, W = sup.shape
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    return np.where(sup, idx, H * W).astype(np.int32), np.where(sup, idx, -1).astype(np.int32)


def plane_model(img, params):
    """The front's float32 arithmetic over the whole plane: edge-padded blur
    in tap order, rows then columns; times 255; central differences with the
    1-px border zeroed; compat bits with zero outside the image."""
    taps, rho, cos_tol = _consts(params)
    H, W = img.shape
    r = len(taps) // 2
    p = np.pad(img, r, mode="edge")
    mid = np.zeros((H + 2 * r, W), f32)
    for k, w in enumerate(taps):
        mid = mid + w * p[:, k : k + W]
    blr = np.zeros((H, W), f32)
    for k, w in enumerate(taps):
        blr = blr + w * mid[k : k + H, :]
    v = blr * f32(255.0)
    gx = np.zeros((H, W), f32)
    gy = np.zeros((H, W), f32)
    gx[:, 1:-1] = (v[:, 2:] - v[:, :-2]) * f32(0.5)
    gy[1:-1, :] = (v[2:, :] - v[:-2, :]) * f32(0.5)
    mag = np.zeros((H, W), f32)
    mag[1:-1, 1:-1] = np.sqrt(gx * gx + gy * gy)[1:-1, 1:-1]
    sup = mag > rho
    bits = _compat(gx, gy, mag, _zero_outside((gx, gy, mag)), rho, cos_tol)
    return (mag, sup, *_seeds(sup), bits)


def tile_model(img, params, tile, halo):
    """The kernel's tiling: every block's window, passes and tile at once."""
    taps, rho, cos_tol = _consts(params)
    H, W = img.shape
    r = len(taps) // 2
    wn, bn, gn = tile + 2 * halo, tile + 4, tile + 2
    nty, ntx = -(-H // tile), -(-W // tile)
    # window cell i of tile t holds row t * tile - halo + i, clamped
    rows = np.clip(np.arange(nty)[:, None] * tile - halo + np.arange(wn)[None], 0, H - 1)
    cols = np.clip(np.arange(ntx)[:, None] * tile - halo + np.arange(wn)[None], 0, W - 1)
    win = img[rows[:, None, :, None], cols[None, :, None, :]]  # (nty, ntx, wn, wn)
    # blurred cell (i, c) is pixel (t * tile - 2 + i, ...): its taps start at
    # window cell c + halo - 2 - r
    o = halo - 2 - r
    mid = np.zeros((nty, ntx, wn, bn), f32)
    for k, w in enumerate(taps):
        mid = mid + w * win[..., :, o + k : o + k + bn]
    blr = np.zeros((nty, ntx, bn, bn), f32)
    for k, w in enumerate(taps):
        blr = blr + w * mid[..., o + k : o + k + bn, :]
    blr = blr * f32(255.0)
    # gradient cell (i, c) is pixel (t * tile - 1 + i, ...)
    ys = np.arange(nty)[:, None] * tile - 1 + np.arange(gn)[None]
    xs = np.arange(ntx)[:, None] * tile - 1 + np.arange(gn)[None]
    col_in = ((xs > 0) & (xs < W - 1))[None, :, None, :]
    row_in = ((ys > 0) & (ys < H - 1))[:, None, :, None]
    gx = np.where(col_in, (blr[..., 1:-1, 2:] - blr[..., 1:-1, :-2]) * f32(0.5), f32(0))
    gy = np.where(row_in, (blr[..., 2:, 1:-1] - blr[..., :-2, 1:-1]) * f32(0.5), f32(0))
    mag = np.where(col_in & row_in, np.sqrt(gx * gx + gy * gy), f32(0))

    def centre(x, dy=0, dx=0):  # the tile, or its neighbour (y - dy, x - dx)
        return x[..., 1 - dy : 1 - dy + tile, 1 - dx : 1 - dx + tile]

    bits = _compat(
        centre(gx), centre(gy), centre(mag), lambda dy, dx: tuple(centre(p, dy, dx) for p in (gx, gy, mag)), rho, cos_tol
    )

    def plane(x):  # (nty, ntx, tile, tile) -> (H, W)
        return x.transpose(0, 2, 1, 3).reshape(nty * tile, ntx * tile)[:H, :W]

    sup = plane(centre(mag)) > rho
    return (plane(centre(mag)), sup, *_seeds(sup), plane(bits))


def _random_image(shape, seed, bright_border=False):
    rs = np.random.RandomState(seed)
    img = rs.rand(*shape).astype(f32)
    if bright_border:  # strong gradients on the rows and columns next to the border
        for sl in ((0, slice(None)), (-1, slice(None)), (slice(None), 0), (slice(None), -1)):
            img[sl] = (rs.rand(*img[sl].shape) > 0.5).astype(f32)
    return img


def _render(shape):
    _, frames = stereo_scene(2)
    img = image01(frames[1][0])
    assert img.shape == shape
    return img


@pytest.mark.parametrize("sigma", [0.75, 0.6])  # radius 3 (the detector's), 2
@pytest.mark.parametrize("shape", [(37, 53), (65, 97), (240, 320)])
def test_tile_model_bit_equal_to_whole_plane(shape, sigma):
    """(37, 53): one tile larger than the image; (65, 97): ragged tiles and
    seams on both axes; (240, 320): a rendered frame."""
    img = _render(shape) if shape == (240, 320) else _random_image(shape, seed=shape[0], bright_border=True)
    params = tlsd.LSDParams(prefilter_sigma=sigma)
    r = timage._blur_taps(sigma).numel() // 2
    tiled = tile_model(img, params, tlsd.FRONT_TILE, tlsd.front_halo(r))
    whole = plane_model(img, params)
    for a, b in zip(tiled, whole):
        np.testing.assert_array_equal(a, b)
    assert whole[4].any() and whole[1].sum() > 20  # planes with compat bits and support


@pytest.mark.parametrize("shape", [(24, 40), (37, 53), (65, 97), (120, 160)])
def test_compat_plane_never_wraps(shape):
    """The plain version builds the compat plane through torch.roll; built
    with zero outside the image it is the same, since the image border has
    mag 0 and is never in the support. Random images whose border rows and
    columns are random 0s and 1s, so the rows and columns next to them carry
    strong gradients and compat bits."""
    img = _random_image(shape, seed=7, bright_border=True)
    params = tlsd.LSDParams()
    blurred = timage.gaussian_blur_torch(torch.from_numpy(img), params.prefilter_sigma)
    gx, gy, mag, _ = timage.image_gradients_torch(blurred * 255.0)
    rolled = tlsd._front_planes(gx, gy, mag, params)
    _, rho, cos_tol = _consts(params)
    g = [np_of(t) for t in (gx, gy, mag)]
    bits = _compat(*g, _zero_outside(g), rho, cos_tol)
    np.testing.assert_array_equal(np_of(rolled[4]), bits)
    assert (np_of(mag)[[0, -1], :] == 0).all() and (np_of(mag)[:, [0, -1]] == 0).all()
    assert bits[1].any() and bits[-2].any() and bits[:, 1].any() and bits[:, -2].any()


def _jax_front(img, params):
    """The JAX package's chain, as tpuslam/kernels/lsd.py detect_lines runs it."""
    x = jimage.gaussian_blur(jnp.asarray(img), params.prefilter_sigma)
    gx, gy, mag, _ = jimage.image_gradients(x * 255.0)
    rho = params.quant / math.sin(params.angle_tol)
    support = mag > rho
    cos_tol = math.cos(params.angle_tol)
    compat = jnp.zeros(img.shape, jnp.int32)
    for d, (dy, dx) in enumerate(jlsd._OFFSETS):
        dots = gx * jlsd._shift(gx, dy, dx) + gy * jlsd._shift(gy, dy, dx)
        ok = support & jlsd._shift(support, dy, dx) & (dots > cos_tol * mag * jlsd._shift(mag, dy, dx))
        compat = compat | (ok.astype(jnp.int32) << d)
    H, W = img.shape
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    planes = (mag, support, jnp.where(support, idx, H * W), jnp.where(support, idx, -1), compat)
    return [torch.from_numpy(np.array(p)) for p in planes], torch.from_numpy(np.array(gx)), torch.from_numpy(np.array(gy))


@pytest.mark.parametrize("shape", [(37, 53), (65, 97), (240, 320)])
def test_plain_front_matches_jax_chain(shape):
    """Blur sums in another order (PyTorch's conv2d against XLA's): mag
    within 1e-3 on the 0..255 scale, the integer planes equal except where a
    threshold decides by less than 1e-3."""
    img = _render(shape) if shape == (240, 320) else _random_image(shape, seed=3, bright_border=True)
    params = tlsd.LSDParams()
    got = tlsd.ccl_inputs(torch.from_numpy(img), params)  # a CPU tensor: the plain version
    ref, gx, gy = _jax_front(img, params)
    assert [t.dtype for t in got] == [torch.float32, torch.bool, torch.int32, torch.int32, torch.int32]
    err, n_near, n_other = tlsd.front_disagreements(got, ref, gx, gy, params)
    assert err <= 1e-3 and n_other == 0, (err, n_near, n_other)
    assert int((np_of(got[4]) != 0).sum()) > 20


@pytest.mark.parametrize("shape", [(37, 53), (65, 97), (240, 320)])
def test_gradients_xy_plain_bit_equal_to_scaled_gradients(shape):
    img = torch.from_numpy(_random_image(shape, seed=5))
    gx, gy = timage.gradients_xy(img, 255.0)  # a CPU tensor: the plain version
    ref = timage.image_gradients_torch(img * 255.0)
    assert torch.equal(gx, ref[0]) and torch.equal(gy, ref[1])
