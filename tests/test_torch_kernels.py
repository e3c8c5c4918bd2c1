"""tpuslam_torch's image, detector and descriptor kernels against tpuslam's.

CPU tensors, so every kernel wrapper runs its plain PyTorch version; the
CUDA kernels are held to those plain versions in test_torch_cuda.py. The
Pallas kernels run in interpret mode, as tests/test_pallas.py runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import QVGA, image01, np_of, stereo_scene
from tpuslam.kernels import image as jimage
from tpuslam.kernels import lbd as jlbd
from tpuslam.kernels import lsd as jlsd
from tpuslam.kernels.pallas_ccl import ccl_propagate_pallas
from tpuslam.kernels.pallas_image import blur_pallas, gradients_pallas
from tpuslam_torch.kernels import image as timage
from tpuslam_torch.kernels import lbd as tlbd
from tpuslam_torch.kernels import lsd as tlsd


@pytest.fixture(scope="module")
def frame():
    """One rendered QVGA left frame, float32 in [0, 1]."""
    _, frames = stereo_scene(4)
    return image01(frames[3][0])


def _random_image(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape,sigma", [((48, 64), 0.75), ((120, 160), 0.9375)])
def test_blur_matches_jax_and_pallas(shape, sigma):
    img = _random_image(shape)
    out = np_of(timage.gaussian_blur(torch.from_numpy(img), sigma))
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma))
    # float32 sums of 7-9 taps in another order: a few ulp of values in [0, 1]
    np.testing.assert_allclose(out, ref, atol=1e-6)
    r = int(np.ceil(3 * sigma))
    pal = np.asarray(blur_pallas(jnp.asarray(img), sigma, interpret=True))
    # the Pallas twin renormalises border taps; interiors agree
    np.testing.assert_allclose(out[r:-r, r:-r], pal[r:-r, r:-r], atol=1e-6)


@pytest.mark.parametrize("shape", [(48, 64), (240, 320)])
def test_gradients_match_jax_and_pallas(shape):
    img = _random_image(shape, seed=1) * 255.0
    out = [np_of(a) for a in timage.image_gradients(torch.from_numpy(img))]
    ref = [np.asarray(a) for a in jimage.image_gradients(jnp.asarray(img))]
    pal = [np.asarray(a) for a in gradients_pallas(jnp.asarray(img), interpret=True)]
    for other in (ref, pal):
        # differences of two float32 values times 0.5: exact
        np.testing.assert_array_equal(out[0], other[0])
        np.testing.assert_array_equal(out[1], other[1])
        # magnitude: correctly rounded sqrt on both sides; 1 ulp at 0..360
        np.testing.assert_allclose(out[2], other[2], rtol=0, atol=1e-4)
        # atan2 of identical inputs, libm against XLA: a few ulp. On the
        # border both gradients are zero, and the Pallas twin's signed zeros
        # (a product with 0) pick -pi where the others pick pi
        np.testing.assert_allclose(out[3][1:-1, 1:-1], other[3][1:-1, 1:-1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[3], ref[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((240, 320), (192, 256)), ((120, 160), (96, 128)), ((50, 70), (40, 56))])
def test_resize_matches_jax_image_resize(src, dst):
    img = _random_image(src, seed=2)
    out = np_of(timage.resize_linear(torch.from_numpy(img), dst))
    ref = np.asarray(jax.image.resize(jnp.asarray(img), dst, method="linear"))
    # antialiased triangle weights built step for step; the two contractions
    # sum in another order: float32 rounding of values in [0, 1]
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_pyramid_matches_jax(frame):
    out = timage.build_pyramid(torch.from_numpy(frame), 2, 0.8)
    ref = jimage.build_pyramid(jnp.asarray(frame), 2, 0.8)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == [(240, 320), (192, 256)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np_of(o), np.asarray(r), atol=2e-6)  # blur + resize rounding


def _random_ccl_inputs(H, W, seed):
    rs = np.random.RandomState(seed)
    support = rs.rand(H, W) < 0.6
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    labels = np.where(support, idx, H * W).astype(np.int32)
    maxlab = np.where(support, idx, -1).astype(np.int32)
    compat = rs.randint(0, 256, (H, W)).astype(np.int32)  # every bit, border and wrap included
    return labels, maxlab, compat


@pytest.mark.parametrize("rounds", [12, 32])
def test_ccl_bit_exact_against_xla_and_pallas(rounds):
    labels, maxlab, compat = _random_ccl_inputs(48, 64, seed=rounds)

    def torch_ccl(cb):
        return [np_of(a) for a in tlsd.ccl_propagate(*map(torch.from_numpy, (labels, maxlab, cb)), rounds)]

    # roll semantics: compat bits on the border reach across the wrap
    ref = [np.asarray(a) for a in jlsd._ccl_xla(*map(jnp.asarray, (labels, maxlab, compat)), rounds)]
    for a, b in zip(torch_ccl(compat), ref):
        np.testing.assert_array_equal(a, b)  # integer labels: bit-exact
    # the Pallas twin fills instead of wrapping, which is the same where the
    # border carries no compat bits (always so in the detector)
    inner = np.zeros_like(compat)
    inner[1:-1, 1:-1] = compat[1:-1, 1:-1]
    pal = ccl_propagate_pallas(*map(jnp.asarray, (labels, maxlab, inner)), rounds, interpret=True, strip=16)
    for a, b in zip(torch_ccl(inner), pal):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_ccl_bit_exact_on_rendered_compat_plane(frame):
    """The detector's own compat plane (rendered frame), 32 rounds."""
    _, _, labels0, maxlab0, compat = tlsd.ccl_inputs(torch.from_numpy(frame), tlsd.LSDParams())
    out = [np_of(a) for a in tlsd.ccl_propagate(labels0, maxlab0, compat, 32)]
    ref = [np.asarray(a) for a in jlsd._ccl_xla(*(jnp.asarray(np_of(t)) for t in (labels0, maxlab0, compat)), 32)]
    assert (np_of(compat) != 0).sum() > 1000  # a real plane, not an empty one
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_topk_stable_reproduces_lax_top_k_ties():
    x = np.array([0, 0, 2, 0, 1, 0, 2], np.float32)
    assert np_of(tlsd.topk_stable(torch.from_numpy(x), 5)).tolist() == [2, 6, 4, 0, 1]
    assert np.asarray(jax.lax.top_k(jnp.asarray(x), 5)[1]).tolist() == [2, 6, 4, 0, 1]
    keys = np.random.default_rng(3).integers(0, 4, 500).astype(np.float32)  # many ties
    np.testing.assert_array_equal(
        np_of(tlsd.topk_stable(torch.from_numpy(keys), 100)), np.asarray(jax.lax.top_k(jnp.asarray(keys), 100)[1])
    )


def _segments(det):
    valid = np_of(det.valid) > 0.5
    return np_of(det.endpoints)[valid]


def _matched(a, b, tol):
    """Fraction of segments in a with a segment in b whose endpoints lie
    within tol px (either orientation)."""
    if len(a) == 0:
        return 1.0
    d_same = np.abs(a[:, None] - b[None]).max(axis=(2, 3))
    d_flip = np.abs(a[:, None] - b[None, :, ::-1]).max(axis=(2, 3))
    return float((np.minimum(d_same, d_flip).min(axis=1) < tol).mean())


def test_detect_lines_segment_sets_match_jax(frame):
    """The support threshold is discontinuous and the moment sums run in
    another order, so slots need not line up: compare the valid segment sets.
    Endpoints of matched segments within 0.5 px; at least 95% of each side's
    segments matched."""
    t_det = tlsd.detect_lines(torch.from_numpy(frame), 128, tlsd.LSDParams(ccl_rounds=32))
    j_det = jlsd.detect_lines(jnp.asarray(frame), 128, jlsd.LSDParams(ccl_rounds=32))
    ts, js = _segments(t_det), _segments(j_det)
    assert len(js) > 40
    assert abs(len(ts) - len(js)) <= 0.05 * len(js)
    assert _matched(js, ts, 0.5) >= 0.95
    assert _matched(ts, js, 0.5) >= 0.95


def test_merge_collinear_matches_jax():
    """Two collinear fragments with a gap merge, a crossing segment stays."""
    K = 8
    ep = np.zeros((K, 2, 2), np.float32)
    ep[0] = [[10, 20], [40, 20.5]]
    ep[1] = [[46, 20.6], [80, 21.2]]
    ep[2] = [[30, 5], [31, 60]]
    valid = np.zeros(K, np.float32)
    valid[:3] = 1
    d = ep[:, 1] - ep[:, 0]
    fields = dict(
        endpoints=ep, valid=valid, response=np.array([30, 34, 55] + [0] * 5, np.float32),
        angle=np.arctan2(d[:, 1], d[:, 0]).astype(np.float32), width=np.full(K, 2.0, np.float32),
        midpoint=ep.mean(axis=1), length=np.linalg.norm(d, axis=-1).astype(np.float32),
    )
    out = tlsd.merge_collinear(tlsd.DetectedLines(**{k: torch.from_numpy(v) for k, v in fields.items()}))
    ref = jlsd.merge_collinear(jlsd.DetectedLines(**{k: jnp.asarray(v) for k, v in fields.items()}))
    np.testing.assert_array_equal(np_of(out.valid), np.asarray(ref.valid))
    assert np_of(out.valid).sum() == 2
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=1e-4)  # float32 moment sums


def test_lbd_bits_exact_on_same_inputs(frame):
    """Same endpoints and gradients into both packages: descriptor floats
    agree to float32 rounding, the 256 bits exactly."""
    j_det = jlsd.detect_lines(jnp.asarray(frame), 128, jlsd.LSDParams(ccl_rounds=32))
    ep = np.array(j_det.endpoints)
    gx, gy, _, _ = jimage.image_gradients(jnp.asarray(frame * 255.0))
    j_desc, j_bits = jlbd.lbd_descriptors(gx, gy, jnp.asarray(ep))
    tgx, tgy, _, _ = timage.image_gradients(torch.from_numpy(frame * 255.0))
    t_desc, t_bits = tlbd.lbd_descriptors(tgx, tgy, torch.from_numpy(ep))
    np.testing.assert_allclose(np_of(t_desc), np.asarray(j_desc), atol=1e-5)
    np.testing.assert_array_equal(np_of(t_bits).astype(np.uint32), np.asarray(j_bits))
    assert (np.asarray(j_bits) != 0).any(axis=1).sum() > 40


def test_cpu_tensors_run_the_plain_versions_and_count_nothing(frame):
    before = (dict(timage.LAUNCHES), dict(tlsd.LAUNCHES))
    x = torch.from_numpy(frame)
    timage.gaussian_blur(x, 0.75)
    timage.image_gradients(x)
    timage.gradients_xy(x, 255.0)
    tlsd.detect_lines(x, 64, tlsd.LSDParams(ccl_rounds=12))
    assert (timage.LAUNCHES, tlsd.LAUNCHES) == before


def test_wrappers_refuse_other_devices():
    x = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        timage.gaussian_blur(x, 0.75)
    with pytest.raises(ValueError, match="unsupported device"):
        timage.image_gradients(x)
    with pytest.raises(ValueError, match="unsupported device"):
        timage.gradients_xy(x, 255.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tlsd.ccl_inputs(x)
    i = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tlsd.ccl_propagate(i, i, i, 4)
