"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

On a machine with a GPU and the CUDA toolkit (the kernels build at first
use; this file and its helper import no JAX, the repo's conftest does):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from torch_parity import QVGA, image01, stereo_scene
from tpuslam_torch.kernels import image, lsd

pytestmark = pytest.mark.cuda

# slice shapes, a QVGA frame and a ragged one (partial 32x8 blocks)
SHAPES = [(480, 640), (384, 512), (240, 320), (37, 53)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(dev)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.75, 0.9375])
def test_blur_kernel_matches_plain(dev, shape, sigma):
    x = _image(shape, dev)
    out = image.gaussian_blur(x, sigma)
    ref = image.gaussian_blur_torch(x, sigma)
    torch.cuda.synchronize()
    # same float32 taps, tap-order sums against cuDNN's order, values in [0, 1]
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_kernel_matches_plain(dev, shape):
    x = _image(shape, dev, seed=1) * 255.0
    out = image.image_gradients(x)
    ref = image.image_gradients_torch(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)  # exact differences
    torch.testing.assert_close(out[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=1e-3)  # 0..255 scale
    torch.testing.assert_close(out[3], ref[3], rtol=0, atol=1e-5)  # atan2f ulp


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rounds", [0, 1, 7, 64])
def test_ccl_kernel_bit_exact(dev, shape, rounds):
    rs = np.random.RandomState(rounds)
    H, W = shape
    support = rs.rand(H, W) < 0.6
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    planes = [
        np.where(support, idx, H * W).astype(np.int32),
        np.where(support, idx, -1).astype(np.int32),
        rs.randint(0, 256, (H, W)).astype(np.int32),  # border bits: wrap-around
    ]
    lab0, mx0, cb = (torch.from_numpy(p).to(dev) for p in planes)
    out = lsd.ccl_propagate(lab0, mx0, cb, rounds)
    ref = lsd._ccl_torch(lab0, mx0, cb, rounds)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert torch.equal(lab0, torch.from_numpy(planes[0]).to(dev))  # inputs untouched


def test_ccl_kernel_bit_exact_on_detector_plane(dev):
    _, frames = stereo_scene(2)
    x = torch.from_numpy(image01(frames[1][0])).to(dev)
    _, _, _, _, lab0, mx0, cb = lsd.ccl_inputs(x, lsd.LSDParams())
    out = lsd.ccl_propagate(lab0, mx0, cb, 64)
    ref = lsd._ccl_torch(lab0, mx0, cb, 64)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_launch_counts(dev):
    x = _image((64, 96), dev)
    before = dict(image.LAUNCHES), dict(lsd.LAUNCHES)
    image.gaussian_blur(x, 0.75)
    image.image_gradients(x)
    image.gaussian_blur_torch(x, 0.75)  # plain versions count nothing
    image.image_gradients_torch(x)
    i = torch.zeros((64, 96), dtype=torch.int32, device=dev)
    lsd.ccl_propagate(i, i, i, 5)  # one call of 5 launches counts once
    assert image.LAUNCHES["blur"] == before[0]["blur"] + 1
    assert image.LAUNCHES["gradients"] == before[0]["gradients"] + 1
    assert lsd.LAUNCHES["ccl"] == before[1]["ccl"] + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        image.gaussian_blur(torch.zeros((16, 16), dtype=torch.float64, device=dev), 0.75)
    with pytest.raises(ValueError):
        image.image_gradients(torch.zeros((16, 32), device=dev)[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        image.gaussian_blur(torch.zeros((2, 16, 16), device=dev), 0.75)  # not (H, W)
    i = torch.zeros((16, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        lsd.ccl_propagate(i, i, torch.zeros((16, 17), dtype=torch.int32, device=dev), 3)


def test_slice_on_card_tracks_like_cpu(dev):
    """Four QVGA frames through System on the card and on the CPU: the same
    states and keyframes; poses within 2 cm (kernels and plain versions
    differ in float rounding, which the detector's thresholds can turn into
    slightly different segments)."""
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.kernels.lsd import LSDParams
    from tpuslam_torch.system import System

    _, frames = stereo_scene(4)
    cfg = TrackerConfig(frontend=FrontendParams(max_lines=128, lsd=LSDParams(ccl_rounds=32)))
    runs = []
    for device in ("cpu", dev):
        s = System(QVGA, sensor="stereo", mapping=False, loop_closing=False, tracker_cfg=cfg, device=device)
        for f, (il, ir) in enumerate(frames):
            s.track_stereo(il, ir, 0.05 * f)
        runs.append(s.trajectory)
    for a, b in zip(*runs):
        assert a.state == b.state and a.made_keyframe == b.made_keyframe
        assert np.linalg.norm(np.linalg.inv(a.T_cw)[:3, 3] - np.linalg.inv(b.T_cw)[:3, 3]) < 0.02
