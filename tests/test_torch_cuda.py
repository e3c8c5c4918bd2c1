"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

On a machine with a GPU and the CUDA toolkit (the kernels build at first
use; this file and its helper import no JAX, the repo's conftest does):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from torch_parity import QVGA, image01, stereo_scene
from tpuslam_torch.kernels import cuda_lib, image, lsd

pytestmark = pytest.mark.cuda

# slice shapes, a QVGA frame, KITTI width and a ragged one (partial tiles;
# smaller than one CCL window)
SHAPES = [(480, 640), (384, 512), (240, 320), (376, 1241), (37, 53)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(shape, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(dev)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.75, 0.9375, 5.0])  # radius 3, 3, 15
def test_blur_kernel_matches_plain(dev, shape, sigma):
    x = _image(shape, dev)
    out = image.gaussian_blur(x, sigma)
    ref = image.gaussian_blur_torch(x, sigma)
    torch.cuda.synchronize()
    # same float32 taps, tap-order sums against cuDNN's order, values in [0, 1]
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.75, 5.0])
def test_blur_kernel_bit_equal_to_two_pass_form(dev, shape, sigma):
    """One launch through shared memory, the same taps in the same order
    and a float32 intermediate: bit for bit the two-launch form."""
    x = _image(shape, dev, seed=2)
    assert torch.equal(image.gaussian_blur(x, sigma), image._blur_two_pass_cuda(x, sigma))


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


def _ccl_planes(shape, seed):
    rs = np.random.RandomState(seed)
    H, W = shape
    support = rs.rand(H, W) < 0.6
    idx = np.arange(H * W, dtype=np.int32).reshape(H, W)
    return [
        np.where(support, idx, H * W).astype(np.int32),
        np.where(support, idx, -1).astype(np.int32),
        rs.randint(0, 256, (H, W)).astype(np.int32),  # border bits: wrap-around
    ]


K = lsd.CCL_TILE[2]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rounds", [0, 1, 7, K, K + 1, 64])
def test_ccl_kernel_bit_exact(dev, shape, rounds):
    planes = _ccl_planes(shape, rounds)
    lab0, mx0, cb = (torch.from_numpy(p).to(dev) for p in planes)
    out = lsd.ccl_propagate(lab0, mx0, cb, rounds)
    ref = lsd._ccl_torch(lab0, mx0, cb, rounds)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert torch.equal(lab0, torch.from_numpy(planes[0]).to(dev))  # inputs untouched


@pytest.mark.parametrize("shape", SHAPES)
def test_ccl_kernel_bit_equal_to_per_round_form(dev, shape):
    lab0, mx0, cb = (torch.from_numpy(p).to(dev) for p in _ccl_planes(shape, 3))
    out = lsd.ccl_propagate(lab0, mx0, cb, 64)
    ref = lsd._ccl_per_round_cuda(lab0, mx0, cb, 64)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_ccl_kernel_bit_exact_on_detector_plane(dev):
    _, frames = stereo_scene(2)
    x = torch.from_numpy(image01(frames[1][0])).to(dev)
    _, _, _, _, lab0, mx0, cb = lsd.ccl_inputs(x, lsd.LSDParams())
    out = lsd.ccl_propagate(lab0, mx0, cb, 64)
    ref = lsd._ccl_torch(lab0, mx0, cb, 64)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_launch_counts(dev):
    x = _image((64, 96), dev)
    before = [dict(d) for d in (image.LAUNCHES, lsd.LAUNCHES, image.KERNEL_LAUNCHES, lsd.KERNEL_LAUNCHES)]
    image.gaussian_blur(x, 0.75)
    image.image_gradients(x)
    image.gaussian_blur_torch(x, 0.75)  # plain versions count nothing
    image.image_gradients_torch(x)
    image._blur_two_pass_cuda(x, 0.75)  # nor do the baseline forms
    i = torch.zeros((64, 96), dtype=torch.int32, device=dev)
    lsd.ccl_propagate(i, i, i, 64)  # one call of ceil(64 / k) launches counts once
    lsd._ccl_per_round_cuda(i, i, i, 5)
    lsd.ccl_propagate(i, i, i, 0)  # a copy, no launch
    assert image.LAUNCHES["blur"] == before[0]["blur"] + 1
    assert image.LAUNCHES["gradients"] == before[0]["gradients"] + 1
    assert lsd.LAUNCHES["ccl"] == before[1]["ccl"] + 2
    # launches per call: 1 for blur and gradients, ceil(64 / k) for CCL
    assert image.KERNEL_LAUNCHES["blur"] == before[2]["blur"] + 1
    assert image.KERNEL_LAUNCHES["gradients"] == before[2]["gradients"] + 1
    assert lsd.KERNEL_LAUNCHES["ccl"] == before[3]["ccl"] + -(-64 // K)


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
    # the C function takes only the built tile, the wrapper's CCL_TILE
    p, n = i.data_ptr(), ctypes.c_int(0)
    for tile in ((32, 32, 16), (16, 16, 4)):
        code = cuda_lib.library().tpuslam_ccl(p, p, p, p, p, p, p, 16, 16, 3, *tile, ctypes.byref(n), cuda_lib.stream_of(i))
        assert code != 0 and n.value == 0
    with pytest.raises(RuntimeError, match="CUDA error"):  # radius 16: more taps than the kernel takes
        image.gaussian_blur(torch.zeros((16, 16), device=dev), 5.3)


def test_system_runs_on_the_card_by_default(dev):
    """No device argument: System, its tracker, mapper and database are on
    the card, and a frame goes through the kernels."""
    from tpuslam_torch.system import System

    _, frames = stereo_scene(2)
    s = System(QVGA, loop_closing=False)
    assert s.tracker.device.type == s.mapper.device.type == s.kf_db.device.type == "cuda"
    before = lsd.LAUNCHES["ccl"]
    for f, (il, ir) in enumerate(frames):
        s.track_stereo(il, ir, 0.05 * f)
    assert lsd.LAUNCHES["ccl"] > before
    assert all(r.state.name == "OK" for r in s.trajectory)


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


VGA = QVGA._replace(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480)


def _mapping_system(device, frames, cam=QVGA, tracker_cfg=None):
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.kernels.lsd import LSDParams
    from tpuslam_torch.system import System

    cfg = tracker_cfg or TrackerConfig(frontend=FrontendParams(max_lines=128, lsd=LSDParams(ccl_rounds=32)), max_frames_between_kf=3)
    s = System(cam, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=cfg, device=device)
    for f, (il, ir) in enumerate(frames):
        s.track_stereo(il, ir, 0.05 * f)
    return s


def test_local_ba_on_card_is_deterministic_and_matches_cpu(dev):
    """A local-BA window of a mapped QVGA run, solved twice on the card: bit
    for bit the same (the solve's sums are fixed-order matmuls, not atomics);
    and within float32 LM agreement of the CPU solve."""
    from tpuslam_torch.backend.lm import run_lm
    from tpuslam_torch.backend.local_ba import assemble_problem

    _, frames = stereo_scene(8)
    s = _mapping_system("cpu", frames)
    cfg = s.mapper.cfg.ba
    center = max(s.map.keyframes)
    gprob, _ = assemble_problem(s.map, center, QVGA, cfg, device=dev)
    a = run_lm(gprob, QVGA, cfg.lm)
    b = run_lm(gprob, QVGA, cfg.lm)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    cprob, _ = assemble_problem(s.map, center, QVGA, cfg, device="cpu")
    c = run_lm(cprob, QVGA, cfg.lm)
    torch.testing.assert_close(a.poses.cpu(), c.poses, rtol=0, atol=1e-3)
    torch.testing.assert_close(a.cost.cpu(), c.cost, rtol=1e-2, atol=0)


def test_mapping_slice_on_card_tracks_like_cpu(dev):
    """System(mapping=True) over 12 VGA frames (default tracker, a keyframe
    at least every 4 frames) on the card and on the CPU: every frame OK,
    keyframe counts within one, a local BA at every keyframe event after the
    first, ATE within 1 cm of each other and under 2 cm, camera centres
    within 5 cm. Kernels and plain versions differ in float rounding (and
    the detector's moment sums use atomics on the card), which the
    detector's thresholds can turn into slightly different segments; with
    mapping those reach the keyframe decisions, the landmarks and the BA."""
    from tpuslam_torch.eval.ate import absolute_trajectory_error
    from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState

    scene, frames = stereo_scene(12, cam=VGA)
    runs = [_mapping_system(d, frames, VGA, TrackerConfig(max_frames_between_kf=4)) for d in ("cpu", dev)]
    centres = [np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in s.trajectory]) for s in runs]
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in scene.poses])
    ates = [absolute_trajectory_error(c, gt).rmse for c in centres]
    assert all(r.state == TrackingState.OK for s in runs for r in s.trajectory)
    assert max(ates) < 0.02 and abs(ates[0] - ates[1]) < 0.01, ates
    assert np.linalg.norm(centres[0] - centres[1], axis=1).max() < 0.05
    n_events = [sum(r.made_keyframe for r in s.trajectory) for s in runs]
    assert abs(n_events[0] - n_events[1]) <= 1
    assert [sum(map(len, s.mapper.solve_ms_by_rung.values())) for s in runs] == [n - 1 for n in n_events]


def test_relocalization_pieces_on_card_match_cpu(dev):
    """The keyframe database's integer scores on the card equal the CPU's,
    and DLT-Lines (eigh, det, SVD through cuSOLVER) recovers the same pose."""
    from tpuslam_torch.backend.dlt import dlt_lines_pose, image_line_coeffs
    from tpuslam_torch.backend.loop_closing import KeyFrameDatabase
    from tpuslam_torch.geometry.se3 import se3_exp

    rs = np.random.RandomState(0)
    base = rs.randint(0, 2**32, size=(256, 8), dtype=np.uint64).astype(np.uint32)
    dbs = [KeyFrameDatabase(device=d) for d in ("cpu", dev)]
    for kid in range(12):
        flip = rs.rand(256, 8, 32) < rs.uniform(0.02, 0.4)
        bits = base ^ np.packbits(flip, axis=-1, bitorder="little").view(np.uint32)[..., 0]
        kf = type("KF", (), dict(kid=kid, features=type("F", (), dict(desc_bits=bits, valid=(rs.rand(256) < 0.9).astype(np.float32)))()))()
        for db in dbs:
            db.add(kf)
    q = (base, np.ones(256, np.float32))
    assert dbs[0].query_bits(*q) == dbs[1].query_bits(*q)

    T = se3_exp(torch.from_numpy((rs.randn(6) * [0.5, 0.5, 0.5, 0.2, 0.2, 0.2]).astype(np.float32)))
    p = rs.randn(40, 3) * 2 + [0, 0, 8.0]
    Xw = torch.from_numpy(np.stack([p, p + rs.randn(40, 3)], axis=1).astype(np.float32))
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    uv = torch.stack([VGA.fx * Xc[..., 0] / Xc[..., 2] + VGA.cx, VGA.fy * Xc[..., 1] / Xc[..., 2] + VGA.cy], -1)
    l2d, w = image_line_coeffs(uv), torch.ones(40)
    (Tc, okc), (Tg, okg) = (dlt_lines_pose(l2d.to(d), Xw.to(d), w.to(d), VGA) for d in ("cpu", dev))
    assert float(okc) == float(okg) == 1.0
    torch.testing.assert_close(Tg.cpu(), Tc, rtol=0, atol=1e-3)  # float32 12x12 eigensolve
    torch.testing.assert_close(Tc, T, rtol=0, atol=5e-3)
