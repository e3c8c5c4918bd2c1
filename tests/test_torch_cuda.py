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

from torch_parity import QVGA, dot_scene, image01, python_graph, stereo_scene
from tpuslam_torch.kernels import cuda_lib, image, lsd

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _in_process_ba(monkeypatch):
    """These tests hold the synchronous path (local and global BA in this
    process, as their CPU references run it); the solver process is held by
    tests/test_torch_ba_worker.py and chip_smoke.py's phase 23."""
    monkeypatch.setenv("TPUSLAM_BA_SUBPROCESS", "0")

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


def _bright_border(shape, dev, seed=0):
    """A random image whose border rows and columns are random 0s and 1s:
    strong gradients and compat bits next to the border."""
    x = _image(shape, dev, seed).clone()
    g = torch.Generator().manual_seed(seed + 1)
    edge = (torch.rand(shape, generator=g) > 0.5).float().to(dev)
    for sl in ((0, slice(None)), (-1, slice(None)), (slice(None), 0), (slice(None), -1)):
        x[sl] = edge[sl]
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.75, 0.9375, 5.0])  # radius 3, 3, 15
def test_blur_kernel_matches_plain(dev, shape, sigma):
    x = _image(shape, dev)
    out = image.gaussian_blur(x, sigma)
    ref = image.gaussian_blur_torch(x, sigma)
    torch.cuda.synchronize()
    # same float32 taps, tap-order sums against cuDNN's order, values in [0, 1]
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(480, 640), (240, 320)])
def test_blur_kernel_matches_plain_at_brief_sigma(dev, shape):
    """BRIEF's smoothing (sigma 2, radius 6) on a frame times 255, as
    fast.detect_corners calls it: within the [0, 1] tolerance scaled to
    0..255, and bit for bit the two-pass form."""
    from tpuslam_torch.kernels.fast import FASTParams

    x = _image(shape, dev, seed=7) * 255.0
    sigma = FASTParams().blur_sigma
    assert image._blur_taps(sigma).numel() == 13
    out = image.gaussian_blur(x, sigma)
    torch.testing.assert_close(out, image.gaussian_blur_torch(x, sigma), rtol=0, atol=255e-5)
    assert torch.equal(out, image._blur_two_pass_cuda(x, sigma))


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


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_xy_kernel_bit_equal_to_two_launch_chain(dev, shape):
    """Each sample scaled before differencing: bit for bit `img * 255` then
    the four-plane gradients kernel, and the plain version."""
    x = _image(shape, dev, seed=6)
    gx, gy = image.gradients_xy(x, 255.0)
    chain = image._gradients_cuda(x * 255.0)
    plain = image.gradients_xy_torch(x, 255.0)
    assert torch.equal(gx, chain[0]) and torch.equal(gy, chain[1])
    assert torch.equal(gx, plain[0]) and torch.equal(gy, plain[1])


FRONT_IMAGES = [(shape, "random") for shape in SHAPES] + [((65, 97), "bright border"), ((480, 640), "bright border"), ((240, 320), "rendered")]


def _front_image(shape, kind, dev):
    if kind == "rendered":
        _, frames = stereo_scene(2)
        return torch.from_numpy(image01(frames[1][0])).to(dev)
    return _bright_border(shape, dev, seed=5) if kind == "bright border" else _image(shape, dev, seed=4)


@pytest.mark.parametrize("shape,kind", FRONT_IMAGES)
def test_front_kernel_bit_equal_to_chain(dev, shape, kind):
    """One launch of the fused front against the chain it replaces (blur
    kernel, `* 255`, gradients kernel, eager compat loop) on the card: every
    plane bit for bit."""
    x = _front_image(shape, kind, dev)
    params = lsd.LSDParams()
    got = lsd.ccl_inputs(x, params)
    ref = lsd._ccl_inputs_chain_cuda(x, params)
    assert [t.dtype for t in got] == [torch.float32, torch.bool, torch.int32, torch.int32, torch.int32]
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((got[4] != 0).sum()) > 20


@pytest.mark.parametrize("shape,kind", FRONT_IMAGES)
def test_front_kernel_matches_plain(dev, shape, kind):
    """Against the plain version on the card, whose blur is cuDNN's: mag
    within 1e-3 on the 0..255 scale; the integer planes differ only where a
    threshold decides by less than 1e-3 (lsd.front_disagreements)."""
    x = _front_image(shape, kind, dev)
    params = lsd.LSDParams()
    got = lsd.ccl_inputs(x, params)
    plain = lsd.ccl_inputs_torch(x, params)
    gx, gy, _, _ = image.image_gradients_torch(image.gaussian_blur_torch(x, params.prefilter_sigma) * 255.0)
    err, _, n_other = lsd.front_disagreements(got, plain, gx, gy, params)
    assert err <= 1e-3 and n_other == 0


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
    _, _, lab0, mx0, cb = lsd.ccl_inputs(x, lsd.LSDParams())
    out = lsd.ccl_propagate(lab0, mx0, cb, 64)
    ref = lsd._ccl_torch(lab0, mx0, cb, 64)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_launch_counts(dev):
    x = _image((64, 96), dev)
    before = [dict(d) for d in (image.LAUNCHES, lsd.LAUNCHES, image.KERNEL_LAUNCHES, lsd.KERNEL_LAUNCHES)]
    image.gaussian_blur(x, 0.75)
    image.image_gradients(x)
    image.gradients_xy(x, 255.0)  # both gradient forms count under "gradients"
    lsd.ccl_inputs(x)
    image.gaussian_blur_torch(x, 0.75)  # plain versions count nothing
    image.image_gradients_torch(x)
    image.gradients_xy_torch(x, 255.0)
    lsd.ccl_inputs_torch(x)
    image._blur_two_pass_cuda(x, 0.75)  # nor do the baseline forms
    lsd._ccl_inputs_chain_cuda(x)
    i = torch.zeros((64, 96), dtype=torch.int32, device=dev)
    lsd.ccl_propagate(i, i, i, 64)  # one call of ceil(64 / k) launches counts once
    lsd._ccl_per_round_cuda(i, i, i, 5)
    lsd.ccl_propagate(i, i, i, 0)  # a copy, no launch
    lsd.segment_moments(x[:7].contiguous(), torch.zeros(96, dtype=torch.int32, device=dev), 5)
    lsd.segment_moments_torch(x[:7].cpu(), torch.zeros(96, dtype=torch.int32), 5)
    lsd._moments_two_launch_cuda(x[:7].contiguous(), torch.zeros(96, dtype=torch.int32, device=dev), 5)  # the replaced form
    planes = (i, x, x > 0.5, torch.arange(4, dtype=torch.int64, device=dev))
    lsd.component_moments(*planes)
    lsd._component_moments_replaced_cuda(*planes)
    z4 = torch.zeros(4, device=dev)
    lsd.component_extents(*planes, z4, z4, torch.zeros((4, 2), device=dev))
    assert image.LAUNCHES["blur"] == before[0]["blur"] + 1
    assert image.LAUNCHES["gradients"] == before[0]["gradients"] + 2
    assert lsd.LAUNCHES["lsd_front"] == before[1]["lsd_front"] + 1
    assert lsd.LAUNCHES["ccl"] == before[1]["ccl"] + 2
    # launches per call: 1 for blur, gradients and the front, ceil(64 / k) for CCL
    assert image.KERNEL_LAUNCHES["blur"] == before[2]["blur"] + 1
    assert image.KERNEL_LAUNCHES["gradients"] == before[2]["gradients"] + 2
    assert lsd.KERNEL_LAUNCHES["lsd_front"] == before[3]["lsd_front"] + 1
    assert lsd.KERNEL_LAUNCHES["ccl"] == before[3]["ccl"] + -(-64 // K)
    for name in lsd.SUMS:  # one call, one launch each
        assert lsd.LAUNCHES[name] == before[1][name] + 1
        assert lsd.KERNEL_LAUNCHES[name] == before[3][name] + 1


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
    with pytest.raises(ValueError):
        image.gradients_xy(torch.zeros((16, 32), device=dev)[:, ::2], 255.0)  # not contiguous


def test_front_wrapper_refuses_what_the_kernel_does_not_take(dev):
    z = torch.zeros((16, 16), device=dev)
    with pytest.raises(ValueError):
        lsd.ccl_inputs(torch.zeros((16, 32), device=dev)[:, ::2])  # not contiguous
    with pytest.raises(TypeError):
        lsd.ccl_inputs(z.double())
    for sigma in (5.3, 0.0):  # radius 16; no prefilter
        with pytest.raises(ValueError, match="prefilter"):
            lsd.ccl_inputs(z, lsd.LSDParams(prefilter_sigma=sigma))
    with pytest.raises(ValueError, match="rho"):  # the mag-0 border in the support
        lsd.ccl_inputs(z, lsd.LSDParams(quant=-1.0))
    # the C function takes only the built tile and the halo of the taps' radius
    taps = image._blur_taps(0.75).numpy()
    p, n = z.data_ptr(), ctypes.c_int(0)
    for tile, halo in ((16, 5), (32, 4), (32, 6)):
        code = cuda_lib.library().tpuslam_lsd_front(
            p, p, p, p, p, p, 16, 16, taps.ctypes.data, taps.size, 5.0, 0.9, tile, halo, ctypes.byref(n), cuda_lib.stream_of(z)
        )
        assert code != 0 and n.value == 0


def test_system_runs_on_the_card_by_default(dev):
    """No device argument: System, its tracker, mapper and database are on
    the card, and a frame goes through the kernels."""
    from tpuslam_torch.system import System

    _, frames = stereo_scene(2)
    s = System(QVGA, loop_closing=False)
    assert s.tracker.device.type == s.mapper.device.type == s.kf_db.device.type == "cuda"
    before = {**image.LAUNCHES, **lsd.LAUNCHES}
    for f, (il, ir) in enumerate(frames):
        s.track_stereo(il, ir, 0.05 * f)
    # per stereo frame: the pyramid's blur per camera; per camera and level
    # the LBD gradients, the detector's front, its propagation and three
    # sums (the components' moments and extents, the merge's sums)
    after = {**image.LAUNCHES, **lsd.LAUNCHES}
    assert {k: after[k] - before[k] for k in after if not k.endswith("_batch")} == {
        "blur": 2 * 2, "gradients": 4 * 2, "lsd_front": 4 * 2, "ccl": 4 * 2,
        "component_moments": 4 * 2, "component_extents": 4 * 2, "segment_moments": 4 * 2,
    }
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


# The JAX package's ATE on the 12 frames of the next test (tpuslam.system.System
# with the same settings, XLA:CPU, cv2 hidden, TPUSLAM_KF_DEFER_MS=0,
# TPUSLAM_NATIVE_MAP=0; keyframes at frames 0, 4, 6, 10): `python
# tests/test_torch_slam.py` prints it
JAX_VGA12_MAPPING_ATE_M = 0.024150047360940955


def test_mapping_slice_on_card_tracks_like_cpu(dev):
    """System(mapping=True) over 12 VGA frames (default tracker, a keyframe
    at least every 4 frames) on the card and on the CPU: every frame OK,
    keyframe counts within one, a local BA at every keyframe event after the
    first, ATE within 1 cm of each other and each within 1 mm of the JAX
    package's on the same frames, camera centres within 5 cm. (The ATE was
    held under 2 cm while the stereo pose LM weighed each observation, 6.4
    mm on the CPU; with the JAX package's IRLS formula, fault 3.2 of
    ROADMAP.md, the port gives the JAX package's 2.4 cm: 0.024039 m on the
    CPU, 0.024090 m on the card, the JAX package 0.024150 m.) Kernels and plain versions differ in float rounding (and
    the detector's moment sums use atomics on the card), which the
    detector's thresholds can turn into slightly different segments; with
    mapping those reach the keyframe decisions, the landmarks and the BA."""
    from tpuslam_torch.eval.ate import absolute_trajectory_error
    from tpuslam_torch.frontend.tracking import TrackerConfig, TrackingState

    scene, frames = stereo_scene(12, cam=VGA)
    with python_graph():  # the JAX reference was taken with the python graph
        runs = [_mapping_system(d, frames, VGA, TrackerConfig(max_frames_between_kf=4)) for d in ("cpu", dev)]
    centres = [np.stack([np.linalg.inv(r.T_cw)[:3, 3] for r in s.trajectory]) for s in runs]
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in scene.poses])
    ates = [absolute_trajectory_error(c, gt).rmse for c in centres]
    assert all(r.state == TrackingState.OK for s in runs for r in s.trajectory)
    assert all(abs(a - JAX_VGA12_MAPPING_ATE_M) <= 1e-3 for a in ates) and abs(ates[0] - ates[1]) < 0.01, ates
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


# kernel calls of one left-image feature extraction at half resolution (the
# bench path's anchors and its synchronous frames): the pyramid's blur; per
# level the LBD gradients, the detector's front and its propagation
PER_EXTRACTION = {"blur": 1, "gradients": 2, "lsd_front": 2, "ccl": 2, "component_moments": 2, "component_extents": 2, "segment_moments": 2}


def test_bench_path_on_card(dev):
    """System with the bench configuration (semi-direct chunks of 6 on
    host-halved VGA frames, mapping on) over 14 frames on the card: one
    result per frame in order, every frame OK, keyframes from anchors (or the
    initialization) only, and the hand kernels called once per extraction's
    worth for each anchor and each synchronous extraction."""
    from tpuslam_torch.system import System, bench_configs

    _, frames = stereo_scene(14, cam=VGA)
    tcfg, mcfg = bench_configs()
    s = System(VGA, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device=dev)
    before = {**image.LAUNCHES, **lsd.LAUNCHES}
    for f, (il, ir) in enumerate(frames):
        s.track_stereo(il, ir, 0.05 * f)
    s.shutdown()
    after = {**image.LAUNCHES, **lsd.LAUNCHES}
    tr = s.tracker
    assert [r.frame_idx for r in s.trajectory] == list(range(14))
    assert all(r.state.name == "OK" for r in s.trajectory)
    assert tr.anchor_frames == [1, 7, 13] and tr.sync_frames == [0]
    assert {r.frame_idx for r in s.trajectory if r.made_keyframe} <= {0, 1, 7, 13}
    n = len(tr.anchor_frames) + len(tr.flush_frames) + tr.n_sync_extractions
    assert {k: after[k] - before[k] for k in after if not k.endswith("_batch")} == {k: v * n for k, v in PER_EXTRACTION.items()}


def test_chunk_on_card_matches_cpu(dev):
    """One semi-direct chunk (C = 4, host-halved VGA frames) on identical
    inputs on the card and on the CPU: the same accept flags, every pose
    within 1e-3."""
    from tpuslam_torch.frontend.frame import host_prescale
    from tpuslam_torch.frontend.pipeline import fused_stereo_semidirect
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap
    from tpuslam_torch.system import bench_configs

    _, frames = stereo_scene(5, cam=VGA)
    tcfg, _ = bench_configs(chunk=4)
    tr = Tracker(VGA, SlamMap(), tcfg, device="cpu")
    tr.track_stereo(*frames[0], 0.0)  # initialization: the local map
    local = tr._local_map_arrays()
    half = [[host_prescale(x, tcfg.frontend) for x in pair] for pair in frames[1:]]
    stack = torch.from_numpy(np.stack([half[0][0], half[0][1]] + [p[0] for p in half[1:]]))
    T = torch.eye(4)
    packed = []
    for d in ("cpu", dev):
        out = fused_stereo_semidirect(
            stack.to(d), T.to(d), T.to(d), {k: v.to(d) for k, v in local.items()}, tr._fxb, VGA, tcfg.frontend,
            tcfg.search_coarse, tcfg.search_fine, tcfg.pose_opt, tcfg.min_track_inliers, tr._direct_lines(), tr._align_params(),
        )
        packed.append(out.packed.cpu().numpy())
    c, g = packed
    np.testing.assert_array_equal(g[:, 19], c[:, 19])
    assert np.all(c[:, 19] == 1.0)
    np.testing.assert_allclose(g[:, :16], c[:, :16], rtol=0, atol=1e-3)


# ---- fixed-order moment sums ------------------------------------------------

# the detector's sums at the bench's two levels and the slice's first: N
# pixels, 7 columns, K + 1 = 257 slots (most pixels in the dump slot K)
MOMENT_SHAPES = [(480 * 640, 7, 257), (240 * 320, 7, 257), (192 * 256, 7, 257), (240 * 320, 1, 257), (256, 7, 256)]


def _moment_inputs(N, V, S, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    slot = torch.randint(0, S, (N,), generator=g, dtype=torch.int32)
    slot[: N // 2] = S - 1
    vals = (torch.randn((V, N), generator=g) * 100.0).contiguous()
    return vals.to(dev), slot.to(dev)


@pytest.mark.parametrize("N, V, S", MOMENT_SHAPES)
def test_moments_kernel_matches_plain_and_repeats(dev, N, V, S):
    """segment_moments' one-block kernel against the plain version
    (index_add_ in item order on the CPU) within 1e-5 relative of the
    column's absolute sum, and bit for bit equal over two calls."""
    vals, slot = _moment_inputs(N, V, S, dev)
    a = lsd.segment_moments(vals, slot, S)
    b = lsd.segment_moments(vals, slot, S)
    ref = lsd.segment_moments_torch(vals.cpu(), slot.cpu(), S)
    assert torch.equal(a, b)
    scale = lsd.segment_moments_torch(vals.abs().cpu(), slot.cpu(), S)
    assert float(((a.cpu() - ref).abs() / (scale + 1e-6)).max()) <= 1e-5


@pytest.mark.parametrize("N, V, S", MOMENT_SHAPES)
def test_moments_kernel_writes_through_both_launches(dev, N, V, S):
    """The replaced two-launch form: scratch and output filled with NaN
    before a call of the C function, the result equals its wrapper's, so
    the block launch wrote every partial the combine reads and the combine
    wrote every sum."""
    vals, slot = _moment_inputs(N, V, S, dev, seed=1)
    ref = lsd._moments_two_launch_cuda(vals, slot, S)
    partial = torch.full((lsd.MOMENTS_BLOCKS, V, S), float("nan"), device=dev)
    out = torch.full((V, S), float("nan"), device=dev)
    n = ctypes.c_int(0)
    code = cuda_lib.library().tpuslam_moments(
        vals.data_ptr(), slot.data_ptr(), partial.data_ptr(), out.data_ptr(), N, V, S, ctypes.byref(n), cuda_lib.stream_of(vals)
    )
    assert code == 0 and n.value == 2
    assert torch.equal(out, ref)


def test_moments_wrapper_refuses_what_the_kernel_does_not_take(dev):
    vals, slot = _moment_inputs(1000, 7, 257, dev)
    with pytest.raises(ValueError):
        lsd.segment_moments(vals, slot.long(), 257)  # int64 slots
    with pytest.raises(ValueError):
        lsd.segment_moments(vals, slot[:999], 257)
    # the one-block kernel refuses more than 8 columns; the replaced form
    # also slots whose warp block (V, S + 33) floats does not fit 48 KB of
    # shared memory
    with pytest.raises(RuntimeError, match="CUDA error"):
        lsd.segment_moments(torch.zeros((9, 1000), device=dev), slot, 257)
    for V, S in ((9, 257), (7, 2000)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            lsd._moments_two_launch_cuda(torch.zeros((V, 1000), device=dev), slot, S)


# ---- the detector's component statistics -------------------------------------

SUM_SHAPES = [(480, 640), (240, 320), (192, 256)]  # the slice's first level, the bench path's two


def _level_image(shape, dev):
    """A rendered VGA left frame at 480x640, halved to 240x320, and that
    image's pyramid level 1 (192x256), as chip_smoke's kernel phase."""
    _, frames = stereo_scene(1, VGA)
    img = torch.from_numpy(image01(frames[0][0])).to(dev)
    if shape == (480, 640):
        return img
    half = image.resize_linear(img, (240, 320)).contiguous()
    return half if shape == (240, 320) else image.build_pyramid(half, 2, 0.8)[1].contiguous()


def _detector_sum_inputs(shape, dev):
    """{entry: args} of the three sums one detect_lines call makes."""
    seen = {}
    real = {name: getattr(lsd, name) for name in lsd.SUMS}

    def grab(name):
        def call(*args):
            seen[name] = args
            return real[name](*args)

        return call

    for name in lsd.SUMS:
        setattr(lsd, name, grab(name))
    try:
        lsd.detect_lines(_level_image(shape, dev), 256)
    finally:
        for name in lsd.SUMS:
            setattr(lsd, name, real[name])
    assert set(seen) == set(lsd.SUMS)
    return seen


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", SUM_SHAPES)
def test_component_kernels_match_plain_and_repeat(dev, shape):
    """The three sum kernels on the detector's own inputs against their
    plain versions: the moments and sn2 within 1e-5 relative (sums of terms
    >= 0), t_min and t_max bit for bit (signed zeros included), the merge's
    one-block sums bit for bit (both add in item order); two calls
    bit-equal; one launch per call by the wrappers' counts."""
    inputs = _detector_sum_inputs(shape, dev)
    plain = {"component_moments": lsd.component_moments_torch, "component_extents": lsd.component_extents_torch,
             "segment_moments": lsd.segment_moments_torch}
    for name, args in inputs.items():
        before = lsd.KERNEL_LAUNCHES[name]
        a = getattr(lsd, name)(*args)
        b = getattr(lsd, name)(*args)
        assert lsd.KERNEL_LAUNCHES[name] == before + 2
        assert torch.equal(_bits(a), _bits(b)), name
        ref = plain[name](*(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
        got = a.cpu()
        if name == "segment_moments":
            assert torch.equal(_bits(got), _bits(ref))
        elif name == "component_moments":
            assert float(((got - ref).abs() / ref.clamp(min=1e-30)).max()) <= 1e-5
            assert float(ref[0].sum()) > 100
        else:
            assert torch.equal(_bits(got[:2]), _bits(ref[:2]))
            assert float(((got[2] - ref[2]).abs() / ref[2].clamp(min=1e-30)).max()) <= 1e-5


@pytest.mark.parametrize("shape", SUM_SHAPES)
def test_component_kernels_follow_the_modelled_order(dev, shape):
    """The component kernels bit for bit equal to tests/torch_sum_model.py,
    the numpy model of their order (the partition from N, a tree over each
    step's members, then steps, warps and blocks in order; extremes by
    (order bits, item index) keys) on the detector's own inputs."""
    from torch_sum_model import member_slot, model_extremes, model_sums

    inputs = _detector_sum_inputs(shape, dev)
    labels, mag, support, roots = (x.cpu().numpy() for x in inputs["component_moments"])
    cx, cy, ev = (x.cpu().numpy() for x in inputs["component_extents"][4:])
    H, W = labels.shape
    N, K = labels.size, roots.size
    slot = member_slot(labels, roots)
    xs = (np.arange(N) % W).astype(np.float32)
    ys = (np.arange(N) // W).astype(np.float32)
    sup = support.reshape(-1)
    w = np.where(sup, mag.reshape(-1), np.float32(0))
    wx, wy = w * xs, w * ys
    cols = np.stack([sup.astype(np.float32), w, wx, wy, wx * xs, wy * ys, wx * ys])
    got = lsd.component_moments(*inputs["component_moments"]).cpu().numpy()
    assert np.array_equal(got.view(np.int32), model_sums(slot, cols, K).view(np.int32))
    k = np.maximum(slot, 0)
    relx, rely = xs - cx[k], ys - cy[k]
    t = relx * ev[k, 0] + rely * ev[k, 1]
    tn = -relx * ev[k, 1] + rely * ev[k, 0]
    ext = lsd.component_extents(*inputs["component_extents"]).cpu().numpy()
    t_min, t_max = model_extremes(slot, t, K)
    assert np.array_equal(ext[0].view(np.int32), t_min.view(np.int32))
    assert np.array_equal(ext[1].view(np.int32), t_max.view(np.int32))
    assert np.array_equal(ext[2].view(np.int32), model_sums(slot, (w * tn * tn)[None], K)[0].view(np.int32))


def _component_call(name, args, partial, keys, out):
    """One call of a component kernel's C function on the given scratch;
    returns (code, launches)."""
    labels = args[0]
    H, W = labels.shape
    K = args[3].numel()
    blocks, ipw = lsd.sum_partition(labels.numel())
    ptrs = [x.data_ptr() for x in args]
    counter = lsd._ticket_counters(labels.device).data_ptr()
    n = ctypes.c_int(0)
    lib = cuda_lib.library()
    if name == "component_moments":
        code = lib.tpuslam_component_moments(*ptrs, partial.data_ptr(), counter, out.data_ptr(), H, W, K,
                                            blocks, ipw, ctypes.byref(n), cuda_lib.stream_of(labels))
    else:
        code = lib.tpuslam_component_extents(*ptrs, partial.data_ptr(), keys.data_ptr(), counter,
                                            out.data_ptr(), H, W, K, blocks, ipw, ctypes.byref(n), cuda_lib.stream_of(labels))
    return code, n.value


@pytest.mark.parametrize("shape", SUM_SHAPES)
def test_component_kernels_write_through_poisoned_scratch(dev, shape):
    """Partial rows and output filled with NaN (the keys with all bits set)
    before each of three calls in a row of the C functions: each result
    equals the wrapper's, so every block wrote what the last block reads and
    the last block wrote every output; every ticket counter is back at 0 for
    the next call."""
    inputs = _detector_sum_inputs(shape, dev)
    for name, C, R in (("component_moments", 7, 7), ("component_extents", 1, 3)):
        args = inputs[name]
        ref = getattr(lsd, name)(*args)
        K = args[3].numel()
        blocks, _ = lsd.sum_partition(args[0].numel())
        rows = blocks + -(-blocks // lsd.SUM_GROUP)  # the blocks' rows, then the groups'
        for _ in range(3):
            partial = torch.full((rows, C, K), float("nan"), device=dev)
            keys = torch.full((rows, 2, K), -1, dtype=torch.int64, device=dev)
            out = torch.full((R, K), float("nan"), device=dev)
            code, n = _component_call(name, args, partial, keys, out)
            assert code == 0 and n == 1
            assert torch.equal(_bits(out), _bits(ref)), name
            assert int(lsd._ticket_counters(dev).abs().sum()) == 0


def test_component_wrappers_refuse_what_the_kernels_do_not_take(dev):
    inputs = _detector_sum_inputs((240, 320), dev)
    labels, mag, support, roots = inputs["component_moments"]
    cx, cy, ev = inputs["component_extents"][4:]
    with pytest.raises(ValueError):
        lsd.component_moments(labels, mag, support, roots.to(torch.int32))  # int32 roots
    with pytest.raises(TypeError):
        lsd.component_moments(labels, mag.double(), support, roots)
    with pytest.raises(TypeError):
        lsd.component_moments(labels, mag, support.to(torch.uint8), roots)
    with pytest.raises(ValueError):
        lsd.component_moments(labels[:, :160].contiguous(), mag, support, roots)  # planes differ in shape
    with pytest.raises(ValueError):
        lsd.component_extents(labels, mag, support, roots, cx, cy, ev.t().contiguous())  # ev (2, K)
    with pytest.raises(ValueError):
        lsd.component_extents(labels, mag, support, roots, cx[:-1].contiguous(), cy, ev)
    # the C functions refuse more than 1024 roots, and a partition that does
    # not cover the plane in whole steps
    big = torch.arange(1100, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        lsd.component_moments(labels, mag, support, big)
    K = roots.numel()
    blocks, ipw = lsd.sum_partition(labels.numel())
    partial = torch.empty((blocks + 1 + blocks // lsd.SUM_GROUP, 7, K), device=dev)
    out = torch.empty((7, K), device=dev)
    counter = lsd._ticket_counters(dev).data_ptr()
    for b, w in ((blocks - 1, ipw), (blocks, ipw - 32), (blocks + 1, ipw), (blocks, ipw + 16)):
        n = ctypes.c_int(0)
        code = cuda_lib.library().tpuslam_component_moments(
            labels.data_ptr(), mag.data_ptr(), support.data_ptr(), roots.data_ptr(), partial.data_ptr(), counter,
            out.data_ptr(), 240, 320, K, b, w, ctypes.byref(n), cuda_lib.stream_of(labels),
        )
        assert code != 0 and n.value == 0, (b, w)


@pytest.mark.parametrize("shape", [(240, 320), (480, 640)])
def test_detect_lines_bit_equal_across_runs(dev, shape):
    """The detector run twice on one image gives bit-equal segments: its
    float sums add in a fixed order on the card."""
    cam = QVGA if shape == (240, 320) else VGA
    _, frames = stereo_scene(1, cam)
    img = torch.from_numpy(image01(frames[0][0])).to(dev)
    a, b = lsd.detect_lines(img, 256), lsd.detect_lines(img, 256)
    assert float(a.valid.sum()) > 20
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_mapping_run_repeats_on_card(dev):
    """The 8-frame QVGA mapping run three times on the card: the same
    keyframes and bit-equal trajectories (so the same ATE)."""
    _, frames = stereo_scene(8)
    runs = [_mapping_system(dev, frames) for _ in range(3)]
    kfs = [[r.frame_idx for r in s.trajectory if r.made_keyframe] for s in runs]
    assert kfs[0] == kfs[1] == kfs[2], kfs
    poses = [np.stack([r.T_cw for r in s.trajectory]) for s in runs]
    assert np.array_equal(poses[0], poses[1]) and np.array_equal(poses[0], poses[2])


def test_hybrid_chunk_on_card_matches_cpu(dev):
    """One hybrid semi-direct chunk (C = 6, host-halved VGA dot frames) on
    identical inputs on the card and on the CPU: the same accept flags,
    every pose within 1e-3, the corner counts equal."""
    from tpuslam_torch.frontend.frame import host_prescale
    from tpuslam_torch.frontend.pipeline import fused_stereo_semidirect_hybrid
    from tpuslam_torch.frontend.tracking import Tracker
    from tpuslam_torch.slammap.map import SlamMap
    from tpuslam_torch.system import bench_configs

    _, frames = dot_scene(7, VGA, seed=1, n_segments=140, n_points=200, motion_scale=0.02)
    tcfg, _ = bench_configs(points=True)
    tr = Tracker(VGA, SlamMap(), tcfg, device="cpu")
    tr.track_stereo(*frames[0], 0.0)  # initialization: the local line and point maps
    local, plocal = tr._local_map_arrays(), tr._point_local_arrays()
    half = [[host_prescale(x, tcfg.frontend) for x in pair] for pair in frames[1:]]
    stack = torch.from_numpy(np.stack([half[0][0], half[0][1]] + [p[0] for p in half[1:]]))
    T = torch.from_numpy(tr.T_cw)
    outs = []
    for d in ("cpu", dev):
        out = fused_stereo_semidirect_hybrid(
            stack.to(d), T.to(d), T.to(d), {k: v.to(d) for k, v in local.items()}, {k: v.to(d) for k, v in plocal.items()},
            tr._fxb, VGA, tcfg.frontend, tcfg.search_coarse, tcfg.search_fine, tcfg.pose_opt, tcfg.min_track_inliers,
            tr._direct_lines(), tr._direct_points(), tcfg.points, tr._align_params(),
        )
        outs.append(out)
    c, g = (o.packed.cpu().numpy() for o in outs)
    np.testing.assert_array_equal(g[:, 19], c[:, 19])
    assert np.all(c[:, 19] == 1.0)
    np.testing.assert_allclose(g[:, :16], c[:, :16], rtol=0, atol=1e-3)
    assert float(outs[0].pfeats.valid.sum()) == float(outs[1].pfeats.valid.sum()) >= 100


def test_detect_corners_on_card_matches_cpu(dev):
    """FAST and BRIEF on a host-halved VGA dot frame (the bench path's
    240x320), on the card (BRIEF's blur through the hand kernel, radius 6)
    and on the CPU: the same corners within 1e-3 px and the same BRIEF
    words."""
    from tpuslam_torch.frontend.frame import host_prescale
    from tpuslam_torch.kernels.fast import detect_corners
    from tpuslam_torch.system import bench_configs

    _, frames = dot_scene(1, VGA, seed=1, n_segments=140, n_points=200, motion_scale=0.02)
    tcfg, _ = bench_configs(points=True)
    img = torch.from_numpy(image01(host_prescale(frames[0][0], tcfg.frontend)))
    assert tuple(img.shape) == (240, 320)
    before = image.LAUNCHES["blur"]
    g = detect_corners(img.to(dev), tcfg.points.max_points, tcfg.points.fast)
    assert image.LAUNCHES["blur"] == before + 1
    c = detect_corners(img, tcfg.points.max_points, tcfg.points.fast)
    gv, cv = g.valid.cpu() > 0.5, c.valid > 0.5
    assert int(gv.sum()) == int(cv.sum()) >= 100
    d = torch.cdist(g.uv.cpu()[gv], c.uv[cv], compute_mode="donot_use_mm_for_euclid_dist")
    j = d.argmin(dim=1)
    assert float(d[torch.arange(len(j)), j].max()) <= 1e-3
    assert torch.equal(g.desc_bits.cpu()[gv], c.desc_bits[cv][j])


def test_hybrid_bench_path_on_card(dev):
    """System with bench_configs(points=True) over 13 VGA dot frames on the
    card: one result per frame in order, every frame OK, live point
    landmarks seen from two keyframes or more, and per extraction two blur
    calls (the pyramid's and BRIEF's) beside the line kernels' counts."""
    from tpuslam_torch.system import System, bench_configs

    _, frames = dot_scene(13, VGA, seed=1, n_segments=140, n_points=200, motion_scale=0.02)
    tcfg, mcfg = bench_configs(points=True)
    s = System(VGA, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device=dev)
    before = {**image.LAUNCHES, **lsd.LAUNCHES}
    for f, (il, ir) in enumerate(frames):
        s.track_stereo(il, ir, 0.05 * f)
    s.shutdown()
    after = {**image.LAUNCHES, **lsd.LAUNCHES}
    tr = s.tracker
    assert [r.frame_idx for r in s.trajectory] == list(range(13)) and all(r.state.name == "OK" for r in s.trajectory)
    n = len(tr.anchor_frames) + len(tr.flush_frames) + tr.n_sync_extractions
    want = {k: v * n for k, v in PER_EXTRACTION.items()}
    want["blur"] = 2 * n
    assert {k: after[k] - before[k] for k in after if not k.endswith("_batch")} == want
    assert (s.map_points()["n_obs"] >= 2).sum() >= 50


# ---- loop closing ------------------------------------------------------------


def _pose_graphs(kind, dev):
    """The drifted circle of tests/test_torch_pose_graph.py (SE(3), or Sim(3)
    with scale drift), padded as the loop closer pads it, on ``dev``."""
    from torch_loop_fixture import pose_graph_fields
    from tpuslam_torch.backend import pose_graph as tpg
    from tpuslam_torch.convert import pose_graph_problem_from, sim3_graph_problem_from

    fields, _ = pose_graph_fields(kind)
    cls, conv = (tpg.PoseGraphProblem, pose_graph_problem_from) if kind == "se3" else (tpg.Sim3GraphProblem, sim3_graph_problem_from)
    return conv(dict(zip(cls._fields, fields)), dev)


@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_pose_graph_on_card_repeats_and_matches_cpu(dev, kind):
    """Both pose graphs on the card: two solves bit for bit the same (the
    block sums are fixed-order matmuls), and within 1e-4 of the CPU solve."""
    from tpuslam_torch.backend import pose_graph as tpg

    solve = tpg.optimize_pose_graph if kind == "se3" else tpg.optimize_pose_graph_sim3
    cfg = tpg.PoseGraphConfig(max_iters=20)
    a, ca = solve(_pose_graphs(kind, dev), cfg)
    b, cb = solve(_pose_graphs(kind, dev), cfg)
    assert torch.equal(a, b) and torch.equal(ca, cb)
    c, _ = solve(_pose_graphs(kind, "cpu"), cfg)
    torch.testing.assert_close(a.cpu(), c, rtol=0, atol=1e-4)


def test_global_ba_on_card_repeats_and_matches_cpu(dev):
    """Global BA on the multi-view drifted-loop map (tests/torch_loop_fixture.py):
    two card runs write back bit-equal maps, within 1e-3 of the CPU's."""
    from torch_loop_fixture import CAM, drifted_loop
    from tpuslam_torch.backend.global_ba import global_bundle_adjustment
    from tpuslam_torch.convert import map_state

    states = []
    for device in (dev, dev, "cpu"):
        _, smap, _, _ = drifted_loop(n_kf=24, fuse=True)
        stats = global_bundle_adjustment(smap, CAM, device=device)
        assert stats.applied and stats.n_lines >= 30
        states.append(map_state(smap))
    a, b, c = states
    for x, y, z in zip(a["keyframes"], b["keyframes"], c["keyframes"]):
        np.testing.assert_array_equal(x["T_cw"], y["T_cw"])
        np.testing.assert_allclose(x["T_cw"], z["T_cw"], atol=1e-3)
    np.testing.assert_array_equal(a["lines"]["plucker"], b["lines"]["plucker"])


def test_close_on_card_matches_cpu(dev):
    """LoopCloser._close on the drifted loop (tests/torch_loop_fixture.py) on
    the card and on the CPU: the same closure, keyframe poses within 1e-3,
    landmark endpoints within 2e-3 m."""
    from torch_loop_fixture import CAM, drifted_loop
    from tpuslam_torch.backend.loop_closing import LoopCloser, LoopConfig
    from tpuslam_torch.convert import map_state

    out = []
    for device in (dev, "cpu"):
        _, smap, kids, _ = drifted_loop()
        lc = LoopCloser(smap, CAM, LoopConfig(min_kid_gap=3, min_inliers=6, ransac_inlier_m=0.5, run_global_ba=False), device=device)
        assert lc._close(smap.keyframes[kids[-1]], 0)
        out.append((map_state(smap), lc.closed_loops))
    (a, la), (c, lc_) = out
    assert la == lc_ == [(kids[-1], 0)]
    for x, z in zip(a["keyframes"], c["keyframes"]):
        assert x["loop_edges"] == z["loop_edges"]
        np.testing.assert_allclose(x["T_cw"], z["T_cw"], atol=1e-3)
    alive = c["lines"]["alive"]
    np.testing.assert_allclose(a["lines"]["endpoints"][alive], c["lines"]["endpoints"][alive], atol=2e-3)


def test_ransac_on_card_matches_cpu(dev):
    """The mono initializer's batched 8-point RANSAC (256 hypotheses) on the
    card and on the CPU with the same samples: E within 1e-5 up to sign (both
    solve in float64), the same best score and inliers."""
    from tpuslam_torch.frontend.initializer import MonoInitParams, ransac_essential

    rng = np.random.default_rng(0)
    n = 240
    X = np.c_[rng.uniform(-0.7, 0.7, n), rng.uniform(-0.7, 0.7, n), np.ones(n)] * rng.uniform(2, 8, (n, 1))
    t = np.array([-0.4, 0.05, 0.1])
    uv0 = (X[:, :2] / X[:, 2:] + rng.normal(size=(n, 2)) * 6e-4).astype(np.float32)
    X1 = X + t
    uv1 = (X1[:, :2] / X1[:, 2:] + rng.normal(size=(n, 2)) * 6e-4).astype(np.float32)
    uv1[: n // 5] += rng.normal(size=(n // 5, 2)).astype(np.float32) * 0.05  # outliers
    params = MonoInitParams(inlier_px=2.0 / 458)
    samples = torch.from_numpy(rng.integers(0, n, (params.n_hypotheses, 8)))
    out = []
    for device in (dev, "cpu"):
        a, b = torch.from_numpy(uv0).to(device), torch.from_numpy(uv1).to(device)
        E, inl, score = ransac_essential(a, b, torch.ones(n, device=device), params, samples=samples)
        out.append((E.cpu().numpy(), inl.cpu().numpy(), float(score)))
    (Ec, ic, sc), (Eh, ih, sh) = out
    assert min(np.abs(Ec - Eh).max(), np.abs(Ec + Eh).max()) <= 1e-5
    assert sc == sh >= 0.75 * n
    np.testing.assert_array_equal(ic, ih)


def test_mono_system_repeats_on_card(dev):
    """System(cam, sensor="mono") with hybrid points over tests/test_hybrid.py's
    16 QVGA mono frames, twice on the card: it initializes, and the two runs
    make the same keyframes and bit-equal poses (the RANSAC draws from a
    generator seeded with the frame index)."""
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.io.synthetic import make_mono_scene, render_wireframe_image
    from tpuslam_torch.system import System

    cam = QVGA._replace(fx=200.0, fy=200.0, baseline=0.0)
    rng = np.random.default_rng(0)
    scene = make_mono_scene(rng, 16, cam=cam, n_segments=24, n_points=130, step=0.08)
    frames = [render_wireframe_image(scene, f, noise=1.0, rng=rng, draw_points=True) for f in range(16)]
    cfg = TrackerConfig(min_init_lines=8, min_track_matches=6, min_track_inliers=6, max_frames_between_kf=3, points=PointFrontendParams())
    runs = []
    for _ in range(2):
        s = System(cam, sensor="mono", tracker_cfg=cfg, device=dev)
        for f, img in enumerate(frames):
            s.track_monocular(img, f * 0.05)
        s.shutdown()
        runs.append(s)
    assert sum(r.state.name == "OK" for r in runs[0].trajectory) >= 10
    kfs = [[r.frame_idx for r in s.trajectory if r.made_keyframe] for s in runs]
    assert kfs[0] == kfs[1], kfs
    assert all(np.array_equal(a.T_cw, b.T_cw) for a, b in zip(runs[0].trajectory, runs[1].trajectory))


# ---- the pipelined forms and the front end's other branches ------------------


@pytest.mark.parametrize("shape", [(480, 640), (240, 320)])
def test_blur_kernel_at_the_resize_sigma(dev, shape):
    """The in-program resize's prefilter (sigma 0.5, radius 2): within the
    [0, 1] tolerance of the plain version and bit for bit the two-pass form;
    the whole resize (blur, then the two weight products) within 1e-5 of the
    CPU's."""
    from tpuslam_torch.frontend.frame import FrontendParams, resize_to_base_scale

    x = _image(shape, dev, seed=5)
    assert image._blur_taps(0.5).numel() == 5
    out = image.gaussian_blur(x, 0.5)
    torch.testing.assert_close(out, image.gaussian_blur_torch(x, 0.5), rtol=0, atol=1e-5)
    assert torch.equal(out, image._blur_two_pass_cuda(x, 0.5))
    fe = FrontendParams(base_scale=0.5)
    torch.testing.assert_close(resize_to_base_scale(x, fe).cpu(), resize_to_base_scale(x.cpu(), fe), rtol=0, atol=1e-5)


def _card_forms():
    """name -> (TrackerConfig, sensor): each pipelined form at QVGA (chunks
    of 4), the synchronous tracker with radtan distortion."""
    import chip_smoke
    from tpuslam_torch.frontend.frame import FrontendParams
    from tpuslam_torch.frontend.points import PointFrontendParams
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.geometry.camera import Distortion
    from tpuslam_torch.kernels.align_direct import DirectAlignParams
    from tpuslam_torch.kernels.stereo_direct import DirectStereoParams

    d = DirectStereoParams(max_disp=64.0)
    return {
        "frame": TrackerConfig(pipelined=True, direct_stereo=d),
        "descriptor frame": TrackerConfig(pipelined=True),
        "hybrid frame": TrackerConfig(pipelined=True, direct_stereo=DirectStereoParams(), points=PointFrontendParams()),
        "full-detection chunk": TrackerConfig(pipelined=True, chunk=4, direct_stereo=d),
        "resized semi-direct chunk": TrackerConfig(
            pipelined=True, chunk=4, direct_stereo=d, semidirect=DirectAlignParams(), frontend=FrontendParams(base_scale=0.5)
        ),
        "classic": TrackerConfig(pipelined=True, fused=False),
        "radtan": TrackerConfig(frontend=FrontendParams(dist=Distortion(**chip_smoke.RADTAN), cam=QVGA)),
    }


def _form_frames(name):
    import chip_smoke

    if name == "hybrid frame":
        return dot_scene(8)[1]
    frames = stereo_scene(8)[1]
    if name == "radtan":
        return [tuple(chip_smoke.distort_image(x, QVGA, chip_smoke.RADTAN) for x in pair) for pair in frames]
    return frames


@pytest.mark.parametrize("name", list(_card_forms()))
def test_pipelined_form_on_card_tracks_like_cpu(dev, name):
    """Eight QVGA frames through System (mapping off) in each form on the
    card and on the CPU: one result per frame, the same states and
    keyframes, poses within 2 cm (kernels and plain versions differ in float
    rounding, which the detector's thresholds can turn into slightly
    different segments)."""
    from tpuslam_torch.system import System
    from torch_parity import DOTS

    cfg = _card_forms()[name]
    cam = DOTS if name == "hybrid frame" else QVGA
    frames = _form_frames(name)
    runs = []
    for device in ("cpu", dev):
        s = System(cam, sensor="stereo", mapping=False, loop_closing=False, tracker_cfg=cfg, device=device)
        for f, (il, ir) in enumerate(frames):
            s.track_stereo(il, ir, 0.05 * f)
        s.shutdown()
        runs.append(s.trajectory)
    assert [r.frame_idx for r in runs[1]] == [r.frame_idx for r in runs[0]] == list(range(8))
    for a, b in zip(*runs):
        assert a.state == b.state and a.made_keyframe == b.made_keyframe, a.frame_idx
        assert np.linalg.norm(np.linalg.inv(a.T_cw)[:3, 3] - np.linalg.inv(b.T_cw)[:3, 3]) < 0.02


def test_pipelined_mono_on_card_tracks_like_cpu(dev):
    """The mono sequence's first 10 VGA frames through pipelined lines-only
    mono (the classic pipeline) on the card and on the CPU, with the same
    RANSAC draws (the default generators of the two devices draw
    differently): the same states and keyframes, poses within 2 cm once
    initialized."""
    import chip_smoke
    from tpuslam_torch.frontend.initializer import MonoInitializer
    from tpuslam_torch.frontend.tracking import TrackerConfig
    from tpuslam_torch.system import System

    cam, _, frames = chip_smoke.make_mono_frames(10)
    cfg = TrackerConfig(**chip_smoke.MONO_TRACKER, pipelined=True)

    def draws(frame_idx, n_rows, n_hypotheses):  # the same RANSAC draws on both devices
        return np.random.default_rng(frame_idx).integers(0, n_rows, (n_hypotheses, 8))

    runs = []
    for device in ("cpu", dev):
        s = System(cam, sensor="mono", tracker_cfg=cfg, device=device)
        s.tracker.mono_init = MonoInitializer(cam, sampler=draws)
        for f, img in enumerate(frames):
            s.track_monocular(img, 0.05 * f)
        s.shutdown()
        runs.append(s.trajectory)
    assert [r.frame_idx for r in runs[1]] == list(range(10))
    assert any(r.state.name == "OK" for r in runs[1])
    for a, b in zip(*runs):
        assert a.state == b.state and a.made_keyframe == b.made_keyframe, a.frame_idx
        if a.state.name == "OK":
            assert np.linalg.norm(np.linalg.inv(a.T_cw)[:3, 3] - np.linalg.inv(b.T_cw)[:3, 3]) < 0.02


def test_single_frame_program_repeats_on_card(dev):
    """The single-frame direct program (System with bench_configs(chunk=1),
    mapping on) over 10 host-halved VGA frames twice on the card: the same
    keyframes and bit-equal poses."""
    from tpuslam_torch.system import System, bench_configs

    _, frames = stereo_scene(10, cam=VGA)
    tcfg, mcfg = bench_configs(chunk=1)
    runs = []
    for _ in range(2):
        s = System(VGA, sensor="stereo", mapping=True, loop_closing=False, tracker_cfg=tcfg, mapper_cfg=mcfg, device=dev)
        for f, (il, ir) in enumerate(frames):
            s.track_stereo(il, ir, 0.05 * f)
        s.shutdown()
        runs.append(s.trajectory)
    assert s.tracker.anchor_frames == list(range(1, 10))
    assert [r.made_keyframe for r in runs[0]] == [r.made_keyframe for r in runs[1]]
    assert all(np.array_equal(a.T_cw, b.T_cw) for a, b in zip(*runs))


# ---- the batched kernels: one launch for N images ---------------------------

BATCHES = [1, 3, 8]


def _batch(shape, n, dev):
    """n random images of one shape at amplitudes 0, 1/2 and 1 in turn: the
    all-zero ones have no support pixel and no component, so the images of
    one batch hold different numbers of components (and of live CCL cells)."""
    return torch.stack([_image(shape, dev, seed=i) * ((i % 3) / 2.0) for i in range(n)]).contiguous()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", BATCHES)
def test_batched_image_kernels_bit_equal_to_single(dev, shape, n):
    """The blur (the pyramid's and the front's radii) and the LBD gradients
    of N images in one launch each, bit for bit N single-image calls."""
    x = _batch(shape, n, dev)
    before = dict(image.KERNEL_LAUNCHES)
    blurs = {sigma: image.gaussian_blur_batch(x, sigma) for sigma in (0.75, 5.0)}
    gx, gy = image.gradients_xy_batch(x, 255.0)
    assert image.KERNEL_LAUNCHES["blur_batch"] == before["blur_batch"] + 2
    assert image.KERNEL_LAUNCHES["gradients_batch"] == before["gradients_batch"] + 1
    for i in range(n):
        for sigma, out in blurs.items():
            assert torch.equal(out[i], image.gaussian_blur(x[i], sigma)), (i, sigma)
        sx, sy = image.gradients_xy(x[i], 255.0)
        assert torch.equal(gx[i], sx) and torch.equal(gy[i], sy), i


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", BATCHES)
def test_batched_front_and_ccl_bit_equal_to_single(dev, shape, n):
    """The detector's front and the label propagation (64 rounds) of N
    images, one front launch and ceil(64 / k) CCL launches for the batch,
    bit for bit N single-image calls."""
    x = _batch(shape, n, dev)
    before = dict(lsd.KERNEL_LAUNCHES)
    planes = lsd.ccl_inputs_batch(x)
    lab, mx = lsd.ccl_propagate_batch(*planes[2:], 64)
    assert lsd.KERNEL_LAUNCHES["lsd_front_batch"] == before["lsd_front_batch"] + 1
    assert lsd.KERNEL_LAUNCHES["ccl_batch"] == before["ccl_batch"] + -(-64 // lsd.CCL_TILE[2])
    for i in range(n):
        single = lsd.ccl_inputs(x[i])
        assert all(torch.equal(a[i], b) for a, b in zip(planes, single)), i
        sl, sm = lsd.ccl_propagate(*single[2:], 64)
        assert torch.equal(lab[i], sl) and torch.equal(mx[i], sm), i


def test_batched_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((2, 16, 16), device=dev)
    with pytest.raises(ValueError):
        image.gaussian_blur_batch(x[0], 0.75)  # not (B, H, W)
    with pytest.raises(ValueError):
        image.gaussian_blur_batch(torch.zeros((0, 16, 16), device=dev), 0.75)  # an empty batch
    with pytest.raises(ValueError):
        image.gradients_xy_batch(torch.zeros((2, 16, 32), device=dev)[..., ::2], 255.0)  # not contiguous
    with pytest.raises(TypeError):
        lsd.ccl_inputs_batch(x.double())
    i = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        lsd.ccl_propagate_batch(i, i, i[:1].contiguous(), 3)
    sup = torch.zeros((2, 16, 16), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # the roots of another batch
        lsd.component_moments_batch(i, x, sup, torch.zeros((3, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):  # one slot row for a batch
        lsd.segment_moments_batch(torch.zeros((2, 7, 8), device=dev), torch.zeros((8,), dtype=torch.int32, device=dev), 8)


def _batched_sum_inputs(imgs):
    """{single entry: args} of the three batched sums one batched
    detect_lines call makes."""
    seen = {}
    names = {f"{name}_batch": name for name in lsd.SUMS}
    real = {name: getattr(lsd, name) for name in names}

    def grab(name):
        def call(*args):
            seen[names[name]] = args
            return real[name](*args)

        return call

    for name in names:
        setattr(lsd, name, grab(name))
    try:
        lsd.detect_lines(imgs, 256)
    finally:
        for name in names:
            setattr(lsd, name, real[name])
    assert set(seen) == set(lsd.SUMS)
    return seen


@pytest.mark.parametrize("shape", SUM_SHAPES)
@pytest.mark.parametrize("n", BATCHES)
def test_batched_component_sums_bit_equal_to_single(dev, shape, n):
    """The three sum kernels on a batched detector's own inputs, images with
    different numbers of components (rendered frames and all-zero ones, which
    have none): one launch each for the batch, each image bit for bit its
    single call (its own ticket counters: one image's last-block combine
    never fires on another's count), twice in a row bit-equal."""
    rendered = _level_image(shape, dev)
    imgs = torch.stack([rendered * (i % 3) / 2.0 for i in range(n)]).contiguous()
    inputs = _batched_sum_inputs(imgs)
    for name, args in inputs.items():
        fn = getattr(lsd, f"{name}_batch")
        before = lsd.KERNEL_LAUNCHES[f"{name}_batch"]
        a, b = fn(*args), fn(*args)
        assert lsd.KERNEL_LAUNCHES[f"{name}_batch"] == before + 2
        assert torch.equal(_bits(a), _bits(b)), name
        for i in range(n):
            per = [x[i] if isinstance(x, torch.Tensor) else x for x in args]
            assert torch.equal(_bits(a[i]), _bits(getattr(lsd, name)(*per))), (name, i)
    counts = inputs["component_moments"]
    members = [float(lsd.component_moments(*(x[i] for x in counts))[0].sum()) for i in range(n)]
    assert n < 2 or len(set(members)) > 1, members


@pytest.mark.parametrize("n", [2, 8])
def test_batched_extraction_bit_equal_to_single(dev, n):
    """extract_features of N VGA frames (both pyramid levels, detection,
    LBD, the level merge) in one set of launches, bit for bit N single
    extractions; the batched kernels alone launched."""
    from tpuslam_torch.frontend.frame import FrontendParams, extract_features

    _, frames = stereo_scene(n, cam=VGA)
    imgs = torch.stack([torch.from_numpy(image01(f[0])) for f in frames]).to(dev)
    before = ({**image.LAUNCHES, **lsd.LAUNCHES})
    fb = extract_features(imgs, FrontendParams())
    after = ({**image.LAUNCHES, **lsd.LAUNCHES})
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "blur_batch": 1, "gradients_batch": 2, "lsd_front_batch": 2, "ccl_batch": 2,
        "component_moments_batch": 2, "component_extents_batch": 2, "segment_moments_batch": 2,
    }
    for i in range(n):
        fs = extract_features(imgs[i], FrontendParams())
        for name, a, b in zip(fs._fields, fb, fs):
            assert torch.equal(a[i], b), (i, name)


def test_batched_ba_on_card_matches_single_solves(dev):
    """batched_ba of 8 toy problems at the bench rung (16, 256, 1024) against
    8 single run_lm solves on the card. float64, 4 iterations: every field
    within 1e-8 plus 1e-6 of its largest entry (the same LM, batched). float32 (what local BA runs): both converge
    (noiseless observations: final costs below 1e-4), the costs within 1e-5
    and the poses within 5e-3 (on the CPU the two roundings leave converged
    poses up to 2.3e-3 apart along the weakly constrained directions of
    line-only BA); two batched solves bit-equal."""
    from tpuslam_torch.backend.lm import BAProblem, LMConfig, run_lm
    from tpuslam_torch.parallel.sharded_ba import _toy_problem, batched_ba, stack_problems

    rng = np.random.default_rng(0)
    probs = [_toy_problem(rng, 16, 256, 1024, VGA, device=dev) for _ in range(8)]
    for dtype in (torch.float64, torch.float32):
        ps = [BAProblem(*(x.to(dtype) if x.is_floating_point() else x for x in p)) for p in probs]
        cfg = LMConfig(max_iters=4) if dtype == torch.float64 else LMConfig()  # float64: short of ties at convergence
        a = batched_ba(stack_problems(ps), VGA, cfg)
        singles = [run_lm(p, VGA, cfg) for p in ps]
        for i, s in enumerate(singles):
            if dtype == torch.float64:
                assert all(float((x[i] - y).abs().max()) <= 1e-8 + 1e-6 * float(y.abs().max()) for x, y in zip(a, s)), i
            else:
                assert float(a.cost[i]) < 1e-4 and float(s.cost) < 1e-4, i
                assert abs(float(a.cost[i]) - float(s.cost)) <= 1e-5, i
                assert float((a.poses[i] - s.poses).abs().max()) <= 5e-3, i
    b = batched_ba(stack_problems(ps), VGA, LMConfig())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- config #5 split over a mesh ------------------------------------------------


def _card_meshes():
    """(cuda:0, cuda:0): two shard processes on one card; and every card
    when there are several."""
    from tpuslam_torch.parallel.sharded_ba import DeviceMesh, make_mesh

    meshes = [DeviceMesh((torch.device("cuda", 0),) * 2)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    return meshes


def _pose_gap(T, T_ref):
    """(rotation angle rad, camera centre distance m) between two T_cw."""
    T, T_ref = np.asarray(T, np.float64), np.asarray(T_ref, np.float64)
    dR = T[:3, :3] @ T_ref[:3, :3].T
    w = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    ang = float(np.arctan2(np.linalg.norm(w), 0.5 * (np.trace(dR) - 1.0)))
    return ang, float(np.linalg.norm(-T[:3, :3].T @ T[:3, 3] + T_ref[:3, :3].T @ T_ref[:3, 3]))


def _split_run(mesh, n_seq=4, n_frames=8):
    """MultiTracker over tests/test_parallel.py's 4 synthetic sequences
    (this package's scenes and features), a LocalMapper per sequence on its
    tracker's device (``mapper_cfg``): results per frame and the tracker's
    ``stats()`` (over a mesh, read from its shard processes)."""
    from tpuslam_torch.backend.mapping import MapperConfig
    from tpuslam_torch.frontend.frame import FrameFeatures
    from tpuslam_torch.io.synthetic import make_wireframe_scene, synthetic_frame_features
    from tpuslam_torch.parallel import multi_seq as tms

    scenes = [
        make_wireframe_scene(np.random.default_rng(100 + s), n_segments=120, n_frames=n_frames, cam=VGA, motion_scale=0.02)
        for s in range(n_seq)
    ]
    mt = tms.MultiTracker([VGA] * n_seq, mesh=mesh, device="cuda:0", mapper_cfg=MapperConfig())
    res = []
    for f in range(n_frames):
        per = [
            synthetic_frame_features(sc, f, noise_px=0.3, rng=np.random.default_rng(f * 31 + s), with_depth=True, device="cuda:0")[0]
            for s, sc in enumerate(scenes)
        ]
        res.append(mt.track_features(FrameFeatures(*(torch.stack(xs) for xs in zip(*per))), [f * 0.05] * n_seq))
    stats = mt.stats()
    mt.close()
    return res, stats


def test_split_on_card_matches_unsplit(dev):
    """MultiTracker and batched_ba over (cuda:0, cuda:0) and over every card
    when there are several, against the unsplit calls on cuda:0. Tracking
    (4 sequences x 8 frames, a mapper each): one dispatch per shard per
    steady frame, on the shard's card; every sequence's states and
    keyframes equal, poses within 1e-5 rad and 1e-4 m (a shard's batched
    pose LM runs on fewer rows, which the card's batched products may round
    apart; on the CPU 2 of 4 rows are bit-equal and 1 of 4 within 2.5e-6
    rad and 2.0e-5 m). batched_ba of 8 toy problems at the bench rung (16,
    256, 1024) in float64, 4 iterations: every field within 1e-8 plus 1e-6
    of its largest entry, gathered on the mesh's first card."""
    from tpuslam_torch.backend.lm import BAProblem, LMConfig
    from tpuslam_torch.parallel.sharded_ba import _toy_problem, batched_ba, stack_problems

    ref, _ = _split_run(None)
    rng = np.random.default_rng(0)
    probs = stack_problems([
        BAProblem(*(x.double() if x.is_floating_point() else x for x in _toy_problem(rng, 16, 256, 1024, VGA, device="cuda:0")))
        for _ in range(8)
    ])
    ba_ref = batched_ba(probs, VGA, LMConfig(max_iters=4))
    for mesh in _card_meshes():
        k = len(mesh.devices)
        res, stats = _split_run(mesh)
        assert [(sh["batched_dispatches"], sh["device"]) for sh in stats["shards"]] == [(7, str(d)) for d in mesh.devices]
        assert [q["device"] for q in stats["sequences"]] == [str(d) for d in mesh.devices for _ in range(4 // k)]
        for f, (a, b) in enumerate(zip(res, ref)):
            for s in range(4):
                assert (a[s].state, a[s].made_keyframe) == (b[s].state, b[s].made_keyframe), (mesh, f, s)
                ang, dist = _pose_gap(a[s].T_cw, b[s].T_cw)
                assert ang <= 1e-5 and dist <= 1e-4, (mesh, f, s, ang, dist)
        out = batched_ba(probs, VGA, LMConfig(max_iters=4), mesh=mesh)
        mesh.close()
        for x, y in zip(out, ba_ref):
            assert x.device == mesh.devices[0]
            assert float((x - y).abs().max()) <= 1e-8 + 1e-6 * float(y.abs().max())


def test_kernel_on_a_non_current_card(dev):
    """Each hand kernel's wrapper on a tensor of cuda:1 while cuda:0 is the
    current device: it launches on cuda:1 (the counts move), and its result
    is bit for bit the same call's on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from tpuslam_torch.frontend.frame import FrontendParams, extract_features

    _, frames = stereo_scene(2, cam=VGA)
    imgs = torch.stack([torch.from_numpy(image01(f[0])) for f in frames])
    with torch.cuda.device(0):
        a = extract_features(imgs.to("cuda:0"), FrontendParams())
        before = {**image.LAUNCHES, **lsd.LAUNCHES}
        b = extract_features(imgs.to("cuda:1"), FrontendParams())
        after = {**image.LAUNCHES, **lsd.LAUNCHES}
        blur1 = image.gaussian_blur(imgs[0].to("cuda:1"), 1.2)
        blur0 = image.gaussian_blur(imgs[0].to("cuda:0"), 1.2)
    assert {k for k in after if after[k] != before[k]} == {
        "blur_batch", "gradients_batch", "lsd_front_batch", "ccl_batch",
        "component_moments_batch", "component_extents_batch", "segment_moments_batch",
    }
    torch.cuda.synchronize(1)
    for name, x, y in zip(a._fields, a, b):
        assert y.device == torch.device("cuda", 1), name
        assert torch.equal(x, y.to("cuda:0")), name
    assert torch.equal(blur0, blur1.to("cuda:0"))


def test_system_warms_the_loop_on_the_card(dev, monkeypatch):
    """On the card System(cam) runs the loop warm-up at start by default
    (its seconds in warm_loop_s), and not under TPUSLAM_WARM_LOOP=0."""
    from tpuslam_torch.system import System

    monkeypatch.delenv("TPUSLAM_WARM_LOOP", raising=False)
    s = System(QVGA, device="cuda")
    assert set(s.warm_loop_s) == {"pose_graph_s", "loop_refine_s"}
    monkeypatch.setenv("TPUSLAM_WARM_LOOP", "0")
    assert System(QVGA, device="cuda").warm_loop_s is None
