"""Direct epipolar stereo: tpuslam_torch.kernels.stereo_direct against
tpuslam.kernels.stereo_direct on the same rendered pairs and segments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import QVGA, image01, np_of, stereo_scene
from tpuslam.frontend.frame import FrontendParams as JFrontendParams
from tpuslam.frontend.frame import extract_features as j_extract
from tpuslam.kernels import stereo_direct as jsd
from tpuslam_torch import Intrinsics
from tpuslam_torch.convert import features_from, params_from
from tpuslam_torch.frontend.frame import FrontendParams, host_prescale
from tpuslam_torch.kernels import stereo_direct as tsd

VGA = Intrinsics(fx=458.0, fy=457.0, cx=320.0, cy=240.0, width=640, height=480, baseline=0.11)
HALF = FrontendParams(base_scale=0.5, prescaled=True)


@pytest.fixture(scope="module")
def pairs():
    """Per coord_scale: the (left, right) float32 pair at 240x320, the JAX
    package's left features of it (full-resolution geometry) and the
    direct-stereo params. 1.0: a rendered QVGA pair; 0.5: a rendered VGA
    pair halved on the host (the bench's ingest)."""
    out = {}
    _, frames = stereo_scene(2, QVGA, seed=3)
    il, ir = frames[1]
    out[1.0] = (image01(il), image01(ir), j_extract(jnp.asarray(image01(il)), JFrontendParams()), tsd.DirectStereoParams())
    _, frames = stereo_scene(2, VGA, seed=3)
    il, ir = (host_prescale(x, HALF) for x in frames[1])
    fe = JFrontendParams(base_scale=0.5, prescaled=True)
    p = tsd.inject_coord_scale(tsd.DirectStereoParams(), 0.5, True)
    out[0.5] = (image01(il), image01(ir), j_extract(jnp.asarray(image01(il)), fe), p)
    return out


@pytest.mark.parametrize("args", [(0.1, 0.9, 8), (0.08, 0.92, 6), (0.1, 0.9, 12), (0.3, 0.4, 9)])
def test_linspace_matches_jax_inside_jit(args):
    """The sample positions along a segment equal jnp.linspace's as the
    jitted JAX bodies compute them, bit for bit."""
    ref = np.asarray(jax.jit(lambda: jnp.linspace(*args))())
    np.testing.assert_array_equal(tsd.linspace_np(*args).view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(np_of(tsd.linspace(*args, "cpu")), ref)


@pytest.mark.parametrize(
    "p, base_scale, prescaled",
    [
        (tsd.DirectStereoParams(), 0.5, True),
        (tsd.DirectStereoParams(), 0.5, False),
        (tsd.DirectStereoParams(), 1.0, True),
        (tsd.DirectStereoParams(max_disp=10.0), 0.5, True),  # floor of 8 px
        (tsd.DirectStereoParams(coord_scale=0.25), 0.5, True),  # explicit scale kept
    ],
)
def test_inject_coord_scale_matches_jax(p, base_scale, prescaled):
    ref = jsd.inject_coord_scale(jsd.DirectStereoParams(**p._asdict()), base_scale, prescaled)
    assert tsd.inject_coord_scale(p, base_scale, prescaled)._asdict() == ref._asdict()


@pytest.mark.parametrize("coord_scale", [1.0, 0.5])
def test_line_disparity_matches_jax(pairs, coord_scale):
    """okf agrees on all lines but at most 1 of 256; where both accept, the
    endpoint disparities agree within 1e-3 px (cumulative-sum moving means
    round differently from XLA's)."""
    il, ir, fl, p = pairs[coord_scale]
    jp = jsd.DirectStereoParams(**p._asdict())
    d_ref, ok_ref = jsd.direct_line_disparity(jnp.asarray(il), jnp.asarray(ir), fl.endpoints, fl.valid, fl.angle, jp)
    tf = features_from(fl)
    d, ok = tsd.direct_line_disparity_body(torch.from_numpy(il), torch.from_numpy(ir), tf.endpoints, tf.valid, tf.angle, p)
    d, ok, d_ref, ok_ref = np_of(d), np_of(ok), np.asarray(d_ref), np.asarray(ok_ref)
    assert ok.shape == (256,) and d.shape == (256, 2)
    assert ok_ref.sum() >= 40  # the rig's lines mostly get depths
    assert int(np.sum(ok != ok_ref)) <= 1
    both = (ok > 0.5) & (ok_ref > 0.5)
    np.testing.assert_allclose(d[both], d_ref[both], rtol=0, atol=1e-3)


def test_direct_stereo_depths_match_jax(pairs):
    """The FrameFeatures form at coord_scale 0.5 (the bench's): depth and
    has_depth as the JAX package fills them."""
    il, ir, fl, p = pairs[0.5]
    fxb = VGA.fx * VGA.baseline
    ref = jsd.direct_stereo_depths(il, ir, fl, fxb, jsd.DirectStereoParams(**p._asdict()))
    out = tsd.direct_stereo_depths(torch.from_numpy(il), torch.from_numpy(ir), features_from(fl), fxb, p)
    ok, ok_ref = np_of(out.has_depth), np.asarray(ref.has_depth)
    assert int(np.sum(ok != ok_ref)) <= 1
    both = (ok > 0.5) & (ok_ref > 0.5)
    np.testing.assert_allclose(np_of(out.depth)[both], np.asarray(ref.depth)[both], rtol=1e-4, atol=0)
    assert np.all(np_of(out.depth)[ok < 0.5] == 0)


def test_params_convert():
    """The JAX params carry into the port's with every field."""
    j = jsd.DirectStereoParams(max_disp=64.0, coord_scale=0.5)
    assert params_from(tsd.DirectStereoParams, j)._asdict() == j._asdict()
