"""The public helpers of tpuslam_torch's geometry and matching modules
against the JAX package's, on seeded numpy inputs (one case per helper).

Tolerances: the bit, count, gate and top-k helpers are exact (integers,
booleans, integer-valued float32 distances and their indices, ties in
index order); the float32 geometry helpers agree within 1e-6 relative
(XLA:CPU and PyTorch may fuse a product and a sum differently).
"""

import numpy as np
import pytest
import torch

from torch_parity import QVGA

REL = 1e-6


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _jcam():
    from tpuslam.geometry.camera import Intrinsics as JIntrinsics

    return JIntrinsics(*QVGA)


def _poses(rng, n):
    from tpuslam_torch.geometry.se3 import se3_exp

    return se3_exp(torch.as_tensor(rng.normal(size=(n, 6)) * 0.5, dtype=torch.float32)).numpy()


def _lines(rng, n):
    return rng.normal(size=(n, 6)).astype(np.float32)


def _words(rng, n, w=8):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)


def case_se3_compose(rng):
    from tpuslam.geometry import se3_compose as j
    from tpuslam_torch.geometry import se3_compose as t

    a, b = _poses(rng, 5), _poses(rng, 5)
    return np.asarray(j(_jnp(a), _jnp(b))), t(torch.from_numpy(a), torch.from_numpy(b)).numpy(), REL


def case_se3_identity(rng):
    from tpuslam.geometry import se3_identity as j
    from tpuslam_torch.geometry import se3_identity as t

    return np.asarray(j((2, 3))), t((2, 3)).numpy(), 0.0


def case_plucker_closest_point(rng):
    from tpuslam.geometry import plucker_closest_point as j
    from tpuslam_torch.geometry import plucker_closest_point as t

    L = _lines(rng, 32)
    return np.asarray(j(_jnp(L))), t(torch.from_numpy(L)).numpy(), REL


def case_plucker_distance_to_origin(rng):
    from tpuslam.geometry import plucker_distance_to_origin as j
    from tpuslam_torch.geometry import plucker_distance_to_origin as t

    L = _lines(rng, 32)
    return np.asarray(j(_jnp(L))), t(torch.from_numpy(L)).numpy(), REL


def case_plucker_point_at(rng):
    from tpuslam.geometry.plucker import plucker_point_at as j
    from tpuslam_torch.geometry import plucker_point_at as t

    L, s = _lines(rng, 32), rng.normal(size=32).astype(np.float32) * 3
    return np.asarray(j(_jnp(L), _jnp(s))), t(torch.from_numpy(L), torch.from_numpy(s)).numpy(), REL


def case_backproject_pixels(rng):
    from tpuslam.geometry import backproject_pixels as j
    from tpuslam_torch.geometry import backproject_pixels as t

    uv = rng.uniform(0, 320, size=(4, 8, 2)).astype(np.float32)
    z = rng.uniform(0.5, 20, size=(4, 8)).astype(np.float32)
    return np.asarray(j(_jcam(), _jnp(uv), _jnp(z))), t(QVGA, torch.from_numpy(uv), torch.from_numpy(z)).numpy(), REL


def case_project_plucker_line(rng):
    from tpuslam.geometry import project_plucker_line as j
    from tpuslam_torch.geometry import project_plucker_line as t

    L = _lines(rng, 32)
    return np.asarray(j(_jcam(), _jnp(L))), t(QVGA, torch.from_numpy(L)).numpy(), REL


def case_stereo_depth_from_disparity(rng):
    from tpuslam.geometry.triangulate import stereo_depth_from_disparity as j
    from tpuslam_torch.geometry import stereo_depth_from_disparity as t

    d = rng.uniform(-1, 64, size=40).astype(np.float32)
    d[:3] = 0.0
    return np.asarray(j(_jcam(), _jnp(d))), t(QVGA, torch.from_numpy(d)).numpy(), REL


def case_unpack_bits(rng):
    from tpuslam.kernels.match import unpack_bits as j
    from tpuslam_torch.kernels.match import unpack_bits as t

    w = _words(rng, 12)
    return np.asarray(j(_jnp(w), 256)), t(torch.from_numpy(w.astype(np.int64)), 256).numpy(), 0.0


def case_popcount_u32(rng):
    from tpuslam.kernels.match import popcount_u32 as j
    from tpuslam_torch.kernels.match import popcount_u32 as t

    w = _words(rng, 12)
    w[0, :3] = [0, 0xFFFFFFFF, 0x80000001]
    out = t(torch.from_numpy(w.astype(np.int64)))
    assert out.dtype == torch.int32
    return np.asarray(j(_jnp(w))), out.numpy(), 0.0


def case_hamming_distance_mxu(rng):
    from tpuslam.kernels.match import hamming_distance_mxu as j
    from tpuslam_torch.kernels.match import hamming_distance_matrix, hamming_distance_mxu

    a, b = _words(rng, 20), _words(rng, 30)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    out = hamming_distance_mxu(ta, tb, 256)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), hamming_distance_matrix(ta, tb).numpy())
    return np.asarray(j(_jnp(a), _jnp(b), 256)), out.numpy(), 0.0


def _mids(rng, n):
    return rng.uniform(0, 100, size=(n, 2)).astype(np.float32)


def case_angle_gate(rng):
    from tpuslam.kernels.match import angle_gate as j
    from tpuslam_torch.kernels.match import angle_gate as t

    a, b = (rng.uniform(-np.pi, np.pi, size=n).astype(np.float32) for n in (30, 40))
    return np.asarray(j(_jnp(a), _jnp(b), 0.3)), t(torch.from_numpy(a), torch.from_numpy(b), 0.3).numpy(), 0.0


def case_length_ratio_gate(rng):
    from tpuslam.kernels.match import length_ratio_gate as j
    from tpuslam_torch.kernels.match import length_ratio_gate as t

    a, b = (rng.uniform(0, 60, size=n).astype(np.float32) for n in (30, 40))
    a[0] = 0.0
    return np.asarray(j(_jnp(a), _jnp(b), 0.6)), t(torch.from_numpy(a), torch.from_numpy(b), 0.6).numpy(), 0.0


def case_midpoint_radius_gate(rng):
    from tpuslam.kernels.match import midpoint_radius_gate as j
    from tpuslam_torch.kernels.match import midpoint_radius_gate as t

    a, b = _mids(rng, 30), _mids(rng, 40)
    return np.asarray(j(_jnp(a), _jnp(b), 25.0)), t(torch.from_numpy(a), torch.from_numpy(b), 25.0).numpy(), 0.0


def case_stereo_row_gate(rng):
    from tpuslam.kernels.match import stereo_row_gate as j
    from tpuslam_torch.kernels.match import stereo_row_gate as t

    a, b = _mids(rng, 30), _mids(rng, 40)
    b[:, 1] = a[rng.integers(0, 30, 40), 1] + rng.normal(size=40).astype(np.float32) * 2
    args = (3.0, 0.5, 64.0)
    return np.asarray(j(_jnp(a), _jnp(b), *args)), t(torch.from_numpy(a), torch.from_numpy(b), *args).numpy(), 0.0


def case_match_topk_database(rng):
    from tpuslam.kernels.match import match_topk_database as j
    from tpuslam_torch.kernels.match import match_topk_database as t

    q, db = _words(rng, 16, 2), _words(rng, 48, 2)  # 64-bit words: many equal distances
    db[5] = db[9]  # an exact tie
    q[0] = db[5]
    valid = (rng.uniform(size=48) > 0.2).astype(np.float32)
    jd, ji = j(_jnp(q), _jnp(db), _jnp(valid), 6, n_bits=64)
    td, ti = t(torch.from_numpy(q.astype(np.int64)), torch.from_numpy(db.astype(np.int64)), torch.from_numpy(valid), 6, n_bits=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    return np.asarray(jd), td.numpy(), 0.0


CASES = {name.removeprefix("case_"): fn for name, fn in list(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    """The port's helper against the JAX package's on the same seeded
    inputs: equal shapes and dtype kinds, exact where the tolerance is 0,
    else within it relative (and absolute, near zero)."""
    ref, out, tol = CASES[name](np.random.default_rng(sum(map(ord, name))))
    assert ref.shape == out.shape, (ref.shape, out.shape)
    assert ref.dtype.kind == out.dtype.kind, (ref.dtype, out.dtype)
    if tol == 0.0:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
