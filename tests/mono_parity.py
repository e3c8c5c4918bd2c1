"""Shared pieces of the tests that hold tpuslam_torch's mono path to tpuslam's.

- ``jax_samples``: the RANSAC row samples the JAX initializer draws for a
  frame (``jax.random.categorical`` from ``PRNGKey(frame_idx)`` over all-valid
  rows), for the port's ``MonoInitializer(sampler=...)``.
- ``essential_from_8_f64``: the 8-point algorithm in float64 numpy, the
  reference of the port's float64 solve.
- ``jax_e8_float64``: a context in which the JAX initializer's 8-point solve
  is the port's float64 one, on the CPU (through ``jax.pure_callback``). The
  JAX package's float32 normal equations are noise at the level the tests
  compare (ROADMAP.md section 3), and a sample that draws a row twice (~10%
  of the 256 hypotheses) has a null space of two dimensions or more, where
  each LAPACK returns its own vector, which can tie for the best score. So
  the end-to-end comparisons run both packages on this one solve; the solve
  itself is held to ``essential_from_8_f64``. JAX's compile caches are
  cleared on entry and exit, so that nothing traced inside leaks into other
  tests of the process.
- ``synthetic_point_features``: corners for the JAX package's synthetic
  features (tpuslam.io.synthetic has line features only).
"""

import contextlib

import numpy as np


def jax_samples(frame_idx: int, n_rows: int, n_hypotheses: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(frame_idx)
    return np.array(jax.random.categorical(key, jnp.zeros(n_rows, jnp.float32), shape=(n_hypotheses, 8)))


def essential_from_8_f64(uv0n, uv1n) -> np.ndarray:
    """(..., 8, 2) normalized coordinates twice -> (..., 3, 3) float64 E."""
    a = np.asarray(uv0n, np.float64)
    b = np.asarray(uv1n, np.float64)
    x0, y0, x1, y1 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, np.ones_like(x0)], axis=-1)
    _, V = np.linalg.eigh(np.swapaxes(A, -1, -2) @ A)
    E = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    U, _, Vt = np.linalg.svd(E)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt


@contextlib.contextmanager
def jax_e8_float64():
    import jax
    import jax.numpy as jnp

    from tpuslam.frontend import initializer as ji

    import torch

    from tpuslam_torch.frontend.initializer import _essential_from_8

    def solve(a, b):
        return _essential_from_8(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))).numpy()

    def e8(uv0n, uv1n):
        out = jax.ShapeDtypeStruct(uv0n.shape[:-2] + (3, 3), jnp.float32)
        return jax.pure_callback(solve, out, uv0n, uv1n, vmap_method="broadcast_all")

    saved = ji._essential_from_8
    jax.clear_caches()
    ji._essential_from_8 = e8
    try:
        yield
    finally:
        ji._essential_from_8 = saved
        jax.clear_caches()


def synthetic_point_features(scene, frame: int, capacity: int = 256, noise_px: float = 0.0, rng=None, desc_seed: int = 4321):
    """Detector-bypassing corners for the JAX package (its PointFeatures):
    the scene's visible points projected into ``frame``, with identity-stable
    BRIEF words (point q always has the same 256 bits) and no depth, as the
    mono front end sees them."""
    from tpuslam.io.synthetic import observe_frame
    from tpuslam.kernels.fast import PointFeatures

    obs = observe_frame(scene, frame)
    words = np.random.RandomState(desc_seed).randint(0, 2**32, size=(len(scene.points), 8), dtype=np.uint64).astype(np.uint32)
    vis = np.nonzero(obs.pt_visible)[0][:capacity]
    n = len(vis)
    uv = np.zeros((capacity, 2), np.float32)
    uv[:n] = obs.pt_uv[vis]
    if noise_px > 0 and rng is not None:
        uv[:n] += (rng.normal(size=(n, 2)) * noise_px).astype(np.float32)
    valid = np.zeros(capacity, np.float32)
    valid[:n] = 1.0
    bits = np.zeros((capacity, 8), np.uint32)
    bits[:n] = words[vis]
    zeros = np.zeros(capacity, np.float32)
    return PointFeatures(uv=uv, valid=valid, response=valid.copy(), desc_bits=bits, depth=zeros, has_depth=zeros.copy())
