"""Front-end kernels: image pyramid and gradients, line detection, LBD
descriptors, descriptor matching (torch).

The hand-written CUDA kernels (``csrc/``) sit behind three wrappers:
``image.gaussian_blur``, ``image.image_gradients`` and
``lsd.ccl_propagate``; ``cuda_lib`` builds and loads them.
"""
