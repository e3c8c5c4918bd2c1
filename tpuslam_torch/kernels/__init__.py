"""Front-end kernels: image pyramid and gradients, line detection, LBD
descriptors, descriptor matching (torch).

The hand-written CUDA kernels (``csrc/``) sit behind five wrappers:
``image.gaussian_blur``, ``image.image_gradients``, ``image.gradients_xy``,
``lsd.ccl_inputs`` (the detector's fused front) and ``lsd.ccl_propagate``;
``cuda_lib`` builds and loads them.
"""
