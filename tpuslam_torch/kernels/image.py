"""Image pyramid and gradient field (torch).

Counterpart of ``tpuslam.kernels.image``. Three of the functions are kernel
wrappers: :func:`gaussian_blur`, :func:`image_gradients` and
:func:`gradients_xy` launch the CUDA kernels of ``csrc/image.cu`` on a CUDA
tensor and run their plain PyTorch versions (:func:`gaussian_blur_torch`,
:func:`image_gradients_torch`, :func:`gradients_xy_torch`) on a CPU tensor.
:func:`gaussian_blur_batch` and :func:`gradients_xy_batch` take a batch of
images of one shape, (B, H, W), in one launch of the same kernels (each
image bit for bit its single call); their plain versions run the single
plain version per image. ``LAUNCHES`` counts the kernel calls made on the
card, ``KERNEL_LAUNCHES`` the device launches of those calls (one per
call); both gradient forms count under "gradients", the batched forms under
"blur_batch" and "gradients_batch". The ``_*_cuda`` functions launch
without counting.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpuslam_torch.kernels import cuda_lib

# kernel calls made on the card, by kernel, and their device launches
LAUNCHES = {"blur": 0, "gradients": 0, "blur_batch": 0, "gradients_batch": 0}
KERNEL_LAUNCHES = dict(LAUNCHES)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorised CPU sqrt
    is off by one ulp for some inputs; IEEE sqrt (XLA's, and CUDA's sqrtf)
    is not, and the detector's thresholds and tie orders read these values.
    A float64 sqrt rounded to float32 is the correctly rounded result."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """float32 taps, computed as the JAX package computes them."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur_taps(sigma: float) -> torch.Tensor:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    return _gaussian_kernel1d(sigma, radius)


def gaussian_blur_torch(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Plain version: separable Gaussian of an (H, W) image, edge padding,
    rows then columns."""
    k = _blur_taps(sigma).to(img.device)
    r = k.numel() // 2
    x = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    return x[0, 0]


def _blur_host_taps(img: torch.Tensor, sigma: float) -> np.ndarray:
    cuda_lib.require_plane(img, torch.float32, "gaussian_blur")
    return np.ascontiguousarray(_blur_taps(sigma).numpy())


def _blur_cuda(img: torch.Tensor, sigma: float, batched: bool = False):
    """(blurred plane, device launches made) of an (H, W) image; ``batched``,
    of each image of a (B, H, W) batch in the same launch."""
    B, H, W = cuda_lib.image_batch(img, torch.float32, "gaussian_blur", batched)
    taps = np.ascontiguousarray(_blur_taps(sigma).numpy())
    out = torch.empty_like(img)
    n = ctypes.c_int(0)
    cuda_lib.launch(
        "tpuslam_blur_batch", img, "gaussian_blur",
        img.data_ptr(), out.data_ptr(), B, H, W, taps.ctypes.data, taps.size, ctypes.byref(n),
    )
    return out, n.value


def _blur_two_pass_cuda(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """The two-pass form of the kernel (its first form): rows then columns
    through a global intermediate plane in two launches, for timing and
    bit-equality checks beside :func:`_blur_cuda` on the card. The front
    end never calls it, and it counts no launches."""
    taps = _blur_host_taps(img, sigma)
    H, W = img.shape
    tmp = torch.empty_like(img)
    out = torch.empty_like(img)
    cuda_lib.launch(
        "tpuslam_blur_two_pass", img, "gaussian_blur (two pass)",
        img.data_ptr(), tmp.data_ptr(), out.data_ptr(), H, W, taps.ctypes.data, taps.size,
    )
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) float32 image, radius ceil(3 sigma),
    edge padding. Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if cuda_lib.on_card(img):
        out, n = _blur_cuda(img, sigma)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "blur", n)
        return out
    return gaussian_blur_torch(img, sigma)


def gaussian_blur_batch_torch(imgs: torch.Tensor, sigma: float) -> torch.Tensor:
    """Plain version of :func:`gaussian_blur_batch`: each image's plain blur."""
    return torch.stack([gaussian_blur_torch(im, sigma) for im in imgs])


def gaussian_blur_batch(imgs: torch.Tensor, sigma: float) -> torch.Tensor:
    """:func:`gaussian_blur` of each image of a (B, H, W) float32 batch, in
    one kernel launch on a CUDA tensor (each image bit for bit its single
    call), the plain version on a CPU tensor."""
    if cuda_lib.on_card(imgs):
        out, n = _blur_cuda(imgs, sigma, batched=True)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "blur_batch", n)
        return out
    return gaussian_blur_batch_torch(imgs, sigma)


def _central_differences(img: torch.Tensor):
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * 0.5
    gy[1:-1, :] = (img[2:, :] - img[:-2, :]) * 0.5
    return gx, gy


def image_gradients_torch(img: torch.Tensor):
    """Plain version: central differences with a zeroed 1-px border.

    Returns (gx, gy, mag, angle), angle = atan2(gx, -gy) the level-line angle.
    """
    gx, gy = _central_differences(img)
    mag = sqrt_rn(gx * gx + gy * gy)
    border = torch.zeros_like(img)
    border[1:-1, 1:-1] = 1.0
    mag = mag * border
    return gx, gy, mag, torch.atan2(gx, -gy)


def _gradients_cuda(img: torch.Tensor):
    cuda_lib.require_plane(img, torch.float32, "image_gradients")
    H, W = img.shape
    gx, gy, mag, angle = (torch.empty_like(img) for _ in range(4))
    cuda_lib.launch(
        "tpuslam_gradients", img, "image_gradients",
        img.data_ptr(), gx.data_ptr(), gy.data_ptr(), mag.data_ptr(), angle.data_ptr(),
        H, W,
    )
    return gx, gy, mag, angle


def image_gradients(img: torch.Tensor):
    """(gx, gy, mag, angle) of an (H, W) float32 image. Kernel on a CUDA
    tensor, plain version on a CPU tensor."""
    if cuda_lib.on_card(img):
        out = _gradients_cuda(img)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "gradients", 1)
        return out
    return image_gradients_torch(img)


def gradients_xy_torch(img: torch.Tensor, scale: float):
    """Plain version: (gx, gy) of ``img * scale``, bit for bit
    ``image_gradients_torch(img * scale)[:2]``."""
    return _central_differences(img * scale)


def _gradients_xy_cuda(img: torch.Tensor, scale: float, batched: bool = False):
    B, H, W = cuda_lib.image_batch(img, torch.float32, "gradients_xy", batched)
    gx, gy = torch.empty_like(img), torch.empty_like(img)
    cuda_lib.launch("tpuslam_gradients_xy_batch", img, "gradients_xy", img.data_ptr(), gx.data_ptr(), gy.data_ptr(), B, H, W, scale)
    return gx, gy


def gradients_xy(img: torch.Tensor, scale: float):
    """(gx, gy) of ``img * scale`` for an (H, W) float32 image, in one pass
    that reads ``img`` and writes only gx and gy (the LBD descriptors read
    nothing else). Kernel on a CUDA tensor, plain version on a CPU tensor;
    each sample is scaled before differencing, so the two agree bit for bit
    with ``image_gradients(img * scale)[:2]``."""
    if cuda_lib.on_card(img):
        out = _gradients_xy_cuda(img, scale)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "gradients", 1)
        return out
    return gradients_xy_torch(img, scale)


def gradients_xy_batch_torch(imgs: torch.Tensor, scale: float):
    """Plain version of :func:`gradients_xy_batch`: each image's plain form."""
    gx, gy = zip(*(gradients_xy_torch(im, scale) for im in imgs))
    return torch.stack(gx), torch.stack(gy)


def gradients_xy_batch(imgs: torch.Tensor, scale: float):
    """:func:`gradients_xy` of each image of a (B, H, W) float32 batch ->
    (gx, gy), each (B, H, W), in one kernel launch on a CUDA tensor (each
    image bit for bit its single call), the plain version on a CPU tensor."""
    if cuda_lib.on_card(imgs):
        out = _gradients_xy_cuda(imgs, scale, batched=True)
        cuda_lib.count(LAUNCHES, KERNEL_LAUNCHES, "gradients_batch", 1)
        return out
    return gradients_xy_batch_torch(imgs, scale)


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float = 0.8):
    """Per-level (H, W) shapes, as the JAX package computes them."""
    shapes = [(height, width)]
    for _ in range(1, n_levels):
        h, w = shapes[-1]
        shapes.append((max(16, int(round(h * scale))), max(16, int(round(w * scale)))))
    return shapes


def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize(..., "linear")`` along
    one axis: the triangle kernel widened by 1/scale when downsampling
    (antialias=True), each column normalised, samples outside the input
    zeroed — the same steps as ``jax.image.scale_and_translate``."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _resize_weights(in_size: int, out_size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(in_size, out_size)).to(device)


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """Antialiased linear resize of an (H, W) image (or a (B, H, W) batch of
    them, each image through its own two products), equal to
    ``jax.image.resize(img, shape, "linear")`` up to float rounding: two small
    matmuls with the weight matrices of :func:`_resize_weights_np`. The rows
    are contracted first, as XLA:CPU orders JAX's einsum (the lowered program
    holds ``dot_general(w_rows, img)`` and then the product with the column
    weights)."""
    H, W = img.shape[-2:]
    wh = _resize_weights(H, int(shape[0]), str(img.device))
    ww = _resize_weights(W, int(shape[1]), str(img.device))
    if img.dim() == 3:
        # one pair of products per image: cuBLAS picks its algorithm (and so
        # its summation order) by the whole product's shape, so a product
        # over the batch would round each image unlike its own call
        return torch.stack([wh.T @ im @ ww for im in img])
    return wh.T @ img @ ww


def build_pyramid(img: torch.Tensor, n_levels: int = 2, scale: float = 0.8, blur_sigma: float = 0.6):
    """(H, W) float32 image in [0, 1] -> list of per-level images: a Gaussian
    of sigma = blur_sigma / scale before each x``scale`` resample. A (B, H,
    W) batch gives (B, h, w) levels through the batched blur."""
    blur = gaussian_blur_batch if img.dim() == 3 else gaussian_blur
    shapes = pyramid_shapes(img.shape[-2], img.shape[-1], n_levels, scale)
    levels = [img]
    cur = img
    for lvl in range(1, n_levels):
        cur = resize_linear(blur(cur, blur_sigma / scale), shapes[lvl])
        levels.append(cur)
    return levels
