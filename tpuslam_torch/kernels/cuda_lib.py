"""Build and load the hand-written CUDA kernels under ``tpuslam_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, from the package's own sources only, into ``tpuslam_torch/_build/``;
the library's file name carries a hash of the sources and flags, so an
edited source builds anew. A file lock serialises concurrent builds (several
test workers may start one at once).

Each C entry point takes data pointers, sizes and the CUDA stream, launches
on that stream without synchronising, and returns ``cudaGetLastError()``;
:func:`check` raises when that is not 0. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("image.cu", "ccl.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no fused multiply-add: keeps float rounding equal to the plain versions'
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpuslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. The compiler's
    output (ptxas resource usage included) goes to a ``.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out
            tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True, check=False)
            out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.tpuslam_gradients.argtypes = [P, P, P, P, P, I, I, P]
    lib.tpuslam_gradients.restype = I
    lib.tpuslam_blur.argtypes = [P, P, I, I, P, I, IP, P]
    lib.tpuslam_blur.restype = I
    lib.tpuslam_blur_two_pass.argtypes = [P, P, P, I, I, P, I, P]
    lib.tpuslam_blur_two_pass.restype = I
    lib.tpuslam_ccl.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, IP, P]
    lib.tpuslam_ccl.restype = I
    lib.tpuslam_ccl_per_round.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
    lib.tpuslam_ccl_per_round.restype = I
    lib.tpuslam_error_string.argtypes = [I]
    lib.tpuslam_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().tpuslam_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_plane(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """Raise unless ``t`` is a contiguous 2-D CUDA tensor of ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (H, W) tensor, got {tuple(t.shape)}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements exceed the kernels' int32 sizes")


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the kernels take CUDA or CPU tensors")
