"""Build and load the hand-written CUDA kernels under ``tpuslam_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``: one ``nvcc -c`` per source,
all started at once, then one link. The build happens at first use, from the
package's own sources only, into ``tpuslam_torch/_build/``; the library's
file name carries a hash of the sources, headers and flags, so an edited
source builds anew. A file lock serialises concurrent builds (several test
workers may start one at once).

Each C entry point takes data pointers, sizes and the CUDA stream, launches
on that stream without synchronising, and returns ``cudaGetLastError()``;
:func:`launch` calls it with the tensor's card as the current device (a CUDA
launch goes to the calling thread's current device, whatever card the
pointers and the stream belong to) and raises when that is not 0. The
wrappers count their calls through :func:`count`, under a lock, and
:func:`launch` tallies each call by entry point, device and images
(``TALLY``: a split's shard process reports its own, ``parallel``). Nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("image.cu", "lsd_front.cu", "ccl.cu", "moments.cu")
HEADERS = ("taps.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no fused multiply-add: keeps float rounding equal to the plain versions'
    "--fmad=false",
    "-Xcompiler", "-fPIC",
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
    for name in SOURCES + HEADERS:
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
            objs = [out.with_name(f"{out.stem}.tmp{os.getpid()}.{Path(src).stem}.o") for src in SOURCES]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / src)] for o, src in zip(objs, SOURCES)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
            failed = any(p.returncode for p in procs)
            if not failed:
                res = subprocess.run(link, capture_output=True, text=True, check=False)
                logs.append(res.stdout + res.stderr)
                failed = res.returncode != 0
            out.with_suffix(".log").write_text(
                "".join(" ".join(c) + "\n" + log for c, log in zip([*cmds, link], logs))
            )
            for o in objs:
                o.unlink(missing_ok=True)
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed:\n{''.join(logs)}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
TALLY: Counter = Counter()  # (entry point, device, images) -> launch calls


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the build's file lock
    orders processes, this lock the threads of one)."""
    with _LIB_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    F = ctypes.c_float
    lib.tpuslam_gradients.argtypes = [P, P, P, P, P, I, I, P]
    lib.tpuslam_gradients.restype = I
    lib.tpuslam_gradients_xy.argtypes = [P, P, P, I, I, F, P]
    lib.tpuslam_gradients_xy.restype = I
    lib.tpuslam_lsd_front.argtypes = [P, P, P, P, P, P, I, I, P, I, F, F, I, I, IP, P]
    lib.tpuslam_lsd_front.restype = I
    lib.tpuslam_blur.argtypes = [P, P, I, I, P, I, IP, P]
    lib.tpuslam_blur.restype = I
    lib.tpuslam_blur_two_pass.argtypes = [P, P, P, I, I, P, I, P]
    lib.tpuslam_blur_two_pass.restype = I
    lib.tpuslam_ccl.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, IP, P]
    lib.tpuslam_ccl.restype = I
    lib.tpuslam_ccl_per_round.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
    lib.tpuslam_ccl_per_round.restype = I
    lib.tpuslam_moments.argtypes = [P, P, P, P, I, I, I, IP, P]
    lib.tpuslam_moments.restype = I
    lib.tpuslam_component_moments.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, IP, P]
    lib.tpuslam_component_moments.restype = I
    lib.tpuslam_component_extents.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, IP, P]
    lib.tpuslam_component_extents.restype = I
    lib.tpuslam_segment_sums.argtypes = [P, P, P, I, I, I, IP, P]
    lib.tpuslam_segment_sums.restype = I
    # the batched forms: B images of one shape per launch (a B after the pointers)
    lib.tpuslam_gradients_xy_batch.argtypes = [P, P, P, I, I, I, F, P]
    lib.tpuslam_blur_batch.argtypes = [P, P, I, I, I, P, I, IP, P]
    lib.tpuslam_lsd_front_batch.argtypes = [P, P, P, P, P, P, I, I, I, P, I, F, F, I, I, IP, P]
    lib.tpuslam_ccl_batch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, IP, P]
    lib.tpuslam_component_moments_batch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, IP, P]
    lib.tpuslam_component_extents_batch.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, IP, P]
    lib.tpuslam_segment_sums_batch.argtypes = [P, P, P, I, I, I, I, IP, P]
    for name in BATCH_ENTRY_POINTS:
        getattr(lib, name).restype = I
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


def launch(entry: str, t: torch.Tensor, what: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``t``'s card, that card being the current device during the call;
    raise if it reports a CUDA error."""
    lib = library()
    with torch.cuda.device(t.device):
        code = getattr(lib, entry)(*args, stream_of(t))
    check(code, what)
    with _COUNT_LOCK:
        TALLY[(entry, str(t.device), t.shape[0] if t.dim() == 3 else 1)] += 1


def count(launches: dict, kernel_launches: dict, key: str, n: int) -> None:
    """One more call of a wrapper, which made ``n`` device launches."""
    with _COUNT_LOCK:
        launches[key] += 1
        kernel_launches[key] += n


def kernel_counts() -> dict:
    """This process's hand-kernel counters: calls and device launches by
    wrapper, and launch calls by (C entry point, device, images)."""
    from tpuslam_torch.kernels import image, lsd

    return {
        "calls": {**image.LAUNCHES, **lsd.LAUNCHES},
        "launches": {**image.KERNEL_LAUNCHES, **lsd.KERNEL_LAUNCHES},
        "entries": dict(TALLY),
    }


def reset_kernel_counts() -> None:
    """Every counter of :func:`kernel_counts` to 0."""
    from tpuslam_torch.kernels import image, lsd

    with _COUNT_LOCK:
        for d in (image.LAUNCHES, lsd.LAUNCHES, image.KERNEL_LAUNCHES, lsd.KERNEL_LAUNCHES):
            for k in d:
                d[k] = 0
        TALLY.clear()


BATCH_ENTRY_POINTS = (
    "tpuslam_gradients_xy_batch", "tpuslam_blur_batch", "tpuslam_lsd_front_batch", "tpuslam_ccl_batch",
    "tpuslam_component_moments_batch", "tpuslam_component_extents_batch", "tpuslam_segment_sums_batch",
)


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


def require_batch(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """Raise unless ``t`` is a contiguous (B, H, W) CUDA tensor of ``dtype``
    with B >= 1 (the batched kernels' grid holds B images) whose B H W
    elements fit the kernels' int32 sizes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 3 or not t.is_contiguous() or not 1 <= t.shape[0] <= 65535:
        raise ValueError(f"{name}: expected a contiguous (B, H, W) tensor, 1 <= B <= 65535, got {tuple(t.shape)}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements exceed the kernels' int32 sizes")


def image_batch(t: torch.Tensor, dtype: torch.dtype, name: str, batched: bool):
    """(B, H, W) of a kernel's input after :func:`require_batch` (``batched``)
    or :func:`require_plane` (an (H, W) plane is the batch of one)."""
    if batched:
        require_batch(t, dtype, name)
        return tuple(t.shape)
    require_plane(t, dtype, name)
    return (1, *t.shape)


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the kernels take CUDA or CPU tensors")
