"""ctypes bindings for the native map store (``tpuslam_torch/csrc/mapstore.cpp``).

Counterpart of ``tpuslam.slammap.native``. The library is host C++ with a
C interface (no CUDA), built at first use with the JAX package's flags
(``g++ -O2 -std=c++17 -shared -fPIC``) into ``tpuslam_torch/_build/``. A
file lock serialises concurrent builds, and the library is written to a
temporary file and renamed into place, so a process never loads a
half-written one (several test workers may build at once).

:class:`NativeMapStore` mirrors the graph structure of a ``SlamMap``'s
line store (observations, keyframe slot rows, covisibility counts); the
geometry stays in the python store's numpy arrays. Unlike the JAX
package's ``load_native``, which returns None, :func:`library` raises when
the library cannot be built or loaded: ``SlamMap`` then fails rather than
quietly counting covisibility another way.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "mapstore.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libmapstore.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)


def build(build_dir: Path | None = None) -> Path:
    """Compile the library into ``build_dir`` (default ``BUILD_DIR``) unless
    it is there and newer than the source; returns its path."""
    build_dir = Path(build_dir or BUILD_DIR)
    out = build_dir / LIB_NAME

    def fresh() -> bool:
        return out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime

    if fresh():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "mapstore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if fresh():
                return out
            tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
            try:
                subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True, capture_output=True, text=True)
            except (OSError, subprocess.CalledProcessError) as e:
                tmp.unlink(missing_ok=True)
                detail = getattr(e, "stderr", None) or str(e)
                raise RuntimeError(
                    f"the native map store did not build ({detail.strip()}); set TPUSLAM_NATIVE_MAP=0 to count "
                    "covisibility in python instead"
                ) from e
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


@functools.lru_cache(maxsize=None)
def library(build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded library (built on first call); raises RuntimeError when it
    cannot be built or loaded."""
    path = build(build_dir)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"the native map store {path} did not load ({e}); set TPUSLAM_NATIVE_MAP=0") from e
    I, P = ctypes.c_int32, ctypes.c_void_p
    lib.ms_create.restype = P
    lib.ms_create.argtypes = [I, I, I]
    lib.ms_destroy.argtypes = [P]
    lib.ms_add_keyframe.argtypes = [P, I]
    lib.ms_allocate.restype = I
    lib.ms_allocate.argtypes = [P, I]
    lib.ms_add_observation.restype = I
    lib.ms_add_observation.argtypes = [P, I, I, I]
    lib.ms_erase_observation.argtypes = [P, I, I]
    lib.ms_kill.argtypes = [P, I]
    lib.ms_replace.argtypes = [P, I, I]
    lib.ms_n_obs.restype = I
    lib.ms_n_obs.argtypes = [P, I]
    lib.ms_alive.restype = I
    lib.ms_alive.argtypes = [P, I]
    lib.ms_get_line_ids.argtypes = [P, I, _I32P]
    lib.ms_covisibility.restype = I
    lib.ms_covisibility.argtypes = [P, I, I, _I32P, _I32P, I]
    lib.ms_window_lines.restype = I
    lib.ms_window_lines.argtypes = [P, _I32P, I, _I32P, I]
    lib.ms_observations.restype = I
    lib.ms_observations.argtypes = [P, _I32P, I, _I32P, _I32P, _I32P, I]
    lib.ms_remove_keyframe.argtypes = [P, I]
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


class NativeMapStore:
    """The graph structure of a line store, in the native library: landmark
    ids allocated as the python store allocates them (LIFO free list), up to
    32 observations per landmark, one slot row per keyframe."""

    def __init__(self, line_capacity: int = 16384, kf_capacity: int = 4096, feat_capacity: int = 512):
        self._lib = library()
        self._h = self._lib.ms_create(line_capacity, kf_capacity, feat_capacity)
        self.line_capacity = line_capacity
        self.kf_capacity = kf_capacity
        self.feat_capacity = feat_capacity

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ms_destroy(h)
            self._h = None

    def add_keyframe(self, kid: int):
        self._lib.ms_add_keyframe(self._h, kid)

    def allocate(self, first_kf: int) -> int:
        """A landmark id, or -1 beyond the line capacity."""
        return int(self._lib.ms_allocate(self._h, first_kf))

    def add_observation(self, lid: int, kid: int, slot: int) -> bool:
        return bool(self._lib.ms_add_observation(self._h, lid, kid, slot))

    def erase_observation(self, lid: int, kid: int):
        self._lib.ms_erase_observation(self._h, lid, kid)

    def kill(self, lid: int):
        self._lib.ms_kill(self._h, lid)

    def replace(self, old: int, new: int):
        self._lib.ms_replace(self._h, old, new)

    def n_obs(self, lid: int) -> int:
        return int(self._lib.ms_n_obs(self._h, lid))

    def alive(self, lid: int) -> bool:
        return bool(self._lib.ms_alive(self._h, lid))

    def _kids(self, kids) -> np.ndarray:
        """Keyframe ids as int32, refused outside [0, kf_capacity): the
        library reads their slot rows unchecked."""
        kids = np.ascontiguousarray(kids, np.int32)
        if kids.size and not (0 <= kids.min() and kids.max() < self.kf_capacity):
            raise IndexError(f"keyframe ids {kids.tolist()} outside [0, {self.kf_capacity})")
        return kids

    def line_ids(self, kid: int) -> np.ndarray:
        self._kids([kid])
        out = np.empty(self.feat_capacity, np.int32)
        self._lib.ms_get_line_ids(self._h, kid, _i32p(out))
        return out

    def covisibility(self, kid: int, min_weight: int = 1, max_out: int = 256):
        """(keyframe ids, shared-landmark counts) of ``kid``'s neighbours,
        by count, descending."""
        self._kids([kid])
        kids = np.empty(max_out, np.int32)
        counts = np.empty(max_out, np.int32)
        n = self._lib.ms_covisibility(self._h, kid, min_weight, _i32p(kids), _i32p(counts), max_out)
        return kids[:n].copy(), counts[:n].copy()

    def window_lines(self, kids, max_out: int = 4096) -> np.ndarray:
        """Sorted ids of the live landmarks a window of keyframes observes."""
        kids = self._kids(kids)
        out = np.empty(max_out, np.int32)
        n = self._lib.ms_window_lines(self._h, _i32p(kids), len(kids), _i32p(out), max_out)
        return out[:n].copy()

    def observations(self, lines, max_out: int = 16384):
        """(index into ``lines``, keyframe id, slot) of every observation of
        the live ``lines`` by a live keyframe."""
        lines = np.ascontiguousarray(lines, np.int32)
        li = np.empty(max_out, np.int32)
        kids = np.empty(max_out, np.int32)
        slots = np.empty(max_out, np.int32)
        n = self._lib.ms_observations(self._h, _i32p(lines), len(lines), _i32p(li), _i32p(kids), _i32p(slots), max_out)
        return li[:n].copy(), kids[:n].copy(), slots[:n].copy()

    def remove_keyframe(self, kid: int):
        self._lib.ms_remove_keyframe(self._h, kid)
