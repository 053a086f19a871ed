"""ctypes bindings for the host image loader `csrc/loader.cpp`
(`tripled_tpu/data/native_loader.py`): file -> decoded, Lanczos-resized
float32 (H, W, 3) in [0, 1] in one native call, bit for bit PIL's resize
divided by 255 (a multiply by 1/255).

The library is built with g++ at first use (libpng, libjpeg) into
`build/tripled_tpu_torch/libtripled_loader-<hash>.so`. `available()` says
whether it built and loaded; the datasets decode with PIL when it did not.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from tripled_tpu_torch.utils import cuda_build

NAME = "tripled_loader"
SOURCES = (Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp",)
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None  # why the first build or load failed


def library_path() -> Path:
    return cuda_build.host_library_path(NAME, SOURCES, LIBS)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the loader, with every argtype set; once
    per process. Raises RuntimeError when g++, a header or a library is
    missing; a failure is kept, so later calls raise it without running g++
    again."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(cuda_build.build_host(NAME, SOURCES, LIBS)))
        except (RuntimeError, OSError) as e:
            _error = f"the native loader did not build or load: {e}"
            raise RuntimeError(_error) from e
        fp = ctypes.POINTER(ctypes.c_float)
        lib.tripled_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, fp]
        lib.tripled_load_image.restype = ctypes.c_int
        lib.tripled_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int), fp, ctypes.c_int]
        lib.tripled_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def load_image(path: str, height: int, width: int, flip: bool = False) -> np.ndarray:
    """Decode and Lanczos-resize one image -> float32 (H, W, 3) in [0, 1],
    mirrored after the resize when `flip`. IOError when the file cannot be
    read or decoded."""
    lib = load_library()
    out = np.empty((height, width, 3), np.float32)
    rc = lib.tripled_load_image(path.encode(), height, width, int(flip),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"native load failed ({rc}): {path}")
    return out


def load_batch(paths: list[str], height: int, width: int, flips: list[bool] | None = None,
               num_threads: int | None = None) -> np.ndarray:
    """`load_image` of each path on `num_threads` threads (default: one per
    core, at most one per image) -> float32 (N, H, W, 3). IOError naming the
    count of images that failed."""
    lib = load_library()
    n = len(paths)
    flips = flips or [False] * n
    if num_threads is None:
        num_threads = min(max(os.cpu_count() or 1, 1), n)
    out = np.empty((n, height, width, 3), np.float32)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    flip_ints = (ctypes.c_int * n)(*[int(f) for f in flips])
    fails = lib.tripled_load_batch(names, n, height, width, flip_ints,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   num_threads)
    if fails:
        raise IOError(f"native batch load: {fails}/{n} images failed")
    return out
