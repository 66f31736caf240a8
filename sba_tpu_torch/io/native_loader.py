"""ctypes bindings for the native C++ data-loading runtime.

Port of ``sba_tpu/io/native_loader.py``. The native library
(``native/sba_native.cc``, shared with sba_tpu and not rewritten here)
provides the reference's native-runtime capabilities -- bounded JobQueue
+ worker-pool prefetching (ref: util/threading.h:99,195,261), float-TIFF
decoding (ref: util/matrix_vis.h:130), image decode + resize pipeline
(ref: feature/extraction.cc:112-177) -- behind a C API. This module
builds it with ``g++`` at first use into ``sba_tpu_torch/_build/``
(nothing under ``native/`` is written), loads it, and degrades to the
pure-Python PIL path otherwise (`is_available()` reports which).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_SOURCE = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "sba_native.cc"))
_BUILD_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "_build"))
_LIB_PATH = os.path.join(_BUILD_DIR, "libsba_native.so")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> bool:
    """Compile the native source with the native Makefile's flags into a
    temporary file of the build directory, then rename it into place (a
    concurrent build of another process is harmless)."""
    if not os.path.exists(_SOURCE):
        return False
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
                        _SOURCE], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build_library():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.sba_decode_image.restype = ctypes.c_int
        lib.sba_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.sba_loader_create.restype = ctypes.c_void_p
        lib.sba_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.sba_loader_next.restype = ctypes.c_int
        lib.sba_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.sba_loader_destroy.restype = None
        lib.sba_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


_NATIVE_EXTS = (".pgm", ".ppm", ".bmp", ".tif", ".tiff")


def decode_image_native(path: str, max_size: int = 0,
                        max_pixels: int = 64 * 1024 * 1024
                        ) -> Optional[np.ndarray]:
    """Decode one image via the native library -> [H, W] f32, or None if
    the library/format is unavailable (caller falls back to PIL)."""
    lib = _load()
    if lib is None or not path.lower().endswith(_NATIVE_EXTS):
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.sba_decode_image(path.encode(), max_size, None,
                              ctypes.byref(w), ctypes.byref(h), 0)
    if rc != 0:
        return None
    n = w.value * h.value
    if n <= 0 or n > max_pixels:
        return None
    buf = np.empty(n, np.float32)
    rc = lib.sba_decode_image(
        path.encode(), max_size,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h), n)
    if rc != 0:
        return None
    return buf.reshape(h.value, w.value)


class PrefetchingImageLoader:
    """Multi-threaded native prefetcher over a path list.

    Iterates (index, image [H, W] f32). Decode order is
    completion-order (like the reference's JobQueue pipeline); failed
    decodes yield (index, None).
    """

    def __init__(self, paths: Sequence[str], num_threads: int = 4,
                 max_size: int = 0, queue_size: int = 8,
                 max_pixels: int = 64 * 1024 * 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(paths)
        self._capacity = max_pixels
        self._handle = lib.sba_loader_create(
            arr, self._n, num_threads, max_size, queue_size)
        if not self._handle:
            raise RuntimeError("failed to create native loader")

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
        w = ctypes.c_int()
        h = ctypes.c_int()
        buf = np.empty(self._capacity, np.float32)
        for _ in range(self._n):
            rc = self._lib.sba_loader_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._capacity, ctypes.byref(w), ctypes.byref(h))
            if rc == -1:
                return
            if rc <= -2:
                yield (-rc - 2, None)
                continue
            yield (rc, buf[: w.value * h.value]
                   .reshape(h.value, w.value).copy())

    def close(self):
        if self._handle:
            self._lib.sba_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
