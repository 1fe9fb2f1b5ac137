"""ctypes bindings for the port's native host-IO library (``io.cc``).

The port's counterpart of ``tpuvc/native/``, with its own copy of
``io.cc`` (the same three C entries and ABI).  The library is compiled
with g++ at first use, never at import, into ``build/tpuvc_torch_host/``
at the repository root through ``utils/aot_cache.py`` (keyed by the
source, the flags and g++'s version).  There is no ``-march=native``: the
build directory may travel with the working tree to another host.  There
is no numpy fallback either: a failed build raises.

  read_wav_native(path)   PCM16 mono/stereo WAV -> (float32 mono, fs);
                          None for a file io.cc refuses (not PCM16, more
                          than 2 channels, ``data`` before ``fmt ``)
  read_f32_native(path)   a raw float32 record file; None if it cannot be
                          opened
  gather_rows(src, idx)   out[i] = src[idx[i]], threaded from 1024 rows;
                          IndexError for an index outside [0, n)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

import numpy as np

from tpuvc_torch.utils import aot_cache

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "io.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "tpuvc_torch_host")
TAG = "libtpuvc_io"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lpthread",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: tpuvc_torch's host-IO library "
                           "is compiled with g++ at first use")
    return gxx


def build() -> str:
    """Compile the library unless one for this source exists; return its
    path.  ``build_seconds`` is the compile's time when this process ran
    one."""
    gxx = _gxx()

    def compile(out: str) -> None:
        global build_seconds
        t0 = time.perf_counter()
        aot_cache.run([gxx, *CXX_FLAGS, "-o", out, SOURCE, *LIBS])
        build_seconds = time.perf_counter() - t0

    return aot_cache.cached_library(TAG, BUILD_DIR, [SOURCE],
                                    CXX_FLAGS + LIBS, compile, gxx)


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            handle.tpuvc_wav_read_pcm16.restype = ctypes.c_int64
            handle.tpuvc_wav_read_pcm16.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
            handle.tpuvc_read_f32.restype = ctypes.c_int64
            handle.tpuvc_read_f32.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64]
            handle.tpuvc_gather_rows.restype = None
            handle.tpuvc_gather_rows.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32]
            _lib = handle
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_wav_native(path: str) -> tuple[np.ndarray, int] | None:
    """PCM16 WAV -> (float32 mono in [-1, 1], fs); None if io.cc refuses
    the file's format."""
    handle = lib()
    buf = np.empty(max(os.path.getsize(path) // 2, 1), np.float32)
    fs = ctypes.c_int32(0)
    n = handle.tpuvc_wav_read_pcm16(os.fsencode(path), _fptr(buf),
                                    buf.size, ctypes.byref(fs))
    if n < 0:
        return None
    return buf[:n].copy(), int(fs.value)


def read_f32_native(path: str) -> np.ndarray | None:
    """A raw float32 file's values (a trailing partial value is dropped);
    None if the file cannot be opened."""
    handle = lib()
    n_floats = os.path.getsize(path) // 4
    buf = np.empty(max(n_floats, 1), np.float32)
    n = handle.tpuvc_read_f32(os.fsencode(path), _fptr(buf), n_floats)
    if n < 0:
        return None
    return buf[:n]


def gather_rows(src: np.ndarray, idx: np.ndarray,
                n_threads: int | None = None) -> np.ndarray:
    """out[i] = src[idx[i]] as float32, gathered by ``n_threads`` threads
    (default: up to 8; io.cc threads only from 1024 indices).  An index
    outside [0, n) raises IndexError before the C call (io.cc would
    zero-fill its row, which could hide a data-pipeline fault)."""
    src = np.ascontiguousarray(src, np.float32)
    idx64 = np.ascontiguousarray(idx, np.int64)
    if idx64.size and (idx64.min() < 0 or idx64.max() >= src.shape[0]):
        raise IndexError(
            f"gather_rows: indices out of range [0, {src.shape[0]})")
    handle = lib()
    out = np.empty((idx64.size, src.shape[1]), np.float32)
    handle.tpuvc_gather_rows(
        _fptr(src), src.shape[0], src.shape[1],
        idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx64.size,
        _fptr(out), n_threads or min(8, os.cpu_count() or 1))
    return out
