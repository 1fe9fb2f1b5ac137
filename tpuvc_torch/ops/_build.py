"""Build and load the port's hand-written CUDA kernels.

Every ``tpuvc_torch/csrc/*.cu`` file exports a plain C launcher that
returns ``cudaGetLastError()``.  They are compiled together with ``nvcc``
for ``sm_90a`` into one shared library under ``build/tpuvc_torch/`` at the
repository root, kept by ``utils/aot_cache.py`` under a name keyed by the
sources, the flags and nvcc's version (an edit rebuilds; the two most
recently used libraries stay), and loaded with ``ctypes``.  Nothing here
runs at import time: the first kernel launch calls :func:`lib`.

No ``--use_fast_math``: the event, contour and merge kernels must be
bit-exact against their plain versions, and the harmonic and window kernels
rely on IEEE ``sinf``/``cosf`` and division to stay inside their tolerances.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

from tpuvc_torch.utils import aot_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpuvc_torch")
TAG = "libtpuvc_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# launcher name -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "tpuvc_event_block_pairs": (_P, _P, _I, _I, _I, _I, _P),
    "tpuvc_harmonic_dft": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                           _I, _P),
    "tpuvc_windowed_frames": (_P, _P, _P, _P, _I, _I, _F, _P),
    "tpuvc_box_smooth": (_P, _P, _P, _I, _I, _I, _F, _F, _P),
    "tpuvc_topk_sum": (_P, _P, _I, _I, _I, _P),
    "tpuvc_refine_score": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P),
    "tpuvc_top2_block_scans": (_P, _P, _I, _I, _P),
    "tpuvc_conv_ln_lrelu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _F, _P),
    "tpuvc_d2s_ln_lrelu": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    "tpuvc_extend_scans": (_P, _P, _P, _I, _I, _I, _F, _P),
    "tpuvc_norm_lrelu": (_P, _P, _P, _P, _L, _I, _I, _F, _F, _P),
    "tpuvc_merge_channels": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P),
    "tpuvc_pwg_residual": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                           _P),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of tpuvc_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a library for these sources exists;
    ``build_seconds`` is the compile's time when this process ran one."""
    cu = [s for s in sources() if s.endswith(".cu")]
    nvcc = _nvcc()

    def compile(out: str) -> None:
        global build_seconds
        t0 = time.perf_counter()
        log = aot_cache.run([nvcc, *NVCC_FLAGS,
                             *(["-Xptxas", "-v"] if verbose else []),
                             "-o", out, *cu])
        build_seconds = time.perf_counter() - t0
        if verbose:
            print(log, flush=True)

    return aot_cache.cached_library(TAG, BUILD_DIR, sources(), NVCC_FLAGS,
                                    compile, nvcc)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


# the launch counters' names, one per kernel, in the order of their records
KERNEL_NAMES = ("events", "harmonics", "window", "smooth", "topk", "refine",
                "scan", "conv", "d2s", "extend", "norm", "merge", "pwg")
_counts = dict.fromkeys(KERNEL_NAMES, 0)


def count(kernel: str) -> None:
    """Add one to ``kernel``'s launch counter.  The increment is a
    read-modify-write, so it runs under a lock: a device mesh launches from
    a thread per device."""
    with _count_lock:
        _counts[kernel] += 1


def reset_counts() -> None:
    with _count_lock:
        _counts.update(dict.fromkeys(KERNEL_NAMES, 0))


def read_counts() -> dict:
    """kernel name -> launches since the counters were last set to 0."""
    with _count_lock:
        return dict(_counts)


def require_launches(kernels, device, where: str) -> None:
    """On the card, raise unless every kernel of ``kernels`` launched since
    the counters were last set to 0 (a CPU tensor takes the plain
    versions, which count nothing)."""
    import torch
    if torch.device(device).type != "cuda":
        return
    counts = read_counts()
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise RuntimeError(f"{where}: kernels did not launch: {missing} "
                           f"(counts {counts})")


def launch(name: str, device, *args) -> None:
    """Call a C launcher on ``device``'s current PyTorch stream, with that
    device current; raise on a CUDA error."""
    import torch
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
