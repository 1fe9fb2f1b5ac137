"""Paths, cache directories, named data files and the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``); a per-layer metric is read by
``metrics/<metric>.py`` (or ``metrics/<stem>.py`` for ``<stem>.<suffix>``),
and ``<kernel>_roofline`` by the count in ``roofline/<kernel>.py``
(``readers.find``).  A later change adds a cell, a mix, a metric or a
kernel by adding files only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import types

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# the program's build and kernel caches, at fixed paths inside the
# checkout (the port keeps its nvcc library in build/tpuvc_torch itself),
# and one host thread per pool: the program launches from one thread, and
# idle pool threads only contend with it for the host's cores
CACHE = os.path.join(ROOT, "build", "benchmark_cache")
RUN_ENV = {
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
    "CUDA_CACHE_PATH": os.path.join(CACHE, "cuda"),
    "TORCHINDUCTOR_CACHE_DIR": os.path.join(CACHE, "inductor"),
    # a library the port uses must not load JAX behind its back
    "USE_FLAX": "0",
    "USE_JAX": "0",
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
}

# modules no run may load, compared by their whole top-level name
# (``tpuvc_torch`` is the port and passes; ``tpuvc`` is the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpuvc")


def set_run_env() -> None:
    """Point every build and kernel cache at the checkout and set the
    host's thread pools; call before torch is imported."""
    for k, v in RUN_ENV.items():
        os.environ[k] = v
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
              "TORCHINDUCTOR_CACHE_DIR"):
        os.makedirs(os.environ[k], exist_ok=True)


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name is one of ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in forbidden)


def reference_leaks(modules=None) -> list[str]:
    """Names in the plain reference's modules (``benchmark.reference``)
    that come from the program, JAX or the JAX package: the reference
    takes nothing of what it judges."""
    names = sys.modules if modules is None else modules
    bad = []
    for name, mod in list(names.items()):
        if not name.startswith("benchmark.reference") or mod is None:
            continue
        for key, value in vars(mod).items():
            origin = (value.__name__ if isinstance(value, types.ModuleType)
                      else getattr(value, "__module__", None))
            if (isinstance(origin, str) and origin.split(".", 1)[0]
                    in FORBIDDEN + ("tpuvc_torch",)):
                bad.append(f"{name}.{key}")
    return sorted(bad)


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    path = os.path.join(BENCH, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def names(kind: str, ext: str) -> list[str]:
    """The names of the files of ``benchmark/<kind>/`` ending in ``ext``."""
    d = os.path.join(BENCH, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that cell
    ``cell`` reports: those listing it, and those listing no cells."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]
