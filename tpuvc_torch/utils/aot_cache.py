"""On-disk cache of the port's compiled shared libraries.

The port's counterpart of ``tpuvc/utils/aot_cache.py``.  PyTorch runs
eagerly and compiles no graph, so what the port compiles ahead of time is
its native code: the nvcc kernel library (``ops/_build.py``) and the g++
host-IO library (``native/``).  ``cached_library`` keeps each under a name
keyed by what was compiled, so an edit rebuilds and an unchanged tree
loads what is there:

    path = cached_library("libtpuvc_io", build_dir, [src], flags,
                          compile=lambda out: ..., compiler="g++")

The key is a sha256 over each source's basename and bytes, the flags, the
compiler's ``--version`` output and ``platform.machine()``; the file is
``{tag}_{16 hex}.so``.  A miss compiles to a private name in the same
directory and renames it into place, so processes building at once never
load a half-written library; a hit touches the file's mtime.  After each
save the directory keeps only the ``KEEP_PER_TAG`` most recently used
libraries of the tag (the JAX module's ``_prune_tag`` rule: the exact
file name, so a tag never prunes another that extends it).  The cache is
always on and reads no environment variable; a failed compile raises.

The whole ``--version`` output enters the key, not its first line: nvcc's
first line names the tool and is the same for every release.
"""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import re
import subprocess
import tempfile
from collections.abc import Callable, Sequence

KEEP_PER_TAG = 2


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """``compiler --version``'s output (once per process and compiler)."""
    return run([compiler, "--version"]).strip()


def library_key(sources: Sequence[str], flags: Sequence[str],
                version: str) -> str:
    """16 hex digits of the sha256 of what a build compiles."""
    h = hashlib.sha256()
    for path in sources:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(("\0".join(flags) + "\0" + version + "\0"
              + platform.machine()).encode())
    return h.hexdigest()[:16]


def library_path(tag: str, build_dir: str, sources: Sequence[str],
                 flags: Sequence[str], compiler: str) -> str:
    return os.path.join(build_dir, f"{tag}_" + library_key(
        sources, flags, compiler_version(compiler)) + ".so")


def run(cmd: Sequence[str]) -> str:
    """Run a compiler command; raise with the command and its output when
    it fails.  Returns its output (stdout, then stderr)."""
    res = subprocess.run(list(cmd), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    return res.stdout + res.stderr


def _prune_tag(build_dir: str, tag: str, keep: int) -> None:
    """Delete all but the ``keep`` most recently used ``{tag}_{16 hex}.so``
    of ``build_dir``."""
    pat = re.compile(re.escape(tag) + r"_[0-9a-f]{16}\.so")
    entries = []
    for name in os.listdir(build_dir):
        if pat.fullmatch(name):
            path = os.path.join(build_dir, name)
            try:
                entries.append((os.path.getmtime(path), path))
            except FileNotFoundError:   # pruned by another process
                pass
    entries.sort(reverse=True)
    for _, path in entries[keep:]:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


def cached_library(tag: str, build_dir: str, sources: Sequence[str],
                   flags: Sequence[str], compile: Callable[[str], None],
                   compiler: str) -> str:
    """The path of the library that ``compile(out)`` builds from
    ``sources`` with ``flags`` by ``compiler``, built only when no library
    of the same key is in ``build_dir``."""
    path = library_path(tag, build_dir, sources, flags, compiler)
    if os.path.exists(path):
        try:
            os.utime(path)   # used: the pruning keeps the newest
        except FileNotFoundError:
            pass             # pruned meanwhile: build it again below
        else:
            return path
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir)
    os.close(fd)
    try:
        compile(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _prune_tag(build_dir, tag, KEEP_PER_TAG)
    return path
