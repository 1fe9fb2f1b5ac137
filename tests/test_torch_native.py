"""The port's host-IO library (tpuvc_torch/native), its wiring into
read_wav, from_bin_dir and BatchStream, and the compiled-library cache
(tpuvc_torch/utils/aot_cache.py), against the JAX package's.

The native entries must be bit-equal to the JAX package's and to numpy /
scipy; the JAX library is compared where it loads (it builds itself with
make at first use and gives up when that fails, which the port's does
not).  The last test checks that every module of the JAX package has a
counterpart in the port, from file names alone.
"""

import ctypes
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpuvc_torch import native
from tpuvc_torch.io import wav as port_wav
from tpuvc_torch.utils import aot_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one PyTorch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native module, or None where its library did not
    load."""
    from tpuvc import native as jn
    return jn if jn.available() else None


# --- WAV files built by hand ----------------------------------------------

def _chunk(tag: bytes, body: bytes) -> bytes:
    pad = b"\0" * (len(body) & 1)
    return tag + struct.pack("<I", len(body)) + body + pad


def _fmt(tag: int, channels: int, fs: int, bits: int) -> bytes:
    block = channels * bits // 8
    return _chunk(b"fmt ", struct.pack("<HHIIHH", tag, channels, fs,
                                       fs * block, block, bits))


def _riff(*chunks: bytes) -> bytes:
    body = b"WAVE" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _pcm16(rng, n: int, channels: int) -> np.ndarray:
    a = rng.integers(-32768, 32768, (n, channels)).astype("<i2")
    a[:4] = [[-32768] * channels, [32767] * channels, [0] * channels,
             [-1] * channels]
    return a


def _write_case(path: str, case: str, rng) -> np.ndarray | None:
    """Write the WAV of ``case``; return its int16 samples [n, channels]
    where io.cc decodes it."""
    if case in ("mono_scipy", "stereo_scipy"):
        a = _pcm16(rng, 4001, 1 if case == "mono_scipy" else 2)
        wavfile.write(path, 16000, a[:, 0] if case == "mono_scipy" else a)
        return a
    if case == "float32":
        wavfile.write(path, 16000,
                      rng.uniform(-1, 1, 3001).astype(np.float32))
        return None
    if case == "uint8":
        wavfile.write(path, 8000,
                      rng.integers(0, 256, 3001).astype(np.uint8))
        return None
    channels = 2 if case.startswith("stereo") else 1
    a = _pcm16(rng, 2999, channels)
    fmt = _fmt(1, channels, 22050, 16)
    data = _chunk(b"data", a.tobytes())
    if case == "data_before_fmt":
        raw = _riff(data, fmt)
        a = None
    elif case in ("mono_list", "stereo_list"):
        # a LIST chunk of odd size (padded) and a fmt chunk with an
        # extension before the data
        ext = _chunk(b"fmt ", _fmt(1, channels, 22050, 16)[8:] + b"\0\0")
        info = _chunk(b"LIST", b"INFOISFT\x05\0\0\0tpuvc")
        raw = _riff(ext, info, data)
    else:
        raw = _riff(fmt, data)
    with open(path, "wb") as f:
        f.write(raw)
    return a


PCM16_CASES = ("mono_scipy", "stereo_scipy", "mono_hand", "stereo_hand",
               "mono_list", "stereo_list")


@pytest.mark.parametrize("case", PCM16_CASES)
def test_read_wav_native_pcm16_bit_equal(case, tmp_path, jax_native):
    """PCM16 mono and stereo, written by scipy and by hand (a LIST chunk
    and an extended fmt chunk before the data too): the port's decoder
    gives int16 / 32768 (the channels' mean for stereo) bit for bit, as
    the JAX package's and the port's scipy path do, and read_wav returns
    it as float64."""
    path = str(tmp_path / "t.wav")
    a = _write_case(path, case, np.random.default_rng(len(case)))
    got = native.read_wav_native(path)
    assert got is not None
    y, fs = got
    assert y.dtype == np.float32
    want = (a.astype(np.float64) / 32768.0).mean(axis=1)
    np.testing.assert_array_equal(y.astype(np.float64), want)
    scipy_x, scipy_fs = port_wav.read_wav_scipy(path)
    assert fs == scipy_fs
    np.testing.assert_array_equal(y.astype(np.float64), scipy_x)
    x, fs2 = port_wav.read_wav(path)
    assert x.dtype == np.float64 and fs2 == fs
    np.testing.assert_array_equal(x, want)
    if jax_native is not None:
        jy, jfs = jax_native.read_wav_native(path)
        assert jfs == fs and jy.tobytes() == y.tobytes()
        from tpuvc.io.wav import read_wav as jax_read_wav
        jx, _ = jax_read_wav(path)
        np.testing.assert_array_equal(x, jx)


@pytest.mark.parametrize("case", ("float32", "uint8", "data_before_fmt"))
def test_read_wav_native_refuses_other_formats(case, tmp_path, jax_native):
    """io.cc refuses float32, 8-bit and a data chunk before fmt (None);
    read_wav then takes scipy's path and equals the JAX package's (both
    raise scipy's error for the data chunk before fmt)."""
    from tpuvc.io.wav import read_wav as jax_read_wav
    path = str(tmp_path / "t.wav")
    _write_case(path, case, np.random.default_rng(7))
    assert native.read_wav_native(path) is None
    if jax_native is not None:
        assert jax_native.read_wav_native(path) is None
    if case == "data_before_fmt":
        for read in (port_wav.read_wav, jax_read_wav):
            with pytest.raises(ValueError, match="fmt"):
                read(path)
        return
    x, fs = port_wav.read_wav(path)
    jx, jfs = jax_read_wav(path)
    assert fs == jfs and x.dtype == jx.dtype == np.float64
    np.testing.assert_array_equal(x, jx)
    assert np.abs(x).max() <= 1.0


def test_read_wav_scipy_scales_stereo_before_averaging(tmp_path):
    """A stereo 8-bit file through the scipy path: each channel scaled to
    [-1, 1] and then averaged (the JAX fallback averages the raw codes
    and leaves them unscaled)."""
    a = np.random.default_rng(3).integers(0, 256, (999, 2)).astype(np.uint8)
    path = str(tmp_path / "s8.wav")
    wavfile.write(path, 8000, a)
    assert native.read_wav_native(path) is None
    x, fs = port_wav.read_wav(path)
    assert fs == 8000
    np.testing.assert_array_equal(
        x, ((a.astype(np.float64) - 128.0) / 128.0).mean(axis=1))


@pytest.mark.parametrize("n_bytes", [0, 4, 4 * 1029 * 7, 4 * 1029 + 2])
def test_read_f32_native_matches_fromfile(n_bytes, tmp_path, jax_native):
    """Raw float32 files (empty, one value, records, a trailing partial
    value) read as np.fromfile and the JAX package read them."""
    path = str(tmp_path / "r.bin")
    with open(path, "wb") as f:
        f.write(np.random.default_rng(n_bytes).bytes(n_bytes))
    got = native.read_f32_native(path)
    want = np.fromfile(path, dtype=np.float32)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    if jax_native is not None:
        assert jax_native.read_f32_native(path).tobytes() == got.tobytes()


@pytest.mark.parametrize("n_threads", [1, 3, 8, None])
@pytest.mark.parametrize("n_idx", [0, 100, 1024, 3001])
def test_gather_rows_matches_numpy_and_jax(n_threads, n_idx, jax_native):
    """Fewer than and at least 1024 indices (where io.cc starts threads),
    1, 3 and 8 threads and the default, indices repeated: numpy's rows."""
    rng = np.random.default_rng(n_idx)
    src = rng.standard_normal((517, 37)).astype(np.float32)
    idx = rng.integers(0, 60, n_idx)       # many repeats
    idx[:min(n_idx, 2)] = 516
    got = native.gather_rows(src, idx, n_threads)
    assert got.shape == (n_idx, 37) and got.dtype == np.float32
    np.testing.assert_array_equal(got, src[idx])
    if jax_native is not None:
        np.testing.assert_array_equal(
            jax_native.gather_rows(src, idx, n_threads), got)


@pytest.mark.parametrize("bad", [-1, 50])
def test_gather_rows_rejects_out_of_range(bad, jax_native):
    src = np.zeros((50, 3), np.float32)
    idx = np.array([0, 7, bad, 3])
    with pytest.raises(IndexError, match="out of range"):
        native.gather_rows(src, idx)
    if jax_native is not None:
        with pytest.raises(IndexError):
            jax_native.gather_rows(src, idx)


# --- the wiring ------------------------------------------------------------

@pytest.fixture(scope="module")
def analysed_corpus(tmp_path_factory):
    """The synthetic corpus' first 2 speakers x 2 training utterances of
    0.5 s, analysed by the port on the CPU."""
    from tpuvc_torch.data import synthetic
    from tpuvc_torch.data.analyze_corpus import analyze_corpus
    from tpuvc_torch.io import corpus
    root = str(tmp_path_factory.mktemp("corpus"))
    defs = dict(list(synthetic.SPEAKER_DEFS.items())[:2])
    synthetic.make_corpus(root, n_train=2, n_test=0, dur_s=0.5, seed=0,
                          speaker_defs=defs)
    analyze_corpus(root, splits=(corpus.TRAIN_SPLIT,), bucket_s=0.5,
                   device="cpu")
    return root


def test_from_bin_dir_and_batch_stream_match_jax(analysed_corpus,
                                                 monkeypatch):
    """from_bin_dir (native records, and memory-mapped) and 50 BatchStream
    batches (native gather, normalised) equal the JAX package's bit for
    bit; the stream reads its records through read_f32_native and gathers
    through gather_rows."""
    from tpuvc.data.dataset import FrameDataset as JaxFrameDataset
    from tpuvc.data.normalizer import Tanhize as JaxTanhize
    from tpuvc_torch.data import dataset as port_dataset
    from tpuvc_torch.data.normalizer import Tanhize
    calls = {"read": 0, "gather": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(native, "read_f32_native",
                        counted("read", native.read_f32_native))
    monkeypatch.setattr(native, "gather_rows",
                        counted("gather", native.gather_rows))
    ds = port_dataset.FrameDataset.from_bin_dir(analysed_corpus)
    assert calls["read"] == 4
    jds = JaxFrameDataset.from_bin_dir(analysed_corpus)
    mapped = port_dataset.FrameDataset.from_bin_dir(analysed_corpus,
                                                    mmap=True)
    assert calls["read"] == 4
    for d in (ds, mapped):
        assert d.x.tobytes() == jds.x.tobytes()
        assert d.y.tobytes() == jds.y.tobytes()
    etc = os.path.join(analysed_corpus, "etc")
    a = ds.batches(16, seed=3, normalizer=Tanhize.from_etc(etc))
    b = jds.batches(16, seed=3, normalizer=JaxTanhize.from_etc(etc))
    for _ in range(50):
        (xa, ya), (xb, yb) = next(a), next(b)
        assert xa.dtype == xb.dtype == np.float32
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()
    assert calls["gather"] == 50


# --- the compiled-library cache ---------------------------------------------

def _sources(tmp_path, text: bytes = b"int f() { return 1; }\n"):
    src = tmp_path / "a.cc"
    src.write_bytes(text)
    return [str(src)]


def test_library_key_moves_with_what_is_compiled(tmp_path):
    """The key moves with one source byte, a source's name, the flags and
    the compiler's version string, and with nothing else."""
    srcs = _sources(tmp_path)
    base = aot_cache.library_key(srcs, ("-O3",), "g++ 12.2.0")
    assert base == aot_cache.library_key(srcs, ("-O3",), "g++ 12.2.0")
    assert len(base) == 16 and int(base, 16) >= 0
    assert base != aot_cache.library_key(srcs, ("-O2",), "g++ 12.2.0")
    assert base != aot_cache.library_key(srcs, ("-O3",), "g++ 13.1.0")
    assert base != aot_cache.library_key(srcs, ("-O", "3"), "g++ 12.2.0")
    _sources(tmp_path, b"int f() { return 2; }\n")
    assert base != aot_cache.library_key(srcs, ("-O3",), "g++ 12.2.0")
    other = tmp_path / "b.cc"
    other.write_bytes(b"int f() { return 1; }\n")
    assert base != aot_cache.library_key([str(other)], ("-O3",),
                                         "g++ 12.2.0")


def test_cached_library_compiles_once_and_prunes(tmp_path):
    """A second call is a hit (the compile callable runs once) that
    touches the file; after each save the two most recently used
    libraries of the tag stay, and other tags (``tagx``, ``tag_x``) and
    other files are left alone."""
    build = tmp_path / "build"
    build.mkdir()
    srcs = _sources(tmp_path)
    compiles = []

    def compile(out):
        compiles.append(out)
        with open(out, "wb") as f:
            f.write(b"library")

    def get(flags):
        return aot_cache.cached_library("tag", str(build), srcs, flags,
                                        compile, sys.executable)

    first = get(("-O1",))
    assert os.path.basename(first).startswith("tag_")
    assert open(first, "rb").read() == b"library"
    os.utime(first, (1, 1))
    assert get(("-O1",)) == first and len(compiles) == 1
    assert os.path.getmtime(first) > 1
    strangers = ["tagx_0123456789abcdef.so", "tag_x_0123456789abcdef.so",
                 "other_0123456789abcdef.so", "tag_0123456789abcdeg.so",
                 "tag_0123456789abcdef.so.tmp", "notes.txt"]
    for name in strangers:
        (build / name).write_bytes(b"")
        os.utime(build / name, (0, 0))
    paths = [first]
    for i, flags in enumerate((("-O2",), ("-O3",), ("-Os",))):
        os.utime(paths[-1], (10 + i, 10 + i))
        paths.append(get(flags))
    assert len(compiles) == 4 and len(set(paths)) == 4
    mine = sorted(n for n in os.listdir(build) if n not in strangers)
    assert mine == sorted(os.path.basename(p) for p in paths[-2:])
    assert set(strangers) <= set(os.listdir(build))
    assert not [n for n in os.listdir(build) if n.startswith("tmp")]


def test_cached_library_raises_on_a_failed_compile(tmp_path):
    """A failing compiler raises with the command and its output and
    leaves no library and no temporary file behind."""
    build = tmp_path / "build"
    srcs = _sources(tmp_path, b"this is not C++\n")

    def compile(out):
        aot_cache.run(["g++", "-shared", "-fPIC", "-o", out, *srcs])

    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        aot_cache.cached_library("bad", str(build), srcs, ("-shared",),
                                 compile, "g++")
    assert "a.cc" in str(e.value) and "error" in str(e.value)
    assert os.listdir(build) == []


def test_host_library_build_failure_raises_in_read_wav(tmp_path,
                                                       monkeypatch):
    """No silent fallback: with g++ made to fail, read_wav on a PCM16 file
    raises instead of returning scipy's samples."""
    path = str(tmp_path / "t.wav")
    wavfile.write(path, 16000, np.arange(-50, 50, dtype=np.int16))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-fno-such-flag-tpuvc",))
    with pytest.raises(RuntimeError, match="failed"):
        port_wav.read_wav(path)
    assert native._lib is None


_BUILD_SCRIPT = textwrap.dedent("""
    import ctypes, sys
    sys.path.insert(0, sys.argv[1])
    from tpuvc_torch import native
    native.BUILD_DIR = sys.argv[2]
    lib = native.lib()
    import numpy as np
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert native.gather_rows(src, np.array([3, 1]))[0, 0] == 9.0
    print(native.build())
""")


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes that build the host library into the same empty
    directory at once both load a whole library (each compiles to a
    private name and renames it into place)."""
    build = str(tmp_path / "build")
    cmd = [sys.executable, "-c", _BUILD_SCRIPT, ROOT, build]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert os.listdir(build) == [os.path.basename(paths.pop())]


def test_host_library_is_built_without_march_native():
    """The host library's flags are the portable ones; it lands in
    build/tpuvc_torch_host/ (not the kernels' directory) and loads."""
    assert native.CXX_FLAGS + native.LIBS == (
        "-O3", "-std=c++17", "-fPIC", "-shared", "-lpthread")
    path = native.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "tpuvc_torch_host")
    assert os.path.basename(path).startswith("libtpuvc_io_")
    assert isinstance(native.lib(), ctypes.CDLL)


# --- the port is whole ---------------------------------------------------

# a Pallas kernel module of the JAX package -> the port's wrapper module
KERNEL_WRAPPERS = {f"ops/pallas_{k}.py": f"ops/{k}.py" for k in (
    "events", "harmonics", "window", "smooth", "topk", "conv", "d2s")}


def test_every_jax_module_has_a_counterpart():
    """Every module of tpuvc/ (its .py files and native/io.cc) has a file
    at the same relative path in tpuvc_torch/, a Pallas kernel module its
    wrapper (ops/pallas_X.py -> ops/X.py).  File names only: nothing of
    tpuvc is imported."""
    jax_root = os.path.join(ROOT, "tpuvc")
    port_root = os.path.join(ROOT, "tpuvc_torch")
    missing, seen = [], 0
    for dirpath, _, files in os.walk(jax_root):
        for name in files:
            if not name.endswith((".py", ".cc")):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jax_root)
            seen += 1
            port = KERNEL_WRAPPERS.get(rel, rel)
            if not os.path.isfile(os.path.join(port_root, port)):
                missing.append(rel)
    assert seen >= 60
    assert not missing, f"no counterpart in tpuvc_torch/: {missing}"
